"""Weights for the port: from a JAX parameter tree, or a seeded init.

:func:`state_dict_from_jax` takes the JAX package's ``{'params': ...}`` tree
as nested dicts of numpy arrays and returns the port's state dict for
:class:`~cm3p_torch.models.CM3PBeatmapModel` or, when the tree holds the
metadata side, :class:`~cm3p_torch.models.CM3PModel`. Its naming and
transposes are this module's own copy of the HF export mapping:

* Dense kernels (in, out) are transposed to nn.Linear's (out, in);
* conv kernels (k, in, out) become (out, in, k);
* LayerNorm params live under ``LayerNorm_0`` (``scale`` -> ``weight``);
* the audio encoder has no token table;
* the metadata encoder ``metadata_model`` becomes ``metadata_model.encoder.``;
  ``metadata_projection`` and the scalar ``logit_scale`` keep their names.

:func:`init_weights` makes the same state dict from a ``torch.Generator``
with the JAX package's trunc-normal init scales (no JAX needed).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..configs import CM3PConfig, EncoderConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _norm(node: dict, key: str, out: dict) -> None:
    ln = node["LayerNorm_0"]
    out[key + ".weight"] = _t(ln["scale"])
    if "bias" in ln:
        out[key + ".bias"] = _t(ln["bias"])


def _encoder(tower: dict, prefix: str, out: dict) -> None:
    if "tok_embeddings" in tower:
        out[prefix + "embeddings.tok_embeddings.weight"] = _t(tower["tok_embeddings"]["embedding"])
    _norm(tower["embeddings_norm"], prefix + "embeddings.norm", out)
    i = 0
    while f"layers_{i}" in tower:
        lp = tower[f"layers_{i}"]
        p = f"{prefix}layers.{i}."
        if i != 0:
            _norm(lp["attn_norm"], p + "attn_norm", out)
        out[p + "attn.Wqkv.weight"] = _t(lp["attn"]["Wqkv"]["kernel"]).T.contiguous()
        out[p + "attn.Wo.weight"] = _t(lp["attn"]["Wo"]["kernel"]).T.contiguous()
        _norm(lp["mlp_norm"], p + "mlp_norm", out)
        out[p + "mlp.Wi.weight"] = _t(lp["mlp"]["Wi"]["kernel"]).T.contiguous()
        out[p + "mlp.Wo.weight"] = _t(lp["mlp"]["Wo"]["kernel"]).T.contiguous()
        i += 1
    _norm(tower["final_norm"], prefix + "final_norm", out)


def encoder_state_dict_from_jax(tower: dict) -> dict[str, torch.Tensor]:
    """One JAX ``ModernBertEncoder`` subtree -> a ``ModernBertEncoder`` state dict."""
    out: dict[str, torch.Tensor] = {}
    _encoder(tower, "", out)
    return out


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``{'params': ...}`` tree (numpy leaves) -> the port's fp32 state dict."""
    tree = params.get("params", params)
    bm = tree["beatmap_model"]
    out: dict[str, torch.Tensor] = {}
    _encoder(bm["encoder"], "beatmap_model.encoder.", out)
    ae = bm["audio_encoder"]
    for conv in ("conv1", "conv2"):
        out[f"beatmap_model.audio_encoder.{conv}.weight"] = _t(ae[conv]["kernel"]).permute(2, 1, 0).contiguous()
        out[f"beatmap_model.audio_encoder.{conv}.bias"] = _t(ae[conv]["bias"])
    _encoder(ae["encoder"], "beatmap_model.audio_encoder.encoder.", out)
    for lin in ("linear_1", "linear_2"):
        kernel = ae["multi_modal_projector"][lin]["kernel"]
        out[f"beatmap_model.audio_encoder.multi_modal_projector.{lin}.weight"] = _t(kernel).T.contiguous()
    out["beatmap_projection.weight"] = _t(tree["beatmap_projection"]["kernel"]).T.contiguous()
    if "metadata_model" in tree:
        _encoder(tree["metadata_model"], "metadata_model.encoder.", out)
        out["metadata_projection.weight"] = _t(tree["metadata_projection"]["kernel"]).T.contiguous()
        out["logit_scale"] = _t(tree["logit_scale"]).reshape(())
    return out


def _trunc_normal(shape, std: float, cutoff: float, generator: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(t, std=std, a=-cutoff * std, b=cutoff * std, generator=generator)


def _init_encoder(cfg: EncoderConfig, prefix: str, token_embeddings: bool, gen, out: dict) -> None:
    std, cut = cfg.initializer_range, cfg.initializer_cutoff_factor
    wo_std = std / math.sqrt(2.0 * cfg.num_hidden_layers)
    h, f = cfg.hidden_size, cfg.intermediate_size
    dev = gen.device
    if token_embeddings:
        out[prefix + "embeddings.tok_embeddings.weight"] = _trunc_normal((cfg.vocab_size, h), std, cut, gen)

    def norm(key):
        out[key + ".weight"] = torch.ones(h, device=dev)
        if cfg.norm_bias:
            out[key + ".bias"] = torch.zeros(h, device=dev)

    norm(prefix + "embeddings.norm")
    for i in range(cfg.num_hidden_layers):
        p = f"{prefix}layers.{i}."
        if i != 0:
            norm(p + "attn_norm")
        out[p + "attn.Wqkv.weight"] = _trunc_normal((3 * h, h), std, cut, gen)
        out[p + "attn.Wo.weight"] = _trunc_normal((h, h), wo_std, cut, gen)
        norm(p + "mlp_norm")
        out[p + "mlp.Wi.weight"] = _trunc_normal((2 * f, h), std, cut, gen)
        out[p + "mlp.Wo.weight"] = _trunc_normal((h, f), wo_std, cut, gen)
    norm(prefix + "final_norm")


def init_weights(config: CM3PConfig, generator: torch.Generator, with_metadata: bool = False) -> dict[str, torch.Tensor]:
    """A seeded fp32 state dict on the generator's device: for
    ``CM3PBeatmapModel(config)``, or with ``with_metadata`` for ``CM3PModel(config)``."""
    bc = config.beatmap_config
    ac = bc.audio_config
    out: dict[str, torch.Tensor] = {}
    _init_encoder(bc, "beatmap_model.encoder.", True, generator, out)
    a = "beatmap_model.audio_encoder."
    std, cut = ac.initializer_range, ac.initializer_cutoff_factor
    out[a + "conv1.weight"] = _trunc_normal((ac.hidden_size, ac.n_mels, 3), std, cut, generator)
    out[a + "conv1.bias"] = torch.zeros(ac.hidden_size, device=generator.device)
    out[a + "conv2.weight"] = _trunc_normal((ac.hidden_size, ac.hidden_size, 3), std, cut, generator)
    out[a + "conv2.bias"] = torch.zeros(ac.hidden_size, device=generator.device)
    _init_encoder(ac, a + "encoder.", False, generator, out)
    out[a + "multi_modal_projector.linear_1.weight"] = _trunc_normal(
        (ac.projector_dim, ac.projector_intermediate_size), std, cut, generator
    )
    out[a + "multi_modal_projector.linear_2.weight"] = _trunc_normal(
        (ac.projector_dim, ac.projector_dim), std, cut, generator
    )
    out["beatmap_projection.weight"] = _trunc_normal(
        (config.projection_dim, bc.hidden_size), bc.hidden_size**-0.5 * config.initializer_factor, 2.0, generator
    )
    if with_metadata:
        mc = config.metadata_config
        _init_encoder(mc, "metadata_model.encoder.", True, generator, out)
        out["metadata_projection.weight"] = _trunc_normal(
            (config.projection_dim, mc.hidden_size), mc.hidden_size**-0.5 * config.initializer_factor, 2.0, generator
        )
        out["logit_scale"] = torch.tensor(config.logit_scale_init_value, device=generator.device)
    return out
