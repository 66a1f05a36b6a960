"""Weights for the port: from a JAX parameter tree, or a seeded init.

:func:`state_dict_from_jax` takes the JAX package's ``{'params': ...}`` tree
as nested dicts of numpy arrays and returns the port's state dict for the
model of the same class: :class:`~cm3p_torch.models.CM3PBeatmapModel` or, when
the tree holds the metadata side, :class:`~cm3p_torch.models.CM3PModel` (with
its decoder head); the flat trees of ``BeatmapModelWithProjection``,
``MetadataModelWithProjection``, ``MaskedLMModule`` and ``ClassifierModule``
for their counterparts. Its naming and transposes are this module's own copy
of the HF export mapping:

* Dense kernels (in, out) are transposed to nn.Linear's (out, in);
* conv kernels (k, in, out) become (out, in, k);
* LayerNorm params live under ``LayerNorm_0`` (``scale`` -> ``weight``);
* the audio encoder has no token table;
* the metadata encoder ``metadata_model`` becomes ``metadata_model.encoder.``;
  ``metadata_projection`` and the scalar ``logit_scale`` keep their names;
* the heads: ``head.dense``, ``head.norm``, ``decoder`` and ``classifier``
  keep their names; a tied decoder's ``decoder_bias`` becomes ``decoder.bias``.

:func:`init_weights` makes the same state dict from a ``torch.Generator``
with the JAX package's trunc-normal init scales (no JAX needed).

Both give whole tensors. A JAX tree trained on a ``(data, model)`` mesh is
logically whole (``np.asarray`` of its leaves); a tensor-parallel rank takes
its part with :func:`~cm3p_torch.parallel.mesh.shard_state_dict`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..configs import BeatmapConfig, EncoderConfig, MetadataConfig


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


def _dense(node: dict, key: str, out: dict) -> None:
    out[key + ".weight"] = _t(node["kernel"]).T.contiguous()
    if "bias" in node:
        out[key + ".bias"] = _t(node["bias"])


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``{'params': ...}`` tree (numpy leaves) -> the port's fp32 state dict."""
    tree = params.get("params", params)
    out: dict[str, torch.Tensor] = {}
    if "beatmap_model" in tree:
        bm = tree["beatmap_model"]
        _encoder(bm["encoder"], "beatmap_model.encoder.", out)
        ae = bm["audio_encoder"]
        for conv in ("conv1", "conv2"):
            out[f"beatmap_model.audio_encoder.{conv}.weight"] = _t(ae[conv]["kernel"]).permute(2, 1, 0).contiguous()
            out[f"beatmap_model.audio_encoder.{conv}.bias"] = _t(ae[conv]["bias"])
        _encoder(ae["encoder"], "beatmap_model.audio_encoder.encoder.", out)
        for lin in ("linear_1", "linear_2"):
            _dense(ae["multi_modal_projector"][lin], f"beatmap_model.audio_encoder.multi_modal_projector.{lin}", out)
    if "metadata_model" in tree:
        _encoder(tree["metadata_model"], "metadata_model.encoder.", out)
        if "logit_scale" in tree:  # created with the dual-tower module even where only the beatmap side ran
            out["logit_scale"] = _t(tree["logit_scale"]).reshape(())
    for name in ("beatmap_projection", "metadata_projection", "decoder", "classifier"):
        if name in tree:
            _dense(tree[name], name, out)
    if "head" in tree:
        _dense(tree["head"]["dense"], "head.dense", out)
        _norm(tree["head"]["norm"], "head.norm", out)
    if "decoder_bias" in tree:  # the tied decoder's own parameter
        out["decoder.bias"] = _t(tree["decoder_bias"])
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


def _init_beatmap_tower(bc: BeatmapConfig, gen, out: dict) -> None:
    ac = bc.audio_config
    _init_encoder(bc, "beatmap_model.encoder.", True, gen, out)
    a = "beatmap_model.audio_encoder."
    std, cut = ac.initializer_range, ac.initializer_cutoff_factor
    out[a + "conv1.weight"] = _trunc_normal((ac.hidden_size, ac.n_mels, 3), std, cut, gen)
    out[a + "conv1.bias"] = torch.zeros(ac.hidden_size, device=gen.device)
    out[a + "conv2.weight"] = _trunc_normal((ac.hidden_size, ac.hidden_size, 3), std, cut, gen)
    out[a + "conv2.bias"] = torch.zeros(ac.hidden_size, device=gen.device)
    _init_encoder(ac, a + "encoder.", False, gen, out)
    out[a + "multi_modal_projector.linear_1.weight"] = _trunc_normal(
        (ac.projector_dim, ac.projector_intermediate_size), std, cut, gen
    )
    out[a + "multi_modal_projector.linear_2.weight"] = _trunc_normal(
        (ac.projector_dim, ac.projector_dim), std, cut, gen
    )


def _init_projection(key: str, projection_dim: int, hidden: int, factor: float, gen, out: dict) -> None:
    out[key + ".weight"] = _trunc_normal((projection_dim, hidden), hidden**-0.5 * factor, 2.0, gen)


def _init_head(bc: BeatmapConfig, gen, out: dict) -> None:
    """``PredictionHead``: Dense kernel at the tower's std and cutoff, LayerNorm ones / zeros."""
    h, dev = bc.hidden_size, gen.device
    out["head.dense.weight"] = _trunc_normal((h, h), bc.initializer_range, bc.initializer_cutoff_factor, gen)
    if bc.classifier_bias:
        out["head.dense.bias"] = torch.zeros(h, device=dev)
    out["head.norm.weight"] = torch.ones(h, device=dev)
    if bc.norm_bias:
        out["head.norm.bias"] = torch.zeros(h, device=dev)


def _init_decoder(bc: BeatmapConfig, std: float, tied: bool, gen, out: dict) -> None:
    if not tied:
        out["decoder.weight"] = _trunc_normal((bc.vocab_size, bc.hidden_size), std, 2.0, gen)
    if bc.decoder_bias:
        out["decoder.bias"] = torch.zeros(bc.vocab_size, device=gen.device)


HEADS = ("projection", "mlm", "classifier")


def init_weights(config, generator: torch.Generator, with_metadata: bool = False,
                 head: str = "projection") -> dict[str, torch.Tensor]:
    """A seeded fp32 state dict on the generator's device, with the JAX initialisers' stds.

    ``config`` a ``CM3PConfig``: for ``CM3PBeatmapModel(config)``, or with
    ``with_metadata`` for ``CM3PModel(config)`` (its decoder head too under
    ``has_decoder_head``). A flat ``BeatmapConfig``: the beatmap tower under
    ``head``, one of :data:`HEADS` (``BeatmapModelWithProjection``,
    ``MaskedLMModel``, ``ClassifierModel``). A ``MetadataConfig``:
    ``MetadataModelWithProjection``."""
    out: dict[str, torch.Tensor] = {}
    dev = generator.device
    if isinstance(config, MetadataConfig):
        _init_encoder(config, "metadata_model.encoder.", True, generator, out)
        _init_projection("metadata_projection", config.projection_dim, config.hidden_size,
                         config.initializer_factor, generator, out)
        return out
    if isinstance(config, BeatmapConfig):
        if head not in HEADS:
            raise ValueError(f"head must be one of {HEADS}, not {head!r}")
        _init_beatmap_tower(config, generator, out)
        if head == "projection":
            _init_projection("beatmap_projection", config.projection_dim, config.hidden_size,
                             config.initializer_factor, generator, out)
        elif head == "mlm":
            _init_head(config, generator, out)
            _init_decoder(config, config.initializer_range, config.tie_word_embeddings, generator, out)
        else:
            out["classifier.weight"] = _trunc_normal(
                (config.num_labels, config.hidden_size), config.hidden_size**-0.5 * config.initializer_factor,
                2.0, generator,
            )
            out["classifier.bias"] = torch.zeros(config.num_labels, device=dev)
        return out
    bc = config.beatmap_config
    _init_beatmap_tower(bc, generator, out)
    _init_projection("beatmap_projection", config.projection_dim, bc.hidden_size, config.initializer_factor,
                     generator, out)
    if with_metadata:
        mc = config.metadata_config
        _init_encoder(mc, "metadata_model.encoder.", True, generator, out)
        _init_projection("metadata_projection", config.projection_dim, mc.hidden_size, config.initializer_factor,
                         generator, out)
        out["logit_scale"] = torch.tensor(config.logit_scale_init_value, device=dev)
        if config.has_decoder_head:
            _init_head(bc, generator, out)
            _init_decoder(bc, config.initializer_range, False, generator, out)
    return out
