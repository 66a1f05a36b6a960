"""Inference entry points: load a model, save it, embed a beatmap, rank metadata, predict masked tokens.

Counterpart of the JAX package's ``inference.py`` (``load_pretrained``,
``embed_beatmap``, ``zero_shot_classify``, ``masked_predict``) and of its HF
export (``save_pretrained``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for the default device on a machine without a GPU
raises. Checkpoints are HF-layout directories (``config.json`` beside
``model.safetensors``, the shards of a sharded checkpoint, or
``pytorch_model*.bin`` files), local or a Hub id in a local cache
(:mod:`.interop.hub`; nothing is downloaded), read and written with the port's
own safetensors code; the port's state-dict names are the HF names.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .configs import CM3PConfig
from .interop.hf_config import default_architecture, hf_config_dict, hf_config_to_cm3p
from .interop.hub import resolve_artifact
from .interop.safetensors_io import load_file, save_file
from .models import ClassifierModel, CM3PBeatmapModel, CM3PModel, EncoderOptions, MaskedLMModel, TowerModel
from .processing.processor import CM3PProcessor

_WEIGHT_MODULES = (nn.Linear, nn.Embedding, nn.Conv1d)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; pass device='cpu'")
    return device


def place_model(model: nn.Module, device: torch.device, dtype: torch.dtype) -> nn.Module:
    """``model`` on ``device`` in eval mode, the weights of its Linear, Embedding and Conv1d layers
    in ``dtype``, every other parameter (LayerNorms, a tied decoder's bias, the logit scale) fp32."""
    model.to(device)
    for module in model.modules():
        if isinstance(module, _WEIGHT_MODULES):
            module.to(dtype)
    return model.eval()


def load_model(
    config: CM3PConfig,
    state_dict: Optional[dict] = None,
    device: Optional[Union[str, torch.device]] = None,
    dtype: torch.dtype = torch.bfloat16,
    options: Optional[EncoderOptions] = None,
) -> CM3PBeatmapModel:
    """Build the beatmap model, load ``state_dict`` (HF key names) and place it.

    Weights of Linear, Embedding and Conv1d layers take ``dtype``; LayerNorm
    params stay fp32 as in the JAX package. ``options`` are the extraction
    options of every tower (default: exact). The model is in eval mode.
    """
    device = resolve_device(device)
    model = CM3PBeatmapModel(config)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    if options is not None:
        model.set_options(options)
    return place_model(model, device, dtype)


_AUDIO_TOKEN_TABLE = "beatmap_model.audio_encoder.encoder.embeddings.tok_embeddings.weight"
_TOKEN_TABLE = "beatmap_model.encoder.embeddings.tok_embeddings.weight"
_HEAD_KEYS = ("head.", "decoder.")


def load_pretrained(
    model_dir: Union[str, os.PathLike],
    processor_dir: Optional[Union[str, os.PathLike]] = None,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    options: Optional[EncoderOptions] = None,
    cache_dir: Optional[Union[str, os.PathLike]] = None,
    attn_impl: str = "pallas",
):
    """(processor, model) from an HF-layout directory or a Hub id in a local cache.

    ``model_dir`` holds ``config.json`` (the HF layout, nested or flat) and the
    weights :func:`read_bundle` reads: a published reference checkpoint, a bundle of the JAX
    package's ``export_hf_checkpoint``, or one written by :func:`save_pretrained`.
    ``model_dir`` and ``processor_dir`` may be Hub ids (``org/name``), resolved in
    the local cache ``cache_dir`` (:func:`~cm3p_torch.interop.hub.resolve_artifact`;
    nothing is downloaded).
    The model's class follows the JAX package's dispatch: a nested config gives
    :class:`CM3PModel` (:class:`CM3PBeatmapModel` where the file has no metadata
    tower; its decoder head, if any, is dropped), a flat one
    :class:`ClassifierModel` when it has ``num_labels > 0`` and a
    ``problem_type``, else :class:`MaskedLMModel`. A tied MLM bundle's
    ``decoder.weight`` (the token table again) is dropped. Weights take
    ``dtype`` (default bf16) as in :func:`load_model`. The processor comes from ``processor_dir``, or from
    ``model_dir`` (a Hub snapshot included) when that holds a ``processor_config.json``, else it is the
    default one. A tokenizer whose vocabulary exceeds the checkpoint's raises
    on CUDA, where an out-of-range id faults the device, and warns on the CPU.
    ``attn_impl="xla"`` is the JAX package's route without its kernels
    (:meth:`~cm3p_torch.models.TowerModel.set_attn_impl`: the plain version of every op, ``options`` reduced to
    ``xla_int8``). The Orbax layout is not supported.
    """
    device = resolve_device(device)
    model_dir = Path(resolve_artifact(model_dir, cache_dir=cache_dir))
    if processor_dir is None and (model_dir / "processor_config.json").exists():
        processor_dir = model_dir
    elif processor_dir is not None:
        processor_dir = resolve_artifact(processor_dir, cache_dir=cache_dir)
    processor = CM3PProcessor.from_pretrained(processor_dir) if processor_dir else CM3PProcessor()
    config, state = read_bundle(model_dir)
    bc = getattr(config, "beatmap_config", config)
    if bc.vocab_size < processor.beatmap_tokenizer.vocab_size:
        message = (
            f"checkpoint vocab {bc.vocab_size} < tokenizer vocab {processor.beatmap_tokenizer.vocab_size}: "
            "tokenized inputs can produce out-of-range ids; pass a matching processor_dir"
        )
        if device.type == "cuda":
            raise ValueError(message)
        import warnings

        warnings.warn(message, stacklevel=2)
    if isinstance(config, CM3PConfig):
        cls = CM3PModel
        if not any(k.startswith("metadata_model.") for k in state):
            cls = CM3PBeatmapModel
            state = {k: v for k, v in state.items() if not k.startswith(_HEAD_KEYS)}
    elif config.num_labels > 0 and config.problem_type:
        cls = ClassifierModel
    else:
        cls = MaskedLMModel
        if config.tie_word_embeddings:
            state.pop("decoder.weight", None)
    model = cls(config)
    model.load_state_dict(state, strict=True)
    if options is not None:
        model.set_options(options)
    model.set_attn_impl(attn_impl)
    return processor, place_model(model, device, dtype or torch.bfloat16)


def read_bundle(model_dir: Union[str, os.PathLike]) -> tuple:
    """(config, state dict on the CPU, floating tensors in fp32) of a local HF-layout directory, read as the
    JAX package's ``load_torch_state`` reads it: every ``*.safetensors`` file (the shards of a sharded
    checkpoint, in name order; an index file is not needed), else every ``pytorch_model*.bin`` file
    (``torch.load`` with ``weights_only``). The audio tower's token table (the port's audio tower consumes
    embeddings only) and ``position_ids`` are left out."""
    model_dir = Path(model_dir)
    if not model_dir.is_dir():
        raise FileNotFoundError(f"{str(model_dir)!r} is not a local directory (load_pretrained resolves Hub ids)")
    files = sorted(model_dir.glob("*.safetensors")) or sorted(model_dir.glob("pytorch_model*.bin"))
    if not files:
        if (model_dir / "params").exists():
            raise NotImplementedError(
                f"{model_dir} holds an Orbax checkpoint (params/); the port reads only the HF layout: "
                "export it with the JAX package's export_hf_checkpoint first"
            )
        raise FileNotFoundError(f"{model_dir} holds no *.safetensors and no pytorch_model*.bin")
    with open(model_dir / "config.json") as f:
        config = hf_config_to_cm3p(json.load(f))
    state: dict = {}
    for path in files:
        if path.suffix == ".safetensors":
            part = {k: torch.from_numpy(v) for k, v in load_file(path).items()}
        else:
            part = torch.load(path, map_location="cpu", weights_only=True)
        state.update({k: v.float() if v.is_floating_point() else v for k, v in part.items()})
    state.pop(_AUDIO_TOKEN_TABLE, None)
    return config, {k: v for k, v in state.items() if not k.endswith("position_ids")}


def save_pretrained(
    model: TowerModel,
    out_dir: Union[str, os.PathLike],
    processor: Optional[CM3PProcessor] = None,
    bf16: bool = False,
    state: Optional[dict] = None,
) -> Path:
    """Write ``config.json`` + ``model.safetensors`` in the HF layout.

    Any model of the family: the dual-tower and beatmap models under the nested
    config, :class:`MaskedLMModel` and :class:`ClassifierModel` under the flat
    one, with ``architectures`` from ``default_architecture``. Tensors are stored
    as float32 (or BF16 with ``bf16``) under the state-dict names, which are the
    reference's; the audio tower's unused (1, hidden) token table is written as
    zeros, as the reference model expects it, and a tied decoder's weight as the
    token table (the JAX export's ``flax_to_hf_state_dict``). With ``processor``
    its files go into the same directory. ``state`` is the state dict to write (default: the model's; a model
    sharded over a model group passes its gathered whole state, ``parallel.tensor.gather_module_state``).
    """
    config = model.config
    bc = getattr(config, "beatmap_config", config)
    architecture = default_architecture(config)
    if isinstance(model, ClassifierModel) and architecture != "CM3PForBeatmapClassification":
        raise ValueError("a ClassifierModel without a problem_type would load back as a masked-LM model "
                         "(the bundle's config decides the class): set config.problem_type")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    state = model.state_dict() if state is None else state
    state = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in state.items()}
    state[_AUDIO_TOKEN_TABLE] = np.zeros((1, bc.audio_config.hidden_size), np.float32)
    if isinstance(model, MaskedLMModel) and bc.tie_word_embeddings:
        state["decoder.weight"] = state[_TOKEN_TABLE]
    save_file(state, out_dir / "model.safetensors", metadata={"format": "pt"}, bf16=bf16)
    cfg_dict = hf_config_dict(config, architecture=architecture)
    cfg_dict["tie_word_embeddings"] = bool(bc.tie_word_embeddings)
    with open(out_dir / "config.json", "w") as f:
        json.dump(cfg_dict, f, indent=2, sort_keys=True)
    if processor is not None:
        processor.save_pretrained(out_dir)
    return out_dir


def _on(model: nn.Module, device: Optional[Union[str, torch.device]]) -> torch.device:
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model lies on {param.device}, inputs were asked on {device}")
    return device


@torch.no_grad()
def embed_beatmap(
    model: CM3PBeatmapModel,
    processor: CM3PProcessor,
    beatmap,
    audio=None,
    audio_sampling_rate: Optional[int] = None,
    mean_pool: bool = True,
    device: Optional[Union[str, torch.device]] = None,
    **processor_kwargs,
) -> np.ndarray:
    """Normalized beatmap embeddings: (windows, dim), or one mean-pooled (dim,)."""
    device = _on(model, device)
    inputs = processor(beatmap=beatmap, audio=audio, audio_sampling_rate=audio_sampling_rate, **processor_kwargs)
    features = None
    if "input_features" in inputs:
        features = torch.as_tensor(np.asarray(inputs["input_features"], np.float32), device=device)
    feats = model.get_beatmap_features(
        torch.as_tensor(np.asarray(inputs["input_ids"]), dtype=torch.int64, device=device),
        input_features=features,
        attention_mask=torch.as_tensor(np.asarray(inputs["attention_mask"]), dtype=torch.int32, device=device),
        normalize=True,
    )
    feats = feats.float().cpu().numpy()
    if not mean_pool:
        return feats
    mean = feats.mean(axis=0)
    norm = np.linalg.norm(mean)
    return mean / norm if norm > 0 else mean


@torch.no_grad()
def zero_shot_classify(
    model: CM3PModel,
    processor: CM3PProcessor,
    beatmap,
    candidates: Sequence[dict],
    audio=None,
    audio_sampling_rate: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    **processor_kwargs,
) -> np.ndarray:
    """Score candidate metadata dicts against each beatmap window.

    Returns the fp32 (windows, candidates) similarity logits; the argmax along
    the last axis is each window's predicted candidate.
    """
    device = _on(model, device)
    inputs = processor(beatmap=beatmap, audio=audio, audio_sampling_rate=audio_sampling_rate, **processor_kwargs)
    meta = processor.metadata_tokenizer(list(candidates))

    def ints(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)

    features = None
    if "input_features" in inputs:
        features = torch.as_tensor(np.asarray(inputs["input_features"], np.float32), device=device)
    out = model(
        ints(inputs["input_ids"]), input_features=features, metadata_ids=ints(meta["input_ids"]),
        attention_mask=ints(inputs["attention_mask"]), metadata_attention_mask=ints(meta["attention_mask"]),
        return_loss=False,
    )
    return out.logits_per_beatmap.float().cpu().numpy()


@torch.no_grad()
def masked_predict(
    model: Union[MaskedLMModel, CM3PModel],
    processor: CM3PProcessor,
    beatmap,
    mask_prob: float = 0.15,
    top_k: int = 5,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    **processor_kwargs,
):
    """Mask random tokens of a beatmap's first window and return top-k predictions.

    Tokens are masked with probability ``mask_prob`` from numpy's
    ``default_rng(seed)``, never at padding or special ids. Returns
    (masked positions, their true ids, (n, top_k) predicted ids). ``model`` is a
    :class:`MaskedLMModel` or a :class:`CM3PModel` with the decoder head.
    """
    device = _on(model, device)
    tok = processor.beatmap_tokenizer
    inputs = processor(beatmap=beatmap, **processor_kwargs)
    ids = np.asarray(inputs["input_ids"])[:1].copy()
    mask = np.asarray(inputs["attention_mask"])[:1]

    rng = np.random.default_rng(seed)
    corrupt = (rng.random(ids.shape) < mask_prob) & (mask == 1)
    for sid in tok.all_special_ids:
        corrupt &= ids != sid
    true_ids = ids[corrupt]
    corrupted = np.where(corrupt, tok.mask_token_id, ids)

    out = model(
        input_ids=torch.as_tensor(corrupted, dtype=torch.int64, device=device),
        attention_mask=torch.as_tensor(mask, dtype=torch.int32, device=device),
    )
    logits = out.logits.float().cpu().numpy()[corrupt]
    topk = np.argsort(-logits, axis=-1)[:, :top_k]
    positions = np.argwhere(corrupt)[:, 1]
    return positions, true_ids, topk
