"""Inference entry points: load a model, save it, embed a beatmap.

Counterpart of the JAX package's ``inference.py`` (``load_pretrained``,
``embed_beatmap``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for the default device on a machine without a GPU
raises. Checkpoints are local HF-layout directories (``config.json`` +
``model.safetensors``), read and written with the port's own safetensors code;
the port's state-dict names are the HF names.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from .configs import CM3PConfig
from .interop.hf_config import default_architecture, hf_config_dict, hf_config_to_cm3p
from .interop.safetensors_io import load_file, save_file
from .models import CM3PBeatmapModel, CM3PModel, EncoderOptions
from .processing.processor import CM3PProcessor

_WEIGHT_MODULES = (nn.Linear, nn.Embedding, nn.Conv1d)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; pass device='cpu'")
    return device


def _place(model: nn.Module, device: torch.device, dtype: torch.dtype) -> nn.Module:
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
    return _place(model, device, dtype)


_AUDIO_TOKEN_TABLE = "beatmap_model.audio_encoder.encoder.embeddings.tok_embeddings.weight"


def load_pretrained(
    model_dir: Union[str, os.PathLike],
    processor_dir: Optional[Union[str, os.PathLike]] = None,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    options: Optional[EncoderOptions] = None,
):
    """(processor, model) from a local HF-layout directory.

    ``model_dir`` holds ``config.json`` (the nested HF layout) and
    ``model.safetensors``: a published reference checkpoint, a bundle of the JAX
    package's ``export_hf_checkpoint``, or one written by :func:`save_pretrained`.
    The model is a :class:`CM3PModel` when the file carries the metadata tower,
    else a :class:`CM3PBeatmapModel`; weights take ``dtype`` (default bf16) as
    in :func:`load_model`. The processor comes from ``processor_dir``, or from
    ``model_dir`` when that holds a ``processor_config.json``, else it is the
    default one. A tokenizer whose vocabulary exceeds the checkpoint's raises
    on CUDA, where an out-of-range id faults the device, and warns on the CPU.
    Hub ids and the Orbax layout are not supported.
    """
    device = resolve_device(device)
    model_dir = Path(model_dir)
    if not model_dir.is_dir():
        raise NotImplementedError(
            f"{str(model_dir)!r} is not a local directory: loading a Hub repository id is not ported; "
            "download the repository and pass its path"
        )
    if not (model_dir / "model.safetensors").exists():
        if (model_dir / "params").exists():
            raise NotImplementedError(
                f"{model_dir} holds an Orbax checkpoint (params/); the port reads only the HF layout: "
                "export it with the JAX package's export_hf_checkpoint first"
            )
        raise FileNotFoundError(f"{model_dir} holds no model.safetensors")
    if processor_dir is None and (model_dir / "processor_config.json").exists():
        processor_dir = model_dir
    processor = CM3PProcessor.from_pretrained(processor_dir) if processor_dir else CM3PProcessor()
    with open(model_dir / "config.json") as f:
        config = hf_config_to_cm3p(json.load(f))
    if not isinstance(config, CM3PConfig):
        raise NotImplementedError("flat MLM/classifier bundles are not ported: the port has the dual-tower model only")
    state = {k: torch.from_numpy(v) for k, v in load_file(model_dir / "model.safetensors").items()}
    state.pop(_AUDIO_TOKEN_TABLE, None)  # the audio tower consumes embeddings only and has no table
    state = {k: v for k, v in state.items() if not k.endswith("position_ids")}
    bc = config.beatmap_config
    if bc.vocab_size < processor.beatmap_tokenizer.vocab_size:
        message = (
            f"checkpoint vocab {bc.vocab_size} < tokenizer vocab {processor.beatmap_tokenizer.vocab_size}: "
            "tokenized inputs can produce out-of-range ids; pass a matching processor_dir"
        )
        if device.type == "cuda":
            raise ValueError(message)
        import warnings

        warnings.warn(message, stacklevel=2)
    full = any(k.startswith("metadata_model.") for k in state)
    model = CM3PModel(config) if full else CM3PBeatmapModel(config)
    model.load_state_dict(state, strict=True)
    if options is not None:
        model.set_options(options)
    return processor, _place(model, device, dtype or torch.bfloat16)


def save_pretrained(
    model: CM3PBeatmapModel,
    out_dir: Union[str, os.PathLike],
    processor: Optional[CM3PProcessor] = None,
    bf16: bool = False,
) -> Path:
    """Write ``config.json`` + ``model.safetensors`` in the HF layout.

    Tensors are stored as float32 (or BF16 with ``bf16``) under the state-dict
    names, which are the reference's; the audio tower's unused (1, hidden)
    token table is written as zeros, as the reference model expects it. With
    ``processor`` its files go into the same directory.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    config = model.config
    state = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in model.state_dict().items()}
    state[_AUDIO_TOKEN_TABLE] = np.zeros((1, config.beatmap_config.audio_config.hidden_size), np.float32)
    save_file(state, out_dir / "model.safetensors", metadata={"format": "pt"}, bf16=bf16)
    cfg_dict = hf_config_dict(config, architecture=default_architecture(config))
    cfg_dict["tie_word_embeddings"] = bool(config.beatmap_config.tie_word_embeddings)
    with open(out_dir / "config.json", "w") as f:
        json.dump(cfg_dict, f, indent=2, sort_keys=True)
    if processor is not None:
        processor.save_pretrained(out_dir)
    return out_dir


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
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model lies on {param.device}, inputs were asked on {device}")
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
