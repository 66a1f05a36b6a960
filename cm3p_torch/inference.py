"""Inference entry points: load a beatmap model, embed a beatmap.

Counterpart of the JAX package's ``inference.py`` (``embed_beatmap``). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; asking for the
default device on a machine without a GPU raises.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from .configs import CM3PConfig
from .models import CM3PBeatmapModel
from .processing.processor import CM3PProcessor

_WEIGHT_MODULES = (nn.Linear, nn.Embedding, nn.Conv1d)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; pass device='cpu'")
    return device


def load_model(
    config: CM3PConfig,
    state_dict: Optional[dict] = None,
    device: Optional[Union[str, torch.device]] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> CM3PBeatmapModel:
    """Build the beatmap model, load ``state_dict`` (HF key names) and place it.

    Weights of Linear, Embedding and Conv1d layers take ``dtype``; LayerNorm
    params stay fp32 as in the JAX package. The model is in eval mode.
    """
    device = resolve_device(device)
    model = CM3PBeatmapModel(config)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.to(device)
    for module in model.modules():
        if isinstance(module, _WEIGHT_MODULES):
            module.to(dtype)
    return model.eval()


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
