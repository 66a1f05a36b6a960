"""Symmetric int8 quantisers of the W8A8 extraction options, in plain PyTorch.

Counterparts of the JAX package's ``quantize_weight_int8`` and
``_quant_rows_int8`` (``ops/fused_ffn.py``). Weights use the nn.Linear layout
(out, in), so "per output channel" is per row here. Both round half to even
and divide by the scale (a true division, not a multiply by a reciprocal):
the CUDA kernels quantise activations with the same arithmetic, so kernel
and plain version produce the same codes up to the reduction order of the
LayerNorm in front of them.

:func:`int8_matmul` multiplies codes exactly. The sums reach 127^2 * K, which
passes 2^24 at K = 1152, so a float32 product would round; float64 holds every
partial sum exactly on the CPU and on CUDA (where no int32 matmul exists).
"""
from __future__ import annotations

import torch

_INV_127 = 1.0 / 127.0


def quantize_weight_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (int8 codes (out, in), fp32 scale (out,)).

    ``scale = amax / 127`` per output channel, ``codes = clip(round(w / scale))``.
    """
    wf = w.float()
    amax = wf.abs().amax(dim=1).clamp_min(1e-30)
    sw = amax / 127.0
    wq = torch.round(wf / sw[:, None]).clamp_(-127, 127).to(torch.int8)
    return wq.contiguous(), sw.contiguous()


def quant_rows_int8(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 activations (..., K) -> (int8 codes, fp32 row scale (..., 1)).

    ``scale = amax * (1 / 127)`` per row, ``codes = clip(round(y / scale))``.
    """
    if y.dtype != torch.float32:
        raise ValueError(f"quant_rows_int8 takes float32 activations, got {y.dtype}")
    amax = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    sa = amax * _INV_127
    q = torch.round(y / sa).clamp_(-127.0, 127.0).to(torch.int8)
    return q, sa


def int8_matmul(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact ``q @ wq.T`` of int8 codes, returned as the float32 rounding of the
    int32 sum (what ``int32 -> float32`` conversion gives)."""
    return (q.double() @ wq.double().t()).float()
