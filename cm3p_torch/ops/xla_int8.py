"""W8A8 product outside any kernel: the counterpart of the JAX package's ``ops/xla_int8.py``.

:func:`int8_dot` computes ``x @ W^T`` with both operands quantised to int8:
each row of ``x`` symmetric per row, each output channel of ``W`` symmetric
per channel, the codes multiplied with exact int32 sums, the sum converted to
fp32 and scaled by the row scale, then by the channel scale (the JAX order),
and cast to ``x``'s dtype. Weights use the nn.Linear layout (out, in), so the
JAX package's "per column of (D, N)" is per row here.

The quantisers are this module's own and not those of :mod:`.quant`: the
scale is ``max(amax / 127, 1e-12)``, a division floored on the scale, where
the fused kernels' quantisers take ``amax * (1 / 127)`` with ``amax`` floored
at 1e-30. The two give different codes on some values. The division is by a
127 on the tensor's device: PyTorch's CUDA division by a Python number
multiplies by its reciprocal, which moves codes against the CPU and the JAX
function.

The JAX package computes this product with ``lax.dot_general`` on int8
operands, outside any Pallas kernel; here it is ``torch._int_mm`` (cuBLASLt on
CUDA). On CUDA ``_int_mm`` takes more than 16 rows, and K and N multiples of
8: fewer rows are padded with zero rows to 17 and the result sliced; a K or
N that is not a multiple of 8 raises. No other product stands in where the
call fails.

Under autograd (grad enabled and an input that requires it) the exact
product ``F.linear(x, W.to(x.dtype))`` runs with its ordinary gradient, the
counterpart of the JAX ``custom_vjp`` forward: training math is unchanged.
:func:`int8_dot_plain` is the same function with the codes multiplied
exactly in float64 (tests and ``chip_smoke.py`` hold :func:`int8_dot` to it).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .quant import int8_matmul

_MIN_ROWS = 17  # _int_mm on CUDA needs more than 16 rows


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax / 127, 1e-12)`` with a true division on every device."""
    return torch.clamp_min(amax / torch.full((), 127.0, device=amax.device), 1e-12)


def quant_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last axis: (codes int8, fp32 scale (..., 1))."""
    xf = x.float()
    sa = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / sa).clamp_(-127.0, 127.0).to(torch.int8), sa


def quant_weight_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an (out, in) weight: (codes (out, in), fp32 scale (out,))."""
    wf = w.float()
    sw = _scale(wf.abs().amax(dim=1))
    return torch.round(wf / sw[:, None]).clamp_(-127.0, 127.0).to(torch.int8).contiguous(), sw.contiguous()


def int_mm(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``q @ wq^T`` of int8 codes (q (M, K), wq (N, K)) through ``torch._int_mm``."""
    m, k = q.shape
    n = wq.shape[0]
    if q.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"int8_dot on CUDA needs K and N multiples of 8 (torch._int_mm), got K {k}, N {n}")
    if m < _MIN_ROWS:
        q = torch.cat([q, q.new_zeros(_MIN_ROWS - m, k)])
    return torch._int_mm(q.contiguous(), wq.t())[:m]


def int8_dot(x: torch.Tensor, weight: torch.Tensor, w_q: Optional[tuple] = None) -> torch.Tensor:
    """``x @ weight^T`` in W8A8 (x (..., K), weight (N, K)), out in ``x.dtype``.

    ``w_q``: the weight's (codes, scales) from :func:`quant_weight_int8`, made once per model; made here
    when absent. Under autograd the exact product runs instead (module docstring).
    """
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return F.linear(x, weight.to(x.dtype))
    q, sa = quant_rows_int8(x)
    wq, sw = w_q if w_q is not None else quant_weight_int8(weight)
    acc = int_mm(q.reshape(-1, q.shape[-1]), wq).reshape(*q.shape[:-1], wq.shape[0])
    return (acc.float() * sa * sw).to(x.dtype)


def int8_dot_plain(x: torch.Tensor, weight: torch.Tensor, w_q: Optional[tuple] = None) -> torch.Tensor:
    """:func:`int8_dot` with the codes multiplied exactly in float64 (no grad route)."""
    q, sa = quant_rows_int8(x)
    wq, sw = w_q if w_q is not None else quant_weight_int8(weight)
    return (int8_matmul(q, wq) * sa * sw).to(x.dtype)
