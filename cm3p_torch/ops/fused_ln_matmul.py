"""Fused LayerNorm -> matmul (+ residual): CUDA kernels and plain versions.

Counterpart of the JAX package's ``ops/fused_ln_matmul.py``. Two functions, each
one kernel in ``csrc/fused_ln_matmul.cu``:

* :func:`fused_ln_matmul` - ``[residual +] [LN(x)] @ W^T`` in the activation
  dtype: LN in fp32 (flax formula) then cast, fp32 accumulation, the product
  cast to the activation dtype, *then* the residual added (and rounded once
  more). With ``scale`` it is the attention pre-norm fused into the QKV
  projection; without ``scale`` and with ``residual`` it is the attention
  out-projection with its residual add.
* :func:`fused_ln_matmul_q` - the W8A8 form: the fp32 LN output (or ``x`` as
  fp32 when there is no LN) is quantised per row to int8 over all D columns,
  multiplied by an int8 weight (per output channel) with int32 accumulation,
  and dequantised as ``float(acc) * sa * sw[n]`` in that order, cast, then the
  residual added.

Weights use the nn.Linear layout (N, D). On a CPU tensor the wrappers run the
plain versions; on a CUDA tensor they launch the kernel (D in {256, 512, 768},
N a multiple of 128) or raise: bf16 activations the bf16 kernels, fp32
activations the fp32 kernels of ``csrc/fused_ln_matmul_f32.cu`` (register-tiled
fp32 FMA on the CUDA cores; the int8 form on int8 ``mma.sync`` with exact int32
sums, its activation codes resident per 128-row tile; no TF32), each fp32 form counted under
its own name (``fused_ln_matmul_f32``, ``fused_ln_matmul_wo_f32``,
``fused_ln_matmul_q_f32``, ``fused_ln_matmul_q_wo_f32``). The weight, the
residual and the output take the activation dtype. These are no-grad ops:
under autograd the encoder takes the unfused modules, whose autodiff equals
the analytic gradient the JAX package attaches to its fused ops.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .fused_ffn import KERNEL_WIDTHS, FormLaunches, layer_norm_f32
from .quant import int8_matmul, quant_rows_int8, quantize_weight_int8

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cm3p_ln_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P],
    "cm3p_ln_matmul_q": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _P],
}
_LL = ctypes.c_longlong
_F32_SIGNATURES = {
    "cm3p_ln_matmul_f32": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, ctypes.c_float, _I, _P],
    "cm3p_ln_matmul_q_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, ctypes.c_float, _I, _P],
}
ACTIVATION_DTYPES = (torch.bfloat16, torch.float32)  # bf16: csrc/fused_ln_matmul.cu; fp32: its _f32 form
COLUMN_TILE = 128


fused_ln_matmul_wo = FormLaunches()  # fused_ln_matmul without LN: the out-projection with its residual
fused_ln_matmul_q_wo = FormLaunches()  # the same form of fused_ln_matmul_q
# the fp32 kernels' forms (csrc/fused_ln_matmul_f32.cu)
fused_ln_matmul_f32 = FormLaunches()
fused_ln_matmul_wo_f32 = FormLaunches()
fused_ln_matmul_q_f32 = FormLaunches()
fused_ln_matmul_q_wo_f32 = FormLaunches()


def lnmm_fusable(d_in: int, d_out: int) -> bool:
    """Shape-only fusability, as the JAX package's: both widths multiples of 128.

    The encoder asks this before it routes a projection here. On CUDA the
    kernels additionally take only D in ``KERNEL_WIDTHS`` and bf16 or fp32, and
    raise on anything else.
    """
    return d_in % 128 == 0 and d_out % 128 == 0


def fused_ln_matmul_plain(x, w, scale=None, bias=None, residual=None, eps: float = 1e-5):
    """Plain PyTorch version of :func:`fused_ln_matmul` (``reference_ln_matmul`` plus
    the kernel's rounding points: fp32 accumulate, cast, then the residual)."""
    dt = x.dtype
    y = layer_norm_f32(x, scale, bias, eps).to(dt) if scale is not None else x
    out = (y.float() @ w.to(dt).float().t()).to(dt)
    return residual + out if residual is not None else out


def fused_ln_matmul_q_plain(x, w, scale=None, bias=None, residual=None, eps: float = 1e-5, w_q=None):
    """Plain PyTorch version of :func:`fused_ln_matmul_q` (``reference_ln_matmul_q``
    plus the residual). ``w_q`` = (codes, scales) skips quantising ``w``."""
    dt = x.dtype
    y = layer_norm_f32(x, scale, bias, eps) if scale is not None else x.float()
    wq, sw = w_q if w_q is not None else quantize_weight_int8(w)
    q, sa = quant_rows_int8(y)
    out = (int8_matmul(q, wq) * sa * sw).to(dt)
    return residual + out if residual is not None else out


def _check(x, w, w_dtype, scale, bias, residual, sw=None):
    d = x.shape[-1]
    n = w.shape[0]
    if not x.is_cuda or x.dtype not in ACTIVATION_DTYPES or not x.is_contiguous():
        raise ValueError("x must be a contiguous bfloat16 or float32 CUDA tensor")
    if d not in KERNEL_WIDTHS or n % COLUMN_TILE or n <= 0:
        raise ValueError(
            f"the kernel takes D in {KERNEL_WIDTHS} and N a multiple of {COLUMN_TILE}, got D={d}, N={n}")
    if w.device != x.device or w.dtype != w_dtype or not w.is_contiguous() or tuple(w.shape) != (n, d):
        raise ValueError(f"w must be contiguous {w_dtype} (N, D) on x's device, got {w.dtype} {tuple(w.shape)}")
    if bias is not None and scale is None:
        raise ValueError("an LN bias needs the LN scale")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (d,) or not t.is_contiguous()
                              or t.device != x.device):
            raise ValueError(f"{name} must be contiguous float32 (D,) on x's device")
    if residual is not None and (
        residual.device != x.device or residual.dtype != x.dtype or not residual.is_contiguous()
        or residual.shape != x.shape[:-1] + (n,)
    ):
        raise ValueError("residual must be contiguous, of x's dtype and of the output's shape on x's device")
    if sw is not None and (sw.device != x.device or sw.dtype != torch.float32 or not sw.is_contiguous()
                           or sw.shape != (n,)):
        raise ValueError("the weight scales must be contiguous float32 (N,) on x's device")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def fused_ln_matmul(x, w, scale=None, bias=None, residual=None, eps: float = 1e-5):
    """``[residual +] [LN(x)] @ w.T`` over (..., D) -> (..., N); LN skipped when ``scale`` is None."""
    if x.device.type == "cpu":
        return fused_ln_matmul_plain(x, w, scale, bias, residual, eps)
    _check(x, w, x.dtype, scale, bias, residual)
    d, n = x.shape[-1], w.shape[0]
    rows = x.numel() // d
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        err = _build.library("fused_ln_matmul_f32", _F32_SIGNATURES).cm3p_ln_matmul_f32(
            x.data_ptr(), _ptr(scale), _ptr(bias), w.data_ptr(), _ptr(residual), out.data_ptr(),
            rows, d, n, float(eps), int(scale is not None), torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(err, "cm3p_ln_matmul_f32")
        (fused_ln_matmul_f32 if scale is not None else fused_ln_matmul_wo_f32).launches += 1
        return out
    err = _build.library("fused_ln_matmul", _SIGNATURES).cm3p_ln_matmul(
        x.data_ptr(), _ptr(scale), _ptr(bias), w.data_ptr(), _ptr(residual), out.data_ptr(),
        rows, d, n, float(eps), int(scale is not None), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cm3p_ln_matmul")
    (fused_ln_matmul if scale is not None else fused_ln_matmul_wo).launches += 1
    return out


fused_ln_matmul.launches = 0


def fused_ln_matmul_q(x, w, scale=None, bias=None, residual=None, eps: float = 1e-5, w_q=None,
                      codes_out: Optional[torch.Tensor] = None):
    """The W8A8 form of :func:`fused_ln_matmul`.

    ``w_q`` = (int8 codes (N, D), fp32 scales (N,)) made once by the caller;
    otherwise ``w`` is quantised here. ``codes_out`` (int8, x's shape) receives
    the activation codes the kernel used: for comparing the quantiser with
    the plain version, not used by the model.
    """
    if x.device.type == "cpu":
        if codes_out is not None:
            raise ValueError("codes_out is an output of the CUDA kernel")
        return fused_ln_matmul_q_plain(x, w, scale, bias, residual, eps, w_q)
    wq, sw = w_q if w_q is not None else quantize_weight_int8(w)
    _check(x, wq, torch.int8, scale, bias, residual, sw)
    if codes_out is not None and (codes_out.dtype != torch.int8 or codes_out.shape != x.shape
                                  or codes_out.device != x.device or not codes_out.is_contiguous()):
        raise ValueError("codes_out must be contiguous int8 of x's shape on x's device")
    d, n = x.shape[-1], wq.shape[0]
    rows = x.numel() // d
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        err = _build.library("fused_ln_matmul_f32", _F32_SIGNATURES).cm3p_ln_matmul_q_f32(
            x.data_ptr(), _ptr(scale), _ptr(bias), wq.data_ptr(), sw.data_ptr(), _ptr(residual), out.data_ptr(),
            _ptr(codes_out), rows, d, n, float(eps), int(scale is not None),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(err, "cm3p_ln_matmul_q_f32")
        (fused_ln_matmul_q_f32 if scale is not None else fused_ln_matmul_q_wo_f32).launches += 1
        return out
    err = _build.library("fused_ln_matmul", _SIGNATURES).cm3p_ln_matmul_q(
        x.data_ptr(), _ptr(scale), _ptr(bias), wq.data_ptr(), sw.data_ptr(), _ptr(residual), out.data_ptr(),
        _ptr(codes_out), rows, d, n, float(eps), int(scale is not None),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cm3p_ln_matmul_q")
    (fused_ln_matmul_q if scale is not None else fused_ln_matmul_q_wo).launches += 1
    return out


fused_ln_matmul_q.launches = 0
