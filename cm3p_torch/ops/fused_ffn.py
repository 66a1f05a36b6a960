"""Fused LayerNorm + GeGLU half-block: CUDA kernel and plain version.

Counterpart of the JAX package's ``ops/fused_ffn.py``. :func:`fused_ln_ffn` computes

    out = x + Wo( gelu_erf(a) * b ),   [a | b] = Wi( LN_fp32(x) )

with the TPU kernel's rounding points: LN in fp32, its output in the
activation dtype before Wi, ``h`` in the activation dtype after Wi,
``gelu(a) * b`` in fp32 then the activation dtype before Wo, fp32
accumulation throughout. Weights use the nn.Linear layout: ``wi`` is
(2F, D) and ``wo`` is (D, F).

On a CPU tensor the wrapper runs :func:`fused_ln_ffn_plain`; on a CUDA
tensor it launches ``csrc/fused_ffn.cu`` (bf16, D in {256, 512, 768}, F a
multiple of 64) or raises. The source note on the kernel's design and bound
is in ``csrc/fused_ffn.cu``.

The kernel is the no-grad path. Under autograd :class:`LnFfnFunction` runs the
JAX package's training composition (``_ln_ffn_fwd``: LN in fp32, matmuls in
the activation dtype, saving ``x`` and the pre-split ``h``) and its analytic
backward (``_ln_ffn_bwd``), with these rounding points: gelu(a) * b and the
elementwise backward in fp32, ``dh`` and every matmul input in the activation
dtype, the weight gradients of the two products in the activation dtype (the
JAX package accumulates them to fp32; the difference is one rounding of a
gradient that Muon orthogonalises in bf16).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_P = ctypes.c_void_p
_SIGNATURES = {
    "cm3p_fused_ln_ffn": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
}
KERNEL_WIDTHS = (256, 512, 768)


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` in fp32 (var = E[x^2] - E[x]^2); returns fp32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float())
    return y + bias.float() if bias is not None else y


def fused_ln_ffn_plain(x, scale, bias, wi, wo, eps: float):
    """Plain PyTorch version of :func:`fused_ln_ffn`, with the kernel's rounding points."""
    dt = x.dtype
    y = layer_norm_f32(x, scale, bias, eps).to(dt)
    h = (y.float() @ wi.to(dt).float().t()).to(dt)
    f = wo.shape[1]
    g = (F.gelu(h[..., :f].float()) * h[..., f:].float()).to(dt)
    o = (g.float() @ wo.to(dt).float().t()).to(dt)
    return x + o


def _check(x, scale, bias, wi, wo):
    d = x.shape[-1]
    f = wo.shape[-1] if wo.dim() == 2 else -1
    for name, t in (("x", x), ("wi", wi), ("wo", wo)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device")
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bfloat16")
    if d not in KERNEL_WIDTHS or f % 64 or f <= 0:
        raise ValueError(f"the kernel takes D in {KERNEL_WIDTHS} and F a multiple of 64, got D={d}, F={f}")
    if wi.shape != (2 * f, d) or wo.shape != (d, f):
        raise ValueError(f"wi must be (2F, D) and wo (D, F), got {tuple(wi.shape)}, {tuple(wo.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None and name == "bias":
            continue
        if t.dtype != torch.float32 or t.shape != (d,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 (D,) on x's device")


def fused_ln_ffn(x, scale, bias, wi, wo, eps: float):
    """``x + Wo(gelu(a) * b)`` with ``[a | b] = Wi(LN(x))`` over (..., D)."""
    if x.device.type == "cpu":
        return fused_ln_ffn_plain(x, scale, bias, wi, wo, eps)
    _check(x, scale, bias, wi, wo)
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    err = _build.library("fused_ffn", _SIGNATURES).cm3p_fused_ln_ffn(
        x.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
        wi.data_ptr(), wo.data_ptr(), out.data_ptr(), rows, d, wo.shape[1], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cm3p_fused_ln_ffn")
    fused_ln_ffn.launches += 1
    return out


fused_ln_ffn.launches = 0


_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _gelu_grad(u: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(u * _SQRT_HALF)) + u * torch.exp(-0.5 * u * u) * _INV_SQRT_2PI


class LnFfnFunction(torch.autograd.Function):
    """``x + Wo(gelu(a) * b)``, ``[a | b] = Wi(LN(x))`` with the JAX package's
    training forward and analytic backward (nn.Linear weight layout)."""

    @staticmethod
    def forward(ctx, x, scale, bias, wi, wo, eps):
        dt = x.dtype
        y = layer_norm_f32(x, scale, bias, eps).to(dt)
        h = y @ wi.to(dt).t()
        f = wo.shape[1]
        g = (F.gelu(h[..., :f].float()) * h[..., f:].float()).to(dt)
        ctx.save_for_backward(x, scale, bias, wi, wo, h)
        ctx.eps = eps
        return x + g @ wo.to(dt).t()

    @staticmethod
    def backward(ctx, go):
        x, scale, bias, wi, wo, h = ctx.saved_tensors
        dt = x.dtype
        d, f = x.shape[-1], wo.shape[1]
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        r = torch.rsqrt(var + ctx.eps)
        xhat = (xf - mu) * r
        yb = xhat * scale
        yb = (yb + bias if bias is not None else yb).to(dt)
        inp, gate = h[..., :f].float(), h[..., f:].float()
        a = F.gelu(inp)
        gb = (a * gate).to(dt)
        go = go.contiguous()
        g2 = go.reshape(-1, d)
        dwo = g2.t() @ gb.reshape(-1, f)
        dgb = (go @ wo.to(dt)).float()
        dh = torch.cat([dgb * gate * _gelu_grad(inp), dgb * a], dim=-1).to(dt)
        dwi = dh.reshape(-1, 2 * f).t() @ yb.reshape(-1, d)
        dy = (dh @ wi.to(dt)).float()
        rows = tuple(range(dy.dim() - 1))
        dscale = (dy * xhat).sum(dim=rows)
        dbias = dy.sum(dim=rows) if bias is not None else None
        dxhat = dy * scale
        dxf = r * (dxhat - dxhat.mean(dim=-1, keepdim=True) - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        dx = dxf.to(dt) + go
        return dx, dscale, dbias, dwi.to(wi.dtype), dwo.to(wo.dtype), None
