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
multiple of 64; with ``w8a8`` and ``w8a8_wo`` at D 768, F <= 1152) or raises:
warp-specialised ``wgmma`` kernels in every form; the forms with an int8 Wo
run the Wi product once more to find each row's absmax of ``gelu(a) * b``
first (``w8a8_wo`` alone at D 768: an absmax pass, then a quantising pass per
384-column half of the output). The source note on the kernel's design and
bound is in ``csrc/fused_ffn.cu``. fp32 activations (a model run in fp32)
launch the fp32 kernel of ``csrc/fused_ffn_f32.cu`` in every form (register-tiled
fp32 FMA on the CUDA cores, int8 ``mma.sync`` with exact int32 sums for the
int8 products; no TF32; any F that is a multiple of 64), counted as
``fused_ln_ffn_f32``, ``fused_ln_ffn_q_f32``, ``fused_ln_ffn_q_wo_f32`` and
``fused_ln_ffn_wo_f32``; its
weights are fp32 where they are not int8. It passes ``gelu(a) * b`` through a
device scratch that the wrapper allocates (:func:`f32_scratch_bytes`: one slot
of 128 rows per block of the kernel's persistent grid).

The W8A8 extraction options follow the TPU kernel: ``w8a8`` quantises the
fp32 LN output per row to int8 and multiplies by an int8 Wi (per output
channel), ``h = bf16(acc * sa * swi)``; ``w8a8_wo`` quantises the fp32
``gelu(a) * b`` row over all F columns and multiplies by an int8 Wo. The
quantised weights may be passed in (``wi_q``/``wo_q`` = (codes, scales) from
:func:`~cm3p_torch.ops.quant.quantize_weight_int8`, made once per model) or
are made from ``wi``/``wo`` on the fly. Each form counts its launches on its
own counter: ``w8a8`` on :func:`fused_ln_ffn_q`'s, ``w8a8 + w8a8_wo`` on
``fused_ln_ffn_q_wo``, ``w8a8_wo`` alone on ``fused_ln_ffn_wo``, the bf16 form
on :func:`fused_ln_ffn`'s.

The kernel is the no-grad path. Under autograd :class:`LnFfnFunction` runs the
JAX package's training composition (``_ln_ffn_fwd``: LN in fp32, matmuls in
the activation dtype, saving ``x`` and the pre-split ``h``) and its analytic
backward (``_ln_ffn_bwd``), with these rounding points: gelu(a) * b and the
elementwise backward in fp32, ``dh`` and every matmul input in the activation
dtype, the weight gradients of the two products accumulated and returned in
fp32 (``preferred_element_type=float32`` in ``_ln_ffn_bwd``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .quant import int8_matmul, quant_rows_int8, quantize_weight_int8

_P = ctypes.c_void_p
_SIGNATURES = {
    "cm3p_fused_ln_ffn": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "cm3p_fused_ln_ffn_q": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.c_int, ctypes.c_int, _P],
}
_LL = ctypes.c_longlong
_F32_SIGNATURES = {
    "cm3p_fused_ln_ffn_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, ctypes.c_int, ctypes.c_int,
                              ctypes.c_float, ctypes.c_int, ctypes.c_int, _P],
    "cm3p_fused_ln_ffn_f32_scratch_bytes": [_LL, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(_LL)],
}
KERNEL_WIDTHS = (256, 512, 768)
ACTIVATION_DTYPES = (torch.bfloat16, torch.float32)  # bf16: csrc/fused_ffn.cu; fp32: csrc/fused_ffn_f32.cu


def f32_scratch_bytes(rows: int, d: int, f: int, w8a8: bool = False, w8a8_wo: bool = False) -> int:
    """The device scratch the fp32 kernel takes for ``rows`` rows in a form on the current card: 128 rows of
    ``gelu(a) * b`` in fp32 (and the y and g codes of the int8 forms) per block of its persistent grid, as the
    kernel's source reckons it; builds the kernel."""
    n = ctypes.c_longlong(0)
    err = _build.library("fused_ffn_f32", _F32_SIGNATURES).cm3p_fused_ln_ffn_f32_scratch_bytes(
        rows, d, f, int(w8a8), int(w8a8_wo), ctypes.byref(n))
    _build.check(err, "cm3p_fused_ln_ffn_f32_scratch_bytes")
    return n.value


def ffn_fusable(d_model: int, d_ff: int) -> bool:
    """The JAX package's shape rule for its fused MLP kernel (lane-aligned widths).

    The port's MLP half-block always goes through :func:`fused_ln_ffn`; this
    only decides whether the W8A8 options apply to a layer, since the JAX
    package falls back to its exact unfused MLP at other shapes.
    """
    return d_model % 128 == 0 and d_ff % 128 == 0


def layer_norm_f32(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` in fp32 (var = E[x^2] - E[x]^2); returns fp32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float())
    return y + bias.float() if bias is not None else y


def fused_ln_ffn_plain(x, scale, bias, wi, wo, eps: float, w8a8: bool = False, w8a8_wo: bool = False,
                       wi_q=None, wo_q=None):
    """Plain PyTorch version of :func:`fused_ln_ffn`, with the kernel's rounding points."""
    dt = x.dtype
    f = wo.shape[1]
    y = layer_norm_f32(x, scale, bias, eps)
    if w8a8:
        wiq, swi = wi_q if wi_q is not None else quantize_weight_int8(wi)
        q, sa = quant_rows_int8(y)
        h = (int8_matmul(q, wiq) * sa * swi).to(dt)
    else:
        h = (y.to(dt).float() @ wi.to(dt).float().t()).to(dt)
    gf = F.gelu(h[..., :f].float()) * h[..., f:].float()
    if w8a8_wo:
        woq, swo = wo_q if wo_q is not None else quantize_weight_int8(wo)
        gq, sg = quant_rows_int8(gf)
        o = (int8_matmul(gq, woq) * sg * swo).to(dt)
    else:
        o = (gf.to(dt).float() @ wo.to(dt).float().t()).to(dt)
    return x + o


def _check_common(x, scale, bias, d, f):
    if not x.is_cuda or x.dtype not in ACTIVATION_DTYPES or not x.is_contiguous():
        raise ValueError("x must be a contiguous bfloat16 or float32 CUDA tensor")
    if d not in KERNEL_WIDTHS or f % 64 or f <= 0:
        raise ValueError(f"the kernel takes D in {KERNEL_WIDTHS} and F a multiple of 64, got D={d}, F={f}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None and name == "bias":
            continue
        if t.dtype != torch.float32 or t.shape != (d,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 (D,) on x's device")


def _check_weight(name, w, shape, dtype, device):
    if w.device != device or w.dtype != dtype or not w.is_contiguous() or tuple(w.shape) != shape:
        raise ValueError(f"{name} must be contiguous {dtype} of shape {shape} on x's device, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")


def _check(x, scale, bias, wi, wo):
    d = x.shape[-1]
    f = wo.shape[-1] if wo.dim() == 2 else -1
    _check_common(x, scale, bias, d, f)
    _check_weight("wi", wi, (2 * f, d), x.dtype, x.device)
    _check_weight("wo", wo, (d, f), x.dtype, x.device)


def _launch_f32(x, scale, bias, wi, swi, wo, swo, eps, codes_y=None, codes_g=None):
    """The fp32 kernel (csrc/fused_ffn_f32.cu) in the form the weights' scales name (``swi`` / ``swo``
    given: that weight is int8 codes); shapes and types checked by the caller."""
    d, f = x.shape[-1], wo.shape[1]
    rows, w8a8, w8a8_wo = x.numel() // d, swi is not None, swo is not None
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        scratch = torch.empty(f32_scratch_bytes(rows, d, f, w8a8, w8a8_wo), dtype=torch.uint8, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _build.library("fused_ffn_f32", _F32_SIGNATURES).cm3p_fused_ln_ffn_f32(
        x.data_ptr(), scale.data_ptr(), ptr(bias), wi.data_ptr(), ptr(swi), wo.data_ptr(), ptr(swo), out.data_ptr(),
        ptr(codes_y), ptr(codes_g), scratch.data_ptr(), scratch.numel(), rows, d, f, float(eps), int(w8a8),
        int(w8a8_wo), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cm3p_fused_ln_ffn_f32")
    return out


def fused_ln_ffn(x, scale, bias, wi, wo, eps: float, w8a8: bool = False, w8a8_wo: bool = False,
                 wi_q=None, wo_q=None):
    """``x + Wo(gelu(a) * b)`` with ``[a | b] = Wi(LN(x))`` over (..., D).

    ``w8a8`` / ``w8a8_wo`` select the int8 forms (see the module docstring)."""
    if x.device.type == "cpu":
        return fused_ln_ffn_plain(x, scale, bias, wi, wo, eps, w8a8, w8a8_wo, wi_q, wo_q)
    if w8a8 or w8a8_wo:
        return fused_ln_ffn_q(x, scale, bias, wi, wo, eps, w8a8, w8a8_wo, wi_q, wo_q)
    _check(x, scale, bias, wi, wo)
    if x.dtype == torch.float32:
        out = _launch_f32(x, scale, bias, wi, None, wo, None, eps)
        fused_ln_ffn_f32.launches += 1
        return out
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


def fused_ln_ffn_q(x, scale, bias, wi, wo, eps: float, w8a8: bool = True, w8a8_wo: bool = False,
                   wi_q=None, wo_q=None, codes_y=None, codes_g=None):
    """The int8 forms of :func:`fused_ln_ffn` on a CUDA tensor (the kernel or an error).

    A weight whose option is on is passed to the kernel as int8 codes with its
    fp32 per-channel scales, the other as bf16. ``codes_y`` (int8, x's shape)
    and ``codes_g`` (int8, (..., F)) receive the activation codes the kernel
    used: for comparing its quantisers with the plain version's, not used by
    the model.
    """
    if not (w8a8 or w8a8_wo):
        raise ValueError("fused_ln_ffn_q needs w8a8 or w8a8_wo; the bf16 form is fused_ln_ffn")
    d = x.shape[-1]
    f = wo.shape[-1] if wo.dim() == 2 else -1
    _check_common(x, scale, bias, d, f)
    if w8a8 and w8a8_wo and d == 768 and f > 1152 and x.dtype == torch.bfloat16:
        raise ValueError(f"the w8a8 + w8a8_wo kernel keeps the codes of all F: F <= 1152 at D 768, got F={f}")
    swi = swo = None
    if w8a8:
        wi, swi = wi_q if wi_q is not None else quantize_weight_int8(wi)
        _check_weight("wi scales", swi, (2 * f,), torch.float32, x.device)
    if w8a8_wo:
        wo, swo = wo_q if wo_q is not None else quantize_weight_int8(wo)
        _check_weight("wo scales", swo, (d,), torch.float32, x.device)
    _check_weight("wi", wi, (2 * f, d), torch.int8 if w8a8 else x.dtype, x.device)
    _check_weight("wo", wo, (d, f), torch.int8 if w8a8_wo else x.dtype, x.device)
    for name, t, width in (("codes_y", codes_y, d), ("codes_g", codes_g, f)):
        if t is not None and (t.dtype != torch.int8 or t.shape != x.shape[:-1] + (width,) or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int8 (..., {width}) on x's device")
    if x.dtype == torch.float32:
        out = _launch_f32(x, scale, bias, wi, swi, wo, swo, eps, codes_y, codes_g)
        (fused_ln_ffn_q_f32 if not w8a8_wo else fused_ln_ffn_q_wo_f32 if w8a8 else fused_ln_ffn_wo_f32).launches += 1
        return out
    rows = x.numel() // d
    out = torch.empty_like(x)
    err = _build.library("fused_ffn", _SIGNATURES).cm3p_fused_ln_ffn_q(
        x.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
        wi.data_ptr(), None if swi is None else swi.data_ptr(),
        wo.data_ptr(), None if swo is None else swo.data_ptr(), out.data_ptr(),
        None if codes_y is None else codes_y.data_ptr(), None if codes_g is None else codes_g.data_ptr(),
        rows, d, f, float(eps), int(w8a8), int(w8a8_wo),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "cm3p_fused_ln_ffn_q")
    (fused_ln_ffn_q if not w8a8_wo else fused_ln_ffn_q_wo if w8a8 else fused_ln_ffn_wo).launches += 1
    return out


fused_ln_ffn_q.launches = 0  # the w8a8 form: an int8 Wi, a bf16 Wo


class FormLaunches:
    """Launch count of one further form of a kernel (``ops.KERNELS`` reads and resets it)."""

    launches = 0


fused_ln_ffn_q_wo = FormLaunches()  # fused_ln_ffn_q with an int8 Wo: it runs the Wi product twice
fused_ln_ffn_wo = FormLaunches()  # w8a8_wo alone: a bf16 Wi, an int8 Wo (the Wi product three times at D 768)
# the fp32 kernel's forms (csrc/fused_ffn_f32.cu): fp32 Wi and Wo, int8 Wi, both int8, int8 Wo alone
fused_ln_ffn_f32 = FormLaunches()
fused_ln_ffn_q_f32 = FormLaunches()
fused_ln_ffn_q_wo_f32 = FormLaunches()
fused_ln_ffn_wo_f32 = FormLaunches()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in fp32 (a weight gradient for an fp32 master); fp64 operands stay
    fp64.

    bf16 operands on CUDA go through ``torch.mm(..., out_dtype=float32)`` where
    this PyTorch has it (no upcast copies); otherwise the operands are upcast,
    which gives the same sums (a bf16 x bf16 product is exact in fp32).
    """
    if a.dtype in (torch.float32, torch.float64):
        return a @ b
    if a.is_cuda and hasattr(torch.ops.aten.mm, "dtype"):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _gelu_grad(u: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(u * _SQRT_HALF)) + u * torch.exp(-0.5 * u * u) * _INV_SQRT_2PI


class LnFfnFunction(torch.autograd.Function):
    """``x + Wo(gelu(a) * b)``, ``[a | b] = Wi(LN(x))`` with the JAX package's
    training forward and analytic backward (nn.Linear weight layout).

    With a model ``group`` (tensor parallelism) ``wi`` holds this rank's
    matched gate and up rows and ``wo`` the same columns: the partial
    ``g @ wo^T`` is summed over the group in fp32 and rounded once before
    ``x +``, and in the backward the partial ``dh @ wi`` is summed over the
    group in fp32 and rounded once before the LayerNorm's backward, so every
    rank gets the same ``dx``, ``dscale`` and ``dbias``."""

    @staticmethod
    def forward(ctx, x, scale, bias, wi, wo, eps, group=None):
        dt = x.dtype
        y = layer_norm_f32(x, scale, bias, eps).to(dt)
        h = y @ wi.to(dt).t()
        f = wo.shape[1]
        g = (F.gelu(h[..., :f].float()) * h[..., f:].float()).to(dt)
        ctx.save_for_backward(x, scale, bias, wi, wo, h)
        ctx.eps, ctx.group = eps, group
        if group is None:
            return x + g @ wo.to(dt).t()
        partial = _mm_f32(g.reshape(-1, f), wo.to(dt).t())
        torch.distributed.all_reduce(partial, group=group)
        return x + partial.to(dt).view_as(x)

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
        dwo = _mm_f32(g2.t(), gb.reshape(-1, f))
        dgb = (go @ wo.to(dt)).float()
        dh = torch.cat([dgb * gate * _gelu_grad(inp), dgb * a], dim=-1).to(dt)
        dwi = _mm_f32(dh.reshape(-1, 2 * f).t(), yb.reshape(-1, d))
        if ctx.group is None:
            dy = (dh @ wi.to(dt)).float()
        else:
            dy = _mm_f32(dh.reshape(-1, 2 * f), wi.to(dt)).view_as(go)
            torch.distributed.all_reduce(dy, group=ctx.group)
            dy = dy.to(dt).float()  # rounded where the unsharded product rounds
        rows = tuple(range(dy.dim() - 1))
        dscale = (dy * xhat).sum(dim=rows)
        dbias = dy.sum(dim=rows) if bias is not None else None
        dxhat = dy * scale
        dxf = r * (dxhat - dxhat.mean(dim=-1, keepdim=True) - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        dx = dxf.to(dt) + go
        return dx, dscale, dbias, dwi.to(wi.dtype), dwo.to(wo.dtype), None, None
