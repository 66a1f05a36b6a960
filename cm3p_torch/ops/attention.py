"""Window (local) and segment (global) attention: CUDA kernels and plain versions.

Counterpart of the JAX package's ``ops/flash_attention.py`` and
``ops/flash_attention_bwd.py``. Two mask types, both over head-minor
(B, L, H, D) tensors, the layout the fused Wqkv output reshapes to:

* window: query i sees key j iff |i - j| <= window, kseg[j] > 0 and
  qseg[i] == kseg[j]. :func:`window_attention` replaces
  ``_window_fused_kernel``; :func:`window_attention_dq` and
  :func:`window_attention_dkv` replace ``_dq_fused_kernel`` and
  ``_dkv_fused_kernel``;
* segment: the same without the window, visiting only the tiles whose
  segment interval meets the tile's (:func:`segment_tile_ranges`, the work of
  ``_block_ranges`` and ``qb_index``; on the card :func:`key_tile_ranges`
  forms them in one kernel launch). :func:`segment_attention` replaces
  ``_seg_unrolled_kernel``; :func:`segment_attention_dq` and
  :func:`segment_attention_dkv` replace ``_dq_unrolled_kernel`` and
  ``_dkv_unrolled_kernel``. :func:`segment_attention_rect` is the same
  kernel's rectangular form (``_seg_unrolled_fwd``'s lq != lk): a shard of Lq
  queries over Lk keys, the keys gathered by sequence parallelism, with a key
  mask as the key segments; forward only, no rope, no window, no lse.

The forwards rotate raw q/k with rope (rotate-half, arange positions) when
``rope_theta`` is given (on the card k in one pass into a scratch buffer, each
Q tile inside the kernel), use the softmax scale 1/sqrt(D) with fp32 scores,
write 0 for a query that sees no key and, with ``return_lse``, also return the
base-2 log-sum-exp (B, H, L) fp32 the backward needs (log2(1e-30) for a query
that sees no key, as the TPU kernels write). The backward recomputes
p = exp2(s * log2(e) / sqrt(D) - lse) and gives dq, dk, dv; delta =
rowsum(dout * out) is formed here in fp32.

The out-projection epilogue (the JAX package's ``CM3P_FUSED_WO`` and
``CM3P_FUSED_WO_Q`` gates, no-grad only): :func:`window_attention_wo`,
:func:`segment_attention_wo` and their int8 forms ``..._wo_q`` return
``residual + o @ Wo^T`` with the rounding points of ``fused_ln_matmul`` (o in
the activation dtype, fp32 accumulation, cast, then the residual), or of
``fused_ln_matmul_q`` (o quantised per row over all H*D columns, int8 Wo per
output channel); o never reaches device memory (``csrc/attention_wo.cu``).
Their plain versions compose the plain attention with those plain products.
:func:`wo_fusable` is the JAX package's rule for where its kernels apply the
epilogue; :func:`wo_shape_ok` is its shape part without the TPU's VMEM limit.

:func:`attention` is the dispatch of ``flash_attention()``: it turns a key
mask and segment ids into (qseg, kseg). Without autograd it runs the forward
kernel (rope in the kernel for arange positions), with ``residual`` its
epilogue form. Under autograd it follows the JAX training route, and
:class:`AttentionFunction` ties the forward with lse to the backward kernels.
Where :func:`rope_in_kernels` admits the layer (the JAX package's
``CM3P_TRAIN_FUSED_ROPE`` route) q and k stay raw: the forward kernel rotates
them and the backward kernels run their rope forms
(``window_attention_dq(..., rope_theta=...)`` and the other three, counted as
``*_rope``), which read q and k rotated once by :func:`backward_rope_pass`
(one pass per backward call feeds both kernels) and counter-rotate dq/dk;
:func:`attention_bwd_rope_plain` is their oracle. Elsewhere (positions
other than arange) and on the plain route rope is applied outside the kernels,
and autograd of that rope is the counter-rotation of dq/dk.

The window kernels take any window: the TPU's streaming route for windows
wider than 128 (``_fa_kernel`` and the backward's ``_dq_kernel`` /
``_dkv_kernel``) is the same function, and runs here on the same kernels.

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA tensor it
launches the kernel (``csrc/attention.cu``, ``csrc/attention_bwd.cu``) or
raises. The plain versions are also the oracle the kernels are held against on
the card. The source notes on the kernels' design and bound are in the ``.cu``
files. The epilogue kernels take H*D in ``WO_KERNEL_WIDTHS`` and an output
width that is a multiple of 128.

fp32 (a model run in fp32, the JAX package's ``--dtype float32``): the
forwards launch ``csrc/attention_f32.cu`` (register-tiled fp32 FMA on the CUDA
cores, 4 x 8 sums a thread in both products, no TF32; with rope the segment
forms first rotate k once by :func:`rope_k_f32`, the window form rotates each
key tile it stages), counted as ``window_attention_f32``,
``segment_attention_f32`` and ``segment_attention_rect_f32``; it writes no
lse, so an fp32 forward under autograd on CUDA raises (the port trains in
bf16, as the JAX trainer does, and has no fp32 backward kernel). The
epilogue forms at fp32 run the fp32 attention kernel, then the fp32 LN-matmul
kernel's residual form (``res + o @ Wo^T``, int8 with ``wo_q``): the unfused
route the bf16 epilogue replaces, and the same function.

The bounds-checked build (:func:`checked_kernels`): inside that context the
bf16 forward, backward, rope and tile-range wrappers load
``csrc/attention.cu`` and ``csrc/attention_bwd.cu`` built with
``ops._build.CHECKED_FLAGS`` (``csrc/bounds.cuh``), fill every output and
scratch buffer a launch writes with 0xFF bytes first (NaN in bf16 and fp32,
-1 in int32), pass the extents of the tensors a launch addresses, and after
the launch synchronise and raise on the kernel's fault record or on an output
element still holding the fill. Nothing else selects that build.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build
from .fused_ffn import FormLaunches
from .fused_ln_matmul import (
    COLUMN_TILE,
    fused_ln_matmul,
    fused_ln_matmul_plain,
    fused_ln_matmul_q,
    fused_ln_matmul_q_plain,
)

TILE = 64  # query and key tile of csrc/attention.cu and csrc/attention_bwd.cu
HEAD_DIM = 64  # the kernels' head dim
LOG2E = 1.4426950408889634
EMPTY_LSE = math.log2(1e-30)  # lse of a query that sees no key
WO_KERNEL_WIDTHS = (256, 512, 768)  # H * D that csrc/attention_wo.cu takes
WO_GLOBAL_MAX_LEN = 2048  # the JAX package's VMEM limit on its global epilogue kernel

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "cm3p_window_attention": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _P],
    "cm3p_segment_attention": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _P],
    "cm3p_key_tile_ranges": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}
_F32_SIGNATURES = {
    "cm3p_window_attention_f32": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cm3p_segment_attention_f32": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _P],
    "cm3p_rope_k_f32": [_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P],
}
ACTIVATION_DTYPES = (torch.bfloat16, torch.float32)  # bf16: csrc/attention.cu; fp32: csrc/attention_f32.cu
_WO_SIGNATURES = {
    "cm3p_attention_wo": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P],
}
_BWD_ARGTYPES = [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _P]
_BWD_SIGNATURES = {
    **{name: _BWD_ARGTYPES for name in (
        "cm3p_window_attention_dq", "cm3p_window_attention_dkv",
        "cm3p_segment_attention_dq", "cm3p_segment_attention_dkv",
    )},
    "cm3p_attention_rope_qk": [_P, _P, _LL, _LL, _LL, _LL, _P, _P, _P, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=64)
def rope_tables(length: int, head_dim: int, theta: float, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (L, head_dim // 2) cos and sin of ``position * theta**(-2i/head_dim)``."""
    return _rope_at(torch.arange(length), head_dim, theta, device)


def _rope_at(positions: torch.Tensor, head_dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    freqs = positions.to(torch.float32)[..., None] * inv_freq.to(positions.device)
    return freqs.cos().to(device).contiguous(), freqs.sin().to(device).contiguous()


def apply_rope(x: torch.Tensor, theta: float, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate-half rope over (B, L, H, D); fp32 math, result in x's dtype.

    ``positions`` (L,) or (B, L) int; None means arange(L).
    """
    _, length, _, d = x.shape
    if positions is None:
        cos, sin = rope_tables(length, d, float(theta), str(x.device))
    else:
        cos, sin = _rope_at(positions, d, float(theta), x.device)
    cos, sin = cos[..., None, :], sin[..., None, :]  # (L, 1, D/2) or (B, L, 1, D/2)
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _visible(qseg, kseg, window, r0, r1, near):
    ks = kseg[r0:r1, None, None, :]
    mask = (ks > 0) & (qseg[r0:r1, None, :, None] == ks)
    return mask & near if near is not None else mask


def _near(length, window, device):
    if window is None:
        return None
    idx = torch.arange(length, device=device)
    return (idx[:, None] - idx[None, :]).abs() <= window


def _row_step(heads: int, length: int, copies: int = 1, key_length: Optional[int] = None) -> int:
    # bound each (rows, H, Lq, Lk) fp32 score block to ~1 GiB / copies
    return max(1, (1 << 30) // (copies * heads * length * (key_length or length) * 4))


def _attention_plain(q, k, v, qseg, kseg, window: Optional[int], rope_theta: Optional[float], return_lse: bool):
    b, length, heads, d = q.shape
    if rope_theta is not None:
        q, k = apply_rope(q, rope_theta), apply_rope(k, rope_theta)
    out = torch.empty(b, length, heads, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, heads, length, dtype=torch.float32, device=q.device) if return_lse else None
    near = _near(length, window, q.device)
    step = _row_step(heads, length, key_length=k.shape[1])
    for r0 in range(0, b, step):
        r1 = min(b, r0 + step)
        qf = q[r0:r1].float().transpose(1, 2)
        kf = k[r0:r1].float().transpose(1, 2)
        vf = v[r0:r1].float().transpose(1, 2)
        s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        s = s.masked_fill(~_visible(qseg, kseg, window, r0, r1, near), float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        o = (p.to(q.dtype).float() @ vf) / torch.where(denom > 0, denom, torch.ones_like(denom))
        out[r0:r1] = o.transpose(1, 2).to(q.dtype)
        if return_lse:
            lse2 = (m + torch.log(denom)) * LOG2E
            lse[r0:r1] = torch.where(denom > 0, lse2, torch.full_like(lse2, EMPTY_LSE))[..., 0]
    return (out, lse) if return_lse else out


def window_attention_plain(q, k, v, qseg, kseg, window: int, rope_theta: Optional[float] = None,
                           return_lse: bool = False):
    """Plain PyTorch version of :func:`window_attention` (dense masked scores)."""
    return _attention_plain(q, k, v, qseg, kseg, window, rope_theta, return_lse)


def segment_attention_plain(q, k, v, qseg, kseg, rope_theta: Optional[float] = None, return_lse: bool = False):
    """Plain PyTorch version of :func:`segment_attention` (dense masked scores)."""
    return _attention_plain(q, k, v, qseg, kseg, None, rope_theta, return_lse)


def segment_attention_rect_plain(q, k, v, qseg, kseg):
    """Plain PyTorch version of :func:`segment_attention_rect` (dense masked
    (Lq, Lk) scores)."""
    return _attention_plain(q, k, v, qseg, kseg, None, None, False)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dout * out) per head in fp32: (B, H, L) contiguous."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _attention_bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, window: Optional[int], tables=None):
    """dq, dk, dv from the saved lse and delta, chunked over rows like the forward.

    Rounding points of the kernels: p and ds in the activation dtype before
    their products, fp32 accumulation, outputs in the activation dtype. With
    ``tables`` (the rope tables of rotated q/k) dq and dk are counter-rotated
    in fp32 before that cast, as the rope forms of the kernels do.
    """
    b, length, heads, d = q.shape
    dt = q.dtype
    scale = 1.0 / math.sqrt(d)
    dq, dk, dv = (torch.empty(b, length, heads, d, dtype=dt, device=q.device) for _ in range(3))
    near = _near(length, window, q.device)
    step = _row_step(heads, length, copies=4)
    for r0 in range(0, b, step):
        r1 = min(b, r0 + step)
        qf, kf, vf, dof = (x[r0:r1].float().transpose(1, 2) for x in (q, k, v, dout))
        s2 = (qf @ kf.transpose(-1, -2)) * (scale * LOG2E)
        vis = _visible(qseg, kseg, window, r0, r1, near)
        p = torch.where(vis, torch.exp2(s2 - lse[r0:r1, :, :, None]), torch.zeros_like(s2))
        del s2
        dv[r0:r1] = (p.to(dt).float().transpose(-1, -2) @ dof).transpose(1, 2).to(dt)
        ds = p * ((dof @ vf.transpose(-1, -2)) - delta[r0:r1, :, :, None])
        del p
        ds = ds.to(dt).float()
        dq_f = ((ds @ kf) * scale).transpose(1, 2)
        dk_f = ((ds.transpose(-1, -2) @ qf) * scale).transpose(1, 2)
        if tables is not None:
            dq_f, dk_f = _counter_rope(dq_f, *tables), _counter_rope(dk_f, *tables)
        dq[r0:r1] = dq_f.to(dt)
        dk[r0:r1] = dk_f.to(dt)
    return dq, dk, dv


def _counter_rope(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rope's transpose over fp32 (B, L, H, D): the gradient with respect to the
    raw rows from the one with respect to the rotated rows (g1 c + g2 s, g2 c - g1 s)."""
    half = g.shape[-1] // 2
    cos, sin = cos[:, None, :], sin[:, None, :]
    g1, g2 = g[..., :half], g[..., half:]
    return torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)


def attention_bwd_rope_plain(q, k, v, dout, lse, delta, qseg, kseg, window: Optional[int], rope_theta: float):
    """Plain backward for raw q/k that the forward rotated itself (rope in the
    kernels): rotate with :func:`apply_rope`, the plain backward, then rope's
    transpose on dq and dk. The oracle of the rope forms of the backward kernels."""
    tables = rope_tables(q.shape[1], q.shape[3], float(rope_theta), str(q.device))
    qr, kr = apply_rope(q, rope_theta), apply_rope(k, rope_theta)
    return _attention_bwd_plain(qr, kr, v, dout, lse, delta, qseg, kseg, window, tables)


def _bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, window, rope_theta):
    if rope_theta is None:
        return _attention_bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, window)
    return attention_bwd_rope_plain(q, k, v, dout, lse, delta, qseg, kseg, window, rope_theta)


def window_attention_bwd_plain(q, k, v, out, dout, lse, qseg, kseg, window: int):
    """Plain PyTorch backward of :func:`window_attention` (q, k already rotated)."""
    return _attention_bwd_plain(q, k, v, dout, lse, attention_delta(out, dout), qseg, kseg, window)


def segment_attention_bwd_plain(q, k, v, out, dout, lse, qseg, kseg):
    """Plain PyTorch backward of :func:`segment_attention` (q, k already rotated)."""
    return _attention_bwd_plain(q, k, v, dout, lse, attention_delta(out, dout), qseg, kseg, None)


def segment_tile_ranges(qseg: torch.Tensor, kseg: torch.Tensor, tile: int = TILE):
    """Per (row, query tile) [start, start + count) of the key tiles to visit.

    A key tile is needed when its positive-segment interval meets the query
    tile's; padding (segment 0) tiles never meet anything. Returns int32
    (B, nq) tensors ``start`` and ``count`` (count 0 = nothing to visit).
    ``qseg`` (B, Lq) and ``kseg`` (B, Lk) are padded and tiled apart, nq x nk
    tiles (Lq != Lk in the rectangular form).
    """
    b = qseg.shape[0]
    nq, nk = -(-qseg.shape[1] // tile), -(-kseg.shape[1] // tile)
    qs = torch.nn.functional.pad(qseg, (0, nq * tile - qseg.shape[1])).view(b, nq, tile)
    ks = torch.nn.functional.pad(kseg, (0, nk * tile - kseg.shape[1])).view(b, nk, tile)
    big = 2**30
    qmin = torch.where(qs > 0, qs, big).amin(-1)
    qmax = torch.where(qs > 0, qs, 0).amax(-1)
    kmin = torch.where(ks > 0, ks, big).amin(-1)
    kmax = torch.where(ks > 0, ks, 0).amax(-1)
    needed = (
        (qmin[:, :, None] <= kmax[:, None, :])
        & (kmin[:, None, :] <= qmax[:, :, None])
        & (qmax[:, :, None] > 0)
        & (kmax[:, None, :] > 0)
    ).to(torch.int32)
    any_needed = needed.amax(-1) > 0
    first = needed.argmax(-1)
    last = (nk - 1) - needed.flip(-1).argmax(-1)
    start = torch.where(any_needed, first, torch.zeros_like(first))
    count = torch.where(any_needed, last - first + 1, torch.zeros_like(first))
    return start.to(torch.int32).contiguous(), count.to(torch.int32).contiguous()


def key_tile_ranges(qseg: torch.Tensor, kseg: torch.Tensor):
    """:func:`segment_tile_ranges` for the kernels: on a CUDA tensor one launch of ``cm3p_key_tile_ranges``
    (part of the op that asks for the ranges, not counted apart), on the CPU the plain version. ``qseg`` and
    ``kseg`` are contiguous int32 (B, Lq) and (B, Lk)."""
    if qseg.device.type == "cpu":
        return segment_tile_ranges(qseg, kseg)
    for name, t in (("qseg", qseg), ("kseg", kseg)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous() or t.device != qseg.device:
            raise ValueError(f"{name} must be contiguous int32 (B, L) on one CUDA device with the other")
    if kseg.shape[0] != qseg.shape[0]:
        raise ValueError(f"qseg and kseg must have one batch size, got {qseg.shape[0]} and {kseg.shape[0]}")
    (b, lq), lk = qseg.shape, kseg.shape[1]
    nq, nk = -(-lq // TILE), -(-lk // TILE)
    # start, count, then the kernel's scratch: each row's tile bounds (low and high ends, query then key tiles)
    out = torch.empty(2 * b * nq + 2 * b * (nq + nk), dtype=torch.int32, device=qseg.device)
    start, count, bounds = out[:b * nq].view(b, nq), out[b * nq:2 * b * nq].view(b, nq), out[2 * b * nq:]
    _launch("attention", _SIGNATURES, "cm3p_key_tile_ranges",
            (qseg.data_ptr(), kseg.data_ptr(), start.data_ptr(), count.data_ptr(), bounds.data_ptr(), b, lq, lk,
             _stream(qseg)),
            dict(qseg=qseg, kseg=kseg), dict(start=start, count=count, range_scratch=bounds))
    return start, count


def _check(q, k, v, qseg, kseg, square: bool = True):
    """What the kernels take; ``square=False`` (the rectangular form) admits
    k, v (B, Lk, H, D) beside q (B, Lq, H, D), with kseg (B, Lk)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    same = q.shape == k.shape if square else (q.shape[0], q.shape[2:]) == (k.shape[0], k.shape[2:])
    if q.dim() != 4 or k.dim() != 4 or not same or k.shape != v.shape:
        shape = "one (B, L, H, D) shape" if square else "B, H and D, with k and v of one shape"
        raise ValueError(f"q, k, v must share {shape}, got {q.shape}, {k.shape}, {v.shape}")
    b, length, heads, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the kernels take head dim {HEAD_DIM}, got {d}")
    if q.dtype not in ACTIVATION_DTYPES:
        raise ValueError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
        st = t.stride()
        if st[3] != 1 or st[2] != d or st[1] % 8 or st[0] % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous 16-byte-aligned heads, got strides {st}")
    for name, s, n, dims in (("qseg", qseg, length, "(B, Lq)"), ("kseg", kseg, k.shape[1], "(B, Lk)")):
        if s.dtype != torch.int32 or s.shape != (b, n) or not s.is_contiguous() or s.device != q.device:
            raise ValueError(f"{name} must be contiguous int32 {dims} on q's device")


def _check_bwd(q, k, v, dout, lse, delta, qseg, kseg):
    _check(q, k, v, qseg, kseg)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the backward kernels take bfloat16 (training runs in bf16), got {q.dtype}")
    b, length, heads, _ = q.shape
    if dout.shape != q.shape or dout.dtype != torch.bfloat16 or not dout.is_contiguous() or dout.device != q.device:
        raise ValueError("dout must be contiguous bfloat16 of q's shape on q's device")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, heads, length) or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 (B, H, L) on q's device")


def _qkv_args(q, k, v):
    strides = (q.stride(0), k.stride(0), v.stride(0), q.stride(1), k.stride(1), v.stride(1))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides)


def _common_args(q, k, v, qseg, kseg, rope_theta):
    return (*_qkv_args(q, k, v), qseg.data_ptr(), kseg.data_ptr(), *_tables(q, rope_theta))


def _table_tensors(q, rope_theta) -> dict:
    """The rope tables for (B, L, H, D) q by their ``BOUNDS_TENSORS`` names (none without rope)."""
    if rope_theta is None:
        return {}
    cos, sin = rope_tables(q.shape[1], q.shape[3], float(rope_theta), str(q.device))
    return dict(cos=cos, sin=sin)


def _tables(q, rope_theta):
    """The rope tables' pointers for (B, L, H, D) q, or two nulls without rope."""
    tables = _table_tensors(q, rope_theta)
    return (tables["cos"].data_ptr(), tables["sin"].data_ptr()) if tables else (None, None)


def _forward_outputs(out, lse, rot) -> dict:
    """What a bf16 forward launch writes whole: out, lse when asked for, and the rotated k with rope."""
    return {name: t for name, t in (("out", out), ("lse", lse), ("rot", rot)) if t is not None}


# ------------------------------------------------------------ the bounds-checked build

_checked = False  # set by checked_kernels(): the wrappers below load the checked build
# the names of csrc/bounds.cuh's enums, in their order: what a check names (tensors, then ranges) and the kernels
BOUNDS_TENSORS = ("q", "k", "v", "dout", "qseg", "kseg", "cos", "sin", "start", "count", "range_scratch", "out",
                  "lse", "delta", "dq", "dk", "dv", "rot")
BOUNDS_RANGES = ("tile", "head", "row", "stage")
BOUNDS_KERNELS = (
    None, "key_tile_ranges_kernel (attention.cu)", "rope_k_kernel (attention.cu)",
    "sm90_attn::attention_kernel<true> (attention.cu)", "sm90_attn::attention_kernel<false> (attention.cu)",
    "sm90_bwd::rope_qk_kernel (attention_bwd.cu)", "sm90_bwd::attention_dq_kernel<true> (attention_bwd.cu)",
    "sm90_bwd::attention_dq_kernel<false> (attention_bwd.cu)", "sm90_bwd::attention_dkv_kernel<true> (attention_bwd.cu)",
    "sm90_bwd::attention_dkv_kernel<false> (attention_bwd.cu)",
)
_BOUNDS_SIGNATURES = {"cm3p_bounds_arm": [_P, _P], "cm3p_bounds_fault": [_P]}


class BoundsFault(ctypes.Structure):
    """csrc/bounds.cuh's fault record: the first checked access of a launch that failed (kernel 0: none)."""

    _fields_ = [("kernel", ctypes.c_int), ("line", ctypes.c_int), ("what", ctypes.c_int), ("thread", ctypes.c_int),
                ("block", ctypes.c_int * 3), ("pad", ctypes.c_int), ("index", ctypes.c_longlong),
                ("extent", ctypes.c_longlong)]

    def __str__(self) -> str:
        kernel = BOUNDS_KERNELS[self.kernel] if 0 < self.kernel < len(BOUNDS_KERNELS) else f"kernel {self.kernel}"
        names = BOUNDS_TENSORS + BOUNDS_RANGES
        what = names[self.what] if 0 <= self.what < len(names) else f"#{self.what}"
        return (f"{kernel}, line {self.line}: {what} index {self.index} outside [0, {self.extent}) in block "
                f"({self.block[0]}, {self.block[1]}, {self.block[2]}), thread {self.thread}")


@contextlib.contextmanager
def checked_kernels():
    """Run the bf16 attention wrappers on the bounds-checked build (see the module note) while inside; for
    finding a kernel that reads or writes outside its tensors, never for a main path. The switch is global
    (the backward runs on autograd's thread)."""
    global _checked
    before, _checked = _checked, True
    try:
        yield
    finally:
        _checked = before


def _extent(t: Optional[torch.Tensor]) -> int:
    """Elements from t's first element to the end of its storage (0 for no tensor): what a kernel may address
    from the pointer it was given."""
    if t is None:
        return 0
    return t.untyped_storage().nbytes() // t.element_size() - t.storage_offset()


def _poison_view(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """t as integers of its width, and the value of the poison (all bytes 0xFF: NaN in bf16 and fp32, -1 in
    int32) in them."""
    dtype, value = {1: (torch.uint8, 0xFF), 2: (torch.int16, -1), 4: (torch.int32, -1)}[t.element_size()]
    return t.view(dtype), value


def _launch(source: str, signatures: dict, entry: str, args: tuple, tensors: Optional[dict] = None,
            outputs: Optional[dict] = None) -> None:
    """``entry`` of ``csrc/<source>.cu`` on ``args``, raising on its error code. Under :func:`checked_kernels` the
    checked build: the ``outputs`` (name -> tensor the launch must write whole) filled with the poison, the
    extents of ``tensors`` (name in ``BOUNDS_TENSORS`` -> the tensor whose pointer the launch takes, or None; the
    first is a tensor) armed, and
    after the launch the fault record and the outputs read back; either raises, naming the kernel."""
    if not _checked:
        _build.check(getattr(_build.library(source, signatures), entry)(*args), entry)
        return
    lib = _build.library(source, {**signatures, **_BOUNDS_SIGNATURES}, checked=True)
    tensors, outputs = dict(tensors or {}), dict(outputs or {})
    tensors.update(outputs)
    ref = next(iter(tensors.values()))
    for t in outputs.values():
        view, value = _poison_view(t)
        view.fill_(value)
    extents = (ctypes.c_longlong * len(BOUNDS_TENSORS))(*(_extent(tensors.get(n)) for n in BOUNDS_TENSORS))
    _build.check(lib.cm3p_bounds_arm(extents, _stream(ref)), "cm3p_bounds_arm")
    _build.check(getattr(lib, entry)(*args), entry)
    torch.cuda.synchronize(ref.device)
    record = BoundsFault()
    _build.check(lib.cm3p_bounds_fault(ctypes.byref(record)), "cm3p_bounds_fault")
    if record.kernel != 0:
        raise RuntimeError(f"{entry}: bounds check failed: {record}")
    for name, t in outputs.items():
        view, value = _poison_view(t)
        left = view == value
        if bool(left.any()):
            first = tuple(int(i) for i in left.nonzero()[0])
            raise RuntimeError(f"{entry}: {int(left.sum())} of {t.numel()} elements of {name} {tuple(t.shape)} left "
                               f"unwritten (still the poison), the first at {first}")


def _rope_scratch(k, rope_theta):
    """With rope the forward kernels first rotate k once into a (B, L, H, D) bf16 buffer and attend over that
    (each Q tile is rotated inside the kernel)."""
    return None if rope_theta is None else torch.empty(k.shape, dtype=k.dtype, device=k.device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _outputs(q, return_lse: bool):
    b, length, heads, d = q.shape
    out = torch.empty(b, length, heads, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, heads, length, dtype=torch.float32, device=q.device) if return_lse else None
    return out, lse


def _f32_lib():
    return _build.library("attention_f32", _F32_SIGNATURES)


def _no_lse_at_f32(q, return_lse):
    if q.dtype == torch.float32 and return_lse:
        raise ValueError("the fp32 attention kernel writes no lse: it is a no-grad forward (training runs in "
                         "bf16, and no fp32 backward kernel exists)")


def rope_k_f32(k, rope_theta: float) -> torch.Tensor:
    """The fp32 segment forms' rope pass on CUDA: a (B, L, H, D) fp32 view rotated once, with the kernels'
    arithmetic (the window kernel's in-kernel rotation gives the same bits), into a contiguous buffer. Its plain
    version is :func:`apply_rope`."""
    if not k.is_cuda or k.dtype != torch.float32 or k.dim() != 4 or k.shape[-1] != HEAD_DIM:
        raise ValueError(f"the fp32 rope pass takes float32 CUDA (B, L, H, {HEAD_DIM}) rows")
    st = k.stride()
    if st[3] != 1 or st[2] != HEAD_DIM or st[1] % 4 or st[0] % 4 or k.data_ptr() % 16:
        raise ValueError(f"the fp32 rope pass needs contiguous 16-byte-aligned heads, got strides {st}")
    b, length, heads, _ = k.shape
    out = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    err = _f32_lib().cm3p_rope_k_f32(k.data_ptr(), st[0], st[1], *_tables(k, rope_theta), out.data_ptr(), b, length,
                                     heads, _stream(k))
    _build.check(err, "cm3p_rope_k_f32")
    return out


def _launch_window_f32(q, k, v, qseg, kseg, window, rope_theta):
    b, length, heads, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _f32_lib().cm3p_window_attention_f32(
        *_common_args(q, k, v, qseg, kseg, rope_theta), out.data_ptr(), b, length, heads, int(window), _stream(q),
    )
    _build.check(err, "cm3p_window_attention_f32")
    window_attention_f32.launches += 1
    return out


def window_attention(q, k, v, qseg, kseg, window: int, rope_theta: Optional[float] = None,
                     return_lse: bool = False):
    """Local attention (|i - j| <= window) over head-minor (B, L, H, D); with
    ``return_lse`` returns ``(out, lse)`` (bf16 only on CUDA)."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, qseg, kseg, window, rope_theta, return_lse)
    _check(q, k, v, qseg, kseg)
    if window < 0:
        raise ValueError("window must be >= 0")
    _no_lse_at_f32(q, return_lse)
    if q.dtype == torch.float32:
        return _launch_window_f32(q, k, v, qseg, kseg, window, rope_theta)
    b, length, heads, _ = q.shape
    out, lse = _outputs(q, return_lse)
    rot = _rope_scratch(k, rope_theta)
    _launch("attention", _SIGNATURES, "cm3p_window_attention", (
        *_common_args(q, k, v, qseg, kseg, rope_theta), None if rot is None else rot.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, length, heads, int(window), _stream(q),
    ), dict(q=q, k=k, v=v, qseg=qseg, kseg=kseg, **_table_tensors(q, rope_theta)), _forward_outputs(out, lse, rot))
    window_attention.launches += 1
    return (out, lse) if return_lse else out


def _launch_segment(q, k, v, qseg, kseg, rope_theta, return_lse):
    b, length, heads, _ = q.shape
    start, count = key_tile_ranges(qseg, kseg)
    if q.dtype == torch.float32:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        if rope_theta is not None:  # k rotated once by the pass; the kernel rotates each Q tile
            k = rope_k_f32(k, rope_theta)
        err = _f32_lib().cm3p_segment_attention_f32(
            *_common_args(q, k, v, qseg, kseg, rope_theta), start.data_ptr(), count.data_ptr(), out.data_ptr(), b,
            length, k.shape[1], heads, _stream(q),
        )
        _build.check(err, "cm3p_segment_attention_f32")
        return out
    out, lse = _outputs(q, return_lse)
    rot = _rope_scratch(k, rope_theta)
    _launch("attention", _SIGNATURES, "cm3p_segment_attention", (
        *_common_args(q, k, v, qseg, kseg, rope_theta), start.data_ptr(), count.data_ptr(),
        None if rot is None else rot.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(), b, length,
        k.shape[1], heads, _stream(q),
    ), dict(q=q, k=k, v=v, qseg=qseg, kseg=kseg, start=start, count=count, **_table_tensors(q, rope_theta)),
        _forward_outputs(out, lse, rot))
    return (out, lse) if return_lse else out


def segment_attention(q, k, v, qseg, kseg, rope_theta: Optional[float] = None, return_lse: bool = False):
    """Global attention within segments over head-minor (B, L, H, D); with
    ``return_lse`` returns ``(out, lse)``."""
    if q.device.type == "cpu":
        return segment_attention_plain(q, k, v, qseg, kseg, rope_theta, return_lse)
    _check(q, k, v, qseg, kseg)
    _no_lse_at_f32(q, return_lse)
    result = _launch_segment(q, k, v, qseg, kseg, rope_theta, return_lse)
    (segment_attention_f32 if q.dtype == torch.float32 else segment_attention).launches += 1
    return result


def segment_attention_rect(q, k, v, qseg, kseg):
    """Global attention of q (B, Lq, H, D) over k, v (B, Lk, H, D) within
    segments, qseg (B, Lq) and kseg (B, Lk): the rectangular form of
    :func:`segment_attention`, the same kernel (q and k already rotated;
    forward only), counted apart."""
    if q.device.type == "cpu":
        return segment_attention_rect_plain(q, k, v, qseg, kseg)
    _check(q, k, v, qseg, kseg, square=False)
    out = _launch_segment(q, k, v, qseg, kseg, None, False)
    (segment_attention_rect_f32 if q.dtype == torch.float32 else segment_attention_rect).launches += 1
    return out


def backward_rope_pass(q, k, rope_theta: float) -> torch.Tensor:
    """The rope pass of the backward kernels' rope forms on CUDA: raw (B, L, H, D) q and k rotated once, with
    the forward's arithmetic, into one (2, B, L, H, D) buffer (q, then k) that both kernels read (pass it as
    ``rotated``). Its plain version is :func:`apply_rope` of each."""
    if not q.is_cuda or q.dtype != torch.bfloat16 or k.shape != q.shape or k.dtype != q.dtype or k.device != q.device:
        raise ValueError("the rope pass takes bfloat16 CUDA q and k of one shape")
    if q.shape[-1] != HEAD_DIM or q.stride(-1) != 1 or k.stride(-1) != 1 or q.stride(2) != HEAD_DIM \
            or k.stride(2) != HEAD_DIM:
        raise ValueError(f"the rope pass takes head dim {HEAD_DIM} with heads {HEAD_DIM} elements apart")
    b, length, heads, _ = q.shape
    rot = torch.empty((2, *q.shape), dtype=q.dtype, device=q.device)
    _launch("attention_bwd", _BWD_SIGNATURES, "cm3p_attention_rope_qk", (
        q.data_ptr(), k.data_ptr(), q.stride(0), k.stride(0), q.stride(1), k.stride(1), *_tables(q, rope_theta),
        rot.data_ptr(), b, length, heads, _stream(q),
    ), dict(q=q, k=k, **_table_tensors(q, rope_theta)), dict(rot=rot))
    return rot


def _launch_bwd(entry, q, k, v, dout, lse, delta, qseg, kseg, window, ranges, rope_theta, rotated, dq=None, dk=None,
                dv=None):
    _check_bwd(q, k, v, dout, lse, delta, qseg, kseg)
    b, length, heads, _ = q.shape
    start, count = ranges if ranges is not None else (None, None)
    tables = _tables(q, rope_theta)
    # the rope forms read q and k rotated by the rope pass: the caller's, or one run here
    rot = None
    if rope_theta is not None:
        if rotated is None:
            rot = backward_rope_pass(q, k, rope_theta)
        elif rotated.shape != (2, *q.shape) or rotated.dtype != q.dtype or rotated.device != q.device \
                or not rotated.is_contiguous():
            raise ValueError("rotated must be the rope pass's contiguous (2, B, L, H, D) output on q's device")
        else:
            rot = rotated
    _launch("attention_bwd", _BWD_SIGNATURES, entry, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        *_qkv_args(q, k, v)[3:], lse.data_ptr(), delta.data_ptr(), qseg.data_ptr(), kseg.data_ptr(),
        None if start is None else start.data_ptr(), None if count is None else count.data_ptr(), *tables,
        None if dq is None else dq.data_ptr(), None if dk is None else dk.data_ptr(),
        None if dv is None else dv.data_ptr(), None if rot is None else rot.data_ptr(), b, length, heads,
        int(window or 0), _stream(q),
    ), dict(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta, qseg=qseg, kseg=kseg, start=start, count=count, rot=rot,
            **_table_tensors(q, rope_theta)),
        {name: t for name, t in (("dq", dq), ("dk", dk), ("dv", dv)) if t is not None})


# the fp32 forms of the forward (csrc/attention_f32.cu): each counted under its own name
window_attention_f32 = FormLaunches()
segment_attention_f32 = FormLaunches()
segment_attention_rect_f32 = FormLaunches()

# the rope forms of the four backward kernels (raw q/k, rope tables): each counted under its own name
window_attention_dq_rope = FormLaunches()
window_attention_dkv_rope = FormLaunches()
segment_attention_dq_rope = FormLaunches()
segment_attention_dkv_rope = FormLaunches()


def _count(plain_form, rope_form, rope_theta) -> None:
    (plain_form if rope_theta is None else rope_form).launches += 1


def window_attention_dq(q, k, v, dout, lse, delta, qseg, kseg, window: int, rope_theta: Optional[float] = None,
                        rotated: Optional[torch.Tensor] = None):
    """dq of :func:`window_attention` (lse from its forward; delta from
    :func:`attention_delta`). Without ``rope_theta`` q and k are rotated and dq
    is with respect to them; with it (the rope form) q and k are raw, as the
    forward took them, and so is dq. ``rotated``: on CUDA, the output of
    :func:`backward_rope_pass` over these q and k, which the rope form then
    reads instead of running its own pass."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, window, rope_theta)[0]
    if window < 0:
        raise ValueError("window must be >= 0")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("cm3p_window_attention_dq", q, k, v, dout, lse, delta, qseg, kseg, window, None, rope_theta, rotated,
                dq=dq)
    _count(window_attention_dq, window_attention_dq_rope, rope_theta)
    return dq


def window_attention_dkv(q, k, v, dout, lse, delta, qseg, kseg, window: int, rope_theta: Optional[float] = None,
                         rotated: Optional[torch.Tensor] = None):
    """(dk, dv) of :func:`window_attention` (``rope_theta`` and ``rotated`` as for :func:`window_attention_dq`)."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, window, rope_theta)[1:]
    if window < 0:
        raise ValueError("window must be >= 0")
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    _launch_bwd("cm3p_window_attention_dkv", q, k, v, dout, lse, delta, qseg, kseg, window, None, rope_theta,
                rotated, dk=dk, dv=dv)
    _count(window_attention_dkv, window_attention_dkv_rope, rope_theta)
    return dk, dv


def segment_attention_dq(q, k, v, dout, lse, delta, qseg, kseg, rope_theta: Optional[float] = None,
                         rotated: Optional[torch.Tensor] = None):
    """dq of :func:`segment_attention`, visiting the key tiles of
    ``segment_tile_ranges(qseg, kseg)`` (``rope_theta`` and ``rotated`` as for :func:`window_attention_dq`)."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, None, rope_theta)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ranges = key_tile_ranges(qseg, kseg)
    _launch_bwd("cm3p_segment_attention_dq", q, k, v, dout, lse, delta, qseg, kseg, None, ranges, rope_theta, rotated,
                dq=dq)
    _count(segment_attention_dq, segment_attention_dq_rope, rope_theta)
    return dq


def segment_attention_dkv(q, k, v, dout, lse, delta, qseg, kseg, rope_theta: Optional[float] = None,
                          rotated: Optional[torch.Tensor] = None):
    """(dk, dv) of :func:`segment_attention`, visiting the query tiles of
    ``segment_tile_ranges(kseg, qseg)`` (the q/k roles swapped; ``rope_theta`` and ``rotated`` as for
    :func:`window_attention_dq`)."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, None, rope_theta)[1:]
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    ranges = key_tile_ranges(kseg, qseg)
    _launch_bwd("cm3p_segment_attention_dkv", q, k, v, dout, lse, delta, qseg, kseg, None, ranges, rope_theta,
                rotated, dk=dk, dv=dv)
    _count(segment_attention_dkv, segment_attention_dkv_rope, rope_theta)
    return dk, dv


# ------------------------------------------------------------ Wo epilogue


def wo_shape_ok(window: Optional[int], hd: int, dm: int, lq: int, lk: int) -> bool:
    """The shape part of :func:`wo_fusable`: square q/k, widths that are
    multiples of 128, and a window the single-pass kernel takes (at most 128
    on each side at the dispatcher's 128-row blocks)."""
    if lq != lk or hd % 128 or dm % 128:
        return False
    return window is None or -(-(128 + 2 * window) // 128) + 1 <= 4


def wo_fusable(window: Optional[int], hd: int, dm: int, lq: int, lk: int) -> bool:
    """The JAX package's ``wo_fusable`` at its dispatcher's automatic blocks:
    where its attention kernels apply the Wo epilogue. Global layers above
    ``WO_GLOBAL_MAX_LEN`` tokens decline for the TPU's VMEM alone."""
    return wo_shape_ok(window, hd, dm, lq, lk) and (window is not None or lq <= WO_GLOBAL_MAX_LEN)


def window_attention_wo_plain(q, k, v, qseg, kseg, window: int, wo, residual, rope_theta: Optional[float] = None):
    """Plain version of :func:`window_attention_wo`: the plain attention, then
    ``fused_ln_matmul_plain(o, wo, residual=residual)``."""
    o = window_attention_plain(q, k, v, qseg, kseg, window, rope_theta)
    return fused_ln_matmul_plain(o.flatten(2), wo, residual=residual)


def window_attention_wo_q_plain(q, k, v, qseg, kseg, window: int, w_q, residual,
                                rope_theta: Optional[float] = None):
    """Plain version of :func:`window_attention_wo_q`: the plain attention, then
    ``fused_ln_matmul_q_plain(o, None, residual=residual, w_q=w_q)``."""
    o = window_attention_plain(q, k, v, qseg, kseg, window, rope_theta)
    return fused_ln_matmul_q_plain(o.flatten(2), None, residual=residual, w_q=w_q)


def segment_attention_wo_plain(q, k, v, qseg, kseg, wo, residual, rope_theta: Optional[float] = None):
    """Plain version of :func:`segment_attention_wo`."""
    o = segment_attention_plain(q, k, v, qseg, kseg, rope_theta)
    return fused_ln_matmul_plain(o.flatten(2), wo, residual=residual)


def segment_attention_wo_q_plain(q, k, v, qseg, kseg, w_q, residual, rope_theta: Optional[float] = None):
    """Plain version of :func:`segment_attention_wo_q`."""
    o = segment_attention_plain(q, k, v, qseg, kseg, rope_theta)
    return fused_ln_matmul_q_plain(o.flatten(2), None, residual=residual, w_q=w_q)


def _check_wo(q, weight, w_dtype, sw, residual, o_out, codes_out):
    b, length, heads, d = q.shape
    hd = heads * d
    n = weight.shape[0]
    if hd not in WO_KERNEL_WIDTHS:
        raise ValueError(f"the epilogue kernels take H * D in {WO_KERNEL_WIDTHS}, got {hd}")
    if (weight.device != q.device or weight.dtype != w_dtype or not weight.is_contiguous()
            or weight.dim() != 2 or weight.shape[1] != hd or n % COLUMN_TILE or n <= 0):
        raise ValueError(f"Wo must be contiguous {w_dtype} (N, H * D) with N a multiple of {COLUMN_TILE} on "
                         f"q's device, got {weight.dtype} {tuple(weight.shape)}")
    if sw is not None and (sw.device != q.device or sw.dtype != torch.float32 or not sw.is_contiguous()
                           or sw.shape != (n,)):
        raise ValueError("the Wo scales must be contiguous float32 (N,) on q's device")
    if (residual.device != q.device or residual.dtype != torch.bfloat16 or not residual.is_contiguous()
            or residual.shape != (b, length, n)):
        raise ValueError("residual must be contiguous bfloat16 (B, L, N) on q's device")
    for name, t, dt in (("o_out", o_out, torch.bfloat16), ("codes_out", codes_out, torch.int8)):
        if t is not None and (t.device != q.device or t.dtype != dt or not t.is_contiguous()
                              or t.numel() != b * length * hd):
            raise ValueError(f"{name} must be contiguous {dt} with B * L * H * D elements on q's device")


def _wo_f32(q, k, v, qseg, kseg, window, weight, sw, residual, rope_theta, o_out, codes_out):
    """The epilogue forms at fp32: the fp32 attention kernel, then the fp32 LN-matmul kernel's residual form
    (int8 with scales ``sw``), each launch counted by its own wrapper."""
    if o_out is not None or codes_out is not None:
        raise ValueError("o_out and codes_out are outputs of the bf16 epilogue kernel")
    b, length, heads, d = q.shape
    if window is None:
        o = _launch_segment(q, k, v, qseg, kseg, rope_theta, False)
        segment_attention_f32.launches += 1
    else:
        o = _launch_window_f32(q, k, v, qseg, kseg, window, rope_theta)
    o = o.view(b, length, heads * d)
    if sw is None:
        return fused_ln_matmul(o, weight, residual=residual)
    return fused_ln_matmul_q(o, None, residual=residual, w_q=(weight, sw))


def _launch_wo(q, k, v, qseg, kseg, window, weight, sw, residual, rope_theta, o_out, codes_out):
    _check(q, k, v, qseg, kseg)
    if q.dtype == torch.float32:
        return _wo_f32(q, k, v, qseg, kseg, window, weight, sw, residual, rope_theta, o_out, codes_out)
    _check_wo(q, weight, torch.int8 if sw is not None else torch.bfloat16, sw, residual, o_out, codes_out)
    b, length, heads, _ = q.shape
    n = weight.shape[0]
    start, count = key_tile_ranges(qseg, kseg) if window is None else (None, None)
    out = torch.empty(b, length, n, dtype=q.dtype, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _build.library("attention_wo", _WO_SIGNATURES).cm3p_attention_wo(
        *_common_args(q, k, v, qseg, kseg, rope_theta), ptr(start), ptr(count), weight.data_ptr(), ptr(sw),
        residual.data_ptr(), out.data_ptr(), ptr(o_out), ptr(codes_out), b, length, heads, n,
        -1 if window is None else int(window), int(sw is not None), _stream(q),
    )
    _build.check(err, "cm3p_attention_wo")
    return out


def _reject_check_outputs_on_cpu(o_out, codes_out):
    if o_out is not None or codes_out is not None:
        raise ValueError("o_out and codes_out are outputs of the CUDA kernel")


def window_attention_wo(q, k, v, qseg, kseg, window: int, wo, residual, rope_theta: Optional[float] = None,
                        o_out=None):
    """``residual + window_attention(...) @ wo.T`` (o in the activation dtype) in one kernel: (B, L, N); at fp32
    the fp32 attention kernel, then the fp32 LN-matmul residual form.

    ``wo`` (N, H * D) in the activation dtype; ``o_out`` (bf16, B * L * H * D
    elements) receives the attention output the epilogue used, for checks only.
    """
    if q.device.type == "cpu":
        _reject_check_outputs_on_cpu(o_out, None)
        return window_attention_wo_plain(q, k, v, qseg, kseg, window, wo, residual, rope_theta)
    if window < 0:
        raise ValueError("window must be >= 0")
    out = _launch_wo(q, k, v, qseg, kseg, window, wo, None, residual, rope_theta, o_out, None)
    if q.dtype == torch.bfloat16:
        window_attention_wo.launches += 1
    return out


def window_attention_wo_q(q, k, v, qseg, kseg, window: int, w_q, residual, rope_theta: Optional[float] = None,
                          o_out=None, codes_out=None):
    """The int8 form of :func:`window_attention_wo`: ``w_q`` = (int8 codes (N, H * D),
    fp32 scales (N,)); ``codes_out`` (int8) receives the o codes, for checks only."""
    if q.device.type == "cpu":
        _reject_check_outputs_on_cpu(o_out, codes_out)
        return window_attention_wo_q_plain(q, k, v, qseg, kseg, window, w_q, residual, rope_theta)
    if window < 0:
        raise ValueError("window must be >= 0")
    out = _launch_wo(q, k, v, qseg, kseg, window, w_q[0], w_q[1], residual, rope_theta, o_out, codes_out)
    if q.dtype == torch.bfloat16:
        window_attention_wo_q.launches += 1
    return out


def segment_attention_wo(q, k, v, qseg, kseg, wo, residual, rope_theta: Optional[float] = None, o_out=None):
    """``residual + segment_attention(...) @ wo.T`` in one kernel (at fp32 the fp32 pair): (B, L, N)."""
    if q.device.type == "cpu":
        _reject_check_outputs_on_cpu(o_out, None)
        return segment_attention_wo_plain(q, k, v, qseg, kseg, wo, residual, rope_theta)
    out = _launch_wo(q, k, v, qseg, kseg, None, wo, None, residual, rope_theta, o_out, None)
    if q.dtype == torch.bfloat16:
        segment_attention_wo.launches += 1
    return out


def segment_attention_wo_q(q, k, v, qseg, kseg, w_q, residual, rope_theta: Optional[float] = None, o_out=None,
                           codes_out=None):
    """The int8 form of :func:`segment_attention_wo`."""
    if q.device.type == "cpu":
        _reject_check_outputs_on_cpu(o_out, codes_out)
        return segment_attention_wo_q_plain(q, k, v, qseg, kseg, w_q, residual, rope_theta)
    out = _launch_wo(q, k, v, qseg, kseg, None, w_q[0], w_q[1], residual, rope_theta, o_out, codes_out)
    if q.dtype == torch.bfloat16:
        segment_attention_wo_q.launches += 1
    return out


for _fn in (window_attention, segment_attention, segment_attention_rect, window_attention_dq, window_attention_dkv,
            segment_attention_dq, segment_attention_dkv, window_attention_wo, window_attention_wo_q,
            segment_attention_wo, segment_attention_wo_q):
    _fn.launches = 0


def attention_bwd(q, k, v, out, dout, lse, qseg, kseg, window: Optional[int], plain: bool = False,
                  rope_theta: Optional[float] = None):
    """(dq, dk, dv) of the forward with lse: the dq and dkv kernels on CUDA,
    the plain backward on the CPU or with ``plain=True``. With ``rope_theta``
    q and k are raw (the forward rotated them) and the rope forms run."""
    dout = dout.contiguous()
    delta = attention_delta(out, dout)
    if plain:
        return _bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, window, rope_theta)
    # on CUDA one rope pass feeds both kernels
    rot = backward_rope_pass(q, k, rope_theta) if rope_theta is not None and q.is_cuda else None
    if window is None:
        dq = segment_attention_dq(q, k, v, dout, lse, delta, qseg, kseg, rope_theta, rot)
        return (dq, *segment_attention_dkv(q, k, v, dout, lse, delta, qseg, kseg, rope_theta, rot))
    dq = window_attention_dq(q, k, v, dout, lse, delta, qseg, kseg, window, rope_theta, rot)
    return (dq, *window_attention_dkv(q, k, v, dout, lse, delta, qseg, kseg, window, rope_theta, rot))


class AttentionFunction(torch.autograd.Function):
    """Attention with autograd: the forward with lse, then :func:`attention_bwd`.

    Without ``rope_theta`` q and k arrive rotated (the training route applies
    rope outside), so no rope runs here. With it q and k arrive raw and stay
    raw in the saved tensors: the forward kernel rotates them and the backward
    runs the rope forms (the JAX package's ``CM3P_TRAIN_FUSED_ROPE``).
    ``window`` None = segment attention; ``plain`` runs the plain versions on
    any device (the oracle of the training path).
    """

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, window, plain, rope_theta=None):
        if window is None:
            fn = segment_attention_plain if plain else segment_attention
            out, lse = fn(q, k, v, qseg, kseg, rope_theta, return_lse=True)
        else:
            fn = window_attention_plain if plain else window_attention
            out, lse = fn(q, k, v, qseg, kseg, window, rope_theta, return_lse=True)
        ctx.save_for_backward(q, k, v, qseg, kseg, out, lse)
        ctx.window, ctx.plain, ctx.rope_theta = window, plain, rope_theta
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qseg, kseg, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, dout, lse, qseg, kseg, ctx.window, ctx.plain, ctx.rope_theta)
        return dq, dk, dv, None, None, None, None, None


def rope_in_kernels(rope_theta: Optional[float], positions: Optional[torch.Tensor], head_dim: int,
                    heads: int) -> bool:
    """Where the training route keeps rope inside the kernels: the JAX
    package's ``_train_rope_in_kernel`` (arange positions, head dim 64, an even
    head count). Its decline of fp32 is a workaround for its compiler and is
    not carried over."""
    return rope_theta is not None and positions is None and head_dim == HEAD_DIM and heads % 2 == 0


def attention(
    q, k, v,
    key_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    rope_theta: Optional[float] = None,
    plain: bool = False,
    positions: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    wo: Optional[torch.Tensor] = None,
    wo_q: Optional[tuple] = None,
):
    """The dispatch of ``flash_attention()``: masks -> (qseg, kseg) -> kernel.

    With ``segment_ids`` the key segments are the ids masked by the key mask
    and queries share them; with only a key mask queries are segment 1; with
    neither everything is segment 1. ``window`` None = global attention.
    ``positions`` (rope positions other than arange) rotate q/k here, outside
    the kernels; otherwise the forward kernel rotates them itself. Under
    autograd the same holds where :func:`rope_in_kernels` admits the layer:
    the forward kernel rotates raw q/k and the backward kernels' rope forms
    rotate on load and counter-rotate dq/dk; elsewhere, and with ``plain``,
    rope is applied outside (autograd of that rope counter-rotates dq/dk).
    ``plain=True`` runs the plain versions on any device (the oracle). With
    ``residual`` (B, L, N) the out-projection epilogue runs and (B, L, N) is
    returned: its bf16 form with ``wo`` (N, H * D), its int8 form with ``wo_q``
    = (codes, scales); no-grad only.

    k and v longer or shorter than q (Lq != Lk, the sequence-parallel global
    layer: a query shard over gathered keys) take the rectangular form
    :func:`segment_attention_rect`, queries in segment 1 and the key mask (B,
    Lk) as the key segments. It is a no-grad global route over rotated q/k, as
    in the JAX package: a window, rope, segment ids, the epilogue or autograd
    raise there.
    """
    b, length = q.shape[:2]
    if k.shape[1] != length:
        return _attention_rect(q, k, v, key_mask, segment_ids, window, rope_theta, plain, residual)
    if segment_ids is not None:
        kseg = segment_ids.to(torch.int32)
        if key_mask is not None:
            kseg = torch.where(key_mask > 0, kseg, torch.zeros_like(kseg))
        qseg = kseg = kseg.contiguous()
    elif key_mask is not None:
        qseg = torch.ones(b, length, dtype=torch.int32, device=q.device)
        kseg = key_mask.to(torch.int32).contiguous()
    else:
        qseg = kseg = torch.ones(b, length, dtype=torch.int32, device=q.device)
    train = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if train and not plain and q.is_cuda and q.dtype == torch.float32:
        raise ValueError("an fp32 attention forward under autograd on CUDA has no backward kernel: train in "
                         "bf16 (as the JAX trainer does), run the forward under torch.no_grad(), or ask for the "
                         "plain versions (set_plain(True))")
    in_kernel = not train or (not plain and rope_in_kernels(rope_theta, positions, q.shape[3], q.shape[2]))
    if rope_theta is not None and (positions is not None or not in_kernel):
        q, k = apply_rope(q, rope_theta, positions), apply_rope(k, rope_theta, positions)
        rope_theta = None
    if train:
        if residual is not None:
            raise ValueError("the Wo epilogue is a no-grad route")
        return AttentionFunction.apply(q, k, v, qseg, kseg, window, plain, rope_theta)
    if residual is not None:
        if window is not None:
            if wo_q is not None:
                fn = window_attention_wo_q_plain if plain else window_attention_wo_q
                return fn(q, k, v, qseg, kseg, window, wo_q, residual, rope_theta)
            fn = window_attention_wo_plain if plain else window_attention_wo
            return fn(q, k, v, qseg, kseg, window, wo, residual, rope_theta)
        if wo_q is not None:
            fn = segment_attention_wo_q_plain if plain else segment_attention_wo_q
            return fn(q, k, v, qseg, kseg, wo_q, residual, rope_theta)
        fn = segment_attention_wo_plain if plain else segment_attention_wo
        return fn(q, k, v, qseg, kseg, wo, residual, rope_theta)
    if window is not None:
        fn = window_attention_plain if plain else window_attention
        return fn(q, k, v, qseg, kseg, window, rope_theta)
    fn = segment_attention_plain if plain else segment_attention
    return fn(q, k, v, qseg, kseg, rope_theta)


def _attention_rect(q, k, v, key_mask, segment_ids, window, rope_theta, plain, residual):
    refused = dict(window=window, rope_theta=rope_theta, segment_ids=segment_ids, residual=residual)
    named = [name for name, value in refused.items() if value is not None]
    if named:
        raise ValueError(f"attention with Lq != Lk is the global no-rope route; it takes no {', '.join(named)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("attention with Lq != Lk is forward only (no autograd)")
    b, lq = q.shape[:2]
    qseg = torch.ones(b, lq, dtype=torch.int32, device=q.device)
    if key_mask is None:
        kseg = torch.ones(b, k.shape[1], dtype=torch.int32, device=q.device)
    else:
        kseg = key_mask.to(torch.int32).contiguous()
    return (segment_attention_rect_plain if plain else segment_attention_rect)(q, k, v, qseg, kseg)
