"""Window (local) and segment (global) attention: CUDA kernels and plain versions.

Counterpart of the JAX package's ``ops/flash_attention.py``. Two public kernels, both
over head-minor (B, L, H, D) tensors, the layout the fused Wqkv output
reshapes to:

* :func:`window_attention` replaces ``_window_fused_kernel``: query i sees
  key j iff |i - j| <= window, kseg[j] > 0 and qseg[i] == kseg[j];
* :func:`segment_attention` replaces ``_seg_unrolled_kernel``: the same
  without the window, visiting only the key tiles whose segment interval
  meets the query tile's (:func:`segment_tile_ranges`, the work of
  ``_block_ranges``).

Both rotate raw q/k with rope (rotate-half, arange positions) when
``rope_theta`` is given, use the softmax scale 1/sqrt(D) with fp32 scores,
and write 0 for a query that sees no key. :func:`attention` is the
dispatch of ``flash_attention()``: it turns a key mask and segment ids into
(qseg, kseg).

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA tensor it
launches the kernel (``csrc/attention.cu``) or raises. The plain versions are
also the oracle the kernels are held against on the card. The source note on
the kernels' design and bound is in ``csrc/attention.cu``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

TILE = 64  # query and key tile of csrc/attention.cu
HEAD_DIM = 64  # the kernels' head dim

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "cm3p_window_attention": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cm3p_segment_attention": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=64)
def rope_tables(length: int, head_dim: int, theta: float, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (L, head_dim // 2) cos and sin of ``position * theta**(-2i/head_dim)``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    freqs = torch.arange(length, dtype=torch.float32)[:, None] * inv_freq[None, :]
    return freqs.cos().to(device).contiguous(), freqs.sin().to(device).contiguous()


def apply_rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rope at arange positions over (B, L, H, D); fp32 math, result in x's dtype."""
    _, length, _, d = x.shape
    cos, sin = rope_tables(length, d, float(theta), str(x.device))
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attention_plain(q, k, v, qseg, kseg, window: Optional[int], rope_theta: Optional[float]):
    b, length, heads, d = q.shape
    if rope_theta is not None:
        q, k = apply_rope(q, rope_theta), apply_rope(k, rope_theta)
    out = torch.empty(b, length, heads, d, dtype=q.dtype, device=q.device)
    idx = torch.arange(length, device=q.device)
    near = (idx[:, None] - idx[None, :]).abs() <= window if window is not None else None
    # bound the (rows, H, L, L) fp32 score block to ~1 GiB
    step = max(1, (1 << 30) // (heads * length * length * 4))
    for r0 in range(0, b, step):
        r1 = min(b, r0 + step)
        qf = q[r0:r1].float().transpose(1, 2)
        kf = k[r0:r1].float().transpose(1, 2)
        vf = v[r0:r1].float().transpose(1, 2)
        s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        ks = kseg[r0:r1, None, None, :]
        mask = (ks > 0) & (qseg[r0:r1, None, :, None] == ks)
        if near is not None:
            mask = mask & near
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        o = (p.to(q.dtype).float() @ vf) / torch.where(denom > 0, denom, torch.ones_like(denom))
        out[r0:r1] = o.transpose(1, 2).to(q.dtype)
    return out


def window_attention_plain(q, k, v, qseg, kseg, window: int, rope_theta: Optional[float] = None):
    """Plain PyTorch version of :func:`window_attention` (dense masked scores)."""
    return _attention_plain(q, k, v, qseg, kseg, window, rope_theta)


def segment_attention_plain(q, k, v, qseg, kseg, rope_theta: Optional[float] = None):
    """Plain PyTorch version of :func:`segment_attention` (dense masked scores)."""
    return _attention_plain(q, k, v, qseg, kseg, None, rope_theta)


def segment_tile_ranges(qseg: torch.Tensor, kseg: torch.Tensor, tile: int = TILE):
    """Per (row, query tile) [start, start + count) of the key tiles to visit.

    A key tile is needed when its positive-segment interval meets the query
    tile's; padding (segment 0) tiles never meet anything. Returns int32
    (B, nq) tensors ``start`` and ``count`` (count 0 = nothing to visit).
    """
    b, length = qseg.shape
    n = -(-length // tile)
    pad = n * tile - length
    qs = torch.nn.functional.pad(qseg, (0, pad)).view(b, n, tile)
    ks = torch.nn.functional.pad(kseg, (0, pad)).view(b, n, tile)
    big = torch.full_like(qs, 2**30)
    zero = torch.zeros_like(qs)
    qmin = torch.where(qs > 0, qs, big).amin(-1)
    qmax = torch.where(qs > 0, qs, zero).amax(-1)
    kmin = torch.where(ks > 0, ks, big).amin(-1)
    kmax = torch.where(ks > 0, ks, zero).amax(-1)
    needed = (
        (qmin[:, :, None] <= kmax[:, None, :])
        & (kmin[:, None, :] <= qmax[:, :, None])
        & (qmax[:, :, None] > 0)
        & (kmax[:, None, :] > 0)
    ).to(torch.int32)
    any_needed = needed.amax(-1) > 0
    first = needed.argmax(-1)
    last = (n - 1) - needed.flip(-1).argmax(-1)
    start = torch.where(any_needed, first, torch.zeros_like(first))
    count = torch.where(any_needed, last - first + 1, torch.zeros_like(first))
    return start.to(torch.int32).contiguous(), count.to(torch.int32).contiguous()


def _check(q, k, v, qseg, kseg):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, L, H, D) shape, got {q.shape}, {k.shape}, {v.shape}")
    b, length, heads, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the kernels take head dim {HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        st = t.stride()
        if st[3] != 1 or st[2] != d or st[1] % 8 or st[0] % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous 16-byte-aligned heads, got strides {st}")
    for name, s in (("qseg", qseg), ("kseg", kseg)):
        if s.dtype != torch.int32 or s.shape != (b, length) or not s.is_contiguous() or s.device != q.device:
            raise ValueError(f"{name} must be contiguous int32 (B, L) on q's device")


def _common_args(q, k, v, qseg, kseg, rope_theta):
    if rope_theta is not None:
        cos, sin = rope_tables(q.shape[1], q.shape[3], float(rope_theta), str(q.device))
        tables = (cos.data_ptr(), sin.data_ptr())
    else:
        tables = (None, None)
    strides = (q.stride(0), k.stride(0), v.stride(0), q.stride(1), k.stride(1), v.stride(1))
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, qseg.data_ptr(), kseg.data_ptr(), *tables)


def _lib():
    return _build.library("attention", _SIGNATURES)


def window_attention(q, k, v, qseg, kseg, window: int, rope_theta: Optional[float] = None):
    """Local attention (|i - j| <= window) over head-minor (B, L, H, D)."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, qseg, kseg, window, rope_theta)
    _check(q, k, v, qseg, kseg)
    if window < 0:
        raise ValueError("window must be >= 0")
    b, length, heads, d = q.shape
    out = torch.empty(b, length, heads, d, dtype=q.dtype, device=q.device)
    err = _lib().cm3p_window_attention(
        *_common_args(q, k, v, qseg, kseg, rope_theta), out.data_ptr(), b, length, heads, int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "cm3p_window_attention")
    window_attention.launches += 1
    return out


def segment_attention(q, k, v, qseg, kseg, rope_theta: Optional[float] = None):
    """Global attention within segments over head-minor (B, L, H, D)."""
    if q.device.type == "cpu":
        return segment_attention_plain(q, k, v, qseg, kseg, rope_theta)
    _check(q, k, v, qseg, kseg)
    b, length, heads, d = q.shape
    start, count = segment_tile_ranges(qseg, kseg)
    out = torch.empty(b, length, heads, d, dtype=q.dtype, device=q.device)
    err = _lib().cm3p_segment_attention(
        *_common_args(q, k, v, qseg, kseg, rope_theta), start.data_ptr(), count.data_ptr(),
        out.data_ptr(), b, length, heads, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "cm3p_segment_attention")
    segment_attention.launches += 1
    return out


window_attention.launches = 0
segment_attention.launches = 0


def attention(
    q, k, v,
    key_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    rope_theta: Optional[float] = None,
    plain: bool = False,
):
    """The dispatch of ``flash_attention()``: masks -> (qseg, kseg) -> kernel.

    With ``segment_ids`` the key segments are the ids masked by the key mask
    and queries share them; with only a key mask queries are segment 1; with
    neither everything is segment 1. ``window`` None = global attention.
    ``plain=True`` runs the plain versions on any device (the oracle).
    """
    b, length = q.shape[:2]
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
    if window is not None:
        fn = window_attention_plain if plain else window_attention
        return fn(q, k, v, qseg, kseg, window, rope_theta)
    fn = segment_attention_plain if plain else segment_attention
    return fn(q, k, v, qseg, kseg, rope_theta)
