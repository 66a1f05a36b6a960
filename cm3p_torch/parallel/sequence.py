"""Sequence-parallel attention: all-gather K/V over a process group.

Counterpart of the JAX package's ``parallel/sequence.py``. The sequence axis
of (B, L, H, D) activations is sharded over the ranks of a
``torch.distributed`` process group, rank r holding rows [r L/n, (r + 1) L/n):
queries stay local, keys, values and the key mask are all-gathered along L,
and each rank attends its query shard over all keys. Activation memory per
rank is O(L / n) with one all-gather per layer.

* Global layers run :func:`cm3p_torch.ops.attention` on the shard and the
  gathered keys: Lq != Lk, the rectangular form of the segment kernel.
* Windowed layers place the query shard in its absolute rows of a zeroed
  full-length tensor, run the square window kernel, and take the shard's rows
  back out, so the window lines up with the keys' positions.

Rope is applied to q and k before the call, at the shard's absolute
positions. The route is forward only, as in the JAX package. The gather is
the list form of ``torch.distributed.all_gather``, which the gloo and NCCL
backends both take.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops import attention


def _local_allgather_kv_attention(q, k_full, v_full, mask_full, shard: int, n_shards: int,
                                  window: Optional[int], plain: bool = False):
    """q (B, L/n, H, D) of shard ``shard``; k_full, v_full (B, L, H, D) and
    mask_full (B, L) or None gathered over all ``n_shards``."""
    if window is None:
        return attention(q, k_full, v_full, key_mask=mask_full, plain=plain)
    l_loc = q.shape[1]
    q_full = q.new_zeros((q.shape[0], l_loc * n_shards) + tuple(q.shape[2:]))
    q_full[:, shard * l_loc: (shard + 1) * l_loc] = q
    out = attention(q_full, k_full, v_full, key_mask=mask_full, window=window, plain=plain)
    return out[:, shard * l_loc: (shard + 1) * l_loc]


def all_gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along dim 1, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def sequence_sharded_attention(q, k, v, key_mask: Optional[torch.Tensor], group, window: Optional[int] = None,
                               plain: bool = False):
    """Attention over head-minor (B, L/n, H, D) shards of a sequence of length L.

    Each rank of ``group`` passes its own rows of q, k, v (rotated) and of the
    (B, L/n) key mask (or None), and gets its rows of the output. ``window``
    None is a global layer. ``plain`` runs the plain versions (the oracle).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("sequence-parallel attention is forward only (no autograd)")
    k_full, v_full = all_gather_seq(k, group), all_gather_seq(v, group)
    mask_full = None if key_mask is None else all_gather_seq(key_mask.to(torch.int32), group)
    return _local_allgather_kv_attention(
        q, k_full, v_full, mask_full, dist.get_rank(group), dist.get_world_size(group), window, plain
    )
