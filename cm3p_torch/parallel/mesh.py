"""The (data, model) grid of ranks, its process groups, and the tensor-parallel layout: the port's counterpart
of the JAX package's ``parallel/mesh.py``.

The JAX package places a global batch on a ``jax.sharding.Mesh`` and lets
XLA insert the collectives. Here :func:`make_mesh` lays the world's ranks out
as a ``(data, model)`` grid (rank = data index x model + model index, the
model axis inside) and forms a process group per column (the ranks that hold
different rows of the batch and reduce gradients together: the data group,
the whole data group of ``initialize_distributed`` with a model axis of 1)
and per row (the model group). :meth:`Mesh.local_rows` is the batch placement:
the rows of a global batch this rank holds, the JAX ``batch_shardings`` over
``data``.

The model axis is explicit Megatron tensor parallelism (the JAX ``_TP_RULES``
and ``partition_spec_for``, there an annotation that GSPMD follows).
``_TP_RULES`` names, by regex on the HF key, the parameters that rank r of
a model group of n holds in part, and :func:`tp_split_for` gives a key's
split: every encoder layer's ``attn.Wqkv`` per head (the rows of heads [rH/n,
(r + 1)H/n) from each of the q, k and v thirds) and ``attn.Wo`` by the same
heads' columns; ``mlp.Wi`` in matched halves (rows [rF/n, (r + 1)F/n) of the
gate half and the same rows of the up half) and ``mlp.Wo`` by those columns;
the audio projector's ``linear_1`` by rows and ``linear_2`` by columns (a
column / row pair around its activation). Every other parameter stays whole
on every rank: the LayerNorms, and, where the JAX rules shard them too, the
token embeddings, the towers' projections, the decoder and the convolutions
(at this model's size they save little memory, and a vocabulary split of the
decoder would need a vocabulary-parallel cross entropy).
:func:`shard_state_dict` and :func:`gather_state_dict` move between a whole
state dict and its n shards, exactly. ``parallel/tensor.py`` runs the layout.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import active, data_group, process_count, process_index


@dataclass
class Mesh:
    grid: np.ndarray  # (data, model) of ranks
    data_group: Any = None  # this rank's column: None with no process group
    model_group: Any = None  # this rank's row: None with no process group or a model axis of 1

    @property
    def shape(self) -> dict:
        return {"data": int(self.grid.shape[0]), "model": int(self.grid.shape[1])}

    def coords(self, rank: Optional[int] = None) -> tuple[int, int]:
        """(data index, model index) of ``rank`` (default: this process)."""
        rank = process_index() if rank is None else rank
        i, j = np.argwhere(self.grid == rank)[0]
        return int(i), int(j)

    def local_rows(self, n_global: int, rank: Optional[int] = None) -> slice:
        """The rows of a global batch of ``n_global`` rows that ``rank`` holds: its data index's block."""
        d = self.shape["data"]
        if n_global % d:
            raise ValueError(f"a global batch of {n_global} rows does not split over {d} data shards")
        i = self.coords(rank)[0]
        per = n_global // d
        return slice(i * per, (i + 1) * per)


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The (data, model) grid over the world's ranks (one rank with no process group), with its groups.

    Every rank must call it (forming a group is collective). With a model axis of 1 the data group is the
    whole world."""
    n = process_count()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not match {n} ranks")
    grid = np.arange(n).reshape(data, model)
    if not active():
        return Mesh(grid)
    rank = process_index()
    if model == 1:  # each rank is its own model row: no group to form
        return Mesh(grid, data_group())
    backend = dist.get_backend(data_group())
    columns, rows = None, None
    for j in range(model):  # every rank takes part in forming every group, in the same order
        g = dist.new_group(grid[:, j].tolist(), backend=backend)
        if rank in grid[:, j]:
            columns = g
    for i in range(data):
        g = dist.new_group(grid[i, :].tolist(), backend=backend)
        if rank in grid[i, :]:
            rows = g
    return Mesh(grid, columns, rows)


# (regex on the HF key, (dim, parts)): the dim of the torch tensor that is split, and the blocks it holds
# along that dim (the q / k / v thirds of Wqkv, the gate / up halves of Wi), each split in n contiguous pieces
_TP_RULES: list[tuple[str, tuple[int, int]]] = [
    (r"layers\.\d+\.attn\.Wqkv\.weight$", (0, 3)),
    (r"layers\.\d+\.attn\.Wo\.weight$", (1, 1)),
    (r"layers\.\d+\.mlp\.Wi\.weight$", (0, 2)),
    (r"layers\.\d+\.mlp\.Wo\.weight$", (1, 1)),
    (r"multi_modal_projector\.linear_1\.weight$", (0, 1)),
    (r"multi_modal_projector\.linear_2\.weight$", (1, 1)),
]


def tp_split_for(name: str, shape: Sequence[int]) -> Optional[tuple[int, int]]:
    """(dim, parts) of the parameter ``name`` of whole ``shape`` under tensor parallelism, or None (whole on
    every rank): the counterpart of ``partition_spec_for``."""
    for pattern, split in _TP_RULES:
        if re.search(pattern, name) and len(shape) == 2:
            return split
    return None


def shard_tensor(t: torch.Tensor, split: tuple[int, int], n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s part of ``t`` out of ``n``: along ``dim``, piece r of each of the ``parts`` blocks."""
    dim, parts = split
    if t.shape[dim] % (parts * n):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {parts} blocks over {n} ranks")
    blocks = t.unflatten(dim, (parts, n, t.shape[dim] // (parts * n)))
    return blocks.select(dim + 1, r).flatten(dim, dim + 1).contiguous()


def gather_tensor(shards: Sequence[torch.Tensor], split: tuple[int, int]) -> torch.Tensor:
    """The whole tensor from every rank's part, in rank order (the inverse of :func:`shard_tensor`)."""
    dim, parts = split
    blocks = [s.unflatten(dim, (parts, s.shape[dim] // parts)) for s in shards]
    return torch.stack(blocks, dim=dim + 1).flatten(dim, dim + 2)


def shard_state_dict(whole: dict, n: int, r: int) -> dict:
    """Rank ``r``'s state dict out of ``n`` from a whole one: the split tensors cut, the rest as they are."""
    out = {}
    for name, t in whole.items():
        split = tp_split_for(name, t.shape)
        out[name] = t if split is None else shard_tensor(t, split, n, r)
    return out


def gather_state_dict(shards: Sequence[dict]) -> dict:
    """The whole state dict from every rank's, in rank order; the whole tensors are rank 0's. The shapes read
    by :func:`tp_split_for` are the shards' (the rules look at the rank only)."""
    out = {}
    for name, t in shards[0].items():
        split = tp_split_for(name, t.shape)
        out[name] = t if split is None else gather_tensor([s[name] for s in shards], split)
    return out


def check_model_axis(model_axis: int, towers: dict) -> None:
    """Raise unless ``model_axis`` divides every tower's heads and intermediate width (and the audio
    projector's width): ``towers`` maps a tower's name to its encoder config."""
    if model_axis < 1:
        raise ValueError(f"training.model_axis must be >= 1, not {model_axis}")
    bad = []
    for tower, cfg in towers.items():
        sizes = {"heads": cfg.num_attention_heads, "intermediate_size": cfg.intermediate_size}
        if hasattr(cfg, "projector_dim"):
            sizes["projector_dim"] = cfg.projector_dim
        bad += [f"the {tower} tower's {v} {k}" for k, v in sizes.items() if v % model_axis]
    if bad:
        raise ValueError(f"training.model_axis={model_axis} does not divide {', '.join(bad)}: tensor parallelism "
                         "splits every tower by whole heads and matched intermediate columns")
