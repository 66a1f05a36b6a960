"""The (data, model) grid of ranks and its process groups: the data axis of the JAX package's ``parallel/mesh.py``.

The JAX package places a global batch on a ``jax.sharding.Mesh`` and lets
XLA insert the collectives. Here :func:`make_mesh` lays the world's ranks out
as a ``(data, model)`` grid (rank = data index x model + model index, the
model axis inside) and forms a process group per column (the ranks that hold
different rows of the batch and reduce gradients together: the data group,
the whole data group of ``initialize_distributed`` with a model axis of 1)
and per row (the model group). :meth:`Mesh.local_rows` is the batch placement:
the rows of a global batch this rank holds, the JAX ``batch_shardings`` over
``data``.

Only the data axis runs here: tensor parallelism (the JAX ``_TP_RULES`` and
``partition_spec_for``) is not ported, and the entry points raise on a model
axis above 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
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
