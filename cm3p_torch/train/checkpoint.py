"""Checkpoints: atomic ``torch.save`` of model, optimizer and step, with retention.

The port's counterpart of the JAX package's ``train/checkpoint.py`` (Orbax):
``<directory>/step_<n>.pt`` holds the model's state dict, the optimizer's, the
optimizer step ``n`` and the micro-step counter. A save writes a temporary
file and renames it, so a reader never sees half a checkpoint. At most
``max_to_keep`` checkpoints stay, oldest removed first, except the one
:meth:`CheckpointManager.protect` pins (the best evaluation).

Under a process group the parameters are replicated: rank 0 alone writes and
prunes, between two barriers, so every rank decides whether to save from the
same directory listing and sees the file before any rank reads it on a
resume; every rank restores.

Under a model group (tensor parallelism) a checkpoint is still whole: every
rank gathers its row's shards of the model and of the optimizer state
(momentum, AdamW moments) before rank 0 writes, and a restore loads whole
tensors and keeps this rank's part. A checkpoint written at one model axis so
resumes at any other that divides the towers.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

from ..parallel.distributed import barrier, is_primary
from ..parallel.mesh import shard_state_dict
from ..parallel.tensor import (
    gather_module_state,
    gather_optimizer_state,
    group_size,
    model_group_of,
    shard_optimizer_state,
)

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, save_interval_steps: int = 1000, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self._protected_step: Optional[int] = None

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def steps(self) -> list[int]:
        found = (_NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def protect(self, step: Optional[int]) -> None:
        """Pin ``step`` (the current best) so retention never deletes it."""
        self._protected_step = step

    def should_save(self, step: int) -> bool:
        return self.save_interval_steps > 0 and step % self.save_interval_steps == 0 and step not in self.steps()

    def save(self, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer, micro_step: int) -> Path:
        """Write checkpoint ``step`` (every rank calls it; rank 0 writes)."""
        target = self.path(step)
        barrier()  # every rank has looked at the directory before it changes
        group = model_group_of(model)
        model_state = gather_module_state(model)  # whole tensors (every rank of a model group takes part)
        optimizer_state = optimizer.state_dict()
        if group is not None:
            optimizer_state = gather_optimizer_state(optimizer_state, group)
        if is_primary():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            state = {
                "step": step,
                "micro_step": micro_step,
                "model": model_state,
                "optimizer": optimizer_state,
            }
            torch.save(state, tmp)
            os.replace(tmp, target)
            self._prune()
        barrier()  # the file is there for every rank
        return target

    def _prune(self) -> None:
        if self.max_to_keep is None or self.max_to_keep <= 0:
            return
        steps = [s for s in self.steps() if s != self._protected_step]
        keep = self.max_to_keep - (1 if self._protected_step in self.steps() else 0)
        for step in steps[: max(len(steps) - max(keep, 1), 0)]:
            self.path(step).unlink(missing_ok=True)

    def restore(self, model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                step: Optional[int] = None) -> Optional[dict]:
        """Load checkpoint ``step`` (default: the latest) into ``model`` and
        ``optimizer``; returns its ``{"step", "micro_step"}`` or None if absent."""
        step = self.latest_step() if step is None else step
        if step is None or not self.path(step).exists():
            return None
        device = next(model.parameters()).device
        state = torch.load(self.path(step), map_location=device, weights_only=True)
        group = model_group_of(model)
        n, r = group_size(group), (0 if group is None else torch.distributed.get_rank(group))
        model.load_state_dict(shard_state_dict(state["model"], n, r) if n > 1 else state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(shard_optimizer_state(state["optimizer"], n, r))
        return {"step": state["step"], "micro_step": state["micro_step"]}
