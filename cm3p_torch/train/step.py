"""The training and evaluation steps: the port's counterpart of ``train/train_state.py``.

:class:`TrainStep` is one micro-step of ``make_train_step``: the forward
(``CM3PModel.forward_packed`` for packed batches, the model's ``forward``
otherwise: any model of the family, with its ``labels``), the
loss, the gradients of every trainable parameter, their global norm, and, on
the last micro-step of an accumulation window, the optimizer step on the mean
gradient (``optax.MultiSteps``). Under a data group (``model.dp_group``, set
when a process group is active) each micro-step's gradients are reduced to
their mean over the group before the norm, so the norm, the accumulated sum
and the optimizer step are those of the global batch (the JAX step under a
``data`` mesh) and every replica steps on the same gradient. Under a model group (tensor
parallelism, ``model.model_group``) the gradients of the parameters that stay
whole are first averaged over that group (one flat all-reduce; the ranks
computed them alike, and the mean keeps the whole parameters bit-equal across
the group even where a backward sums in a nondeterministic order, as cuDNN's
convolution weight gradient and the scatter of a gather's backward may), and
the norm sums the squares of the split gradients over the group: it is the
norm of the logical gradients.
:func:`eval_step` is the no-grad forward.
:func:`lr_schedule` is ``train.py``'s schedule: an optional linear warmup from
0, then a linear decay from ``lr`` to 0 over ``max_steps - warmup`` updates.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..parallel.distributed import all_reduce_gradients
from ..parallel.tensor import model_group_of, sharded_names

PACKED_KEYS = (
    "input_ids", "segment_ids", "window_rows", "window_segments", "window_valid", "input_features",
    "metadata_ids", "metadata_attention_mask", "metadata_variation_classes", "labels",
)
UNPACKED_KEYS = (
    "input_ids", "input_features", "metadata_ids", "attention_mask", "metadata_attention_mask",
    "metadata_variation_classes", "labels",
)


def lr_schedule(lr: float, max_steps: int, warmup_steps: int = 0) -> Callable[[int], float]:
    """Learning rate of the 0-based update ``t`` (optax ``linear_schedule``/``join_schedules``)."""
    decay_steps = max(max_steps - warmup_steps, 1)

    def schedule(t: int) -> float:
        if warmup_steps > 0 and t < warmup_steps:
            return lr * t / warmup_steps
        done = min(max(t - warmup_steps, 0), decay_steps)
        return lr * (1.0 - done / decay_steps)

    return schedule


def to_device(batch: dict, device, packed: bool) -> dict:
    """The model's arguments from a numpy batch: ints as int64, floats as fp32 (so integer class
    labels stay integer and regression labels floating, which the classifier's loss reads)."""
    keys = PACKED_KEYS if packed else UNPACKED_KEYS
    out = {}
    for key in keys:
        if key not in batch:
            continue
        arr = np.asarray(batch[key])
        dtype = torch.float32 if np.issubdtype(arr.dtype, np.floating) else torch.int64
        out[key] = torch.as_tensor(arr).to(device=device, dtype=dtype, non_blocking=True)
    return out


def forward(model: nn.Module, batch: dict, packed: bool):
    return model.forward_packed(**batch) if packed else model(**batch)


def global_norm(grads, sharded=None, group=None) -> torch.Tensor:
    """fp32 L2 norm over every gradient that is not None (``optax.global_norm``). With a model ``group``,
    ``sharded`` flags the gradients that are this rank's part of a split parameter: their squares are summed
    over the group, the others counted once."""
    if group is None:
        sq = [g.float().square().sum() for g in grads if g is not None]
        return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())
    device = next(g.device for g in grads if g is not None)
    sums = [torch.zeros((), device=device), torch.zeros((), device=device)]  # split, whole
    for g, s in zip(grads, sharded):
        if g is not None:
            sums[0 if s else 1] += g.float().square().sum()
    torch.distributed.all_reduce(sums[0], group=group)
    return torch.sqrt(sums[0] + sums[1])


class TrainStep:
    """One micro-step per call; every ``accumulation_steps`` calls the optimizer steps.

    Returns ``{"loss", "grad_norm", "applied"}``: the micro-batch's loss and
    gradient norm as 0-d tensors (no host sync), and whether the optimizer ran.
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, packed: bool,
                 accumulation_steps: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.packed = packed
        self.accumulation_steps = max(int(accumulation_steps), 1)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        split = sharded_names(model)
        self.sharded = [n in split for n, _ in named]
        self._sum: Optional[list] = None
        self._count = 0

    def grads(self, batch: dict):
        """(loss, gradients aligned with ``self.params`` (None where unused), norm); under a data group the
        global batch's loss and the gradients' mean over the group."""
        out = forward(self.model, batch, self.packed)
        grads = torch.autograd.grad(out.loss, self.params, allow_unused=True)
        model_group = model_group_of(self.model)
        if model_group is not None:  # the whole parameters' gradients, the same on every rank of the row
            whole = all_reduce_gradients([None if s else g for g, s in zip(grads, self.sharded)], model_group)
            grads = [g if s else w for g, w, s in zip(grads, whole, self.sharded)]
        group = getattr(self.model, "dp_group", None)
        if group is not None:
            grads = all_reduce_gradients(grads, group)
        return out.loss.detach(), grads, global_norm(grads, self.sharded, model_group)

    def __call__(self, batch: dict) -> dict:
        self.model.train()
        loss, grads, norm = self.grads(batch)
        if self._sum is None:
            self._sum = list(grads)
        else:
            self._sum = [
                a if g is None else (g if a is None else a.add_(g)) for a, g in zip(self._sum, grads)
            ]
        self._count += 1
        applied = self._count == self.accumulation_steps
        if applied:
            for p, g in zip(self.params, self._sum):
                p.grad = None if g is None else g / self._count
            self.optimizer.step()
            for p in self.params:
                p.grad = None
            self._sum, self._count = None, 0
        return {"loss": loss, "grad_norm": norm, "applied": applied}


@torch.no_grad()
def eval_step(model: nn.Module, batch: dict, packed: bool):
    model.eval()
    return forward(model, batch, packed)
