"""Muon (momentum + Newton-Schulz orthogonalisation) with AdamW, as one torch optimizer.

The port's counterpart of the JAX package's ``train/muon.py`` (an optax
``multi_transform`` of Muon and AdamW):

* Muon: Nesterov momentum 0.95, then NS5 in bfloat16 (6 steps), scaled by
  ``max(1, rows / cols) ** 0.5``, times the learning rate;
* AdamW (optax ``adamw``: bias-corrected moments, eps outside the sqrt,
  decoupled weight decay) at ``learning_rate * adamw_lr_ratio``, or at the full
  rate with ``compat_adamw_lr`` (the reference's quirk);
* routing by :func:`default_muon_label_fn`: names holding ``embed`` or
  ``proj_out``, tensors of rank <= 1 and first dims >= 10000 take AdamW.

Orientation. The JAX package works on flax kernels: a Dense kernel is
(in, out), a Conv kernel (k, in, out) reshaped to (k, in * out). A torch
``Linear.weight`` is (out, in) and a ``Conv1d.weight`` (out, in, k), so the
routing, the NS5 input and its scale are taken on the flax view of each tensor
(:func:`flax_layouts`); otherwise Wqkv would be scaled by sqrt(3) where the JAX
package has 1.

Tensor parallelism (``model_group``: the group
``parallel.tensor.shard_module`` sharded the model over): NS5 runs on the
whole matrix, as the JAX package's Muon does on its logical arrays. The
momentum-applied update of every split parameter is all-gathered over the
group (one all-gather) and put back in the whole matrix's row order (undoing
the per-head and gate / up splits), every rank of the group runs NS5 on it and
keeps its own part. The routing and the ``max(1, rows / cols) ** 0.5`` scale
are read on the whole flax shape. Momentum and the AdamW moments stay sharded:
they are elementwise.

Parameters whose ``grad`` is None take no update and keep no state (the audio
tower of a run without audio). The step counter is shared, as optax's counts
are: the learning rate of update ``t`` (0-based) is ``lr_schedule(t)``.

Freezing (``train.py``'s ``optax.masked`` gate after the whole optimizer):
parameters whose top-level name is in ``frozen`` (``beatmap_model``,
``metadata_model``) keep their values while their moments advance as usual;
with ``unfreeze_at`` every frozen tower moves from update ``t >= unfreeze_at``
on (the gate's own 0-based count of updates), without it never.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn

from ..parallel.mesh import shard_tensor, tp_split_for
from ..parallel.tensor import gather_named, group_size

NS_COEFFS = (3.4445, -4.7750, 2.0315)


def zeropower_via_newtonschulz5(g: torch.Tensor, steps: int = 6, eps: float = 1e-7) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalisation in bfloat16 (returns bf16)."""
    assert g.dim() == 2
    a, b, c = NS_COEFFS
    x = g.to(torch.bfloat16)
    x = x / (torch.linalg.vector_norm(x.float()).to(torch.bfloat16) + eps)
    transpose = g.shape[0] > g.shape[1]
    if transpose:
        x = x.t()
    for _ in range(steps):
        xxt = x @ x.t()
        bmat = b * xxt + c * (xxt @ xxt)
        x = a * x + bmat @ x
    if transpose:
        x = x.t()
    return x


def default_muon_label_fn(name: str, flax_shape: tuple) -> str:
    """``"muon"`` for internal >= 2-D weights, ``"adamw"`` for the rest (on the flax shape)."""
    name = name.lower()
    if "embed" in name or "proj_out" in name:
        return "adamw"
    if len(flax_shape) <= 1:
        return "adamw"
    if flax_shape[0] >= 10000:
        return "adamw"
    return "muon"


def flax_layouts(model: nn.Module) -> dict[str, str]:
    """Parameter name -> ``"linear"``, ``"conv"`` or ``"same"``: how its flax view is taken."""
    layouts = {name: "same" for name, _ in model.named_parameters()}
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, nn.Linear):
            layouts[prefix + "weight"] = "linear"
        elif isinstance(module, nn.Conv1d):
            layouts[prefix + "weight"] = "conv"
    return layouts


def to_flax(t: torch.Tensor, layout: str) -> torch.Tensor:
    """The flax view of a torch tensor; each view is its own inverse."""
    if layout == "linear":
        return t.t()
    if layout == "conv":
        return t.permute(2, 1, 0)
    return t


def flax_shape(t: torch.Tensor, layout: str) -> tuple:
    return tuple(to_flax(t, layout).shape)


class MuonAdamW(torch.optim.Optimizer):
    """Muon on the weights :func:`default_muon_label_fn` routes to it, AdamW on the rest.

    ``named_params`` are (name, parameter) pairs, ``layouts`` the
    :func:`flax_layouts` of their model, ``lr_schedule`` maps the 0-based
    update count to the Muon learning rate; ``model_group`` is the model group
    the parameters were sharded over (None: whole parameters).
    """

    def __init__(
        self,
        named_params: Iterable[tuple[str, nn.Parameter]],
        layouts: dict[str, str],
        lr_schedule: Callable[[int], float],
        *,
        momentum: float = 0.95,
        nesterov: bool = True,
        ns_steps: int = 6,
        adamw_lr_ratio: float = 0.25,
        adamw_betas: tuple[float, float] = (0.95, 0.95),
        adamw_eps: float = 1e-8,
        adamw_weight_decay: float = 0.0,
        label_fn: Optional[Callable[[str, tuple], str]] = None,
        compat_adamw_lr: bool = False,
        frozen: Iterable[str] = (),
        unfreeze_at: Optional[int] = None,
        model_group=None,
    ):
        label_fn = label_fn or default_muon_label_fn
        n = group_size(model_group)
        groups = {label: {"params": [], "names": [], "layouts": []} for label in ("muon", "adamw")}
        # the split of each parameter, per group: kept out of the param groups, which a checkpoint written at
        # another model axis restores
        self.splits: dict[str, list] = {label: [] for label in groups}
        for name, p in named_params:
            if not p.requires_grad:
                continue
            layout = layouts.get(name, "same")
            split = tp_split_for(name, p.shape) if n > 1 else None
            shape = list(p.shape)
            if split is not None:
                shape[split[0]] *= n
            label = label_fn(name, flax_shape(torch.empty(shape, device="meta"), layout))
            g = groups[label]
            g["params"].append(p)
            g["names"].append(name)
            g["layouts"].append(layout)
            self.splits[label].append(split)
        param_groups = [dict(label=label, step=0, **g) for label, g in groups.items() if g["params"]]
        defaults = dict(
            momentum=momentum, nesterov=nesterov, ns_steps=ns_steps,
            adamw_lr_ratio=1.0 if compat_adamw_lr else adamw_lr_ratio,
            betas=adamw_betas, eps=adamw_eps, weight_decay=adamw_weight_decay,
        )
        super().__init__(param_groups, defaults)
        self.lr_schedule = lr_schedule
        self.frozen = frozenset(frozen)
        self.unfreeze_at = unfreeze_at
        self.model_group = model_group if n > 1 else None

    def labels(self) -> dict[str, str]:
        return {n: g["label"] for g in self.param_groups for n in g["names"]}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MuonAdamW takes no closure")
        for group in self.param_groups:
            lr = float(self.lr_schedule(group["step"]))
            held = self.held(group["step"])
            if group["label"] == "muon":
                self._muon(group, lr, held)
            else:
                self._adamw(group, lr * group["adamw_lr_ratio"], held)
            group["step"] += 1

    def held(self, t: int) -> frozenset:
        """The top-level names whose parameters update ``t`` (0-based) leaves as they are."""
        return frozenset() if self.unfreeze_at and t >= self.unfreeze_at else self.frozen

    def _muon(self, group, lr, held=frozenset()):
        mom = group["momentum"]
        live, effs, splits = [], {}, {}
        for i, (p, split) in enumerate(zip(group["params"], self.splits[group["label"]])):
            if p.grad is None:
                continue
            g = p.grad
            state = self.state[p]
            if "momentum" not in state:
                state["momentum"] = torch.zeros_like(p)
            buf = state["momentum"]
            buf.mul_(mom).add_(g)
            effs[i] = g + mom * buf if group["nesterov"] else buf
            if split is not None:
                splits[i] = split
            live.append(i)
        if self.model_group is not None:  # the whole matrices of the split parameters, on every rank
            effs = gather_named(effs, splits, self.model_group)
        for i in live:
            p, layout, name = group["params"][i], group["layouts"][i], group["names"][i]
            k = to_flax(effs[i], layout)
            k2 = k.reshape(k.shape[0], -1)
            ortho = zeropower_via_newtonschulz5(k2, steps=group["ns_steps"])
            ortho = ortho * max(1.0, k2.shape[0] / k2.shape[1]) ** 0.5
            update = to_flax(ortho.reshape(k.shape), layout).to(p.dtype)
            if i in splits:
                update = shard_tensor(update, splits[i], group_size(self.model_group),
                                      torch.distributed.get_rank(self.model_group))
            if name.split(".", 1)[0] not in held:
                p.add_(update * -lr)

    def _adamw(self, group, lr, held=frozenset()):
        b1, b2 = group["betas"]
        count = group["step"] + 1
        for p, name in zip(group["params"], group["names"]):
            if p.grad is None:
                continue
            g = p.grad
            state = self.state[p]
            if "mu" not in state:
                state["mu"] = torch.zeros_like(p)
                state["nu"] = torch.zeros_like(p)
            mu, nu = state["mu"], state["nu"]
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            update = (mu / (1.0 - b1**count)) / (torch.sqrt(nu / (1.0 - b2**count)) + group["eps"])
            if group["weight_decay"]:
                update = update + group["weight_decay"] * p
            if name.split(".", 1)[0] not in held:
                p.add_(update * -lr)
