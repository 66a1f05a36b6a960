"""Tensor parallelism over a model group: the port's Megatron shards, with explicit collectives.

The JAX package shards its parameters by ``_TP_RULES`` and lets GSPMD place
the collectives. The port keeps plain ``nn.Parameter``s of the shard's shape
(:func:`shard_module`, by the layout of ``parallel/mesh.py``) and runs the
collectives itself, where Megatron-LM runs them:

* a column-parallel product (``attn.Wqkv``, the projector's ``linear_1``:
  :func:`column_parallel_linear`) takes its input through
  :func:`copy_to_model_group`: the identity forward, and the all-reduce of
  the input's gradient backward (each rank holds the part of that gradient
  its rows of the weight give);
* a row-parallel product (``attn.Wo``, ``linear_2``:
  :func:`row_parallel_linear`) leaves its partial product for
  :func:`reduce_from_model_group` to sum over the group (the identity
  backward).

Both run in fp32 and round to the activation dtype once, after the sum: the
products, and the input gradient of a column-parallel product, round where
the unsharded route rounds them, so a row's bf16 step differs from one
process's only by the order of fp32 sums. The MLP's fused form is
``LnFfnFunction``'s model-group form (``ops/fused_ffn.py``), with the same
rounding points.

Everything between them (attention at the local heads, the GeGLU of the local
columns) is the rank's own; everything outside them (LayerNorms, embeddings,
the towers' projections, the heads, the losses) runs whole and identical on
every rank of the group.

Every rank of a group must issue the same collectives in the same order. It
does: the ranks of a row run the same layers on the same batch, and
rematerialisation runs the same forward again on each of them.

:func:`gather_module_state` gives the whole state dict from a row's shards
(the checkpoints, ``save_pretrained``); :func:`gather_optimizer_state` and
:func:`shard_optimizer_state` carry the optimizer's per-parameter state
(momentum, AdamW moments: the parameters' shapes) the same way.

A process with no model group (or a group of one rank) hits only no-op paths.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh, check_model_axis, gather_tensor, shard_tensor, tp_split_for

def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or as it is when it is wider (fp64 in tests)."""
    return t if t.dtype == torch.float64 else t.float()


def group_size(group) -> int:
    """The ranks of ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = _f32(grad).contiguous().clone()  # the ranks' parts of the input's gradient, summed in fp32
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product: ``x`` forward; backward, its gradient summed over ``group``."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModelGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; backward, the gradient as it is (every rank's sum holds
    the same gradient)."""
    if group_size(group) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out
    return _ReduceFromModelGroup.apply(x, group)


def column_parallel_linear(x: torch.Tensor, weight: torch.Tensor, group) -> torch.Tensor:
    """``x @ weight^T`` of a column-parallel shard (``weight``: the rank's rows, cast to ``x``'s dtype at use
    as the unsharded ``linear`` casts it) in fp32, rounded to ``x``'s dtype once; backward, the input's
    gradient is summed over ``group`` in fp32 and rounded once."""
    return F.linear(copy_to_model_group(_f32(x), group), _f32(weight.to(x.dtype))).to(x.dtype)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, group) -> torch.Tensor:
    """``x @ weight^T`` of a row-parallel shard (``weight``: the rank's columns, cast to ``x``'s dtype at use):
    the partial product in fp32, summed over ``group`` in fp32, rounded to ``x``'s dtype once."""
    return reduce_from_model_group(F.linear(_f32(x), _f32(weight.to(x.dtype))), group).to(x.dtype)


def model_group_of(model: nn.Module):
    """The model group a model was sharded over (:func:`shard_module`), or None."""
    group = getattr(model, "model_group", None)
    return None if group_size(group) == 1 else group


def sharded_names(model: nn.Module) -> dict:
    """Name -> (dim, parts) of the parameters ``model`` holds in part (none without a model group)."""
    if model_group_of(model) is None:
        return {}
    out = {}
    for name, p in model.named_parameters():
        split = tp_split_for(name, p.shape)
        if split is not None:
            out[name] = split
    return out


@torch.no_grad()
def shard_module(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's part of every parameter the layout splits, and set the model's model group.

    ``model`` is whole and the same on every rank (seeded, or broadcast); its split parameters become new
    ``nn.Parameter``s of the shard's shape, so an optimizer is made after this call. Raises, naming the tower,
    where the model axis does not divide a tower's heads or intermediate width. A model axis of 1 changes
    nothing."""
    n = mesh.shape["model"]
    if n == 1:
        return model
    check_model_axis(n, {type(enc.config).__name__.removesuffix("Config").lower(): enc.config
                         for enc in model.encoders()})
    r = mesh.coords()[1]
    for mname, module in model.named_modules():
        for pname, p in list(module._parameters.items()):
            split = None if p is None else tp_split_for(f"{mname}.{pname}" if mname else pname, p.shape)
            if split is not None:
                module._parameters[pname] = nn.Parameter(shard_tensor(p.detach(), split, n, r),
                                                         requires_grad=p.requires_grad)
    model.set_model_group(mesh.model_group)
    return model


def _all_gather_flat(tensors: Sequence[torch.Tensor], group) -> list[list[torch.Tensor]]:
    """Every rank's ``tensors`` (the same shapes and dtype on every rank), in rank order: one all-gather."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    out = []
    for part in parts:
        pieces, offset = [], 0
        for t in tensors:
            pieces.append(part[offset: offset + t.numel()].view_as(t))
            offset += t.numel()
        out.append(pieces)
    return out


def gather_named(tensors: dict, splits: dict, group) -> dict:
    """``tensors`` (name -> the rank's tensor) with every name of ``splits`` made whole from the ranks of
    ``group``: one all-gather per dtype and device. Every rank of the group must call it with the same names."""
    out = dict(tensors)
    buckets: dict = {}
    for name in tensors:
        if name in splits:
            t = tensors[name]
            buckets.setdefault((t.dtype, t.device), []).append(name)
    for names in buckets.values():
        ranks = _all_gather_flat([tensors[n].detach() for n in names], group)
        for i, name in enumerate(names):
            out[name] = gather_tensor([r[i] for r in ranks], splits[name])
    return out


def gather_module_state(model: nn.Module) -> dict:
    """The model's whole state dict, on every rank of its model group (each must call it); without a model
    group, its state dict."""
    group = model_group_of(model)
    state = model.state_dict()
    if group is None:
        return state
    return gather_named(state, sharded_names(model), group)


def _optimizer_entries(state: dict):
    """(name, per-parameter state dict) of an optimizer state dict whose param groups carry ``names``
    (:class:`~cm3p_torch.train.muon.MuonAdamW`); the per-parameter dicts are copies (an optimizer's
    ``state_dict()`` holds its live ones), put in ``state`` in place of the originals."""
    state["state"] = {idx: dict(entry) for idx, entry in state["state"].items()}
    for group in state["param_groups"]:
        for idx, name in zip(group["params"], group.get("names", ())):
            if idx in state["state"]:
                yield name, state["state"][idx]


def gather_optimizer_state(state: dict, group) -> dict:
    """An optimizer state dict with the per-parameter tensors of the split parameters made whole from the ranks
    of ``group`` (the inverse of :func:`shard_optimizer_state`)."""
    state = dict(state)
    tensors, entries, splits = {}, {}, {}
    for name, entry in _optimizer_entries(state):
        for key, t in entry.items():
            split = tp_split_for(name, t.shape) if torch.is_tensor(t) else None
            if split is not None:
                tensors[(name, key)], entries[(name, key)], splits[(name, key)] = t, entry, split
    whole = gather_named(tensors, splits, group)
    for (name, key), entry in entries.items():
        entry[key] = whole[(name, key)]
    return state


def shard_optimizer_state(state: dict, n: int, r: int) -> dict:
    """Rank ``r``'s optimizer state dict out of ``n`` from a whole one."""
    if n == 1:
        return state
    state = dict(state)
    for name, entry in _optimizer_entries(state):
        for key, t in entry.items():
            split = tp_split_for(name, t.shape) if torch.is_tensor(t) else None
            if split is not None:
                entry[key] = shard_tensor(t, split, n, r)
    return state

