"""Contrastive training of the port: optimizer, steps, checkpoints, the loop.

``python -m cm3p_torch.train --config-name <name> [overrides]`` runs it
(``__main__.py``).
"""
from .checkpoint import CheckpointManager
from .metrics import MetricAccumulator
from .muon import MuonAdamW, default_muon_label_fn, flax_layouts, zeropower_via_newtonschulz5
from .step import TrainStep, eval_step, lr_schedule, to_device
from .trainer import Trainer

__all__ = [
    "CheckpointManager",
    "MetricAccumulator",
    "MuonAdamW",
    "TrainStep",
    "Trainer",
    "default_muon_label_fn",
    "eval_step",
    "flax_layouts",
    "lr_schedule",
    "to_device",
    "zeropower_via_newtonschulz5",
]
