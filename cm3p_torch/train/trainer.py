"""Training loop: micro-steps with gradient accumulation, logs, evaluation, checkpoints.

The port's counterpart of the JAX package's ``train/trainer.py`` on one
device: :class:`~cm3p_torch.train.step.TrainStep` per micro-batch, one
optimizer step every ``gradient_accumulation_steps`` micro-steps (on the mean
gradient), a ``train_log.jsonl`` record every ``logging_steps`` optimizer
steps, evaluation every ``eval_steps`` (zero-shot variation ranking and loss,
``MetricAccumulator``; masked-LM or classification accuracy by the
batches' ``labels_kind``), checkpoints every ``save_steps`` with
``save_total_limit`` retention and resume of the latest, and
``train_results.json`` / ``eval_results.json`` at the end; with ``wandb_project`` every log record also goes
to Weights & Biases (the JAX trainer's optional hook: ``wandb`` is imported when the run starts, and where the
import or ``wandb.init`` fails a warning is logged and the JSONL log stays the only one). A resume seeks the
batch stream through ``train_iter_factory(start_step=...)`` where the factory
takes it, else replays it. Losses stay on the
device until a log record needs them. :func:`from_pretrained` initialises a
model from a local HF-layout directory (the JAX trainer's ``from_pretrained``).

Under a process group (one rank per GPU, the model's ``dp_group``) every rank
runs the same loop on its own shard of the data: the logs and the result files
are written by rank 0 alone (the others write to ``os.devnull``, as the JAX
trainer's non-primary hosts), ``samples_per_sec`` counts the global batch,
checkpoints are written by rank 0 and restored by every rank, and
:meth:`Trainer.evaluate` asks every rank whether it has a batch before each
one, so ranks with unequal eval shards stop together at the shortest.
Under a model group as well (tensor parallelism, ``model.model_group``) the
data group is the grid's column: the samples count is that of the data
groups, the checkpoints are whole (``checkpoint.py``), and the evaluation runs
the sharded forward on every rank of a row.
"""
from __future__ import annotations

import inspect
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..models.cm3p import data_group_of
from ..parallel.distributed import all_processes_have, gather_rows, is_primary
from .checkpoint import CheckpointManager
from .metrics import MetricAccumulator
from .step import TrainStep, eval_step, to_device

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        train_iter_factory: Callable[[], Iterator[dict]],
        eval_iter_factory: Optional[Callable[[], Iterator[dict]]] = None,
        *,
        device,
        packed: bool = False,
        output_dir: str = "output",
        max_steps: int = 1000,
        gradient_accumulation_steps: int = 1,
        logging_steps: int = 10,
        eval_steps: int = 1000,
        max_eval_batches: int = 50,
        save_steps: int = 1000,
        save_total_limit: int = 3,
        resume: bool = True,
        load_best_model_at_end: bool = False,
        labels_kind: str = "none",
        wandb_project: Optional[str] = None,
        wandb_entity: Optional[str] = None,
        wandb_mode: Optional[str] = None,
        run_config: Optional[dict] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.train_iter_factory = train_iter_factory
        self.eval_iter_factory = eval_iter_factory
        self.device = torch.device(device)
        self.packed = packed
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.max_steps = max_steps
        self.grad_accum = max(int(gradient_accumulation_steps), 1)
        self.logging_steps = logging_steps
        self.eval_steps = eval_steps
        self.max_eval_batches = max_eval_batches
        self.resume = resume
        self.load_best_model_at_end = load_best_model_at_end
        self.labels_kind = labels_kind
        self.step_fn = TrainStep(model, optimizer, packed, self.grad_accum)
        self.ckpt = CheckpointManager(
            str(self.output_dir / "checkpoints"), save_interval_steps=save_steps, max_to_keep=save_total_limit
        )
        self._primary = is_primary()
        self._log_file = open(self.output_dir / "train_log.jsonl" if self._primary else os.devnull, "a")
        group = data_group_of(model)
        self.data_groups = 1 if group is None else torch.distributed.get_world_size(group)
        self._best_eval_loss: Optional[float] = None
        self._best_eval_step: Optional[int] = None
        self._last_eval: dict = {}
        self.micro_step = 0
        self.results: dict = {}
        self._wandb = None
        if wandb_project and self._primary:
            self._wandb = _wandb_run(wandb_project, wandb_entity, wandb_mode, run_config, self.output_dir)

    def _log(self, record: dict) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in record.items()}
        self._log_file.write(json.dumps(record) + "\n")
        self._log_file.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "step"}, step=record.get("step"))
        if self._primary:
            logger.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()))

    def _save(self, opt_step: int) -> None:
        self.ckpt.save(opt_step, self.model, self.optimizer, self.micro_step)

    def train(self) -> dict:
        """Run to ``max_steps`` optimizer steps; returns the ``train_results.json`` record."""
        start = self.ckpt.restore(self.model, self.optimizer) if self.resume else None
        self.micro_step = start["micro_step"] if start else 0
        if start:
            logger.info("Resuming from checkpoint step %d", start["step"])
        # micro-step k + 1 trains on batch k, as in an uninterrupted run: a factory that takes
        # ``start_step`` seeks there itself, any other stream is replayed
        if self.micro_step and "start_step" in inspect.signature(self.train_iter_factory).parameters:
            data_iter = iter(self.train_iter_factory(start_step=self.micro_step))
        else:
            data_iter = iter(self.train_iter_factory())
            for _ in range(self.micro_step):
                data_iter = self._advance(data_iter)[1]

        window_t0 = time.perf_counter()
        window_count = 0
        window_samples = 0
        window_loss = 0.0
        pending: list[torch.Tensor] = []
        while self.micro_step < self.max_steps * self.grad_accum:
            batch, data_iter = self._advance(data_iter)
            dev_batch = to_device(batch, self.device, self.packed)
            metrics = self.step_fn(dev_batch)
            self.micro_step += 1
            pending.append(metrics["loss"])
            window_count += 1
            window_samples += int(dev_batch["input_ids"].shape[0]) * self.data_groups
            if not metrics["applied"]:
                continue
            opt_step = self.micro_step // self.grad_accum
            if opt_step % max(self.logging_steps, 1) == 0:
                window_loss = float(torch.stack(pending).float().mean())
                pending = []
                dt = max(time.perf_counter() - window_t0, 1e-9)
                self._log({
                    "step": opt_step,
                    "loss": window_loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "steps_per_sec": window_count / self.grad_accum / dt,
                    "samples_per_sec": window_samples / dt,
                })
                window_t0, window_count, window_samples = time.perf_counter(), 0, 0
            if self.eval_iter_factory is not None and self.eval_steps > 0 and opt_step % self.eval_steps == 0:
                eval_metrics = self.evaluate()
                self._log({"step": opt_step, **{f"eval_{k}": v for k, v in eval_metrics.items() if v is not None}})
                self._last_eval = eval_metrics
                eval_loss = eval_metrics.get("loss")
                if eval_loss is not None and (self._best_eval_loss is None or eval_loss < self._best_eval_loss):
                    self._best_eval_loss, self._best_eval_step = float(eval_loss), opt_step
                    self.ckpt.protect(opt_step)
                    if self.ckpt.latest_step() != opt_step:
                        self._save(opt_step)
            if self.ckpt.should_save(opt_step):
                self._save(opt_step)
        if pending:
            window_loss = float(torch.stack(pending).float().mean())

        final_step = self.micro_step // self.grad_accum
        if self.ckpt.latest_step() != final_step:
            self._save(final_step)
        results = {
            "final_step": final_step,
            "train_loss": window_loss,
            "best_eval_loss": self._best_eval_loss,
            "best_eval_step": self._best_eval_step,
        }
        if self._primary:
            self._write_results(results)
        if self.load_best_model_at_end and self._best_eval_step not in (None, final_step):
            if self.ckpt.restore(self.model, step=self._best_eval_step) is not None:
                logger.info("restored the best checkpoint (step %d, eval_loss %.5g)",
                            self._best_eval_step, self._best_eval_loss)
        self.results = results
        return results

    def _write_results(self, results: dict) -> None:
        (self.output_dir / "train_results.json").write_text(json.dumps(results, indent=2))
        if self._last_eval:
            (self.output_dir / "eval_results.json").write_text(
                json.dumps({k: v for k, v in self._last_eval.items() if v is not None}, indent=2)
            )

    def _advance(self, data_iter):
        try:
            return next(data_iter), data_iter
        except StopIteration:
            data_iter = iter(self.train_iter_factory())
            return next(data_iter), data_iter

    def evaluate(self) -> dict:
        """Loss, zero-shot ranking and the labels' accuracy over at most ``max_eval_batches`` eval batches.

        Under a data group every number is that of the global batches: the loss is the global batch's, the
        zero-shot ranking reads the global similarity with every rank's classes, and the logits and labels of
        the masked-LM and classification metrics are gathered. Before each batch every rank says whether it
        has one; the first rank without one stops all of them.
        """
        group = data_group_of(self.model)
        acc = MetricAccumulator()
        losses = []
        eval_iter = iter(self.eval_iter_factory())
        for i in range(self.max_eval_batches):
            batch = next(eval_iter, None)
            if not all_processes_have(batch is not None, group):
                if batch is not None:
                    logger.warning("evaluate: stopping at batch %d, where another rank's eval shard ended; this "
                                   "rank's remaining batches are dropped", i)
                break
            dev_batch = to_device(batch, self.device, self.packed)
            out = eval_step(self.model, dev_batch, self.packed)
            if out.loss is not None:
                losses.append(float(out.loss))

            def fetch(x):
                return (x if group is None else gather_rows(x, group)).float().cpu().numpy()

            if getattr(out, "logits_per_beatmap", None) is not None and "metadata_variation_classes" in batch:
                # the model's similarity is already the global batch's
                acc.update_zero_shot(out.logits_per_beatmap.float().cpu().numpy(),
                                     fetch(dev_batch["metadata_variation_classes"]).astype(np.int64))
            if "labels" in batch and out.logits is not None:
                if self.labels_kind == "masked_lm":
                    acc.update_masked_lm(fetch(out.logits), fetch(dev_batch["labels"]).astype(np.int64))
                elif self.labels_kind == "ranked_classification":
                    labels = fetch(dev_batch["labels"])
                    acc.update_classification(fetch(out.logits), labels.astype(np.asarray(batch["labels"]).dtype))
        result = acc.result()
        if losses:
            result["loss"] = float(np.mean(losses))
        return result

    def close(self) -> None:
        self._log_file.close()
        if self._wandb is not None:
            self._wandb.finish()


def _wandb_run(project: str, entity: Optional[str], mode: Optional[str], config: Optional[dict], output_dir: Path):
    """A ``wandb`` run, or None (logged) where the package is missing or ``wandb.init`` fails."""
    try:
        import wandb

        return wandb.init(project=project, entity=entity, mode=mode or "online", config=config, dir=str(output_dir))
    except Exception as e:  # a missing package, no network, a bad key: the run goes on with the JSONL log
        logger.warning("wandb init failed (%s); JSONL logging only", e)
        return None


def from_pretrained(model: torch.nn.Module, model_dir, allow_missing: bool = False) -> dict:
    """Copy the parameters a local HF-layout directory holds into ``model`` (the JAX trainer's
    ``from_pretrained``): any model of the family from a bundle of any other, by HF name.

    Every parameter of the model must be in the checkpoint unless ``allow_missing``; then the
    missing ones are logged and keep their values (the staged lineage: an MLM or contrastive run
    into a classifier), but a checkpoint with no parameter of the model at all raises. Parameters
    found only in the checkpoint are logged and ignored; a shape mismatch raises. Returns
    ``{"loaded", "missing", "ignored"}``, lists of names. The model is whole: a tensor-parallel run loads, then
    shards (``parallel.tensor.shard_module``).
    """
    from ..inference import read_bundle

    _, state = read_bundle(model_dir)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    ignored = sorted(set(state) - set(own))
    loaded = sorted(set(own) & set(state))
    if missing:
        if not allow_missing:
            raise ValueError(f"from_pretrained is missing params: {missing[:5]}")
        if not loaded:
            raise ValueError("from_pretrained: no overlapping params at all")
        logger.warning("from_pretrained: %d/%d params newly initialized (e.g. %s)", len(missing), len(own), missing[0])
    if ignored:
        logger.info("from_pretrained: ignoring %d checkpoint-only params (e.g. %s)", len(ignored), ignored[0])
    for name in loaded:
        if tuple(state[name].shape) != tuple(own[name].shape):
            raise ValueError(f"from_pretrained shape mismatch at {name}: {tuple(state[name].shape)} "
                             f"vs model {tuple(own[name].shape)}")
    with torch.no_grad():
        for name in loaded:
            own[name].copy_(state[name])
    logger.info("Initialized params from %s", model_dir)
    return {"loaded": loaded, "missing": missing, "ignored": ignored}
