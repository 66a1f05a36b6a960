"""Multiprocess sample loader.

Copy of the JAX package's ``data/loader.py``: host-side Python workers each own
a strided shard of the dataset and stream processed samples over a queue; the
parent collates fixed-shape numpy batches ready for device transfer. Each worker
writes its own log file. ``int8_ipc`` quantises the mel features to int8 for the
queue hop (a quarter of the pickled bytes); the samples keep the codes, which
``extract_embeddings`` takes as they are on its int8 wire and dequantises on the
others.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
import os
import queue
from typing import Callable, Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

_STOP = "__stop__"
_IPC_SCALE = "_input_features_ipc_scale"


def batch_samples(samples: list[dict]) -> dict:
    """Stack same-shape sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def _quantize_features_for_ipc(sample: dict) -> dict:
    """Symmetric per-window int8 of ``input_features`` for the queue hop.

    The mel block dominates a sample's pickle (a full 80 x 3000 float32 window
    is 960,000 bytes); int8 cuts it 4x. The scale is ``max|x| / 127`` and the
    codes are ``rint(x * (1 / scale))``, so the worst error is about half a
    scale. The extraction tool's int8 device wire quantises with the same
    absmax scale (dividing by it) and takes these codes as they are. Raw-PCM
    samples are left alone (quantising waveforms would shift the on-device mel).
    """
    f = sample.get("input_features")
    if not isinstance(f, np.ndarray) or f.dtype != np.float32:
        return sample
    s = float(np.max(np.abs(f))) / 127.0 or 1.0
    out = dict(sample)
    out["input_features"] = np.rint(f * np.float32(1.0 / s)).astype(np.int8)
    out[_IPC_SCALE] = np.float32(s)
    return out


def _dequantize_features_from_ipc(sample: dict) -> dict:
    """The inverse of :func:`_quantize_features_for_ipc`, in place; also on a batch of such samples
    (``batch_samples`` stacks the scales)."""
    s = sample.pop(_IPC_SCALE, None)
    if s is None:
        return sample
    f = sample["input_features"]
    s = np.asarray(s, np.float32)
    sample["input_features"] = f.astype(np.float32) * s.reshape(s.shape + (1,) * (f.ndim - s.ndim))
    return sample


def _counts_since(dataset, start: Optional[dict]) -> Optional[dict]:
    counts = getattr(dataset, "host_counts", None)
    if counts is None:
        return None
    return {k: v - (start or {}).get(k, 0) for k, v in counts.items()}


def _worker_main(dataset_factory, worker_id: int, num_workers: int, out_queue, log_dir: Optional[str],
                 int8_ipc: bool = False):
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s - %(levelname)s - %(message)s",
            filename=os.path.join(log_dir, f"worker_{worker_id}.log"),
            filemode="w",
        )
        logging.captureWarnings(True)
        logging.info("Worker %d started.", worker_id)
    dataset, start = None, None
    try:
        dataset = dataset_factory(worker_id, num_workers)
        start = dict(getattr(dataset, "host_counts", None) or {})
        for sample in dataset:
            out_queue.put(_quantize_features_for_ipc(sample) if int8_ipc else sample)
    except Exception:  # pragma: no cover - worker crash path
        logging.exception("Worker %d crashed", worker_id)
    finally:
        out_queue.put((_STOP, worker_id, _counts_since(dataset, start)))


class SampleLoader:
    """Stream samples from ``num_workers`` processes (0 = inline).

    ``dataset_factory(worker_id, num_workers)`` returns an iterable of sample
    dicts; with workers it crosses a pickle boundary (spawn), so it must be a
    picklable object, not a closure. ``int8_ipc``: workers send the mel
    features as int8 codes, and the samples keep them with their per-window
    scale under ``_input_features_ipc_scale``
    (:func:`_dequantize_features_from_ipc` turns them back). After an epoch,
    ``host_counts`` sums the datasets' ``host_counts`` over its run (beatmaps
    parsed and audio files decoded by each route), where they have them.
    """

    def __init__(
        self,
        dataset_factory: Callable[[int, int], Iterator[dict]],
        num_workers: int = 0,
        queue_size: int = 64,
        log_dir: Optional[str] = "dataloader",
        idle_timeout: float = 600.0,
        startup_timeout: float = 600.0,
        int8_ipc: bool = False,
    ):
        self.dataset_factory = dataset_factory
        self.num_workers = num_workers
        self.queue_size = queue_size
        self.log_dir = log_dir
        self.idle_timeout = idle_timeout
        self.startup_timeout = startup_timeout
        self.int8_ipc = int8_ipc
        self.host_counts: dict = {}

    def _add_counts(self, counts: Optional[dict]) -> None:
        for k, v in (counts or {}).items():
            self.host_counts[k] = self.host_counts.get(k, 0) + v

    def __iter__(self) -> Iterator[dict]:
        self.host_counts = {}
        if self.num_workers <= 0:
            dataset = self.dataset_factory(0, 1)
            start = dict(getattr(dataset, "host_counts", None) or {})
            try:
                yield from dataset  # no queue hop: ``int8_ipc`` has nothing to do
            finally:
                self._add_counts(_counts_since(dataset, start))
            return

        ctx = mp.get_context("spawn")
        out_queue = ctx.Queue(self.queue_size)
        procs = [
            ctx.Process(
                target=_worker_main,
                args=(self.dataset_factory, i, self.num_workers, out_queue, self.log_dir, self.int8_ipc),
                daemon=True,
            )
            for i in range(self.num_workers)
        ]
        for p in procs:
            p.start()

        done: set[int] = set()
        idle = 0.0
        received_any = False
        try:
            while len(done) < self.num_workers:
                try:
                    # short poll so killed workers (which never post their
                    # stop sentinel) are detected by is_alive() instead of
                    # stalling the epoch for the whole idle timeout
                    item = out_queue.get(timeout=5)
                except queue.Empty:
                    for i, p in enumerate(procs):
                        if i not in done and not p.is_alive() and out_queue.empty():
                            done.add(i)
                            logger.warning(
                                "Loader worker %d died (exitcode %s) without posting its stop sentinel; "
                                "continuing with the remaining workers", i, p.exitcode,
                            )
                    # liveness polling alone can spin forever on a wedged-but-
                    # alive worker: keep an overall bound as a second line of
                    # defense. Before the first item arrives the bound is the
                    # (larger) startup grace: spawn children re-import the
                    # factory's module, which can take tens of seconds.
                    idle += 5.0
                    bound = self.idle_timeout if received_any else max(
                        self.idle_timeout or 0.0, self.startup_timeout or 0.0
                    )
                    if bound and idle >= bound:
                        logger.warning(
                            "Loader queue idle for %.0f s with %d worker(s) still alive; stopping the epoch early",
                            idle, self.num_workers - len(done),
                        )
                        break
                    continue
                idle = 0.0
                received_any = True
                if isinstance(item, tuple) and len(item) == 3 and isinstance(item[0], str) and item[0] == _STOP:
                    done.add(item[1])
                    self._add_counts(item[2])
                    continue
                yield item
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)


def batched_loader(loader, batch_size: int, drop_last: bool = True) -> Iterator[dict]:
    """Collate a sample stream into stacked numpy batches."""
    buf: list[dict] = []
    for sample in loader:
        buf.append(sample)
        if len(buf) == batch_size:
            yield batch_samples(buf)
            buf = []
    if buf and not drop_last:
        yield batch_samples(buf)
