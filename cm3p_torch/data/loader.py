"""Multiprocess sample loader.

Copy of the JAX package's ``data/loader.py``: host-side Python workers each own
a strided shard of the dataset and stream processed samples over a queue; the
parent collates fixed-shape numpy batches ready for device transfer. Each worker
writes its own log file. The JAX package's optional int8 queue hop for the mel
features is left out with the other int8 mel wires.
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


def batch_samples(samples: list[dict]) -> dict:
    """Stack same-shape sample dicts into one batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def _worker_main(dataset_factory, worker_id: int, num_workers: int, out_queue, log_dir: Optional[str]):
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
    try:
        dataset = dataset_factory(worker_id, num_workers)
        for sample in dataset:
            out_queue.put(sample)
    except Exception:  # pragma: no cover - worker crash path
        logging.exception("Worker %d crashed", worker_id)
    finally:
        out_queue.put((_STOP, worker_id))


class SampleLoader:
    """Stream samples from ``num_workers`` processes (0 = inline).

    ``dataset_factory(worker_id, num_workers)`` returns an iterable of sample
    dicts; with workers it crosses a pickle boundary (spawn), so it must be a
    picklable object, not a closure.
    """

    def __init__(
        self,
        dataset_factory: Callable[[int, int], Iterator[dict]],
        num_workers: int = 0,
        queue_size: int = 64,
        log_dir: Optional[str] = "dataloader",
        idle_timeout: float = 600.0,
        startup_timeout: float = 600.0,
    ):
        self.dataset_factory = dataset_factory
        self.num_workers = num_workers
        self.queue_size = queue_size
        self.log_dir = log_dir
        self.idle_timeout = idle_timeout
        self.startup_timeout = startup_timeout

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers <= 0:
            yield from self.dataset_factory(0, 1)
            return

        ctx = mp.get_context("spawn")
        out_queue = ctx.Queue(self.queue_size)
        procs = [
            ctx.Process(
                target=_worker_main,
                args=(self.dataset_factory, i, self.num_workers, out_queue, self.log_dir),
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
                if isinstance(item, tuple) and len(item) == 2 and isinstance(item[0], str) and item[0] == _STOP:
                    done.add(item[1])
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
