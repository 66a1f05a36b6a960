"""Evaluation metric accumulation.

Host-side numpy port of the reference's ``compute_metrics``
(``train.py:38-160``): classification acc/top-5, masked-LM acc/top-5, and
the zero-shot metadata-variation ranking — per variation class, does the
original metadata (class 0) outscore its hard-negative variations on the
matching beatmap's logits?

The port's own copy of the JAX package's ``train/metrics.py``.
"""
from __future__ import annotations

import numpy as np

VARIATION_CLASSES = {
    -200: "classification",
    -100: "masked_lm",
    -1: "padding",
    0: "original",
    1: "year",
    2: "status",
    3: "tags",
    4: "mapper",
}
CLASSES_RANGE = range(1, 5)
CLASSES_WITH_TOP5 = [-100, 3, 4]


class MetricAccumulator:
    """Accumulate batch metrics; ``result()`` finalizes and resets."""

    def __init__(self):
        self._acc: dict[int, dict[str, int]] = {}

    def _bucket(self, var_class: int) -> dict[str, int]:
        return self._acc.setdefault(var_class, {"correct": 0, "total": 0, "top5_correct": 0})

    def update_classification(self, logits: np.ndarray, labels: np.ndarray) -> None:
        logits = np.asarray(logits, np.float32)
        labels = np.asarray(labels)
        preds = logits.argmax(-1)
        k = min(5, logits.shape[-1])
        top5 = np.argpartition(-logits, k - 1, axis=-1)[..., :k]
        b = self._bucket(-200)
        b["correct"] += int((preds == labels).sum())
        b["total"] += int(labels.shape[0])
        b["top5_correct"] += int((top5 == labels[:, None]).any(-1).sum())

    def update_masked_lm(self, logits: np.ndarray, labels: np.ndarray) -> None:
        logits = np.asarray(logits, np.float32)
        labels = np.asarray(labels)
        mask = labels != -100
        if not mask.any():
            return
        preds = logits.argmax(-1)
        k = min(5, logits.shape[-1])
        top5 = np.argpartition(-logits, k - 1, axis=-1)[..., :k]
        b = self._bucket(-100)
        b["correct"] += int((preds[mask] == labels[mask]).sum())
        b["total"] += int(mask.sum())
        b["top5_correct"] += int((top5[mask] == labels[mask][:, None]).any(-1).sum())

    def update_zero_shot(self, logits_per_beatmap: np.ndarray, metadata_variation_classes: np.ndarray) -> None:
        """logits_per_beatmap: (B, B, V); classes: (B, V)."""
        logits_per_beatmap = np.asarray(logits_per_beatmap, np.float32)
        classes = np.asarray(metadata_variation_classes)
        batch_size = logits_per_beatmap.shape[0]

        for var_class in CLASSES_RANGE:
            b = self._bucket(var_class)
            for i in range(batch_size):
                class_mask = (classes[i] == var_class) | (classes[i] == 0)
                if class_mask.sum() <= 1:
                    continue
                group_logits = logits_per_beatmap[i, i][class_mask]
                group_classes = classes[i][class_mask]
                b["total"] += 1
                if group_classes[int(np.argmax(group_logits))] == 0:
                    b["correct"] += 1
                if var_class in CLASSES_WITH_TOP5:
                    k = min(5, group_logits.shape[0])
                    top5 = np.argpartition(-group_logits, k - 1)[:k]
                    if (group_classes[top5] == 0).any():
                        b["top5_correct"] += 1

    def result(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for var_class, m in self._acc.items():
            name = VARIATION_CLASSES.get(var_class, f"class_{var_class}")
            if m["total"] > 0:
                out[f"accuracy_{name}"] = m["correct"] / m["total"]
                if var_class in CLASSES_WITH_TOP5:
                    out[f"top5_accuracy_{name}"] = m["top5_correct"] / m["total"]
            else:
                out[f"accuracy_{name}"] = None
                if var_class in CLASSES_WITH_TOP5:
                    out[f"top5_accuracy_{name}"] = None
        self._acc = {}
        return out
