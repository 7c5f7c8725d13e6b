"""Running meters, the progress printer and the CSV logger (port of
deepinv_tpu/utils/logger.py)."""

from __future__ import annotations

import csv
import os

import numpy as np

__all__ = ["AverageMeter", "ProgressMeter", "CSVLogger"]


class AverageMeter:
    """Uneven-batch-safe running average and deviation (logger.py:11)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.sum2 = 0.0
        self.count = 0.0
        self.avg = 0.0
        self.std = 0.0
        self.vals = []

    def update(self, val, n: int = 1):
        """Add a scalar or an array of values, each counted ``n`` times
        (logger.py:28)."""
        arr = np.asarray(val)
        if arr.ndim > 0:
            self.vals += arr.tolist()
            self.val = float(np.mean(arr))
            self.sum += float(np.sum(arr) * n)
            self.sum2 += float(np.sum(arr ** 2) * n)
            self.count += float(n * arr.size)
        else:
            v = float(arr)
            self.vals.append(v)
            self.val = v
            self.sum += v * n
            self.sum2 += v ** 2 * n
            self.count += float(n)
        self.avg = self.sum / max(self.count, 1.0)
        var = self.sum2 / max(self.count, 1.0) - self.avg ** 2
        self.std = float(np.sqrt(var)) if var > 0 else 0.0

    def __str__(self):
        return f"{self.name} {self.val:.4g} (avg {self.avg:.4g})"


class ProgressMeter:
    """Prints ``prefix[batch/num_batches]`` and each meter (logger.py:55)."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [f"{self.prefix}[{batch}/{self.num_batches}]"] + [str(m) for m in self.meters]
        print("  ".join(entries))


class CSVLogger:
    """Append-mode CSV logger with a header row in a new file (logger.py:69).

    :param path: the CSV file (its directory is made).
    :param fieldnames: the columns.
    """

    def __init__(self, path: str, fieldnames):
        self.path = path
        self.fieldnames = list(fieldnames)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        new = not os.path.exists(path)
        self._fh = open(path, "a", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=self.fieldnames)
        if new:
            self._writer.writeheader()

    def log(self, **row):
        self._writer.writerow(row)
        self._fh.flush()

    def close(self):
        self._fh.close()
