"""Console metric logging + scalar writers.

Port of ``snn_automotive_object_detection_tpu/utils/logging.py``; the
all-reduce goes through ``parallel/collectives.py`` (a no-op without a
process group).

Equivalent of the reference's ``SmoothedValue`` / ``MetricLogger``
(its utils.py:19-208): windowed medians/averages, an iteration
generator printing ETA + iter/data time, and TensorBoard scalar logging
(train.py:131-146) with a JSONL fallback when tensorboard isn't importable.
``synchronize_between_processes`` mirrors the reference's
SmoothedValue.synchronize_between_processes (utils.py:37-49): count/total are
all-reduced across hosts so printed global averages are identical everywhere.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Iterable

from snn_automotive_object_detection_tpu_torch.parallel.collectives import all_reduce_sum


class SmoothedValue:
    """Track a series with a smoothing window + global statistics."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def synchronize_between_processes(self):
        """All-reduce count/total across hosts (reference utils.py:37-49).
        The windowed deque stays rank-local, like the reference's."""
        total, count = all_reduce_sum([self.total, float(self.count)])
        self.total = float(total)
        self.count = int(count)

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self):
        """Sync every meter's global stats across hosts (utils.py:146-148)."""
        for m in self.meters.values():
            m.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        total = len(iterable) if hasattr(iterable, "__len__") else None
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i - 1)
                    eta_s = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i:>4d}/{total}] eta: {eta_s} {self} "
                          f"time: {iter_time} data: {data_time}")
                else:
                    print(f"{header} [{i:>4d}] {self} time: {iter_time} "
                          f"data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{str(datetime.timedelta(seconds=int(elapsed)))} "
              f"({elapsed / max(i, 1):.4f} s / it)")


class ScalarWriter:
    """TensorBoard SummaryWriter when available, JSONL otherwise."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            self._file = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        else:
            self._file.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self._file.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._file.close()
