"""Observability: metric scalars and device traces (port of
``quantized_vit_tpu/utils/logging.py``).

- :class:`MetricsWriter`: scalars to TensorBoard event files when
  ``torch.utils.tensorboard`` imports, always mirrored to a plain
  ``metrics.jsonl`` so a headless run needs no reader.
- :func:`profile_trace`: a context manager around ``torch.profiler``
  (the CPU, and the card's kernels when there is one) that writes a
  Chrome trace, ``trace_<time>.trace.json.gz``, into a directory.
- :func:`device_kernel_times`: per-kernel device time (us) summed from
  the newest such trace.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Dict


class MetricsWriter:
    """Scalar metrics -> TensorBoard events (if available) + JSONL."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:  # noqa: BLE001 -- JSONL only, as documented
                self._tb = None

    @property
    def has_tensorboard(self) -> bool:
        return self._tb is not None

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    prefix: str = ""):
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                self.add_scalar(f"{prefix}{k}", v, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels when CUDA is available) into ``log_dir`` as
    ``trace_<ns>.trace.json.gz`` (Chrome / Perfetto format). No-op when
    disabled."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.trace.json.gz"))


def device_kernel_times(trace_dir: str) -> Dict[str, float]:
    """Per-kernel device time (us) summed over the newest trace that
    :func:`profile_trace` wrote under ``trace_dir``: its ``kernel``
    events, named without trailing digits; {} without a trace."""
    paths = glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True)
    if not paths:
        return {}
    with gzip.open(sorted(paths)[-1]) as f:
        tr = json.load(f)
    durs: Dict[str, float] = collections.defaultdict(float)
    for e in tr.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            durs[re.sub(r"[.\d]+$", "", e["name"])] += e.get("dur", 0.0)
    return dict(durs)
