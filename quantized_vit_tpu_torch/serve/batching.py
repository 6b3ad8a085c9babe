"""Continuous batching for single-image inference requests, and the
front that spreads requests over several serving backends (port of
``quantized_vit_tpu/serve/batching.py``).

Requests queue up; one dispatcher thread forms batches, padded to the
smallest bucket that holds them (the batch sizes seen at warm-up), and
flushes when ``max_batch`` requests wait or the oldest has waited
``max_delay_ms``. ``forward_fn`` returns its result without waiting for
the device (a CUDA tensor is enqueued work); a completer thread
materializes it on the host and resolves the per-request futures, so host
assembly of batch N+1 overlaps device work on batch N. ``max_in_flight``
bounds the outstanding batches.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np


def _buckets_upto(max_batch: int) -> List[int]:
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return out


def _to_host(out) -> np.ndarray:
    if hasattr(out, "detach"):  # a torch tensor, possibly on the GPU
        return out.detach().to("cpu").numpy()
    return np.asarray(out)


class ContinuousBatcher:
    """Batches concurrent single-image requests into bucketed calls.

    forward_fn: [B, ...] numpy batch -> [B, ...] outputs (numpy or tensor).
    """

    def __init__(self, forward_fn: Callable, max_batch: int = 8,
                 max_delay_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None,
                 max_in_flight: int = 2):
        self.forward_fn = forward_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = max_delay_ms / 1e3
        self.buckets = sorted(buckets) if buckets else _buckets_upto(max_batch)
        if self.buckets[-1] < self.max_batch:
            self.buckets.append(self.max_batch)
        self._q: "queue.Queue" = queue.Queue()
        self._done_q: "queue.Queue" = queue.Queue(maxsize=max(1, max_in_flight))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "padded": 0,
                      "batch_hist": {}}

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._thread.start()
        self._completer.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._completer is not None:
            self._done_q.put(None)  # sentinel after dispatcher exit
            self._completer.join(timeout=10)
            self._completer = None
        # reject anything that raced past the dispatcher's exit
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("batcher stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one sample (no batch dim); resolves to its output row."""
        fut: Future = Future()
        if self._stop.is_set() and self._thread is None:
            fut.set_exception(RuntimeError("batcher stopped"))
            return fut
        self._q.put((image, fut, time.monotonic()))
        self.stats["requests"] += 1
        return fut

    def queue_depth(self) -> int:
        return self._q.qsize()

    def warmup(self, example: np.ndarray):
        """Run every bucket shape once before serving."""
        for b in self.buckets:
            batch = np.broadcast_to(example[None], (b, *example.shape))
            _to_host(self.forward_fn(np.ascontiguousarray(batch)))

    def _collect(self) -> List:
        """Block for the first request, then drain until a flush
        condition; already-queued requests are drained unconditionally so
        a backlog still forms full batches."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        pending = [first]
        deadline = first[2] + self.max_delay_s
        while len(pending) < self.max_batch:
            try:
                pending.append(self._q.get_nowait())
                continue
            except queue.Empty:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                pending.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return pending

    def _run(self):
        while not self._stop.is_set() or not self._q.empty():
            pending = self._collect()
            if not pending:
                continue
            n = len(pending)
            bucket = next(b for b in self.buckets if b >= n)
            images = np.stack([p[0] for p in pending])
            if bucket != n:
                pad = np.repeat(images[:1], bucket - n, axis=0)
                images = np.concatenate([images, pad], axis=0)
                self.stats["padded"] += bucket - n
            try:
                out = self.forward_fn(images)
            except Exception as e:  # dispatch-time failure
                for _, fut, _ in pending:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._done_q.put((out, pending))  # blocks at max_in_flight
            self.stats["batches"] += 1
            self.stats["batch_hist"][bucket] = (
                self.stats["batch_hist"].get(bucket, 0) + 1)

    def _complete_loop(self):
        while True:
            item = self._done_q.get()
            if item is None:
                return
            out, pending = item
            try:
                arr = _to_host(out)  # waits for the device
                for i, (_, fut, _) in enumerate(pending):
                    fut.set_result(arr[i])
            except Exception as e:  # device-side failure surfaces here
                for _, fut, _ in pending:
                    if not fut.done():
                        fut.set_exception(e)


class MultiHostFrontend:
    """Request fan-out across serving backends (processes, hosts or
    cards). Data-parallel serving shards requests, not tensors: each
    backend holds its own replica of the weights behind its own batcher,
    and no backend talks to another. A request goes to the least-loaded
    backend by ``queue_depth()``, round robin among equally loaded ones.
    A backend is anything with the batcher's ``start``, ``stop``,
    ``submit``, ``stats`` and ``queue_depth``: an in-process
    :class:`ContinuousBatcher` or an :class:`~.rpc.RpcBackendStub` of a
    serving process."""

    def __init__(self, backends: Sequence[ContinuousBatcher]):
        if not backends:
            raise ValueError("need at least one backend")
        self.backends = list(backends)
        self._rr = 0
        self._lock = threading.Lock()

    def start(self):
        for b in self.backends:
            b.start()
        return self

    def stop(self):
        for b in self.backends:
            b.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def submit(self, image: np.ndarray) -> Future:
        with self._lock:
            loads = [b.queue_depth() for b in self.backends]
            lo = min(loads)
            candidates = [i for i, v in enumerate(loads) if v == lo]
            pick = candidates[self._rr % len(candidates)]
            self._rr += 1
        return self.backends[pick].submit(image)

    @property
    def stats(self):
        return {i: b.stats for i, b in enumerate(self.backends)}
