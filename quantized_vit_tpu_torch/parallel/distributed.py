"""Process-group bring-up for the 'model' axis, and a launcher of its
processes (port of ``quantized_vit_tpu/parallel/distributed.py:
initialize_distributed``).

The JAX function brings up ``jax.distributed`` for a multi-host mesh;
here tp processes (sharing one card, or on the cards of one host) join a
gloo group that carries the host-side handshakes of FSDP serving: the
exchange of CUDA IPC handles and the barriers of
:meth:`~.peers.Peers.fence`. The store is a file (``file://``), so
processes started by separate test workers never meet on a port.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
from datetime import timedelta
from typing import Optional, Sequence

from ..device import resolve_device
from .peers import Peers

# a gloo call that waits longer than this raises (a peer died or hangs)
_GROUP_TIMEOUT = timedelta(seconds=300)


def initialize_distributed(init_method: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> Peers:
    """This process's :class:`~.peers.Peers`: with ``num_processes`` > 1,
    the gloo group of ``num_processes`` processes at ``init_method``
    (``file://<path>``; the file must not exist yet) with rank
    ``process_id``; single-process (``num_processes`` None or 1) a tp = 1
    axis with no group. ``device``: this process's device (the entry
    points' default, the card; raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    tp = num_processes or 1
    if tp == 1:
        return Peers(0, 1, dev)
    if init_method is None or process_id is None:
        raise ValueError("initialize_distributed: num_processes > 1 needs "
                         "init_method and process_id")
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init_method, world_size=tp,
                            rank=process_id, timeout=_GROUP_TIMEOUT)
    return Peers(process_id, tp, dev)


def _child(target, rank, tp, init_method, args, results):
    try:
        results.put((rank, True, target(rank, tp, init_method, *args)))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run_processes(target, tp: int, store_dir: str, args: Sequence = (),
                  timeout_s: float = 300.0) -> list:
    """Run ``target(rank, tp, init_method, *args)`` in ``tp`` spawned
    processes and return their results in rank order (picklable by plain
    pickle: numpy arrays, not tensors, which a queue would share through
    the sender's file descriptors). ``init_method`` is a fresh
    ``file://`` store in ``store_dir`` for :func:`initialize_distributed`.
    Every process is killed at the deadline, or as soon as one fails; a
    process that raises, dies or misses the deadline makes this raise
    (RuntimeError, with its traceback)."""
    import torch.multiprocessing as mp

    # absolute: a relative path would make the file:// URL's first
    # component a host name, and no rank would find the store
    store_dir = os.path.abspath(store_dir)
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    init_method = f"file://{store}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(target, r, tp, init_method,
                                              tuple(args), results),
                         daemon=True) for r in range(tp)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, errors = {}, []
    try:
        while len(got) + len(errors) < tp:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"deadline of {timeout_s} s passed with ranks "
                              f"{sorted(set(range(tp)) - set(got))} "
                              "unfinished")
                break
            try:
                rank, ok, res = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    errors.append(f"ranks {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                    break
                continue
            if not ok:  # the others may wait on it: stop them all
                errors.append(f"rank {rank}:\n{res}")
                break
            got[rank] = res
        if not errors:
            for p in procs:
                p.join(timeout=max(1.0, min(30.0,
                                            deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if os.path.exists(store):
            os.remove(store)
    if errors:
        name = getattr(target, "__name__", target)
        raise RuntimeError(f"run_processes({name}, tp={tp}): "
                           + "\n".join(errors))
    return [got[r] for r in range(tp)]
