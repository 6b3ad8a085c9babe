"""Process-group bring-up, the hybrid mesh, launchers of the processes,
and the health checks (port of ``quantized_vit_tpu/parallel/
distributed.py``: ``initialize_distributed``, ``create_hybrid_mesh``,
``HealthCheckError``, ``HealthReport``, ``collective_health_check``,
``assert_same_step``).

The JAX function brings up ``jax.distributed`` for a multi-host mesh;
here the processes (sharing one card, or on the cards of one host) join
a gloo group that carries the host-side handshakes: the exchange of CUDA
IPC handles and the barriers of :meth:`~.peers.Peers.fence`. The store
is a file (``file://``), so processes started by separate test workers
never meet on a port. The world's ranks are laid out on a (dp, tp) mesh
by :func:`~.partition.create_mesh`; a tp group is one 'model' line of
it.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
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


def reinitialize_distributed(init_method: str, num_processes: int,
                             process_id: int) -> None:
    """Leave the current gloo group (if any) and join a new one of
    ``num_processes`` at ``init_method`` (a fresh ``file://`` store: a
    store file used before hangs every rank) as rank ``process_id``; the
    re-forming of a group after a failure (``elastic.py``)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    if num_processes > 1:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=num_processes, rank=process_id,
                                timeout=_GROUP_TIMEOUT)


def world_size() -> int:
    """The processes of the default gloo group (1 with none)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def check_mesh(dp: int, tp: int) -> None:
    """Refuses a mesh (dp, tp) whose dp x tp processes are not the
    default group's."""
    world = world_size()
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"mesh (dp={dp}, tp={tp}) needs {dp * tp} "
                         f"processes; the group has {world}")


def create_hybrid_mesh(ici_shape: Sequence[int],
                       dcn_shape: Sequence[int] = (1,),
                       axis_names: Sequence[str] = ("data", "model"),
                       device="cuda"):
    """The mesh ``tuple(dcn_shape) + tuple(ici_shape)`` over the world's
    ranks (a collective call, as :func:`~.partition.create_mesh`).

    ``axis_names`` must have one entry per dimension of that shape. On
    one host every dcn factor is 1 and this is ``create_mesh``. Across
    hosts the leading (dcn) axes split over the hosts and the trailing
    (ici) axes stay inside one: ranks are numbered host by host, so the
    row-major layout keeps each model line on one host."""
    from .partition import create_mesh

    full_shape = tuple(dcn_shape) + tuple(ici_shape)
    if len(axis_names) != len(full_shape):
        raise ValueError(
            f"axis_names {tuple(axis_names)} must match dcn+ici shape "
            f"{full_shape}")
    return create_mesh(full_shape, axis_names, device=device)


class HealthCheckError(RuntimeError):
    pass


@dataclasses.dataclass
class HealthReport:
    ok: bool
    num_devices: int
    num_processes: int
    latency_s: float
    detail: str = ""


def _ones_reduced(peers) -> float:
    """Every process contributes 1 to this process's row of a
    reduce-scatter (the tensor-parallel one of ``tp_comm``: over CUDA IPC
    on the card, gloo on the CPU); returns the row's value."""
    import torch

    from .tp_comm import (plan_reduce_scatter, reduce_scatter_plain,
                          run_reduce_scatter)

    if peers.device.type != "cuda":
        return float(reduce_scatter_plain(torch.ones((peers.tp, 1)),
                                          peers)[0, 0])
    with torch.cuda.device(peers.device):
        rs = plan_reduce_scatter(1, 1, torch.float32, peers)
        rs.partials.fill_(1.0)
        return float(run_reduce_scatter(rs)[0, 0].cpu())


def collective_health_check(peers, timeout_s: float = 60.0
                            ) -> HealthReport:
    """One tiny reduction across the processes of ``peers`` (a
    :class:`~.peers.Peers`, or a :class:`~.partition.ProcessMesh`: all
    its ranks) under a watchdog (a collective call: every process makes
    it).

    Every process contributes 1; each must get tp back. A hang (a process
    that never joins, a wedged card) trips the watchdog after
    ``timeout_s`` and raises; a wrong value (a corrupt collective) raises
    with the value seen. Cheap enough to run at start-up."""
    if not isinstance(peers, Peers):
        peers = peers.world_peers()
    result: dict = {}

    def run():
        try:
            result["value"] = _ones_reduced(peers)
        except Exception as e:  # noqa: BLE001 -- reported below
            result["error"] = e

    t0 = time.time()
    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout_s)
    dt = time.time() - t0
    if worker.is_alive():
        raise HealthCheckError(
            f"collective health check hung for {timeout_s}s on {peers} — "
            "suspect a dead or stuck process")
    if "error" in result:
        raise HealthCheckError(
            f"collective health check failed: {result['error']}")
    if result["value"] != float(peers.tp):
        raise HealthCheckError(
            f"collective returned {result['value']}, expected "
            f"{float(peers.tp)} — desynchronized or corrupt collective")
    return HealthReport(ok=True, num_devices=peers.tp,
                        num_processes=peers.tp, latency_s=dt)


def assert_same_step(step: int, peers) -> None:
    """Every process contributes its restored step; min must equal max
    (catches a process resuming from a stale checkpoint). A collective
    call over ``peers`` (a Peers, or a ProcessMesh: all its ranks)."""
    if not isinstance(peers, Peers):
        peers = peers.world_peers()
    steps = peers.all_gather_object(int(step))
    if min(steps) != max(steps):
        raise HealthCheckError(
            f"processes disagree on resume step: min={min(steps)} "
            f"max={max(steps)} — stale checkpoint on some process")


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
    return _collect(target, procs, results, store, timeout_s)


def _collect(target, procs, results, store, timeout_s, first_rank=0):
    """The results of ``procs`` (ranks ``first_rank`` ..) in rank order;
    kills them all at the deadline or at the first failure, removes the
    store, raises RuntimeError with the failures."""
    tp = len(procs)
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
                rank -= first_rank
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
        raise RuntimeError(f"processes of {name} (ranks {first_rank}.."
                           f"{first_rank + tp - 1}): " + "\n".join(errors))
    return [got[r] for r in range(tp)]


class Workers:
    """Ranks 1 .. tp - 1 of a group whose rank 0 is the calling process
    (the serve CLI's mesh branch), spawned here: each runs
    ``target(rank, tp, init_method, *args)``; the caller joins the group
    with ``initialize_distributed(workers.init_method, tp, 0)``.
    ``store_dir`` holds the group's ``file://`` store."""

    def __init__(self, target, tp: int, store_dir: str, args: Sequence = ()):
        import torch.multiprocessing as mp

        store_dir = os.path.abspath(store_dir)
        os.makedirs(store_dir, exist_ok=True)
        self._store = os.path.join(store_dir,
                                   f"store_{os.getpid()}_{time.time_ns()}")
        self.init_method = f"file://{self._store}"
        self._target = target
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_child, args=(target, r, tp, self.init_method,
                                 tuple(args), self._results), daemon=True)
            for r in range(1, tp)]
        for p in self._procs:
            p.start()

    def join(self, timeout_s: float = 300.0) -> list:
        """The workers' results in rank order (ranks 1 ..); raises
        RuntimeError if one failed, died or missed ``timeout_s``."""
        return _collect(self._target, self._procs, self._results,
                        self._store, timeout_s, first_rank=1)
