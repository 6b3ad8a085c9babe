"""Elastic recovery: failure detection wired to a restart on fewer
processes (port of ``quantized_vit_tpu/parallel/elastic.py``).

  detect   ``collective_health_check`` watchdog / any HealthCheckError
  shrink   :func:`shrink_mesh`: the largest valid (data, model) layout
           of the surviving ranks (the model axis kept when it divides,
           else folded into data)
  regroup  the survivors leave the gloo group and form a new one on a
           fresh ``file://`` store (a store file used before hangs every
           rank); ranks outside the new layout return
  restore  ``restore_sharded_checkpoint`` onto the new mesh (shards
           re-placed per the partition rules)
  resume   re-enter the step loop at the checkpoint's ``extra["step"]``

:func:`run_with_elastic_recovery` is the supervisor loop. The failure
signal comes from the watchdog (or, in tests, an injected
HealthCheckError); the surviving ranks from ``surviving_ranks_fn``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import uuid
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .distributed import (HealthCheckError, collective_health_check,
                          reinitialize_distributed)
from .partition import ProcessMesh, create_mesh
from .sharded_ckpt import restore_sharded_checkpoint


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A layout of (old) global ranks on named axes: ``ranks`` [dp, tp]."""

    ranks: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)


def shrink_mesh(ranks: Sequence[int],
                axis_names: Sequence[str] = ("data", "model"),
                model_parallel: int = 1) -> MeshLayout:
    """Largest valid (data, model) layout of ``ranks``: the largest power
    of two of them (so the data axis stays batch-divisible), keeping
    ``model_parallel``-way TP when that count allows it, else folding the
    model axis into data."""
    ranks = list(ranks)
    if not ranks:
        raise ValueError("no surviving ranks")
    n = 2 ** int(math.log2(len(ranks)))
    tp = model_parallel if n % model_parallel == 0 else 1
    return MeshLayout(np.array(ranks[:n]).reshape(n // tp, tp),
                      tuple(axis_names))


def _leave(mesh: Optional[ProcessMesh]) -> None:
    """Drop the mesh's peers without a collective (a peer may be gone)."""
    if mesh is not None:
        mesh._peers.clear()


def elastic_restore(ckpt_path: str, surviving_ranks: Sequence[int],
                    axis_names: Sequence[str] = ("data", "model"),
                    model_parallel: int = 1, rules=None,
                    health_timeout_s: float = 60.0, *,
                    init_method: str, rank: int, device="cuda"
                    ) -> Tuple[Any, dict, Optional[ProcessMesh]]:
    """Shrink to the survivors, re-form the group at ``init_method`` (a
    fresh ``file://`` store), restore the sharded checkpoint onto the new
    mesh and health-check it. ``rank``: this process's rank in the group
    it leaves. Returns (params, extra, mesh); a rank outside the new
    layout leaves the group and gets (None, {}, None)."""
    layout = shrink_mesh(surviving_ranks, axis_names, model_parallel)
    order = [int(r) for r in layout.ranks.reshape(-1)]
    if rank not in order:
        reinitialize_distributed(init_method, 1, 0)
        return None, {}, None
    reinitialize_distributed(init_method, layout.size, order.index(rank))
    mesh = create_mesh(layout.ranks.shape, layout.axis_names, device=device)
    kw = {"rules": rules} if rules is not None else {}
    params, extra = restore_sharded_checkpoint(ckpt_path, mesh=mesh, **kw)
    collective_health_check(mesh, timeout_s=health_timeout_s)
    return params, extra or {}, mesh


def run_with_elastic_recovery(
    step_fn: Callable[[Any, ProcessMesh, int], Any],
    params: Any,
    mesh: ProcessMesh,
    ckpt_path: str,
    *,
    steps: int,
    start_step: int = 0,
    health_fn: Optional[Callable[[ProcessMesh], Any]] = None,
    health_every: int = 1,
    surviving_ranks_fn: Optional[Callable[[], Sequence[int]]] = None,
    model_parallel: int = 1,
    rules=None,
    max_failures: int = 1,
    store_dir: Optional[str] = None,
):
    """Supervisor loop: run steps, health-check, recover on failure.

    step_fn(params, mesh, step) -> params. health_fn defaults to
    ``collective_health_check``; tests inject failures through it.
    surviving_ranks_fn supplies the ranks (of the group at the failure)
    that survived (default: all of them). A recovery re-forms the group
    on a fresh store in ``store_dir`` (default: beside ``ckpt_path``),
    named by a token rank 0 draws at the start. Every rank calls it.

    Returns (params, mesh, failures_handled); a rank left out of the
    shrunken layout returns (None, None, failures_handled) right after
    the failure."""
    health = health_fn or (lambda m: collective_health_check(m))
    store_dir = os.path.abspath(store_dir or os.path.dirname(
        os.path.abspath(ckpt_path)))
    os.makedirs(store_dir, exist_ok=True)
    token = mesh.world_peers().all_gather_object(
        uuid.uuid4().hex if mesh.rank == 0 else None)[0]
    failures = 0
    step = start_step
    while step < steps:
        try:
            if health_every and step % health_every == 0:
                health(mesh)
            params = step_fn(params, mesh, step)
            step += 1
        except HealthCheckError:
            failures += 1
            if failures > max_failures:
                raise
            survivors = (list(surviving_ranks_fn()) if surviving_ranks_fn
                         else list(range(mesh.size)))
            rank = mesh.rank
            _leave(mesh)
            store = os.path.join(store_dir, f"elastic_{token}_{failures}")
            params, extra, mesh = elastic_restore(
                ckpt_path, survivors, mesh.axis_names,
                model_parallel=model_parallel, rules=rules,
                init_method=f"file://{store}", rank=rank,
                device=mesh.device)
            if mesh is None:
                return None, None, failures
            # resume from the checkpoint's step, not the failed one
            step = int(extra.get("step", start_step))
    return params, mesh, failures
