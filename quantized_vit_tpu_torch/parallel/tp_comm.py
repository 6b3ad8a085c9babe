"""The collectives of the 'model' axis in tensor-parallel serving: the
counterpart of ``jax.lax.all_gather`` and ``jax.lax.psum_scatter`` inside
the JAX package's ``shard_map`` (``serve/vit_tp.py:277, 291, 298, 309``).

The tp processes of a :class:`~.peers.Peers` each hold the rows of their
own images (a sequence shard of M_loc rows); M_grp = M_loc x tp rows is
the group's.

- :func:`run_all_gather`: int8 levels [M_loc, D] -> [M_grp, D] in rank
  order, by K14 (:func:`~..ops.ring_gather.run_gather_rows`: each process
  pushes its rows into its slot of every peer's output, through the
  peers' buffers mapped by CUDA IPC). The buffers and the copy jobs are
  made once per batch size (:func:`plan_all_gather`, a collective call).
  Activation rows are not held to the weight shards' 32-row tile: the JAX
  all-gather takes any row count, and M_loc = b_loc x 208.
- :func:`run_reduce_scatter`: partials [M_grp, D] in the comm dtype ->
  [M_loc, D], the sum over the processes of their partials' rows of this
  process. Each process writes its partials into its own buffer, which
  the peers map (:func:`plan_reduce_scatter`); a fence; each process sums
  its own row range over every process's buffer in rank order, in the
  comm dtype (plain PyTorch adds on the mapped views: the JAX package
  computes this outside any Pallas kernel); a fence, so no process
  overwrites a partials buffer a peer still reads.

Every collective is fenced on both sides (:meth:`~.peers.Peers.fence`):
K14's launch sits between two fences, the reduce-scatter's sum too.

Plain versions, for CPU tensors over the gloo group:
:func:`all_gather_plain` (a gloo all-gather of the bytes) and
:func:`reduce_scatter_plain` (a gloo all-gather of the partials, then the
same rank-order sum). At tp = 1 a gather is a copy (K14 on the card) and
a reduce-scatter the partials themselves.

:data:`COLLECTIVES` counts the collectives issued, by (kind, payload
dtype), as the JAX package's audit counts those of the compiled step.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import torch

# (kind, dtype name) -> collectives issued since reset_collectives()
COLLECTIVES: collections.Counter = collections.Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def count_collective(kind: str, dtype: torch.dtype, n: int = 1) -> None:
    """Counts ``n`` collectives of ``kind`` ('all_gather',
    'reduce_scatter') carrying ``dtype``."""
    COLLECTIVES[(kind, str(dtype).replace("torch.", ""))] += n


def _tp(peers) -> Tuple[int, int]:
    return (0, 1) if peers is None else (peers.rank, peers.tp)


def _rank_sum(parts, rows: slice) -> torch.Tensor:
    """The sum of ``parts[p][rows]`` over p in rank order, in their dtype
    (each add rounds to it, on the card and on the CPU alike)."""
    acc = parts[0][rows].clone()
    for p in parts[1:]:
        acc += p[rows]
    return acc


def all_gather_plain(x: torch.Tensor, peers=None) -> torch.Tensor:
    """Plain version of :func:`run_all_gather` on a CPU ``x`` [M_loc, D]:
    [M_grp, D], the processes' rows in rank order (a copy at tp = 1)."""
    _, tp = _tp(peers)
    count_collective("all_gather", x.dtype)
    if tp == 1:
        return x.clone()
    return torch.cat(peers.all_gather(x))


def reduce_scatter_plain(part: torch.Tensor, peers=None) -> torch.Tensor:
    """Plain version of :func:`run_reduce_scatter` on a CPU ``part``
    [M_grp, D]: this process's rows [rank * M_loc, (rank + 1) * M_loc)
    summed over the processes' partials in rank order, in ``part``'s
    dtype."""
    rank, tp = _tp(peers)
    m_grp = part.shape[0]
    if m_grp % tp:
        raise ValueError(f"reduce_scatter: {m_grp} rows over tp={tp}")
    count_collective("reduce_scatter", part.dtype)
    m_loc = m_grp // tp
    parts = [part] if tp == 1 else peers.all_gather(part)
    return _rank_sum(parts, slice(rank * m_loc, (rank + 1) * m_loc))


@dataclasses.dataclass(frozen=True)
class AllGather:
    """An int8 all-gather of M_loc rows of width D, prepared once by
    :func:`plan_all_gather`: this process's ``levels`` [M_loc, D] (K14's
    source: write the rows there), its ``gathered`` [M_grp, D] (the peers
    write into it) and K14's plan."""

    levels: torch.Tensor
    gathered: torch.Tensor
    plan: object  # ops.ring_gather.GatherPlan


def plan_all_gather(m_loc: int, d: int, peers=None,
                    device=None) -> AllGather:
    """The buffers and K14's copy jobs of an all-gather of int8 [m_loc, d]
    rows on a CUDA ``device`` (``peers.device`` when None). At tp > 1 a
    collective call: every process makes it, for the same shape, in the
    same order (the CUDA IPC handles of the outputs are exchanged)."""
    from ..ops.ring_gather import plan_gather_rows

    _, tp = _tp(peers)
    dev = torch.device(device if device is not None else peers.device)
    levels = torch.empty((m_loc, d), dtype=torch.int8, device=dev)
    gathered = torch.empty((m_loc * tp, d), dtype=torch.int8, device=dev)
    plan = plan_gather_rows([levels], [gathered],
                            peers=peers if tp > 1 else None,
                            sublane_rows=False)
    return AllGather(levels=levels, gathered=gathered, plan=plan)


def run_all_gather(ag: AllGather) -> torch.Tensor:
    """K14 of ``ag.levels`` into every process's ``gathered``, between two
    fences; returns this process's ``gathered`` [M_grp, D]."""
    from ..ops.ring_gather import run_gather_rows

    count_collective("all_gather", ag.levels.dtype)
    run_gather_rows(ag.plan)
    return ag.gathered


@dataclasses.dataclass(frozen=True)
class ReduceScatter:
    """A reduce-scatter of [M_grp, D] partials in one dtype, prepared once
    by :func:`plan_reduce_scatter`: this process's ``partials`` (write
    them there) and every process's, mapped into this one (``views``, in
    rank order)."""

    partials: torch.Tensor
    views: Tuple[torch.Tensor, ...]
    m_loc: int
    rank: int
    peers: object


def plan_reduce_scatter(m_loc: int, d: int, dtype, peers=None,
                        device=None) -> ReduceScatter:
    """The partials buffer [m_loc * tp, d] of ``dtype`` on a CUDA
    ``device`` (``peers.device`` when None), and the peers' mapped. At tp
    > 1 a collective call, as :func:`plan_all_gather`."""
    rank, tp = _tp(peers)
    dev = torch.device(device if device is not None else peers.device)
    if dev.type != "cuda":
        raise ValueError(f"plan_reduce_scatter: CUDA buffers only, got "
                         f"{dev}; CPU tensors take reduce_scatter_plain")
    partials = torch.empty((m_loc * tp, d), dtype=dtype, device=dev)
    views = peers.open([partials]) if tp > 1 else [[partials]]
    return ReduceScatter(partials=partials,
                         views=tuple(v[0] for v in views), m_loc=m_loc,
                         rank=rank, peers=peers if tp > 1 else None)


def _fence(peers: Optional[object]) -> None:
    if peers is not None:
        peers.fence()


def run_reduce_scatter(rs: ReduceScatter) -> torch.Tensor:
    """The reduce-scatter of the partials every process wrote into its
    ``rs.partials``: a fence, this process's rows summed over the
    processes' buffers in rank order (a new tensor [M_loc, D]), a fence."""
    count_collective("reduce_scatter", rs.partials.dtype)
    _fence(rs.peers)
    out = _rank_sum(rs.views, slice(rs.rank * rs.m_loc,
                                    (rs.rank + 1) * rs.m_loc))
    _fence(rs.peers)
    return out
