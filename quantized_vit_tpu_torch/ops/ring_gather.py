"""The in-kernel weight all-gather of FSDP serving: kernels K14 and K15.

Port of ``quantized_vit_tpu/ops/ring_gather.py``. The row shards of the
'model' axis are gathered back to whole weights by the processes of a
:class:`~..parallel.Peers` (one per shard; ``peers=None`` is tp = 1).

- :func:`gather_rows` (K14, ``csrc/ring_gather.cu``) replaces
  ``gather_rows`` (``pallas_call`` at ring_gather.py:154): each shard
  [R_j, N_j] becomes [R_j * tp, N_j] in rank order. Each process copies
  its shard into its own row slot and pushes it into the same slot of
  every peer's output, through the peers' buffers that CUDA IPC mapped
  into it; the bytes are copied opaquely (int8 levels, packed int4,
  bf16). Plain version: :func:`gather_rows_plain` (a gloo all-gather of
  the bytes).
- :func:`fused_mlp_gather` (K15) replaces ``fused_mlp_gather``
  (``pallas_call`` at ring_gather.py:314): K2's kernel
  (``csrc/fused_mlp.cu``, at :func:`~.fused.mlp_layout`'s work split, so
  its output is K2's bit for bit, at any width) with the gather of the
  next block's shards folded into the same cooperative launch: every
  block of the MLP's grid copies its chunks of the gather
  (:func:`~.fused.gather_split`) after its LayerNorm rows. Plain
  version: :func:`fused_mlp_gather_plain`.

Ordering. The TPU kernel's neighbour barrier (no device writes into a
peer's buffer while the peer's earlier kernels may still read it) and
its semaphore drain (nobody reads a gathered buffer before every push
into it landed) become :meth:`~..parallel.Peers.fence` before and after
the launch: each process records an interprocess event on its stream, a
gloo barrier orders the records on the host, and each stream waits on its
peers' events. No kernel spins on another process: two processes sharing
one card time-slice, and a spinning kernel could hold its slice.

As in ``fused.py``, a call splits into the prepared side (``plan_*``: the
checks, the copy jobs, the IPC mapping of the peers' outputs) and the
launch (``run_*``, which counts it). The wrappers plan and run per call;
the FSDP forward keeps its plans (``serve/vit_fsdp.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .fused import (MlpLayout, MlpPlan, _card_sms, _mlp_args,
                    _mlp_auto_stripes, _mlp_input, _mlp_library, _mlp_shapes,
                    fused_mlp_plain, gather_split, mlp_grid, mlp_layout,
                    plan_mlp)

# csrc/copy_jobs.cuh: copy jobs a launch takes (shards x destinations)
MAX_JOBS = 64
# K14's copy blocks: one per 64 KB moved, at most a card's SMs
_COPY_BYTES_PER_BLOCK = 65536
_K14_MAX_BLOCKS = 132


def _sublane(dtype) -> int:
    """Rows of the TPU's sublane tile for ``dtype`` (ring_gather.py:65)."""
    return {1: 32, 2: 16}.get(torch.empty((), dtype=dtype).element_size(), 8)


def check_row_shards(shards: Sequence[torch.Tensor]) -> None:
    """Every shard's ROW count must be a multiple of the sublane tile (32
    rows int8 / 16 bf16 / 8 f32), as the JAX function demands
    (ring_gather.py:69-78). The CUDA kernel copies any byte count; the
    check keeps the two packages' shards interchangeable."""
    for s in shards:
        sub = _sublane(s.dtype)
        if s.shape[0] % sub:
            raise ValueError(
                f"row shard rows {s.shape[0]} not a multiple of the "
                f"{str(s.dtype)[6:]} sublane tile {sub}")


def _tp(peers) -> Tuple[int, int]:
    return (0, 1) if peers is None else (peers.rank, peers.tp)


def _gathered_shape(s, tp):
    return (s.shape[0] * tp, *s.shape[1:])


def gather_rows_plain(shards: Sequence[torch.Tensor], peers=None,
                      sublane_rows: bool = True):
    """Plain version of K14 on CPU tensors: each shard's bytes gathered
    over the peers' gloo group in rank order (a copy at tp = 1).
    ``sublane_rows``: as :func:`plan_gather_rows`'s."""
    if sublane_rows:
        check_row_shards(shards)
    _, tp = _tp(peers)
    outs = []
    for s in shards:
        s = s.contiguous()
        if tp == 1:
            outs.append(s.clone())
            continue
        outs.append(torch.cat(peers.all_gather(s)))
    return outs


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """One gather, prepared once by :func:`plan_gather_rows`: the output
    buffers, the copy jobs (this process's shard bytes into its row slot
    of its own and every peer's output) as C arrays, and the tensors they
    point into, held here so that none is freed while the plan lives."""

    outs: Tuple[torch.Tensor, ...]
    src: ctypes.Array
    dst: ctypes.Array
    nbytes: ctypes.Array
    n_jobs: int
    moved: int  # bytes this process writes
    peers: object
    keep: tuple


def _c_ll(vals):
    return (ctypes.c_longlong * max(1, len(vals)))(*vals)


def gather_jobs(shards: Sequence[Tuple[int, int]],
                targets: Sequence[Sequence[int]]):
    """K14's copy jobs (src, dst, bytes lists) from each shard's (address,
    bytes) and its destination addresses (its own output's row slot
    first, then the same slot of each peer's): one job per (shard,
    destination), shard by shard. Refuses more than :data:`MAX_JOBS`."""
    src, dst, nbytes = [], [], []
    for (s, nb), ds in zip(shards, targets):
        for d in ds:
            src.append(s)
            dst.append(d)
            nbytes.append(nb)
    if len(src) > MAX_JOBS:
        raise ValueError(f"gather_rows: {len(src)} copy jobs > {MAX_JOBS} "
                         "(shards x processes)")
    return src, dst, nbytes


def plan_gather_rows(shards: Sequence[torch.Tensor],
                     outs: Optional[Sequence[torch.Tensor]] = None,
                     peers=None, peer_outs=None,
                     sublane_rows: bool = True) -> GatherPlan:
    """K14's prepared side. ``shards``: this process's row shards (CUDA,
    contiguous); ``outs``: the output buffers [R_j * tp, N_j] (allocated
    here when None); ``peer_outs[p]``: peer p's outputs mapped into this
    process (exchanged here through ``peers`` when None: a collective
    call, every peer makes it). ``sublane_rows=False``: the gather stands
    for a ``jax.lax.all_gather``, which takes any row count, not for the
    JAX ``gather_rows`` kernel, so :func:`check_row_shards` is not applied
    (the tensor-parallel forward's int8 levels, b_loc x 208 rows; the
    column-FSDP forward's n-major weight rows, N/tp of them)."""
    if sublane_rows:
        check_row_shards(shards)
    rank, tp = _tp(peers)
    shards = tuple(s.contiguous() for s in shards)
    _build.require_cuda("gather_rows", *shards)
    if outs is None:
        outs = [torch.empty(_gathered_shape(s, tp), dtype=s.dtype,
                            device=s.device) for s in shards]
    outs = tuple(outs)
    for s, o in zip(shards, outs):
        if (tuple(o.shape) != _gathered_shape(s, tp) or o.dtype != s.dtype
                or not o.is_contiguous()):
            raise ValueError(f"gather output {tuple(o.shape)} {o.dtype} vs "
                             f"shard {tuple(s.shape)} {s.dtype} at tp={tp}")
    _build.require_cuda("gather_rows", *outs)
    if tp > 1 and peer_outs is None:
        peer_outs = peers.open(list(outs))
    jobs, targets = [], []
    for j, s in enumerate(shards):
        nb = s.numel() * s.element_size()
        jobs.append((s.data_ptr(), nb))
        targets.append([o.data_ptr() + rank * nb for o in [outs[j]] + (
            [peer_outs[p][j] for p in range(tp) if p != rank]
            if tp > 1 else [])])
    src, dst, nbytes = gather_jobs(jobs, targets)
    return GatherPlan(outs=outs, src=_c_ll(src), dst=_c_ll(dst),
                      nbytes=_c_ll(nbytes), n_jobs=len(src),
                      moved=sum(nbytes), peers=peers,
                      keep=(shards, peer_outs))


def _copy_blocks(moved: int) -> int:
    return max(1, min(_K14_MAX_BLOCKS, -(-moved // _COPY_BYTES_PER_BLOCK)))


def _fence(plan: Optional[GatherPlan]) -> None:
    if plan is not None and plan.peers is not None and plan.peers.tp > 1:
        plan.peers.fence()


def run_gather_rows(plan: GatherPlan) -> Tuple[torch.Tensor, ...]:
    """Launches K14 for a prepared gather (the only place that launches
    it), between two fences at tp > 1; returns the gathered outputs."""
    _fence(plan)
    lib = _build.library("ring_gather")
    fn = lib.qvt_gather_rows
    P, I = _build.P, _build.I
    fn.argtypes = [P, P, P, I, I, P]
    fn.restype = I
    code = fn(plan.src, plan.dst, plan.nbytes, plan.n_jobs,
              _copy_blocks(plan.moved), _build.stream())
    _build.check(code, "gather_rows")
    _build.count_launch("gather_rows")
    _fence(plan)
    return plan.outs


def gather_rows(shards: Sequence[torch.Tensor], *, peers=None):
    """Push all-gather of row shards over the peers (kernel K14).

    shards[j]: this process's [R_j, N_j] rows; returns [R_j * tp, N_j]
    per shard, tiled in rank order (``peers=None``: tp = 1, a copy). Equal
    to ``jax.lax.all_gather(x, axis, axis=0, tiled=True)``. At tp > 1
    every peer calls it with its own shards. CPU tensors take
    :func:`gather_rows_plain`; CUDA tensors :func:`plan_gather_rows` then
    :func:`run_gather_rows` (a caller that gathers into the same buffers
    repeatedly keeps the plan)."""
    shards = list(shards)
    check_row_shards(shards)
    if not shards:
        return []
    if all(s.device.type == "cpu" for s in shards):
        return gather_rows_plain(shards, peers)
    return list(run_gather_rows(plan_gather_rows(shards, peers=peers)))


# ---------------------------------------------------------------------------
# K15: the MLP block + the gather of the next block's shards
# ---------------------------------------------------------------------------


def _check_mlp_gather(w1, w2, act_top, hid_top, fmt, shards, stripes,
                      block_m):
    """The refusals of ring_gather.py:225-234 and :260-262."""
    if not (isinstance(act_top, int) and act_top >= 1):
        raise ValueError(f"positive static act_top required, got {act_top!r}")
    if not (isinstance(hid_top, int) and hid_top >= 1):
        raise ValueError(f"positive static hid_top required, got {hid_top!r}")
    if fmt != "int8":
        raise ValueError(
            "fused_mlp_gather computes in the unpacked-int8 serving "
            f"format (got fmt={fmt!r}); gathered BYTES may be any format")
    check_row_shards(shards)
    _, hid = _mlp_shapes(w1, w2, fmt, fmt, act_top, hid_top)
    n_stripes = stripes or _mlp_auto_stripes(hid)
    if hid % n_stripes:
        raise ValueError(f"stripes={n_stripes} does not divide {hid}")
    if block_m is not None and block_m < 1:
        raise ValueError(f"block_m={block_m} must be positive")


def fused_mlp_gather_plain(x, w1, scale1, bias1, w2, scale2, bias2, *,
                           ln_scale, ln_bias, next_shards=(), peers=None,
                           ln_eps=1e-6, act_d=None, act_t=None, act_top=None,
                           act_pow=False, hid_d=None, hid_t=None,
                           hid_top=None, hid_pow=False, fmt="int8",
                           out_dtype=torch.bfloat16, block_m=None,
                           stripes=None):
    """Plain version of K15: :func:`~.fused.fused_mlp_plain` and
    :func:`gather_rows_plain` of ``next_shards``. Returns (mlp_out,
    [gathered weights])."""
    shards = list(next_shards)
    _check_mlp_gather(w1, w2, act_top, hid_top, fmt, shards, stripes,
                      block_m)
    y = fused_mlp_plain(x, w1, scale1, bias1, w2, scale2, bias2,
                        ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
                        act_d=act_d, act_t=act_t, act_top=act_top,
                        act_pow=act_pow, hid_d=hid_d, hid_t=hid_t,
                        hid_top=hid_top, hid_pow=hid_pow, fmt=fmt,
                        out_dtype=out_dtype)
    return y, gather_rows_plain(shards, peers)


def run_mlp_gather(plan: MlpPlan, gather: Optional[GatherPlan], x, *,
                   out_dtype=torch.bfloat16):
    """Launches K15 on ``x`` [M, K] for a prepared int8 MLP (K2's
    :class:`~.fused.MlpPlan`) and a prepared gather of the next block's
    shards (None: no shards), at :func:`~.fused.mlp_layout`'s work split
    for the card, between two fences at tp > 1. Returns (mlp_out,
    gathered outputs)."""
    _build.require_cuda("fused_mlp_gather", x)
    layout = mlp_layout(_mlp_input(x, plan.k), plan.k, plan.hid,
                        x.element_size(), _card_sms(x.device.index))
    return _launch_mlp_gather(plan, gather, x, layout, out_dtype=out_dtype)


def _launch_mlp_gather(plan: MlpPlan, gather: Optional[GatherPlan], x,
                       layout: MlpLayout, *, out_dtype=torch.bfloat16):
    """K15 at ``layout`` on a checked CUDA ``x``: K2's scratch
    (:func:`~.fused._mlp_args`), the gather's chunks
    (:func:`~.fused.gather_split` over the launch's grid) and the launch
    itself, counted under ``fused_mlp_gather``: the only place that
    launches it."""
    if plan.int4_1 or plan.int4_2:
        raise ValueError("fused_mlp_gather computes in the unpacked-int8 "
                         "serving format")
    m = _mlp_input(x, plan.k)
    x = x.contiguous()
    out = torch.empty((m, plan.k), dtype=out_dtype, device=x.device)
    jobs = gather.n_jobs if gather else 0
    job_bytes = list(gather.nbytes[:jobs]) if gather else []
    split = gather_split(job_bytes, mlp_grid(layout,
                                             _card_sms(x.device.index)))
    if m == 0 and split.chunks == 0:
        return out, []
    _fence(gather)
    scratch, args = _mlp_args(plan, x, out, layout)
    empty = _c_ll([])
    code = _mlp_library().qvt_fused_mlp_gather(
        *args, gather.src if gather else empty,
        gather.dst if gather else empty, gather.nbytes if gather else empty,
        jobs, split.chunk, split.chunks, _build.stream())
    _build.check(code, "fused_mlp_gather")
    _build.count_launch("fused_mlp_gather")
    _fence(gather)
    return out, (list(gather.outs) if gather else [])


def fused_mlp_gather(x, w1, scale1, bias1, w2, scale2, bias2, *, ln_scale,
                     ln_bias, next_shards: Sequence[torch.Tensor] = (),
                     peers=None, ln_eps=1e-6, act_d=None, act_t=None,
                     act_top=None, act_pow=False, hid_d=None, hid_t=None,
                     hid_top=None, hid_pow=False, fmt="int8",
                     out_dtype=torch.bfloat16, block_m=None, stripes=None):
    """:func:`~.fused.fused_mlp` that also all-gathers ``next_shards`` (the
    NEXT block's row shards) over ``peers`` in the same launch (kernel
    K15).

    Returns (mlp_out, [gathered weights]): the MLP bit for bit as K2
    computes it, the gather as :func:`gather_rows`. Int8 weights only
    (``fmt``; the gathered bytes may be any format); ``act_top`` and
    ``hid_top`` positive ints; ``stripes`` must divide the hidden width
    and ``block_m`` be positive, as the JAX function demands, though the
    CUDA kernel tiles by K2's work split. CPU tensors take
    :func:`fused_mlp_gather_plain`; CUDA tensors :func:`~.fused.plan_mlp`
    and :func:`plan_gather_rows`, then :func:`run_mlp_gather`. Any widths
    that :func:`~.fused.fused_mlp_plain` takes."""
    shards = list(next_shards)
    _check_mlp_gather(w1, w2, act_top, hid_top, fmt, shards, stripes,
                      block_m)
    layer = dict(ln_scale=ln_scale, ln_bias=ln_bias, ln_eps=ln_eps,
                 act_d=act_d, act_t=act_t, act_top=act_top, act_pow=act_pow,
                 hid_d=hid_d, hid_t=hid_t, hid_top=hid_top, hid_pow=hid_pow,
                 fmt=fmt)
    if x.device.type == "cpu":
        return fused_mlp_gather_plain(x, w1, scale1, bias1, w2, scale2,
                                      bias2, next_shards=shards, peers=peers,
                                      out_dtype=out_dtype, **layer)
    _build.require_cuda("fused_mlp_gather", x)
    plan = plan_mlp(w1, scale1, bias1, w2, scale2, bias2, **layer)
    gather = plan_gather_rows(shards, peers=peers) if shards else None
    return run_mlp_gather(plan, gather, x, out_dtype=out_dtype)
