"""Quantized collectives: the int8 ring all-reduce for the data axis's
gradient sync (port of ``quantized_vit_tpu/parallel/collectives.py``).

:func:`quantized_ring_all_reduce` runs the two-phase ring of the JAX
function (reduce-scatter, then all-gather), every hop's payload
quantized to int8 levels plus one f32 scale per block, with the same
schedule, chunk arithmetic and f32 math: the input is padded to n x
block-multiple chunks; a hop quantizes with ``127 / scale``, rounds half
to even and clips to +-127; the receiver dequantizes and adds its own
chunk ``(idx - s - 1) mod n``; in the gather phase every rank
dequantizes the same payloads, so all replicas end bit-identical.

:func:`dp_all_reduce_grads` syncs a whole gradient tree: exact (a sum in
rank order, then the mean) or on the ring. The JAX function syncs leaf
by leaf; here the leaves are batched: every leaf is padded to its own
n x block-multiple chunks, and chunk c of every leaf is laid side by
side, so one exchange carries hop s for all leaves. No block straddles
two leaves, so each leaf's sum is the per-leaf ring's bit for bit.

``group`` is the :class:`~.peers.Peers` of the axis (``mesh.peers(
"data")``). An exchange is a gloo all-gather of the payload's bytes on
the CPU; on the card each process writes its payload into its own buffer
(one of two, alternating), which the peers map through CUDA IPC, a fence
(:meth:`~.peers.Peers.fence`) orders the writes before every read, and
the readers take what they need from the mapped buffers (plain torch
ops: the JAX package runs these collectives, the quantize and the
dequantize in XLA, outside any Pallas kernel). A buffer is written again
two exchanges later, after a fence that follows every peer's reads.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from ..models.layers import flatten_tree, unflatten_tree

_ALIGN = 16  # byte alignment of each tensor in a payload


def _quantize_block(x: torch.Tensor, block: int):
    """[n] f32 -> (int8 levels [n], f32 scales [n/block])."""
    xb = x.reshape(-1, block)
    scale = torch.clamp_min(xb.abs().amax(dim=1, keepdim=True), 1e-30)
    inv = 127.0 / scale
    lv = torch.clamp(torch.round(xb * inv), -127.0, 127.0).to(torch.int8)
    return lv.reshape(-1), (scale * (1.0 / 127.0)).reshape(-1)


def _dequantize_block(lv: torch.Tensor, scales: torch.Tensor, block: int):
    return (lv.reshape(-1, block).to(torch.float32)
            * scales[:, None]).reshape(-1)


def _offsets(tensors: Sequence[torch.Tensor]) -> Tuple[List[int], int]:
    offs, off = [], 0
    for t in tensors:
        offs.append(off)
        off += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return offs, off


class _Wire:
    """The exchanges of one axis (see the module docstring): on the card,
    this process's two payload buffers and every peer's, mapped."""

    def __init__(self, peers):
        self.peers = peers
        self.nbytes = 0
        self.views = None  # [rank][k] uint8 buffers (CUDA)
        self.k = 0

    def _reserve(self, nbytes: int) -> None:
        """Buffers of at least ``nbytes`` (a collective call when they
        grow: every process asks for the same sizes in the same order)."""
        if nbytes <= self.nbytes:
            return
        bufs = [torch.empty(nbytes, dtype=torch.uint8,
                            device=self.peers.device) for _ in range(2)]
        self.views = self.peers.open(bufs)
        self.nbytes = nbytes

    def exchange(self, tensors: Sequence[torch.Tensor]) -> List[list]:
        """Every process's ``tensors`` (the same shapes and dtypes on every
        process), in rank order; this process's own are returned as
        given. On the card the peers' are views of their mapped buffers,
        valid until the second exchange after this one."""
        peers, tp = self.peers, self.peers.tp
        offs, nbytes = _offsets(tensors)
        if peers.device.type != "cuda":
            raw = torch.zeros(nbytes, dtype=torch.uint8)
            for t, o in zip(tensors, offs):
                b = t.contiguous().reshape(-1).view(torch.uint8)
                raw[o:o + b.numel()] = b
            parts = peers.all_gather(raw)
        else:
            self._reserve(nbytes)
            k, self.k = self.k, self.k ^ 1
            mine = self.views[peers.rank][k]
            for t, o in zip(tensors, offs):
                b = t.contiguous().reshape(-1).view(torch.uint8)
                mine[o:o + b.numel()].copy_(b)
            peers.fence()
            parts = [v[k] for v in self.views]
        out = []
        for q in range(tp):
            if q == peers.rank:
                out.append(list(tensors))
                continue
            got = []
            for t, o in zip(tensors, offs):
                n = t.numel() * t.element_size()
                got.append(parts[q][o:o + n].view(t.dtype).reshape(t.shape))
            out.append(got)
        return out


def wire(peers) -> _Wire:
    """The exchange wire of ``peers`` (made once per Peers)."""
    w = getattr(peers, "_collective_wire", None)
    if w is None:
        w = _Wire(peers)
        peers._collective_wire = w
    return w


def _chunk(numel: int, n: int, block: int) -> int:
    return -(-numel // (n * block)) * block


def _ring(chunks: torch.Tensor, peers, block: int) -> torch.Tensor:
    """The two-phase quantized ring over the rows of ``chunks`` [n, C]
    (C a multiple of ``block``): the approximate sum over the processes,
    [n * C] in chunk order, the same bits on every process."""
    n, idx = peers.tp, peers.rank
    w = wire(peers)
    # phase 1: reduce-scatter. At step s every process sends the chunk
    # it received last step (quantized) to its right neighbour, which
    # adds its own copy of chunk (idx - s - 1) mod n. After n - 1 steps
    # process d owns the full sum of chunk (d + 1) mod n.
    acc = chunks[idx]
    for s in range(n - 1):
        lv, sc = _quantize_block(acc, block)
        lv_in, sc_in = w.exchange([lv, sc])[(idx - 1) % n]
        acc = _dequantize_block(lv_in, sc_in, block) + chunks[(idx - s - 1)
                                                              % n]
    # phase 2: all-gather the reduced chunks, quantized once each; every
    # process dequantizes the same payloads (its own included)
    lv, sc = _quantize_block(acc, block)
    parts = w.exchange([lv, sc])
    return torch.cat([_dequantize_block(*parts[(ci - 1) % n], block)
                      for ci in range(n)])


def _ring_leaves(leaves: Sequence[torch.Tensor], peers,
                 block: int) -> List[torch.Tensor]:
    """The quantized ring sum of every leaf, one exchange per hop for all
    of them (the module docstring)."""
    n = peers.tp
    widths = [_chunk(t.numel(), n, block) for t in leaves]
    cols = []
    for t, c in zip(leaves, widths):
        flat = t.detach().to(torch.float32).reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, c * n - flat.numel()))
        cols.append(flat.reshape(n, c))
    summed = _ring(torch.cat(cols, dim=1), peers, block).reshape(n, -1)
    out = []
    for t, part in zip(leaves, torch.split(summed, widths, dim=1)):
        out.append(part.reshape(-1)[:t.numel()].reshape(t.shape).to(
            t.dtype))
    return out


def quantized_ring_all_reduce(x: torch.Tensor, group,
                              block: int = 256) -> torch.Tensor:
    """Sum ``x`` over the processes of ``group`` (a Peers) with int8
    quantized ring traffic; the (approximate) sum, of ``x``'s shape and
    dtype, bit-identical on every process. A collective call. Exact
    path: :func:`dp_all_reduce_grads` with ``quantized=False``."""
    if group is None or group.tp == 1:
        return x
    return _ring_leaves([x], group, block)[0]


def _exact_sum(leaves: Sequence[torch.Tensor], peers) -> List[torch.Tensor]:
    """Every leaf summed over the processes in rank order (one exchange
    of all leaves, flattened side by side)."""
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    parts = wire(peers).exchange([flat])
    acc = parts[0][0].clone()
    for p in parts[1:]:
        acc += p[0]
    return [a.reshape(t.shape) for a, t in zip(
        torch.split(acc, [t.numel() for t in leaves]), leaves)]


def dp_all_reduce_grads(grads: Any, group, quantized: bool = False,
                        block: int = 256, mean: bool = True) -> Any:
    """Gradient synchronizer for the data axis: the exact sum in rank
    order, or the int8 ring (all leaves batched); divided by the axis
    size when ``mean``. ``grads``: a tree (nested dicts) of tensors of
    one float dtype; ``group``: the Peers of the axis. A collective
    call."""
    flat = flatten_tree(grads)
    keys, leaves = list(flat), list(flat.values())
    n = 1 if group is None else group.tp
    if n == 1:
        summed = leaves
    elif quantized:
        summed = _ring_leaves(leaves, group, block)
    else:
        summed = _exact_sum(leaves, group)
    return unflatten_tree({k: (s / n if mean else s)
                           for k, s in zip(keys, summed)})
