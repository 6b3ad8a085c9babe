"""K14's plan (``ops/ring_gather.py``), which the CUDA kernel
``csrc/ring_gather.cu`` launches: its constants against the sources, the
grid at ViT-B/16's and ViT-H/14's block weights and tp = 1, 2 and 4, the
job list (one job a (shard, destination), its own output first), the
limit on shards x destinations, and the kernel's thread mapping
(``csrc/copy_jobs.cuh``: ``copy_jobs`` over ``copy_bytes``) mirrored in
Python and replayed on a numpy byte arena: every destination byte written
exactly once, with its source byte, for aligned bodies, unaligned and
misaligned pairs and zero-byte jobs. Also the spawned gloo group's store
directory (``parallel.run_processes``). No JAX: the gathered values are
held to the JAX package in ``tests/test_torch_ring_gather.py``."""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quantized_vit_tpu_torch.ops import ring_gather as rg

torch.set_num_threads(1)

CSRC = Path(rg.__file__).resolve().parent.parent / "csrc"
# (D, MLP hidden) of block 0's four weights, gathered as int8 bytes
WIDTHS = {"vit_b": (768, 3072), "vit_h": (1280, 5120)}
# the grid of K14's launch at each width (the same at every tp: a
# process moves its shard bytes once to each of tp outputs)
GRIDS = {"vit_b": 108, "vit_h": 132}


def _ints(text):
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", text)}


def _shard_bytes(width, tp):
    d, hid = WIDTHS[width]
    return [n // tp for n in (d * 3 * d, d * d, d * hid, hid * d)]


def test_constants_match_the_sources():
    assert _ints((CSRC / "copy_jobs.cuh").read_text())["MAX_JOBS"] == \
        rg.MAX_JOBS
    assert _ints((CSRC / "ring_gather.cu").read_text())["CT"] == 256


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("tp", (1, 2, 4))
def test_grid_at_the_forward_sites(width, tp):
    moved = sum(_shard_bytes(width, tp)) * tp
    assert rg._copy_blocks(moved) == GRIDS[width]
    assert rg._copy_blocks(1) == 1 and rg._copy_blocks(0) == 1


@pytest.mark.parametrize("tp", (1, 2, 4))
def test_job_list_one_job_a_destination(tp):
    """A shard's jobs: its own output's row slot first, then the same
    slot of each peer's output, shard by shard."""
    rank = tp - 1
    nbs = _shard_bytes("vit_b", tp)
    srcs = [1 << 30 | j << 24 for j in range(4)]
    outs = [[(p + 1) << 34 | j << 26 for j in range(4)] for p in range(tp)]
    targets = [[outs[rank][j] + rank * nb] + [
        outs[p][j] + rank * nb for p in range(tp) if p != rank]
        for j, nb in enumerate(nbs)]
    src, dst, nbytes = rg.gather_jobs(list(zip(srcs, nbs)), targets)
    assert len(src) == 4 * tp
    assert src == [s for s in srcs for _ in range(tp)]
    assert nbytes == [n for n in nbs for _ in range(tp)]
    assert dst == [d for t in targets for d in t]
    assert dst[0] == outs[rank][0] + rank * nbs[0]


def test_job_limit_names_it():
    shards = [(16 * j, 32) for j in range(17)]
    assert len(rg.gather_jobs(shards[:16], [[1 << 20] * 4] * 16)[0]) == \
        rg.MAX_JOBS
    with pytest.raises(ValueError, match=r"65 copy jobs > 64 \(shards x "
                       r"processes\)"):
        rg.gather_jobs(shards, [[1 << 20] * 4] * 16 + [[1 << 20]])


def _copy_bytes(s, d, n, tid, stride):
    """``copy_jobs.cuh:copy_bytes`` of one thread: (src, dst, bytes)
    copies, 16-byte pieces four at a time where both addresses are
    16-byte aligned, then the tail byte by byte."""
    vec = ((s | d) & 15) == 0
    n16 = n // 16 if vec else 0
    out = []
    for i in range(tid, n16, 4 * stride):
        for u in range(4):
            if i + u * stride < n16:
                k = i + u * stride
                out.append((s + 16 * k, d + 16 * k, 16))
    for i in range(n16 * 16 + tid, n, stride):
        out.append((s + i, d + i, 1))
    return out


def _kernel_copies(src, dst, nbytes, grid, nt):
    """Every copy of ``copy_jobs`` on ``grid`` blocks of ``nt`` threads."""
    stride = grid * nt
    return [c for tid in range(stride)
            for j in range(len(src))
            for c in _copy_bytes(src[j], dst[j], nbytes[j], tid, stride)]


def test_replay_covers_every_destination_once():
    """Random shards at random byte offsets (aligned bodies, unaligned and
    misaligned pairs, zero-byte jobs) to 1-3 destinations, on grids of 1
    to 3 blocks of 32 threads: each destination byte written once, with
    its source's byte."""
    rng = np.random.default_rng(1)
    for _ in range(60):
        pos, shards, targets = 64, [], []
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.choice([0, 1, 15, 16, 17, 100, 640, 1000]))
            s = pos + int(rng.choice([0, int(rng.integers(0, 16))]))
            pos = s + n + 32
            shards.append((s, n))
        for s, n in shards:
            ds = []
            for _ in range(int(rng.integers(1, 4))):
                d = -(-pos // 16) * 16 + (s % 16 if rng.random() < 0.6
                                          else int(rng.integers(0, 16)))
                pos = d + n + 32
                ds.append(d)
            targets.append(ds)
        src, dst, nbytes = rg.gather_jobs(shards, targets)
        arena = rng.integers(0, 256, pos + 16).astype(np.uint8)
        out, count = arena.copy(), np.zeros(arena.size, np.int32)
        grid = int(rng.integers(1, 4))
        for s, d, n in _kernel_copies(src, dst, nbytes, grid, 32):
            out[d:d + n] = arena[s:s + n]
            count[d:d + n] += 1
        for (s, n), ds in zip(shards, targets):
            for d in ds:
                assert (count[d:d + n] == 1).all()
                assert (out[d:d + n] == arena[s:s + n]).all()
        assert count.sum() == sum(nbytes)


def test_spawned_gather_group_takes_a_relative_store_dir(tmp_path,
                                                         monkeypatch):
    """``run_processes`` with a relative store directory (a relative
    ``file://`` URL would name a host, and no rank would find the store):
    a tp = 2 gloo group gathers two shards, each rank's result equal to
    the plain all-gather."""
    from quantized_vit_tpu_torch.parallel import run_processes

    from tests import torch_workers as tw

    monkeypatch.chdir(tmp_path)
    res = run_processes(tw.run_cases, 2, os.path.join("rel", "store"),
                        args=([("gather", "g", [(32, 24), (64, 8)], "int8",
                                3)],), timeout_s=120)
    for got, plain in (r["g"] for r in res):
        assert all(np.array_equal(a, b) for a, b in zip(got, plain))
    full = tw.full_arrays([(64, 24), (128, 8)], "int8", 3)
    assert all(np.array_equal(g, f.numpy())
               for g, f in zip(res[0]["g"][0], full))
