"""Process bodies of the port's multi-process CPU tests (tp gloo
processes started by ``quantized_vit_tpu_torch.parallel.run_processes``).

This module imports torch, numpy and the port only: a spawned process
imports it afresh, and JAX would add seconds to every start. Every
result is numpy (``run_processes`` returns plain pickles).
"""

import time

import numpy as np
import torch

from quantized_vit_tpu_torch.models import ViTConfig
from quantized_vit_tpu_torch.ops import (fused_mlp_gather, gather_rows,
                                         gather_rows_plain)
from quantized_vit_tpu_torch.parallel import (COLLECTIVES, HealthCheckError,
                                              assert_same_step,
                                              collective_health_check,
                                              create_mesh,
                                              initialize_distributed,
                                              reset_collectives)
from quantized_vit_tpu_torch.serve import (prepare_tp_artifact,
                                           random_vit_int4_artifact,
                                           shard_fsdp_artifact,
                                           shard_fsdp_rdma_artifact,
                                           shard_tp_artifact,
                                           vit_int4_forward_fsdp,
                                           vit_int4_forward_fsdp_rdma,
                                           vit_int4_forward_tp)


def full_arrays(shapes, dtype: str, seed: int):
    """Seeded full arrays [rows, cols] (int8 levels, or bf16 values)."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return [torch.from_numpy(rng.integers(-128, 128, s).astype(np.int8))
                for s in shapes]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16) for s in shapes]


def _whole(shard_shapes, tp):
    return [(r * tp, c) for r, c in shard_shapes]


def rows_of(t, rank, tp):
    r = t.shape[0] // tp
    return t[rank * r:(rank + 1) * r].contiguous()


def as_numpy(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def mlp_inputs(seed: int, m: int, k: int = 128, hid: int = 128):
    """tests/ops/test_ring_gather.py:66-80's MLP inputs at ``m`` rows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    w1 = rng.integers(-7, 8, (k, hid)).astype(np.int8)
    w2 = rng.integers(-7, 8, (hid, k)).astype(np.int8)
    b1 = (rng.standard_normal(hid) * 0.01).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.01).astype(np.float32)
    g = (rng.standard_normal(k) * 0.1 + 1.0).astype(np.float32)
    be = (rng.standard_normal(k) * 0.01).astype(np.float32)
    return x, w1, w2, b1, b2, g, be


def mlp_torch(seed, m, k=128, hid=128):
    """(positional, keyword) arguments of fused_mlp_gather on CPU tensors
    from :func:`mlp_inputs`."""
    x, w1, w2, b1, b2, g, be = (torch.from_numpy(a)
                                for a in mlp_inputs(seed, m, k, hid))
    one = torch.tensor(1.0)
    args = (x.to(torch.bfloat16), w1, torch.tensor(1e-3), b1, w2,
            torch.tensor(1e-3), b2)
    kw = dict(ln_scale=g, ln_bias=be, act_d=torch.tensor(0.05), act_t=one,
              act_top=127, hid_d=torch.tensor(0.05), hid_t=one, hid_top=127,
              out_dtype=torch.float32)
    return args, kw


def run_cases(rank, tp, init_method, cases):
    """Each case, in this process of the gloo group; returns
    {name: result}. Kinds:

    - ("gather", name, shapes, dtype, seed): gather_rows (its plain
      version here) of this rank's row shards (``shapes``: a shard's
      [rows, cols] per array) of seeded full arrays;
    - ("mlp_gather", name, m, shapes, seed): fused_mlp_gather on
      :func:`mlp_inputs` with this rank's shards of seeded int8 arrays;
    - ("fsdp", name, cfg_kw, seed, images, float_dtype): the FSDP forward
      of this rank's shard of the seeded int8 artifact, with the shard's
      block-weight bytes;
    - ("tp", name, cfg_kw, seed, packed, images, float_dtype, comm_dtype):
      the tensor-parallel forward of this rank's shards of the seeded
      artifact, with the collectives it issued;
    - ("fsdp_col", name, cfg_kw, seed, packed, images, float_dtype): the
      column-FSDP forward of this rank's shard, with the shard's
      block-weight bytes and the collectives it issued;
    - ("health", name, late_ranks, timeout_s): the collective health
      check; a rank in ``late_ranks`` joins it only after ``timeout_s`` + 2
      s, so the others' watchdogs trip; returns (raised, message,
      seconds);
    - ("same_step", name, steps): assert_same_step of ``steps[rank]``;
      returns the error message or None;
    - ("mesh", dp, case): ``case`` (an "fsdp", "tp" or "fsdp_col" one) on
      the model line of a (dp, tp/dp) mesh of the group: the rank's
      images are its data line's slice.
    """
    torch.set_num_threads(1)
    peers = initialize_distributed(init_method, tp, rank, device="cpu")
    out = {}
    try:
        for case in cases:
            if case[0] == "mesh":  # ("mesh", dp, case) on a (dp, tp/dp) mesh
                mesh = create_mesh((case[1], tp // case[1]), device="cpu")
                line = mesh.peers("model")
                out.update(_run_case(case[2], line, line.rank, line.tp))
                mesh.close()
            else:
                out.update(_run_case(case, peers, rank, tp))
    finally:
        peers.close()
    return out


def _run_case(case, peers, rank, tp):
    """One case of :func:`run_cases` at the model axis ``peers``."""
    out = {}
    kind, name = case[0], case[1]
    if kind == "gather":
        shapes, dtype, seed = case[2:]
        full = full_arrays(_whole(shapes, tp), dtype, seed)
        shards = [rows_of(f, rank, tp) for f in full]
        got = gather_rows(shards, peers=peers)
        plain = gather_rows_plain(shards, peers)
        out[name] = ([as_numpy(g) for g in got],
                     [as_numpy(g) for g in plain])
    elif kind == "mlp_gather":
        m, shapes, seed = case[2:]
        args, kw = mlp_torch(seed, m)
        full = full_arrays(_whole(shapes, tp), "int8", seed + 1)
        y, gath = fused_mlp_gather(
            *args, next_shards=[rows_of(f, rank, tp) for f in full],
            peers=peers, **kw)
        out[name] = (y.numpy(), [g.numpy() for g in gath])
    elif kind == "fsdp":
        cfg_kw, seed, images, float_dtype = case[2:]
        cfg = ViTConfig(**cfg_kw)
        art = random_vit_int4_artifact(cfg, seed=seed,
                                       pack_weights=False,
                                       device="cpu")
        fart = shard_fsdp_rdma_artifact(art, rank, tp)
        logits = vit_int4_forward_fsdp_rdma(
            fart, torch.from_numpy(images), cfg, peers,
            float_dtype=getattr(torch, float_dtype))
        nbytes = sum(b[k].w.numel() * b[k].w.element_size()
                     for b in fart["blocks"]
                     for k in ("qkv", "proj", "fc1", "fc2"))
        out[name] = (logits.numpy(), nbytes)
    elif kind in ("tp", "fsdp_col"):
        cfg_kw, seed, packed, images = case[2:6]
        cfg = ViTConfig(**cfg_kw)
        art = random_vit_int4_artifact(cfg, seed=seed,
                                       pack_weights=packed,
                                       device="cpu")
        x = torch.from_numpy(images)
        reset_collectives()
        if kind == "tp":
            float_dtype, comm_dtype = case[6:]
            part = shard_tp_artifact(
                prepare_tp_artifact(art, cfg, tp), rank, tp)
            logits = vit_int4_forward_tp(
                part, x, cfg, peers,
                float_dtype=getattr(torch, float_dtype),
                comm_dtype=getattr(torch, comm_dtype))
        else:
            part = shard_fsdp_artifact(art, rank, tp)
            logits = vit_int4_forward_fsdp(
                part, x, cfg, peers,
                float_dtype=getattr(torch, case[6]))
        nbytes = sum(b[k].w.numel() * b[k].w.element_size()
                     for b in part["blocks"]
                     for k in ("qkv", "proj", "fc1", "fc2"))
        out[name] = (logits.float().numpy(), nbytes,
                     dict(COLLECTIVES))
    elif kind == "health":
        late, timeout_s = case[2:]
        if rank in late:
            time.sleep(timeout_s + 2)
        t0 = time.monotonic()
        try:
            rep = collective_health_check(peers, timeout_s)
            out[name] = (False, repr(rep), time.monotonic() - t0)
        except HealthCheckError as e:
            out[name] = (True, str(e), time.monotonic() - t0)
    elif kind == "same_step":
        try:
            assert_same_step(case[2][rank], peers)
            out[name] = None
        except HealthCheckError as e:
            out[name] = str(e)
    else:
        raise ValueError(f"unknown case kind {kind!r}")
    return out
