#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: the ViT-B/16 W4A4 serving
paths, ViT-H/14 serving with int8-stored levels, the kernel-level entry
points that the JAX package's bench and tools drive, FSDP serving with
in-kernel weight gathers (processes sharing the card), and the ViT-B/16
QAT + GETA training path.

Run from the repository root (no arguments; one CUDA card):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel from ``quantized_vit_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel);
2. hold each kernel (K1 ``fused_quant_matmul``, K2 ``fused_mlp``, K3
   ``attention_block``, K4 ``patch_finalize``, K5 ``block_stack``, K6
   ``attention_qkv``, K8 ``fused_mlp_chunked``, K9 ``attention_qkv_proj``,
   K10-K12 ``int4_matmul``, ``int8_matmul``, ``quant_matmul_fa``, K13
   ``flash_attention``, K14 ``gather_rows``, K15 ``fused_mlp_gather``)
   against its plain PyTorch version on the card, at the main paths' ViT-B
   shapes (K13 at its path's ViT-B and ViT-H shapes and a ragged one, in
   bf16, f32 and mixed q/v dtypes, then at 592 tokens, head_dim 128 and 20
   and wherever else its nine (query tile, head bound) instantiations
   need; K14 on a ViT-B block's weights as
   int8, packed int4 and bf16 bytes; K15 at the batch's rows and ragged
   ones and at ViT-H/14's width at 8704, 544 and 1000 rows, all at tp =
   1 here and at tp = 2 and 4 in phase 3c),
   at ViT-H/14's (K8 at 272 and 544 rows, K2 there with int8, packed
   int4 and mixed weights, K3, K6 and K9 at head_dim 80; K3 also with an
   f32 residual stream at batch 4), K1 at every site of the forwards
   (the chain's qkv and proj at batch 1-3 in bf16 and f32, the head at
   one row, ViT-H/14's patch embed at K = 588 on its padded plan and on
   a shared copy read byte by byte, its chain qkv at batch 2, fc1 and
   fc2 at batch 32) and launched at set work splits at 416, 544 and 6656
   rows (whole tiles only, every tile split 2 to 10 ways, 64 and 128
   tiles), K2 launched at set work splits at
   ViT-B's batch 1, 2 and 32 rows (both tiles of each GEMM, fc2's tiles
   whole and split), K3 and K6 launched at
   set query tiles at every (query rows, qkv dtype, head bound)
   instantiation (ragged last tiles, masked keys; K6's three output
   modes, K3's int8 and packed int4 weights and both quantizers;
   ``int_attention``), K6 at 592 tokens in f32 (a 384-px ViT-B/16), K9
   at bench.py's preamble shapes and, launched at set
   layouts, at every
   (query rows, qkv dtype, head bound) instantiation with cluster sizes 1
   to 8 (ragged last tiles, odd head counts, columns split unevenly
   against the proj's 256-column pass), K10-K12 at
   tools/profile_kernels.py's four ViT-B layer shapes (and with float16
   out), and at small ragged
   shapes, for packed int4 and int8 weights, the linear (t = 1) and pow
   (t != 1) quantizers, both residual dtypes and ``int_attention`` on and
   off, under the parity contract: int8 levels within 1 level at <= 0.5%
   of positions, the MLP block's output (K2, K8) within 1e-5, attention
   outputs (K3's and K9's branch, K6's float output, K5's residual
   stream) within 0.1 everywhere and differing at <= 1% of positions, the
   rest exact;
   each row says whether it is bit-exact;
3. the forwards (random artifact from seed 0, host-patchified input, bf16
   residual stream), each with the launch counters set to 0 just before
   and read just after, logits against the plain path: ViT-B/16 at batch
   32 (K3 + K2 route) for both weight storages, the chain at batch 1, 2
   and 3 (K1 + K6 + K1, then K2, or K8 at batch 3 where the JAX routing
   streams int8 weights), ``int_attention`` on both routes (batch 4 and
   2), the batch-1 latency entry (one K5 launch) and a 384-px ViT-B/16
   at depth 2 on the chain at batch 1 with an f32 residual stream (K6 on
   592 tokens, K8) and on the K3 route at batch 4 in bf16 (K3 on 592
   tokens), and ViT-H/14 at depth 2 on the K3 route at batch 4 with an
   f32 residual stream and, with packed int4, on the chain at batch 1 and
   2 (K2 at K = 1280; the logits of these and of the K3 routes required
   equal to the plain path's); then ViT-H/14 at
   full width and depth 32 (int8-stored levels) at batch 1 and 2 (K1 +
   K6 + K1 + K8 per block) and 32 (K3 + K1 proj + the K1 fc1/fc2 chain);
3b. the kernel-level paths at full width, each with the launch counters
   checked: bench.py's parity preamble (K9), tools/exp_vith.py's ViT-H/14
   attention branch at batch 8 (K1 qkv + K9 against K3's branch),
   tools/profile_kernels.py's GEMMs (K10-K12 at ViT-B's layer shapes) and
   the LSFQ pipeline of tests/ops/test_int4_matmul.py at fc1's width
   (K10 and K12 against the fake-quant float product, within 1e-4), and
   K13 on the q/k/v of block 0 of the seed-0 artifacts (ViT-B/16 batch
   32, ViT-H/14 batch 1 and 8; float and int8 outputs);
3c. FSDP serving (serve/vit_fsdp.py) on the batch-32 forward's artifact
   and images, and on ViT-H/14's (batch 32): at tp = 1 in this process
   (ViT-H/14 at full depth), at tp = 2 as two spawned processes sharing
   the card (gloo, CUDA IPC, interprocess events; ViT-H/14 at depth 8),
   each run's launches checked (1 K14, 12 K15, 12 K3, 14 K1, 1 K4; 32
   K15, 32 K3, 34 K1 at ViT-H/14 full depth) and its logits bit-equal
   to ``vit_int4_forward``'s; the spawned groups (tp = 2 and 4) also
   hold K14 and K15 (at both widths) against the full weights and
   ``fused_mlp_plain``, each process under a deadline;
4. the serving CLI's forward behind a batcher: single requests and pairs
   (buckets 1 and 2, the chain through K6), then the CLI's own burst of 64
   requests at max batch 8 on the artifact saved by the port's writer;
   every answer equal to a direct forward of the same images;
5. timings with CUDA events (warm-up, then the median of 20 runs, 200
   under 1 ms): each kernel at its main-path shapes (ViT-B's, K2 also at
   batch 2 and 1 and K8 beside it on the same int8 weights at batch 32,
   2 and 1, and ViT-H/14's: K8 at batch 1 and 2, K2 with packed int4 at
   batch 1 and 2, K1's embed, chain qkv and fc1/fc2
   chain, K3 at batch 32, K6 at batch 1 and 2; K9 at ViT-H's batch 8 and
   ViT-B's 32, K10-K12 at ViT-B's layer shapes; K6 also with
   ``int_attention`` at ViT-B's batch 2 and 32), its plain version,
   ``torch._int_mm`` on its GEMM shapes and
   ``scaled_dot_product_attention`` on K6's, K9's and K13's shapes
   (at K2's, K3's, K6's, K8's and K13's sites with the host's time a call
   and the device time of both, and K3's and K6's FP64 tensor-core
   ceiling;
   yardsticks the port never calls; beside K9 also K6 + K1 and K3's
   branch, beside K12 K1 with its quant prologue, beside K15 K2 on the
   same plan, at ViT-B/16's and ViT-H/14's batch 32), ``torch.cat``
   beside K14, K15's overlap sweep
   (tools/exp_rdma_overlap.py's question: K2 alone, then K15 gathering
   4-31 MB), the FSDP forwards at tp = 1 against ``vit_int4_forward``,
   both routes' attention branch at batch 2, 3, 4, 8, 16 and 32, the
   forwards, and a plain bf16 PyTorch ViT forward of the same
   architecture (ViT-B/16 at batch 32, 1 and 2; ViT-H/14 at 1, 2, 32);
6. training: ViT-B/16 at full width, batch 32, seeded synthetic NHWC
   images, ``QuantConfig(enabled=True, fused_vjp=True)`` at 32 bits, GETA
   with ``cli/train.py``'s defaults over a 13-step schedule (warmup,
   range projection with a bit ramp-down, two pruning periods, fix) driven
   by ``TrainLoop.train_one_epoch``, with the launch counters set to 0
   just before and read just after: every loss finite, K7
   (``quant_bwd``) launched 100 times per step, the target group sparsity
   reached, the bit layout frozen; then ``evaluate`` on held-out arrays, a
   checkpoint round trip, and one step with K7 against the same step with
   the plain chain (losses equal, every gradient but the quantizer
   scalars' bit-identical, those within K7's contract); K7's parity cases
   run in phase 2 (grad_x bit-exact, each sum within 1e-5 of its
   summands' L1 mass). Timings: K7's device time over the training run
   (torch.profiler's CUDA trace of the run), K7 and its plain version on
   the inputs of every quantizer site of one training step (CUDA events,
   and the kernels' own device time from torch.profiler), the whole step
   with K7 and with the plain chain in turns, a profile of each, and a
   plain PyTorch ViT-B/16 training step (f32 and bf16 autocast,
   ``torch.optim.Adam``) as the yardstick.

It prints ``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` reports them, then ``{"ok": true, "device": {...}}`` as the
last line, and writes the full record to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build")
BATCH = 32
ITERS = 20
SHORT_ITERS = 200  # timed runs of anything under 1 ms
# the main path's configuration; a CPU rehearsal (tests) shrinks these
DEV = "cuda"
CFG_KW: dict = {}
# a 384-px ViT-B/16 (577 tokens, 592 padded), depth cut to 2: on the
# chain at batch 1 with an f32 residual stream (the first K6 refused it)
# and on the K3 route at batch 4 in bf16 (the first K3 refused it)
B384_KW: dict = dict(img_size=384, depth=2)
# the ViT-H/14 serving phase: the published widths (Dosovitskiy et al.
# 2021, Table 1: D 1280, 16 heads, MLP 5120, patch 14 at 224 px) at full
# depth, int8-stored levels; a rehearsal shrinks these too
VIT_H_KW: dict = dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16,
                      num_classes=1000)
VIT_H_BATCHES = (1, 2, 32)
# the kernel-level paths of bench.py and the JAX package's tools: the ViT-H
# attention branch at tools/exp_vith.py's batch 8, and the GEMMs at
# tools/profile_kernels.py's M = 8 images of ViT-B/16's padded tokens
VIT_H_BRANCH_BATCH = 8
PROFILE_BATCH = 8
# K13's kernel path: q/k/v of block 0 at ViT-B/16 batch 32 (BATCH) and
# ViT-H/14 batch 1 and 8
K13_VIT_H_BATCHES = (1, 8)
# the FSDP phase (serve/vit_fsdp.py): its forward at tp = 1 in this
# process and at FSDP_TP in spawned processes sharing the card; the
# gathers' parity rows at each of GATHER_TPS (tp > 1 spawned); K15 at
# ragged row counts beside the batch's; the overlap sweep's dummy shards
# (tools/exp_rdma_overlap.py:97-121)
FSDP_TP = 2
GATHER_TPS = (1, 2, 4)
K15_RAGGED_M = (96, 1000)
OVERLAP_MB = (4, 8, 16, 31)
FSDP_TP_ITERS = 5
# the spawned ViT-H/14 FSDP forward's depth (tp = 1 runs all 32 blocks)
VIT_H_FSDP_TP_DEPTH = 8
SPAWN_TIMEOUT_S = 300
ART_DIR = os.path.join(ROOT, "build", "smoke_artifact")  # serve phase

# H100 data-sheet peaks (dense): int8 TOP/s, bf16 FLOP/s, HBM bytes/s,
# FP64 tensor-core FLOP/s (the ceiling of an exact attention kernel on the
# f64 MMA: K6's timing sites)
PEAKS = {
    "SXM": (1979e12, 989e12, 3.35e12, 67e12),
    "PCIe": (1513e12, 756e12, 2.0e12, 51e12),
    "NVL": (1671e12, 835e12, 3.9e12, 60e12),
}
# f32 FLOP/s outside the tensor cores (data sheet): K7's operations
F32_PEAKS = {"SXM": 67e12, "PCIe": 51e12, "NVL": 60e12}
# the training phase's schedule: warmup (step 1), range projection (2-11,
# one bit ramp-down at step 4), two pruning periods (boundaries at steps 6
# and 9, commits at 7 and 10), fix (12-13); the cli/train.py defaults
TRAIN_STEPS = 13
GETA_KW = dict(lr=1e-4, lr_quant=1e-3, variant="adam", weight_decay=0.0,
               target_group_sparsity=0.5, group_divisible=1,
               start_projection_step=1, projection_steps=4,
               projection_periods=2, start_pruning_step=5, pruning_steps=6,
               pruning_periods=2, bit_reduction=4.0, min_bit_wt=4.0,
               max_bit_wt=32.0, min_bit_act=4.0, max_bit_act=32.0)
TRAIN_CKPT = os.path.join(ROOT, "build", "smoke_train_ckpt")


def log(*a):
    print(*a, flush=True)


class Failed(Exception):
    pass


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import quantized_vit_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    record = {"device": torch.cuda.get_device_name(0)}
    try:
        run(record)
    except Failed as e:
        log(f"FAILED: {e}")
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1, default=str)
        return 1
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"kernels": record["kernels"]}))
    print(record["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------


def run(record):
    from quantized_vit_tpu_torch.ops import _build

    dev = torch.device(DEV)
    peaks = next((v for k, v in PEAKS.items() if k in record["device"]),
                 PEAKS["SXM"])
    record["peaks"] = {"int8_ops": peaks[0], "bf16_flops": peaks[1],
                       "bytes_per_s": peaks[2], "fp64_tc_flops": peaks[3]}
    if dev.type != "cuda":  # CPU rehearsal: plain versions only
        record["nvidia_smi"] = "cpu rehearsal, no card"
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        record["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
        log("card:", record["nvidia_smi"])
        t0 = time.time()
        try:
            bdir = _build.build_all()
        except Exception as e:  # a kernel that does not build fails the run
            raise Failed(f"build: {e}")
        record["build_s"] = round(time.time() - t0, 1)
        log(f"[build] {record['build_s']} s -> {bdir}")
        ptx = bdir / "ptxas.log"
        record["ptxas"] = [ln.strip() for ln in (
            ptx.read_text().splitlines() if ptx.exists() else [])
            if "registers" in ln or "spill" in ln]
        for ln in record["ptxas"]:
            if "registers" in ln:
                log("  ptxas:", ln)

    parity = Parity(dev)
    parity.run_all(main_cfg())
    record["parity"] = parity.rows
    if parity.failures:
        raise Failed("kernel parity: " + "; ".join(parity.failures[:8]))

    fwd = forward_phase(dev, record)
    fwd["vit_h"] = vit_h_phase(dev, record)
    fwd["paths"] = kernel_paths_phase(dev, record, fwd)
    fwd["fsdp"] = fsdp_phase(dev, record, parity, fwd)
    serve_phase(dev, record, fwd)
    timing_phase(dev, record, fwd, peaks)
    del fwd
    train_phase(dev, record, peaks)


def main_cfg():
    from quantized_vit_tpu_torch.models import ViTConfig

    return ViTConfig(**CFG_KW)  # ViT-B/16 unless a rehearsal shrinks it


def vit_h_cfg():
    from quantized_vit_tpu_torch.models import ViTConfig

    return ViTConfig(**VIT_H_KW)  # ViT-H/14 unless a rehearsal shrinks it


def vit_h_shapes(cfg):
    """(patches, D, real tokens, padded tokens, hidden, heads) of the
    ViT-H/14 phase."""
    n_pad = -(-cfg.num_tokens // 16) * 16
    return (cfg.num_patches, cfg.embed_dim, cfg.num_tokens, n_pad,
            int(cfg.embed_dim * cfg.mlp_ratio), cfg.num_heads)


def profile_shapes(cfg):
    """(layer, M, K, N) of tools/profile_kernels.py's GEMMs: ViT-B/16's
    qkv, proj, fc1 and fc2 at M = PROFILE_BATCH x the padded tokens."""
    _, _, d, _, n_pad, _, hid, _, _ = shapes(cfg)
    m = PROFILE_BATCH * n_pad
    return [("qkv", m, d, 3 * d), ("proj", m, d, d), ("fc1", m, d, hid),
            ("fc2", m, hid, d)]


def shapes(cfg):
    """(batch, patches, D, real tokens, padded tokens, patch K, hidden,
    classes, heads) of the main path."""
    n_pad = -(-cfg.num_tokens // 16) * 16
    return (BATCH, cfg.num_patches, cfg.embed_dim, cfg.num_tokens, n_pad,
            cfg.patch_size**2 * cfg.in_channels,
            int(cfg.embed_dim * cfg.mlp_ratio), cfg.num_classes,
            cfg.num_heads)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def level_diff(got, want):
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return float(d.max()) if d.numel() else 0.0, float((d > 0).float().mean())


def float_diff(got, want):
    d = (got.float() - want.float()).abs()
    return float(d.max()) if d.numel() else 0.0, float((d > 0).float().mean())


def raw_bytes(t):
    """A tensor's bytes (the gathers copy them opaquely)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def parity_row(kernel, case, kind, got, want):
    """One parity row under the contract of ``kind``: ``levels`` (within
    1 level at <= 0.5% of positions), ``mlp`` (within 1e-5),
    ``attention`` (within 0.1, differing at <= 1% of positions), else
    exact; every value finite."""
    if kind == "levels":
        mx, frac = level_diff(got, want)
        ok = mx <= 1 and frac <= 0.005
    elif kind == "mlp":
        mx, frac = float_diff(got, want)
        ok = mx <= 1e-5
    elif kind == "attention":
        mx, frac = float_diff(got, want)
        ok = mx <= 0.1 and frac <= 0.01
    else:  # exact
        mx, frac = float_diff(got, want)
        ok = (mx == 0.0 and got.shape == want.shape
              and got.dtype == want.dtype)
    if not torch.isfinite(got.float()).all():
        ok = False
    return {"kernel": kernel, "case": case, "check": kind,
            "max_abs_err": mx, "share_differ": frac, "bit_exact": mx == 0.0,
            "ok": ok}


class Parity:
    """Kernel-vs-plain cases; each row: kernel, case, max diff, share of
    positions that differ, pass."""

    def __init__(self, dev):
        self.dev = dev
        self.rows = []
        self.failures = []

    def check(self, kernel, case, kind, got, want):
        row = parity_row(kernel, case, kind, got, want)
        self.add(row)
        return row["max_abs_err"], row["share_differ"]

    def add(self, row):
        self.rows.append(row)
        if not row["ok"]:
            self.failures.append(f"{row['kernel']} {row['case']}: max "
                                 f"{row['max_abs_err']} share "
                                 f"{row['share_differ']}")

    # -- data -------------------------------------------------------------

    def t(self, a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.dev, dtype=dtype) if dtype else t.to(self.dev)

    def weight(self, rng, k, n, fmt):
        from quantized_vit_tpu_torch.quant import pack_int4

        w = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8))
        return (pack_int4(w, axis=0) if fmt == "int4" else w).to(self.dev)

    def scal(self, v):
        return torch.tensor(v, dtype=torch.float32, device=self.dev)

    # -- K1 ---------------------------------------------------------------

    def k1(self, case, m, k, n, fmt, pow_, prologue, epilogue, seed,
           stream=None, layout=None, byte_wise=False):
        """K1 on seeded inputs against fused_quant_matmul_plain, through
        the wrapper (a plan per call); ``stream`` (bf16 or f32): x of the
        LayerNorm prologue, the residual and a float output in that dtype
        (else bf16 x and residual, f32 out unless residual); ``layout``
        (a dict of ``MatmulLayout`` fields): K1 launched at that work
        split (``_launch_matmul``) instead of the picker's; ``byte_wise``:
        on a plan that shares an n-major copy of the weight (``w_t``), as
        a block's plans do, which the kernel reads byte by byte where its
        depth is off the 16-byte path (the wrapper's own copy is padded
        there). A CPU rehearsal takes the wrapper, its plain version."""
        from quantized_vit_tpu_torch.ops import (_build, fused_quant_matmul,
                                                 fused_quant_matmul_plain,
                                                 plan_matmul, run_matmul)
        from quantized_vit_tpu_torch.ops.fused import (COPY_PROLOGUE,
                                                       _launch_matmul,
                                                       matmul_layout)

        rng = np.random.default_rng(seed)
        f32, bf16 = torch.float32, torch.bfloat16
        if prologue is None:
            x = self.t(rng.integers(-7, 8, (m, k)).astype(np.int8))
        elif prologue == "ln_quant":
            x = self.t(rng.standard_normal((m, k)) * 0.5, stream or bf16)
        else:
            x = self.t(rng.standard_normal((m, k)), f32)
        w = self.weight(rng, k, n, fmt)
        scale = self.t(rng.random(n) * 0.01 + 1e-3, f32)
        bias = self.t(rng.standard_normal(n) * 0.1, f32)
        out_dtype = stream or (bf16 if epilogue == "residual" else f32)
        layer = dict(fmt=fmt, prologue=prologue, epilogue=epilogue)
        if prologue is not None:
            layer.update(act_d=self.scal(0.05),
                         act_t=self.scal(1.08 if pow_ else 1.0),
                         act_top=127 if prologue == "ln_quant" else 7,
                         act_pow=pow_ and prologue != "gelu_quant")
        if prologue == "ln_quant":
            layer.update(
                ln_scale=self.t(rng.standard_normal(k) * 0.1 + 1, f32),
                ln_bias=self.t(rng.standard_normal(k) * 0.01, f32))
        run = dict(out_dtype=out_dtype)
        if epilogue == "residual":
            run["residual"] = self.t(rng.standard_normal((m, n)),
                                     stream or bf16)
        if epilogue in ("quant", "gelu_quant"):
            layer.update(out_d=self.scal(0.5), out_t=self.scal(
                0.93 if pow_ else 1.0), out_top=31, out_pow=pow_)
        want = fused_quant_matmul_plain(x, w, scale, bias, **layer, **run)
        if self.dev.type != "cuda" or (layout is None and not byte_wise):
            got = fused_quant_matmul(x, w, scale, bias, **layer, **run)
        elif layout is None:
            got = run_matmul(plan_matmul(w, scale, bias, w_t=_build.n_major(w),
                                         **layer), x, **run)
        else:
            pro = prologue
            if pro is None and (k % 16 or x.data_ptr() % 16):
                pro = COPY_PROLOGUE
            lay = dataclasses.replace(
                matmul_layout(m, k, n, pro, x.element_size()), **layout)
            got = _launch_matmul(plan_matmul(w, scale, bias, **layer), x,
                                 lay, **run)
        kind = ("levels" if epilogue in ("quant", "gelu_quant") else "exact")
        return self.check("fused_quant_matmul", case, kind, got, want)

    def run_k1_sites(self, cfg):
        """K1 at every site of the forwards beyond the batch-32 ones of
        run_all: the chain's qkv (LayerNorm prologue, bf16 and f32
        streams) and proj (residual) at batch 1, 2 and 3, the head at one
        row; ViT-H/14's patch embed (K = 588: the padded plan, int8 and
        packed int4, and the unpadded byte-wise one), chain qkv at batch
        2, fc1 (LayerNorm -> GELU-quant) and fc2 (residual) at batch 32;
        then K1 launched at set work splits at 416, 544 and 6656 rows:
        whole tiles only, every tile split 2 to 8 ways, some whole and
        the rest split 3 to 10 ways, 64 and 128 tiles, every epilogue."""
        b, p, d, _, n_pad, kp, _, ncls, _ = shapes(cfg)
        seed = 600
        for bk in CHAIN_BATCHES:
            m = bk * n_pad
            for stream in (torch.bfloat16, torch.float32):
                for fmt in ("int4", "int8"):
                    seed += 1
                    tag = f"{fmt},{str(stream)[6:]}"
                    self.k1(f"chain_qkv[{m}x{d}x{3 * d}]({tag})", m, d,
                            3 * d, fmt, seed % 3 == 0, "ln_quant", None,
                            seed, stream)
                    self.k1(f"chain_proj[{m}x{d}x{d}]({tag})", m, d, d,
                            fmt, False, None, "residual", seed, stream)
        for fmt in ("int4", "int8"):
            for pow_ in (False, True):
                seed += 1
                self.k1(f"head[1x{d}x{ncls}]({fmt},"
                        f"{'pow' if pow_ else 'lin'})", 1, d, ncls, fmt,
                        pow_, "quant", None, seed)
        vh = vit_h_cfg()
        vp, vd, _, vn_pad, vhid, _ = vit_h_shapes(vh)
        vkp = vh.patch_size**2 * vh.in_channels
        vb = max(VIT_H_BATCHES)
        for fmt in ("int8", "int4"):
            seed += 1
            self.k1(f"vit_h_patch_embed[{vb * vp}x{vkp}x{vd}]({fmt},"
                    "padded)", vb * vp, vkp, vd, fmt, False, "quant", None,
                    seed)
        seed += 1
        self.k1(f"vit_h_patch_embed[{vb * vp}x{vkp}x{vd}](int8,byte-wise)",
                vb * vp, vkp, vd, "int8", False, "quant", None, seed,
                byte_wise=True)
        seed += 1
        self.k1(f"vit_h_chain_qkv[{2 * vn_pad}x{vd}x{3 * vd}](int8)",
                2 * vn_pad, vd, 3 * vd, "int8", False, "ln_quant", None,
                seed, torch.bfloat16)
        mh = vb * vn_pad
        for pow_ in (False, True):
            seed += 1
            tag = "pow" if pow_ else "lin"
            self.k1(f"vit_h_fc1[{mh}x{vd}x{vhid}](int8,{tag})", mh, vd,
                    vhid, "int8", pow_, "ln_quant", "gelu_quant", seed)
            self.k1(f"vit_h_fc2[{mh}x{vhid}x{vd}](int8,{tag})", mh, vhid,
                    vd, "int8", pow_, None, "residual", seed + 50)
        # set work splits: (rows, K, N, prologue, epilogue, (tile, tiles
        # whole, splits) ...); tiles whole past the count are all of them
        m2, mb = 2 * n_pad, b * n_pad
        for m, k, n, pro, epi, lays in (
                (m2, d, 3 * d, "ln_quant", None,
                 ((64, 10**6, 1), (64, 0, 2), (128, 0, 6))),
                (m2, d, d, None, "residual", ((128, 10**6, 1),
                                              (64, 10, 3))),
                (mb, d, d, None, "residual",
                 ((64, 10**6, 1), (128, 0, 2), (128, 264, 6))),
                (mb, d, d, "quant", None, ((64, 100, 4),)),
                (2 * vn_pad, vhid, vd, None, "residual",
                 ((64, 0, 8), (128, 20, 5))),
                (2 * vn_pad, vd, vhid, "ln_quant", "gelu_quant",
                 ((64, 40, 7), (128, 0, 3))),
                (2 * vn_pad, vd, 3 * vd, "ln_quant", "quant",
                 ((128, 10**6, 1), (64, 5, 10)))):
            for tile, full, s in lays:
                seed += 1
                tiles = -(-m // tile) * -(-n // tile)
                full = min(full, tiles)
                fmt = "int8" if seed % 2 else "int4"
                self.k1(f"layout[{m}x{k}x{n},{pro}->{epi}](t{tile},"
                        f"whole{full},S{s},{fmt})", m, k, n, fmt,
                        seed % 3 == 0, pro, epi, seed,
                        layout=dict(tile=tile, full=full, splits=s))

    # -- K2 ---------------------------------------------------------------

    def k2(self, case, m, k, hid, fmt, fmt2, pow_, seed,
           stream=torch.bfloat16, kernel="fused_mlp", bias=True,
           layout=None):
        """K2 (or, with ``kernel="fused_mlp_chunked"``, K8 on int8
        weights) launched on its own plan, against fused_mlp_plain; with
        ``layout`` (a dict of ``MlpLayout`` fields, or for K8 of
        ``ChunkedLayout`` fields), launched at that work split
        (``_launch_mlp``, ``_launch_mlp_chunked``) instead of the
        picker's."""
        from quantized_vit_tpu_torch.ops import (fused_mlp_plain, plan_mlp,
                                                 plan_mlp_chunked, run_mlp,
                                                 run_mlp_chunked)
        from quantized_vit_tpu_torch.ops.fused import (_launch_mlp,
                                                       _launch_mlp_chunked,
                                                       chunked_layout,
                                                       mlp_layout)

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        x = self.t(rng.standard_normal((m, k)) * 0.5, stream)
        w1 = self.weight(rng, k, hid, fmt)
        w2 = self.weight(rng, hid, k, fmt2)
        s1, b1 = self.scal(1e-3), self.t(rng.standard_normal(hid) * 0.01, f32)
        s2, b2 = self.scal(1e-3), self.t(rng.standard_normal(k) * 0.01, f32)
        if not bias:
            b1 = b2 = None
        kw = dict(ln_scale=self.t(rng.standard_normal(k) * 0.1 + 1, f32),
                  ln_bias=self.t(rng.standard_normal(k) * 0.01, f32),
                  act_d=self.scal(0.05), act_t=self.scal(
                      1.08 if pow_ else 1.0), act_top=127, act_pow=pow_,
                  hid_d=self.scal(0.05), hid_t=self.scal(
                      0.93 if pow_ else 1.0), hid_top=127, hid_pow=pow_,
                  fmt=fmt, fmt2=fmt2)
        want = fused_mlp_plain(x, w1, s1, b1, w2, s2, b2, out_dtype=stream,
                               **kw)
        if self.dev.type != "cuda":  # CPU rehearsal: the plain version
            got = fused_mlp_plain(x, w1, s1, b1, w2, s2, b2,
                                  out_dtype=stream, **kw)
        elif layout is not None and kernel == "fused_mlp_chunked":
            lay = dataclasses.replace(
                chunked_layout(m, k, hid, x.element_size()), **layout)
            got = _launch_mlp_chunked(
                plan_mlp_chunked(w1, s1, b1, w2, s2, b2, **kw), x, lay,
                out_dtype=stream)
        elif layout is not None:
            lay = dataclasses.replace(mlp_layout(m, k, hid), **layout)
            got = _launch_mlp(plan_mlp(w1, s1, b1, w2, s2, b2, **kw), x, lay,
                              out_dtype=stream)
        elif kernel == "fused_mlp":
            got = run_mlp(plan_mlp(w1, s1, b1, w2, s2, b2, **kw), x,
                          out_dtype=stream)
        else:
            got = run_mlp_chunked(plan_mlp_chunked(w1, s1, b1, w2, s2, b2,
                                                   **kw), x, out_dtype=stream)
        return self.check(kernel, case, "mlp", got, want)

    # -- K3 ---------------------------------------------------------------

    def k3(self, case, b, n, d, heads, n_valid, fmt, fmt_proj, pow_, seed,
           stream=torch.bfloat16, int_attn=False, rows=None):
        """K3's levels and its branch with the K1 proj against their
        plain versions; with ``rows``, the levels alone, launched at that
        query tile (``_launch_attention_heads``) instead of the picker's
        (a CPU rehearsal takes the wrapper, its plain version)."""
        from quantized_vit_tpu_torch.ops import (attention_block,
                                                 attention_block_plain,
                                                 attention_heads,
                                                 attention_heads_plain)
        from quantized_vit_tpu_torch.ops.attention import (
            _launch_attention_heads, plan_attention_heads)

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        hd = d // heads
        x = self.t(rng.standard_normal((b, n, d)) * 0.2, stream)
        wq = self.weight(rng, d, 3 * d, fmt)
        wp = self.weight(rng, d, d, fmt_proj)
        qs, qb = self.scal(1e-3), self.t(rng.standard_normal(3 * d) * 0.01,
                                         f32)
        ps, pb = self.scal(2e-3), self.t(rng.standard_normal(d) * 0.01, f32)
        kw = dict(ln_scale=self.t(rng.standard_normal(d) * 0.1 + 1, f32),
                  ln_bias=self.t(rng.standard_normal(d) * 0.01, f32),
                  heads=heads, sm_scale=hd**-0.5, n_valid=n_valid,
                  act_d=self.scal(0.05), act_t=self.scal(
                      1.08 if pow_ else 1.0), act_top=127, act_pow=pow_,
                  out_d=self.scal(0.06), out_t=self.scal(
                      0.93 if pow_ else 1.0), out_top=31, out_pow=pow_,
                  out_dtype=stream, int_attention=int_attn)
        want = attention_heads_plain(x, wq, qs, qb, fmt=fmt, **kw)
        if rows is not None:
            run = {k: kw.pop(k) for k in ("n_valid", "out_dtype",
                                          "int_attention")}
            got = (_launch_attention_heads(
                plan_attention_heads(wq, qs, qb, fmt=fmt, **kw), x, rows,
                **run) if self.dev.type == "cuda"
                else attention_heads(x, wq, qs, qb, fmt=fmt, **kw, **run))
            return self.check("attention_block", case, "levels", got, want)
        self.check("attention_block", case + ":levels", "levels",
                   attention_heads(x, wq, qs, qb, fmt=fmt, **kw), want)
        got = attention_block(x, wq, qs, qb, wp, ps, pb, fmt=fmt,
                              fmt_proj=fmt_proj, **kw)
        want = attention_block_plain(x, wq, qs, qb, wp, ps, pb, fmt=fmt,
                                     fmt_proj=fmt_proj, **kw)
        return self.check("attention_block", case, "attention", got, want)

    def run_heads_tiles(self):
        """K3 at every (query rows R, qkv dtype, head bound) instantiation,
        launched at set tiles: 200 tokens at head_dim 64 and 280 at 80 (a
        ragged last tile at every R), masked keys (n_valid < nk < n), each
        instantiation with float attention and ``int_attention``, the
        linear and pow quantizers and int8 and packed int4 weights in
        turn."""
        i = 0
        for rows in (64, 32, 16):
            for dt in (torch.bfloat16, torch.float32):
                for hd, n, nv in ((64, 200, 190), (80, 280, 257)):
                    for ia in (False, True):
                        i += 1
                        fmt = ("int8", "int4")[i % 2]
                        pow_ = i % 3 == 0
                        self.k3(f"tile[R{rows}](2x{n}x{2 * hd},h2)"
                                f"({str(dt)[6:]},{fmt},"
                                f"{'pow' if pow_ else 'lin'},"
                                f"{'int' if ia else 'f'}_attn)", 2, n,
                                2 * hd, 2, nv, fmt, fmt, pow_, 800 + i, dt,
                                int_attn=ia, rows=rows)

    # -- K6 ---------------------------------------------------------------

    def k6(self, case, b, n, heads, hd, n_valid, dtype, quant, int_attn,
           seed, rows=None):
        """quant: None (float out), "lin" (t = 1) or "pow" (t != 1).
        ``rows``: launched at that query tile (``_launch_attention_qkv``)
        instead of the picker's; a CPU rehearsal takes the wrapper (its
        plain version)."""
        from quantized_vit_tpu_torch.ops import (attention_qkv,
                                                 attention_qkv_plain)
        from quantized_vit_tpu_torch.ops.attention import (
            _launch_attention_qkv, plan_attention_qkv)

        rng = np.random.default_rng(seed)
        qkv = self.t(rng.standard_normal((b, n, 3 * heads * hd)) * 0.7,
                     dtype)
        quant_kw = {}
        if quant:
            quant_kw = dict(out_d=self.scal(0.01), out_t=self.scal(
                0.93 if quant == "pow" else 1.0), out_top=31,
                out_pow=quant == "pow")
        run = dict(n_valid=n_valid, out_dtype=dtype, int_attention=int_attn)
        if rows is None or self.dev.type != "cuda":
            got = attention_qkv(qkv, heads=heads, sm_scale=hd**-0.5,
                                **quant_kw, **run)
        else:
            got = _launch_attention_qkv(plan_attention_qkv(
                qkv.device, heads=heads, sm_scale=hd**-0.5, **quant_kw), qkv,
                rows, **run)
        want = attention_qkv_plain(qkv, heads=heads, sm_scale=hd**-0.5,
                                   **quant_kw, **run)
        return self.check("attention_qkv", case,
                          "levels" if quant else "attention", got, want)

    def run_qkv_attn_tiles(self):
        """K6 at every (query rows R, qkv dtype, head bound) instantiation,
        launched at set tiles: 200 tokens at head_dim 64 and 270 at 80
        (a ragged last tile at every R), masked keys (n_valid < nk < n),
        each instantiation with float attention and ``int_attention``,
        the three output modes in turn; then 592 tokens at head_dim 64 in
        f32 (a 384-px ViT-B/16 at batch 1, which the first K6 refused)
        through the wrapper."""
        bf16, f32 = torch.bfloat16, torch.float32
        modes = (None, "lin", "pow")
        i = 0
        for rows in (64, 32, 16):
            for dt in (bf16, f32):
                for hd, n, nv in ((64, 200, 190), (80, 270, 257)):
                    for ia in (False, True):
                        quant = modes[i % 3]
                        i += 1
                        self.k6(f"tile[R{rows}](2x{n},h2x{hd})"
                                f"({str(dt)[6:]},{quant or 'float'},"
                                f"{'int' if ia else 'f'}_attn)", 2, n, 2, hd,
                                nv, dt, quant, ia, 700 + i, rows=rows)
        for quant in modes:
            for ia in (False, True):
                i += 1
                self.k6(f"vit_b384[1x592,h12x64](float32,{quant or 'float'},"
                        f"{'int' if ia else 'f'}_attn)", 1, 592, 12, 64, 577,
                        f32, quant, ia, 700 + i)

    # -- K5 ---------------------------------------------------------------

    def stack_operands(self, rng, depth, d, heads, hid, fmt, pow_):
        """Stacked, folded K5 operands at artifact-like scales (weights
        [L, K(/2), N]) and the static keywords."""
        from quantized_vit_tpu_torch.quant import pack_int4

        f32 = torch.float32

        def w(k, n):
            lv = torch.from_numpy(
                rng.integers(-7, 8, (depth, k, n)).astype(np.int8))
            return (pack_int4(lv, axis=1) if fmt == "int4" else lv).to(
                self.dev)

        def rows(n, scale, base=0.0):
            return self.t(rng.standard_normal((depth, n)) * scale + base,
                          f32)

        def scal(v):
            return torch.full((depth,), v, dtype=f32, device=self.dev)

        t_a, t_h = (1.08, 0.93) if pow_ else (1.0, 1.0)
        # LayerNorm gamma carries 1/d = 20 under the linear quantizer
        g_sc, g_base = (0.1, 1.0) if pow_ else (2.0, 20.0)
        ops = (w(d, 3 * d), rows(3 * d, 2e-4, 1e-3), rows(3 * d, 1e-2),
               rows(d, g_sc, g_base), rows(d, 0.2), w(d, d),
               rows(d, 2e-4, 1e-3), rows(d, 1e-2), rows(d, g_sc, g_base),
               rows(d, 0.2), w(d, hid), rows(hid, 2e-4, 7e-4),
               rows(hid, 1e-2), w(hid, d), rows(d, 2e-4, 1e-3),
               rows(d, 1e-2), scal(0.05), scal(t_a), scal(0.05),
               scal(t_h), scal(0.05), scal(t_a), scal(0.05), scal(t_h))
        kw = dict(heads=heads, sm_scale=(d // heads)**-0.5, fmt=fmt,
                  act_pow=pow_, out_pow=pow_, mlp_pow=pow_, hid_pow=pow_,
                  act_top=7, out_top=7, mlp_top=7, hid_top=7)
        return ops, kw

    def k5(self, case, j, n, n_valid, d, heads, hid, depth, fmt, dtype,
           pow_, seed):
        from quantized_vit_tpu_torch.ops import (plan_block_stack,
                                                 vit_block_stack,
                                                 vit_block_stack_plain)

        rng = np.random.default_rng(seed)
        ops, kw = self.stack_operands(rng, depth, d, heads, hid, fmt, pow_)
        x = self.t(rng.standard_normal((j * n, d)) * 0.5, dtype)
        run = dict(n_valid=n_valid, out_dtype=dtype, j_imgs=j)
        got = vit_block_stack(x, *ops, **kw, **run)
        want = vit_block_stack_plain(plan_block_stack(*ops, **kw), x, **run)
        return self.check("block_stack", case, "attention", got, want)

    def k5_images(self, case, n, n_valid, d, heads, hid, depth, fmt, seed):
        """j_imgs = 2 equals two j_imgs = 1 calls of the kernel, exactly."""
        from quantized_vit_tpu_torch.ops import vit_block_stack

        rng = np.random.default_rng(seed)
        ops, kw = self.stack_operands(rng, depth, d, heads, hid, fmt, False)
        x = self.t(rng.standard_normal((2 * n, d)) * 0.5, torch.bfloat16)
        two = vit_block_stack(x, *ops, **kw, n_valid=n_valid, j_imgs=2)
        one = torch.cat([vit_block_stack(x[i * n:(i + 1) * n], *ops, **kw,
                                         n_valid=n_valid)
                         for i in range(2)])
        return self.check("block_stack", case, "exact", two, one)

    # -- K4 ---------------------------------------------------------------

    def k4(self, case, b, p, d, n_pad, out_dtype, seed):
        from quantized_vit_tpu_torch.ops import (patch_finalize,
                                                 patch_finalize_plain)

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        acc = self.t(rng.standard_normal((b, p, d)) * 300, f32)
        pos = self.t(rng.standard_normal((p, d)) * 0.02, f32)
        cls = self.t(rng.standard_normal(d) * 0.02, f32)
        sc = self.scal(1e-3)
        got = patch_finalize(acc, pos, cls, sc, n_pad=n_pad,
                             out_dtype=out_dtype)
        want = patch_finalize_plain(acc, pos, cls, sc, n_pad=n_pad,
                                    out_dtype=out_dtype)
        return self.check("patch_finalize", case, "exact", got, want)

    def run_small_batch_kernels(self, cfg):
        """K3 with int_attention, K6 and K5 at the small-batch routes'
        shapes (ViT-B: batch 2-3 for K6, batch 1 at full depth for K5)
        and at small ragged ones."""
        _, _, d, n_real, n_pad, _, hid, _, heads = shapes(cfg)
        hd = d // heads
        b = BATCH
        bf16, f32 = torch.bfloat16, torch.float32
        for fmt in ("int4", "int8"):
            self.k3(f"main[{b}x{n_pad}x{d},h{heads}]({fmt},int_attn)", b,
                    n_pad, d, heads, n_real, fmt, fmt, False, 11,
                    int_attn=True)
            for pow_ in (False, True):
                self.k3(f"small[3x40x96,h3]({fmt},{'pow' if pow_ else 'lin'}"
                        ",int_attn)", 3, 40, 96, 3, 29, fmt, fmt, pow_, 12,
                        int_attn=True)
        self.k3("small[3x40x96,h3](f32,int_attn)", 3, 40, 96, 3, 29, "int8",
                "int8", False, 13, f32, int_attn=True)
        seed = 100
        for bk in (2, 3):
            for dt in (bf16, f32):
                for quant in (None, "lin", "pow"):
                    for int_attn in (False, True):
                        seed += 1
                        self.k6(f"main[{bk}x{n_pad},h{heads}x{hd}]"
                                f"({str(dt)[6:]},{quant or 'float'},"
                                f"{'int' if int_attn else 'f'}_attn)", bk,
                                n_pad, heads, hd, n_real, dt, quant,
                                int_attn, seed)
        for quant in (None, "lin", "pow"):
            for int_attn in (False, True):
                seed += 1
                tag = f"{quant or 'float'},{'int' if int_attn else 'f'}_attn"
                self.k6(f"small[3x40,h3x32]({tag})", 3, 40, 3, 32, 29, bf16,
                        quant, int_attn, seed)
                self.k6(f"small[1x37,h2x24](f32,{tag})", 1, 37, 2, 24, 29,
                        f32, quant, int_attn, seed)
        for fmt in ("int4", "int8"):
            for dt in (bf16, f32):
                seed += 1
                self.k5(f"main[1x{n_pad}x{d},h{heads},L{cfg.depth}]"
                        f"({fmt},{str(dt)[6:]})", 1, n_pad, n_real, d, heads,
                        hid, cfg.depth, fmt, dt, False, seed)
        self.k5(f"main[1x{n_pad}x{d},h{heads},L{cfg.depth}](int4,pow)", 1,
                n_pad, n_real, d, heads, hid, cfg.depth, "int4", bf16, True,
                seed + 1)
        for fmt in ("int4", "int8"):
            self.k5(f"small[2x32x96,h3,L2]({fmt},j2)", 2, 32, 29, 96, 3, 160,
                    2, fmt, bf16, False, 120)
            self.k5_images(f"small[2x32x96,h3,L2]({fmt},j2=j1+j1)", 32, 29,
                           96, 3, 160, 2, fmt, 121)
        self.k5("small[1x40x64,h2,L3](int4,pow)", 1, 40, 37, 64, 2, 128, 3,
                "int4", bf16, True, 122)
        self.k5("small[1x40x64,h2,L3](int8,f32)", 1, 40, 37, 64, 2, 128, 3,
                "int8", f32, False, 123)

    # -- K9 ---------------------------------------------------------------

    def k9(self, case, b, n, heads, hd, d, n_valid, dtype, fmt, quant,
           int_attn, seed, bias=True, x_scale=0.7, out_d=0.01, out_top=31,
           scale=2e-3, layout=None):
        """K9 (attention + proj) against its plain version (K6's plain
        levels, then K1's plain residual epilogue); quant "lin" (t = 1) or
        "pow" (t != 1). ``layout`` (query rows, cluster size): launched at
        that layout (``_launch_qkv_proj``) instead of the picker's; a CPU
        rehearsal takes the wrapper (its plain version)."""
        from quantized_vit_tpu_torch.ops import (attention_qkv_proj,
                                                 attention_qkv_proj_plain)
        from quantized_vit_tpu_torch.ops.attention import (
            _launch_qkv_proj, plan_attention_qkv_proj)

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        qkv = self.t(rng.standard_normal((b, n, 3 * heads * hd)) * x_scale,
                     dtype)
        w = self.weight(rng, heads * hd, d, fmt)
        res = self.t(rng.standard_normal((b, n, d)) * 0.5, dtype)
        pb = self.t(rng.standard_normal(d) * 0.01, f32) if bias else None
        kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=n_valid,
                  out_d=self.scal(out_d), out_t=self.scal(
                      0.93 if quant == "pow" else 1.0), out_top=out_top,
                  out_pow=quant == "pow", fmt=fmt, out_dtype=dtype,
                  int_attention=int_attn)
        if layout is None or self.dev.type != "cuda":
            got = attention_qkv_proj(qkv, w, self.scal(scale), pb, res, **kw)
        else:
            run = {k: kw.pop(k) for k in ("n_valid", "out_dtype",
                                          "int_attention")}
            got = _launch_qkv_proj(plan_attention_qkv_proj(
                w, self.scal(scale), pb, **kw), qkv, res, *layout, **run)
            kw.update(run)
        want = attention_qkv_proj_plain(qkv, w, self.scal(scale), pb, res,
                                        **kw)
        return self.check("attention_qkv_proj", case, "attention", got, want)

    def run_qkv_proj_layouts(self):
        """K9 at every (query rows R, qkv dtype, head bound) instantiation,
        each at cluster sizes G the picker can reach (1 to 8): ViT-H/14
        widths at 272 tokens (ragged last 32-row tile: 8 x 32 + 16) with G
        8, 4, 2 and 1, so the 1280 columns split 160 (packed int4), 320 and
        640 a block against the 256-column pass; ViT-B/16 widths at 208
        tokens (6 x 32 + 16) with G 3, 6, 1 and 2; odd head counts (3 heads
        with G 3 and 1, 5 heads of 80 with G 5); masked keys and
        ``int_attention`` on some rows."""
        bf16, f32 = torch.bfloat16, torch.float32
        seed = 600
        for dt, cases in ((bf16, ((32, 8, 3), (16, 4, 6), (32, 2, 1))),
                          (f32, ((32, 8, 3), (16, 4, 6), (16, 1, 2)))):
            dn = str(dt)[6:]
            for rows, gh, gb in cases:
                seed += 1
                fmt = "int4" if gh == 8 else "int8"
                ia = dt == f32 and rows == 32
                self.k9(f"layout[R{rows},G{gh}](2x272,h16x80,{fmt},{dn}"
                        f"{',int_attn' if ia else ''})", 2, 272, 16, 80,
                        1280, 257, dt, fmt, "lin" if rows == 32 else "pow",
                        ia, seed, layout=(rows, gh))
                self.k9(f"layout[R{rows},G{gb}](2x208,h12x64,int4,{dn}"
                        f"{',int_attn' if rows == 16 else ''})", 2, 208, 12,
                        64, 768, 197, dt, "int4", "lin", rows == 16,
                        seed + 50, layout=(rows, gb))
        for rows, g, dt in ((16, 3, bf16), (32, 1, f32), (32, 3, f32)):
            seed += 1
            self.k9(f"layout[R{rows},G{g}](3x40,h3x32,int8,{str(dt)[6:]})",
                    3, 40, 3, 32, 96, 29, dt, "int8", "pow", g == 1, seed,
                    layout=(rows, g))
        self.k9("layout[R32,G5](2x100,h5x80,int4,bf16)", 2, 100, 5, 80, 400,
                90, bf16, "int4", "lin", False, 690, layout=(32, 5))

    def run_qkv_proj_kernels(self, cfg):
        """K9 at bench.py's parity-preamble shapes (bench.py:165-185), at
        ViT-B/16's batch 32 and ViT-H/14's batch 8 (tools/exp_vith.py's B;
        272 padded tokens, as the port's forward pads them), and at small
        ragged shapes (an odd head count, masked keys, heads off the
        16-byte paths): int8 and packed int4 weights, t = 1 and t != 1,
        ``int_attention`` off and on, with and without bias, bf16 and
        f32."""
        bf16, f32 = torch.bfloat16, torch.float32
        for i, fmt in enumerate(("int8", "int4")):
            self.k9(f"bench[2x64x384,h2](bf16,{fmt})", 2, 64, 2, 64, 256, 50,
                    bf16, fmt, "lin", False, 500 + i, x_scale=0.1,
                    out_d=0.05, out_top=7, scale=1e-3)
        b, _, d, n_real, n_pad, _, _, _, heads = shapes(cfg)
        hd = d // heads
        tag = f"vit_b[{b}x{n_pad},h{heads}x{hd}]"
        seed = 510
        for fmt in ("int8", "int4"):
            for quant in ("lin", "pow"):
                seed += 1
                self.k9(f"{tag}({fmt},{quant},bf16)", b, n_pad, heads, hd, d,
                        n_real, bf16, fmt, quant, False, seed)
            self.k9(f"{tag}({fmt},lin,bf16,int_attn)", b, n_pad, heads, hd,
                    d, n_real, bf16, fmt, "lin", True, seed + 10)
        self.k9(f"{tag}(int8,lin,f32,no bias)", b, n_pad, heads, hd, d,
                n_real, f32, "int8", "lin", False, 530, bias=False)
        _, d, n_real, n_pad, _, heads = vit_h_shapes(vit_h_cfg())
        hd = d // heads
        bh = VIT_H_BRANCH_BATCH
        tag = f"vit_h[{bh}x{n_pad},h{heads}x{hd}]"
        for i, (fmt, quant, dt, ia, bias) in enumerate((
                ("int8", "lin", bf16, False, True),
                ("int4", "lin", bf16, False, True),
                ("int8", "pow", bf16, False, False),
                ("int8", "lin", bf16, True, True),
                ("int8", "lin", f32, False, True),
                ("int4", "pow", f32, True, False))):
            opts = (",int_attn" if ia else "") + ("" if bias else ",no bias")
            self.k9(f"{tag}({fmt},{quant},{str(dt)[6:]}{opts})", bh, n_pad,
                    heads, hd, d, n_real, dt, fmt, quant, ia, 540 + i,
                    bias=bias)
        seed = 560
        for quant in ("lin", "pow"):
            for ia in (False, True):
                seed += 1
                t = f"{quant},{'int' if ia else 'f'}_attn"
                self.k9(f"small[3x40,h3x32,D96](int4,bf16,{t})", 3, 40, 3, 32,
                        96, 29, bf16, "int4", quant, ia, seed)
                self.k9(f"small[1x37,h2x24,D72](int8,f32,{t})", 1, 37, 2, 24,
                        72, 29, f32, "int8", quant, ia, seed + 10,
                        bias=not ia)
                self.k9(f"small[2x40,h3x24,D72](int4,bf16,{t})", 2, 40, 3, 24,
                        72, 40, bf16, "int4", quant, ia, seed + 20)

    # -- K10-K12 ----------------------------------------------------------

    def int_mm(self, kernel, case, m, k, n, seed, *, fmt="int4",
               x_dtype=None, act_pow=False, out_dtype=torch.float32,
               requant_top=None, bias=True, scalar=False):
        """One of the integer GEMMs (``int4_matmul``, ``int8_matmul``,
        ``quant_matmul_fa``) against its plain version: float outputs
        exact, requantized levels under the levels contract. Inputs as
        tools/profile_kernels.py makes them (levels in [-7, 7], a float x
        at 0.1 with d 0.05 and top 7); int8_matmul's levels span int8."""
        from quantized_vit_tpu_torch.ops import (int4_matmul,
                                                 int4_matmul_plain,
                                                 int8_matmul,
                                                 int8_matmul_plain,
                                                 quant_matmul_fa,
                                                 quant_matmul_fa_plain)
        from quantized_vit_tpu_torch.quant import pack_int4

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        lo = -127 if kernel == "int8_matmul" else -7
        if kernel == "quant_matmul_fa":
            x = self.t(rng.standard_normal((m, k)) * 0.1, x_dtype)
        else:
            x = self.t(rng.integers(lo, -lo + 1, (m, k)).astype(np.int8))
        w = self.t(rng.integers(lo, -lo + 1, (k, n)).astype(np.int8))
        if fmt == "int4":
            w = pack_int4(w, axis=0)
        sc = (self.scal(1e-3) if scalar else
              self.t(rng.random(n) * 0.01 + 1e-3, f32))
        if requant_top is not None:
            sc = sc * 2.0
        b = self.t(rng.standard_normal(n) * 0.01, f32) if bias else None
        if kernel == "int4_matmul":
            kw = dict(out_dtype=out_dtype, requant_top=requant_top)
            got = int4_matmul(x, w, sc, b, **kw)
            want = int4_matmul_plain(x, w, sc, b, **kw)
        elif kernel == "int8_matmul":
            got = int8_matmul(x, w, sc, b, out_dtype=out_dtype)
            want = int8_matmul_plain(x, w, sc, b, out_dtype=out_dtype)
        else:
            q = (self.scal(0.05), self.scal(1.08 if act_pow else 1.0),
                 torch.full((), 7, dtype=torch.int32, device=self.dev))
            kw = dict(fmt=fmt, act_pow=act_pow, out_dtype=out_dtype)
            got = quant_matmul_fa(x, w, sc, b, *q, **kw)
            want = quant_matmul_fa_plain(x, w, sc, b, *q, **kw)
        return self.check(kernel, case, "levels" if requant_top else "exact",
                          got, want)

    def run_int_matmul_kernels(self, cfg):
        """K10-K12 at tools/profile_kernels.py's four ViT-B/16 layer shapes
        (qkv, proj, fc1, fc2) at M = 8 images x the padded tokens (1664):
        int4_matmul with f32 out and with the requant epilogue,
        int8_matmul with f32 and bf16 out, quant_matmul_fa for int4 and
        int8 weights, act_pow off and on, bf16 x to bf16 out (the tool's
        case) and f32 to f32; then tests/ops/test_int4_matmul.py's ragged
        shapes and a scalar scale without bias."""
        bf16, f32 = torch.bfloat16, torch.float32
        seed = 600
        for label, m, k, n in profile_shapes(cfg):
            tag = f"profile_{label}[{m}x{k}x{n}]"
            seed += 10
            self.int_mm("int4_matmul", tag + "(f32)", m, k, n, seed)
            self.int_mm("int4_matmul", tag + "(requant 7)", m, k, n,
                        seed + 1, requant_top=7)
            for i, dt in enumerate((f32, bf16)):
                self.int_mm("int8_matmul", tag + f"({str(dt)[6:]})", m, k, n,
                            seed + 2 + i, fmt="int8", out_dtype=dt)
            for fmt in ("int4", "int8"):
                for pw in (False, True):
                    for dt in (bf16, f32):
                        self.int_mm("quant_matmul_fa",
                                    tag + f"({fmt},{'pow' if pw else 'lin'},"
                                    f"{str(dt)[6:]})", m, k, n, seed + 4,
                                    fmt=fmt, x_dtype=dt, act_pow=pw,
                                    out_dtype=dt)
        for m, k, n in ((8, 64, 128), (197, 768, 768), (100, 250, 130)):
            self.int_mm("int4_matmul", f"small[{m}x{k}x{n}]", m, k, n, 650)
            self.int_mm("int4_matmul", f"small[{m}x{k}x{n}](requant 7)", m,
                        k, n, 651, requant_top=7)
        for m, k, n in ((64, 128, 128), (197, 768, 256), (33, 40, 24)):
            self.int_mm("int8_matmul", f"small[{m}x{k}x{n}]", m, k, n, 652,
                        fmt="int8", bias=m % 2 == 1)
        self.int_mm("int4_matmul", "small[32x128x64](scalar scale, no bias)",
                    32, 128, 64, 653, scalar=True, bias=False)
        for m, k, n in ((24, 64, 48), (7, 40, 20), (50, 250, 130)):
            for fmt in ("int4", "int8"):
                self.int_mm("quant_matmul_fa", f"small[{m}x{k}x{n}]({fmt})",
                            m, k, n, 654, fmt=fmt, x_dtype=f32, act_pow=True,
                            scalar=fmt == "int8", bias=fmt == "int4")
        # float16 out, which the kernel writes as f32 and the wrapper
        # casts (as the JAX wrappers cast)
        f16 = torch.float16
        for label, m, k, n in profile_shapes(cfg)[:1]:
            tag = f"profile_{label}[{m}x{k}x{n}](float16)"
            self.int_mm("int4_matmul", tag, m, k, n, 655, out_dtype=f16)
            self.int_mm("int8_matmul", tag, m, k, n, 656, fmt="int8",
                        out_dtype=f16)
            self.int_mm("quant_matmul_fa", tag, m, k, n, 657, x_dtype=f32,
                        act_pow=True, out_dtype=f16)
        for m, k, n in ((33, 40, 24), (100, 250, 130)):
            self.int_mm("int4_matmul", f"small[{m}x{k}x{n}](float16)", m, k,
                        n, 658, out_dtype=f16)
            self.int_mm("int8_matmul", f"small[{m}x{k}x{n}](float16)", m, k,
                        n, 659, fmt="int8", out_dtype=f16)

    # -- K7 ---------------------------------------------------------------

    def k7(self, case, x, g, d, q_m, t, q_s=0.0, clip=(-2.0, 2.0)):
        """K7 against its plain version: grad_x bit-exact, each of the
        three sums within 1e-5 of the L1 mass of its summands."""
        from quantized_vit_tpu_torch.ops.quant_vjp import (
            lsfq_nonlinear_bwd_fused, lsfq_nonlinear_bwd_plain,
            nonlinear_bwd_terms)

        kw = dict(clip_lo=clip[0], clip_hi=clip[1], q_s=q_s)
        d, q_m, t = (torch.full((1,), float(v), device=self.dev)
                     for v in (d, q_m, t))
        got = lsfq_nonlinear_bwd_fused(x, g, d, q_m, t, **kw)
        want = lsfq_nonlinear_bwd_plain(x, g, d, q_m, t, **kw)
        l1 = [float(v.abs().sum(dtype=torch.float64))
              for v in nonlinear_bwd_terms(x, g, d, q_m, t, **kw)[1:]]
        gx_max, gx_share = float_diff(got[0], want[0])
        errs = [abs(float(a) - float(b)) for a, b in zip(got[1:], want[1:])]
        finite = bool(torch.isfinite(got[0]).all()) and all(
            np.isfinite(float(v)) for v in got[1:])
        ok = (gx_max == 0.0 and finite
              and all(e <= 1e-5 * m for e, m in zip(errs, l1)))
        self.rows.append({
            "kernel": "quant_bwd", "case": case, "check": "k7",
            "max_abs_err": max([gx_max] + errs), "share_differ": gx_share,
            "bit_exact": gx_max == 0.0 and max(errs) == 0.0, "ok": ok,
            "sum_err_over_l1": max(e / m if m else e
                                   for e, m in zip(errs, l1)),
            "grad_x_exact": gx_max == 0.0})
        if not ok:
            self.failures.append(f"quant_bwd {case}: grad_x max {gx_max}, "
                                 f"sum errors {errs} vs L1 {l1}")

    def run_quant_bwd(self, cfg):
        """K7 at every distinct site shape of the training step (weights
        near 4-bit scales, activations near 8-bit, t != 1, and t = 1 at
        two of them), an edge-mask tile with values at q_s, at q_m and at
        +-clip, a q_m <= q_s overlap, ragged element counts (not divisible
        by 4), a non-contiguous g and an unaligned x."""
        gen = torch.Generator(device=self.dev).manual_seed(70)
        dev = self.dev

        def randn(shape, scale):
            return torch.randn(shape, generator=gen, device=dev) * scale

        seen = set()
        for site, shape, _ in k7_sites(cfg):
            if shape in seen:
                continue
            seen.add(shape)
            weight = site.endswith("_wt")
            x = randn(shape, 0.02 if weight else 1.2)
            g = randn(shape, 1e-3)
            q_m = float(x.abs().max()) * 0.9 if weight else 1.1
            d = q_m / 7 if weight else 0.07
            tag = f"main[{'x'.join(map(str, shape))}]({site})"
            self.k7(tag + "(t!=1)", x, g, d, q_m, 0.94 if weight else 1.06)
            if site in ("qkv_act", "fc1_wt"):
                self.k7(tag + "(t=1)", x, g, d, q_m, 1.0)
        base = torch.tensor([0.0, 1e-8, 0.5, 1.0, 1.5, 2.0, 2.5, -0.5, -1.0,
                             -2.0, -3.0, 0.99, 1.01, -1e-8, 0.0, 0.0],
                            device=dev)
        x = base.repeat(8, 8)  # [8, 128]: q_s = 0, q_m = 1, clip = +-2
        for t in (1.0, 1.06):
            self.k7(f"small[8x128](edges,t={t})", x, torch.cos(x * 3.0),
                    0.05, 1.0, t)
        x = randn((64, 96), 0.6)
        for t in (1.0, 1.06):
            self.k7(f"small[64x96](q_m<=q_s,t={t})", x, randn((64, 96), 1.0),
                    0.02, 0.3, t, q_s=0.5)
        for shape in ((7, 13), (3, 5, 7), (1,), (5, 1001)):
            x = randn(shape, 1.2)
            self.k7(f"small[{'x'.join(map(str, shape))}](ragged)", x,
                    randn(shape, 1.0), 0.07, 1.1, 1.06)
        x = randn((64, 96), 1.2)
        self.k7("small[64x96](g non-contiguous)", x,
                randn((96, 64), 1.0).t(), 0.07, 1.1, 1.06)
        buf = randn((1 + 40 * 100,), 1.2)
        self.k7("small[40x100](x unaligned)", buf[1:].reshape(40, 100),
                randn((40, 100), 1.0), 0.07, 1.1, 0.97)

    def run_mlp_kernels(self, cfg):
        """K2 at ViT-H/14's widths (K 1280, H 5120; batch 1 and 2: 272
        and 544 rows) with int8, packed int4 and mixed int8/int4 weights,
        which its first design refused; then at the ViT-B rows of batch
        1, 2 and 32 (208, 416, 6656) at set work splits: both tiles of
        each GEMM (ragged last row tiles at 208 and 416), fc2's tiles all
        split, some whole and the rest split 2-5 ways, the LayerNorm
        groups of 8 to 256 threads."""
        vh = vit_h_cfg()
        _, d, _, n_pad, hid, _ = vit_h_shapes(vh)
        seed = 500
        for b in (1, 2):
            for f1, f2 in (("int8", "int8"), ("int4", "int4"),
                           ("int8", "int4")):
                seed += 1
                self.k2(f"vit_h[{b * n_pad}x{d}x{hid}]({f1}/{f2})",
                        b * n_pad, d, hid, f1, f2, seed % 2 == 0, seed)
        bb, _, bd, _, bn_pad, _, bhid, _, _ = shapes(cfg)
        # (LN threads, fc1 tile, fc2 tile, fc2 tiles whole, splits)
        for m, lays in ((bn_pad, ((256, 64, 64, 0, 5), (256, 128, 128, 0, 3),
                                  (8, 64, 64, 10, 2))),
                        (2 * bn_pad, ((128, 64, 64, 0, 3),
                                      (32, 128, 128, 4, 4))),
                        (bb * bn_pad, ((8, 128, 128, 264, 5),
                                       (16, 64, 64, 1000, 2)))):
            for t, t1, t2, full, s in lays:
                seed += 1
                tiles2 = -(-m // t2) * -(-bd // t2)
                full = min(full, tiles2)
                self.k2(f"layout[{m}x{bd}x{bhid}](ln{t},t{t1}/{t2},"
                        f"whole{full},S{s})", m, bd, bhid,
                        "int8" if seed % 2 else "int4",
                        "int8" if seed % 2 else "int4", seed % 3 == 0, seed,
                        layout=dict(ln_threads=t, tile1=t1, tile2=t2,
                                    full2=full, splits=s))

    def run_vit_h_kernels(self):
        """K8 against its plain version at ViT-H/14's MLP shapes (batch 1
        and 2: 272 and 544 rows, K 1280, H 5120), at ViT-B's batch-3 chain
        shape (the JAX routing streams int8 weights there too) and at small
        ragged ones (off the 16-byte paths, one row tile, many), for the
        linear and pow quantizers, both residual dtypes, with and without
        bias; K3 and K6 at head_dim 80 (ViT-H's 272 tokens and a ragged
        40; K3 also in f32 at batch 4), int_attention on and off."""
        vh = vit_h_cfg()
        _, d, n_real, n_pad, hid, heads = vit_h_shapes(vh)
        hd = d // heads
        bf16, f32 = torch.bfloat16, torch.float32
        k8 = dict(kernel="fused_mlp_chunked")
        seed = 300
        for b in (1, 2):
            for pow_ in (False, True):
                for stream in (bf16, f32):
                    seed += 1
                    tag = (f"{'pow' if pow_ else 'lin'},"
                           f"{str(stream)[6:]}")
                    self.k2(f"main[{b * n_pad}x{d}x{hid}]({tag})",
                            b * n_pad, d, hid, "int8", "int8", pow_, seed,
                            stream, **k8)
            self.k2(f"main[{b * n_pad}x{d}x{hid}](lin,bf16,no bias)",
                    b * n_pad, d, hid, "int8", "int8", False, seed + 50,
                    bf16, bias=False, **k8)
        _, _, bd, _, bn_pad, _, bhid, _, _ = shapes(main_cfg())
        self.k2(f"vit_b_chain_b3[{3 * bn_pad}x{bd}x{bhid}](lin,bf16)",
                3 * bn_pad, bd, bhid, "int8", "int8", False, 360, bf16, **k8)
        for i, (m, k, h) in enumerate(((45, 96, 160), (96, 128, 512),
                                       (50, 72, 40), (1, 64, 96))):
            for pow_ in (False, True):
                self.k2(f"small[{m}x{k}x{h}]({'pow' if pow_ else 'lin'})",
                        m, k, h, "int8", "int8", pow_, 370 + 2 * i + pow_,
                        f32 if pow_ else bf16, bias=not pow_, **k8)
        for int_attn in (False, True):
            tag = "int_attn" if int_attn else "f_attn"
            self.k3(f"vit_h[2x{n_pad}x{d},h{heads}](int8,{tag})", 2, n_pad,
                    d, heads, n_real, "int8", "int8", False, 380 + int_attn,
                    int_attn=int_attn)
            self.k3(f"small[3x40x{2 * hd},h2](int8,pow,{tag})", 3, 40,
                    2 * hd, 2, 29, "int8", "int8", True, 382 + int_attn,
                    int_attn=int_attn)
            self.k3(f"small[3x40x{2 * hd},h2](f32,{tag})", 3, 40, 2 * hd, 2,
                    29, "int4", "int4", False, 384 + int_attn, f32,
                    int_attn=int_attn)
            # an f32 residual stream at batch 4, which the first K3 refused
            self.k3(f"vit_h[4x{n_pad}x{d},h{heads}](int8,f32,{tag})", 4,
                    n_pad, d, heads, n_real, "int8", "int8", False,
                    386 + int_attn, f32, int_attn=int_attn)
        seed = 400
        for b in (1, 2):
            for dt in (bf16, f32):
                for quant in (None, "lin", "pow"):
                    for int_attn in (False, True):
                        seed += 1
                        self.k6(f"vit_h[{b}x{n_pad},h{heads}x{hd}]"
                                f"({str(dt)[6:]},{quant or 'float'},"
                                f"{'int' if int_attn else 'f'}_attn)", b,
                                n_pad, heads, hd, n_real, dt, quant,
                                int_attn, seed)
        for quant in (None, "lin", "pow"):
            for int_attn in (False, True):
                seed += 1
                self.k6(f"small[3x40,h2x{hd}]({quant or 'float'},"
                        f"{'int' if int_attn else 'f'}_attn)", 3, 40, 2, hd,
                        29, bf16, quant, int_attn, seed)

    # -- K13 --------------------------------------------------------------

    def k13(self, case, b, h, n, hd, n_valid, dts, quant, seed):
        """K13 on seeded q/k/v [b, h, n, hd] (``dts``: q/k dtype, v
        dtype) against its plain version; ``quant``: None (float out in
        v's dtype), "lin" (t = 1) or "pow" (t != 1) int8 levels."""
        from quantized_vit_tpu_torch.ops import (flash_attention,
                                                 flash_attention_plain)
        from quantized_vit_tpu_torch.ops.attention import (_card_shape,
                                                           flash_tile_rows)

        g = torch.Generator(device=self.dev).manual_seed(seed)
        q, k, v = (torch.randn((b, h, n, hd), generator=g,
                               device=self.dev).to(dt)
                   for dt in (dts[0], dts[0], dts[1]))
        kw = dict(sm_scale=hd**-0.5, n_valid=n_valid, out_dtype=dts[1])
        if quant:
            kw.update(out_d=self.scal(0.02), out_t=self.scal(
                0.93 if quant == "pow" else 1.0), out_top=31,
                out_pow=quant == "pow")
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        self.check("flash_attention", case,
                   "levels" if quant else "attention", got, want)
        self.rows[-1]["qt"] = flash_tile_rows(
            b, h, n, hd, *(_card_shape(q.device.index) if q.is_cuda else ()))

    # -- K14, K15 at tp = 1 (tp > 1: fsdp_phase's spawned processes) ------

    def k15(self, case, m, cfg, seed, pow_=False, stream=torch.bfloat16):
        """K15 (tp = 1) with the four int8 weight shards of ``cfg``'s
        block to gather: the MLP against fused_mlp_plain, each gathered
        weight against its shard, byte for byte."""
        rows = mlp_gather_case(self.dev, None, cfg, m, seed, pow_, stream)
        for row in rows:
            self.add(dict(row, case=case + row["case"]))

    def run_chunked_kernels(self, cfg):
        """K8 (its redesign on TMA and wgmma) at the rest of its route's
        sites and past its first design's limits, bit-exact or not: the
        384-px ViT-B/16 chain at batch 1 with an f32 residual stream (592
        rows), ViT-B/16's batch-32 rows (6656, the site timed beside K2),
        ragged rows at ViT-H/14's widths (1, 45, 300), K = 1536 (H 6144)
        at 272 and 544 rows, each with the linear and the pow quantizer
        and both residual dtypes; then launched at set work splits (each
        phase's token chunk and wgmma N 32-256, rings of 3 to 16 stages)
        at ViT-H/14's batch 1 and 2 and at small ragged shapes."""
        from quantized_vit_tpu_torch.ops import fused as F

        from quantized_vit_tpu_torch.models import ViTConfig

        bf16, f32 = torch.bfloat16, torch.float32
        k8 = dict(kernel="fused_mlp_chunked")
        bb, _, bd, _, bn_pad, _, bhid, _, _ = shapes(cfg)
        _, _, _, _, bn384, _, _, _, _ = shapes(ViTConfig(**dict(
            CFG_KW, **B384_KW)))
        vh = vit_h_cfg()
        _, d, _, n_pad, hid, _ = vit_h_shapes(vh)
        wide = 6 * d // 5  # 1536 at ViT-H/14's 1280
        seed = 900
        sites = [(f"chain384_b1[{bn384}x{bd}x{bhid}]", bn384, bd, bhid),
                 (f"vit_b_b{bb}[{bb * bn_pad}x{bd}x{bhid}]", bb * bn_pad,
                  bd, bhid),
                 *[(f"vit_h_ragged[{m}x{d}x{hid}]", m, d, hid)
                   for m in (1, 45, n_pad + 28)],
                 *[(f"wide[{b * n_pad}x{wide}x{4 * wide}]", b * n_pad, wide,
                    4 * wide) for b in (1, 2)]]
        for case, m, k, h in sites:
            for pow_, stream in ((False, bf16), (True, f32), (False, f32),
                                 (True, bf16)):
                seed += 1
                if m == bb * bn_pad and stream == f32 and not pow_:
                    continue
                self.k2(f"{case}({'pow' if pow_ else 'lin'},"
                        f"{str(stream)[6:]})", m, k, h, "int8", "int8", pow_,
                        seed, stream, **k8)

        def split(m, phase, g):
            chunks = 2 if F.CHUNKED_WR[phase - 1] == F.CHUNKED_ROWS else 1
            g = max(g, -(-m // (chunks * F.CHUNKED_NW[-1])))  # <= 256 rows
            nc = -(-(-(-m // (chunks * g))) // 8) * 8
            return {f"nc{phase}": nc,
                    f"nw{phase}": next(v for v in F.CHUNKED_NW if v >= nc),
                    f"g{phase}": -(-m // (chunks * nc))}

        # (rows, K, H, fc1's token groups, fc2's)
        for m, k, h, g1, g2 in ((n_pad, d, hid, 1, 1),
                                (n_pad, d, hid, 2, 3),
                                (n_pad, d, hid, 6, 12),
                                (2 * n_pad, d, hid, 4, 2),
                                (2 * n_pad, d, hid, 12, 5),
                                (45, 96, 160, 1, 1), (50, 72, 40, 3, 2),
                                (1, 64, 96, 1, 1)):
            lay = dict(split(m, 1, g1), **split(m, 2, g2))
            stage = max(F._chunked_stage(F.CHUNKED_WR[0], lay["nw1"]),
                        F._chunked_stage(F.CHUNKED_WR[1], lay["nw2"]))
            for stages in sorted({3, F.chunked_stages(stage)}):
                seed += 1
                pow_ = seed % 2 == 0
                self.k2(f"layout[{m}x{k}x{h}](fc1 {lay['nc1']}/{lay['nw1']}"
                        f"x{lay['g1']},fc2 {lay['nc2']}/{lay['nw2']}x"
                        f"{lay['g2']},st{stages})", m, k, h, "int8", "int8",
                        pow_, seed, f32 if pow_ else bf16,
                        layout=dict(lay, stages=stages), **k8)

    def run_flash_kernels(self, cfg):
        """K13 at K13's path shapes (ViT-B/16 batch 32: 208 tokens, 197
        real; ViT-H/14 batch 1 and 8: 272, 257, head_dim 80) in bf16, f32
        and mixed q/v dtypes, float and int8 outputs, t = 1 and t != 1,
        and at a ragged 50 tokens (37 real); then at a 384-px ViT-B/16's
        592 tokens, ViT-B/16 batch 2, ViT-H/14 batch 2 and batch 1 in f32,
        head_dim 80 and 128 at the tiles those leave out, and a head_dim of
        20 (rows off the 16-byte grid: the element-by-element staging), so
        every (tile, head bound) instantiation runs. Each row records its
        tile."""
        b, _, d, n_real, n_pad, _, _, _, heads = shapes(cfg)
        vh = vit_h_cfg()
        _, dh, nh_real, nh_pad, _, hh = vit_h_shapes(vh)
        bf16, f32 = torch.bfloat16, torch.float32
        seed = 800
        for tag, bb, h, n, hd, nv in (
                (f"vit_b[{b}x{heads}x{n_pad}x{d // heads}]", b, heads, n_pad,
                 d // heads, n_real),
                *((f"vit_h[{bk}x{hh}x{nh_pad}x{dh // hh}]", bk, hh, nh_pad,
                   dh // hh, nh_real) for bk in K13_VIT_H_BATCHES)):
            for quant in (None, "lin", "pow"):
                seed += 1
                self.k13(f"{tag}(bf16,{quant or 'float'})", bb, h, n, hd, nv,
                         (bf16, bf16), quant, seed)
        vb = (b, heads, n_pad, d // heads, n_real)
        for dts in ((f32, f32), (f32, bf16), (bf16, f32)):
            for quant in (None, "lin"):
                seed += 1
                dt = f"{str(dts[0])[6:]}/{str(dts[1])[6:]}"
                self.k13(f"vit_b[{b}x{heads}x{n_pad}x{d // heads}]({dt},"
                         f"{quant or 'float'})", *vb, dts, quant, seed)
        for dts in ((bf16, bf16), (f32, f32), (f32, bf16)):
            for quant in (None, "lin", "pow"):
                seed += 1
                dt = f"{str(dts[0])[6:]}/{str(dts[1])[6:]}"
                self.k13(f"ragged[3x2x50x72]({dt},{quant or 'float'})", 3, 2,
                         50, 72, 37, dts, quant, seed)
        # the ViT-B/16 widths at 384 px (577 tokens padded to 592) and at
        # batch 2; ViT-H/14 at batch 2, and at batch 1 in f32
        n384 = (384 // cfg.patch_size)**2 + 1
        n384_pad = -(-n384 // 16) * 16
        for quant in (None, "lin"):
            self.k13(f"vit_b384[{b}x{heads}x{n384_pad}x{d // heads}]"
                     f"(bf16,{quant or 'float'})", b, heads, n384_pad,
                     d // heads, n384, (bf16, bf16), quant, 830 + bool(quant))
        self.k13(f"vit_b[2x{heads}x{n_pad}x{d // heads}](bf16,float)", 2,
                 heads, n_pad, d // heads, n_real, (bf16, bf16), None, 832)
        self.k13(f"vit_h[2x{hh}x{nh_pad}x{dh // hh}](bf16,float)", 2, hh,
                 nh_pad, dh // hh, nh_real, (bf16, bf16), None, 833)
        for i, (dts, quant) in enumerate((((f32, f32), None),
                                          ((f32, bf16), "lin"))):
            dt = f"{str(dts[0])[6:]}/{str(dts[1])[6:]}"
            self.k13(f"vit_h[1x{hh}x{nh_pad}x{dh // hh}]({dt},"
                     f"{quant or 'float'})", 1, hh, nh_pad, dh // hh,
                     nh_real, dts, quant, 834 + i)
        # the tiles the path shapes leave out (64 rows at head bound 80 and
        # 128, 16 at 64 and 128), head_dim 128 at ragged tokens, and a
        # head_dim of 20 (rows off the 16-byte grid)
        seed = 840
        for shape, cases in (
                ((4, 16, 144, 80, 140), (((bf16, bf16), None),
                                         ((f32, f32), "lin"))),
                ((4, 8, 197, 128, 190), (((bf16, bf16), None),
                                         ((bf16, bf16), "pow"),
                                         ((f32, f32), None))),
                ((32, 16, 40, 128, 37), (((bf16, bf16), None),
                                         ((f32, f32), "lin"))),
                ((1, 2, 40, 128, 33), (((bf16, bf16), None),)),
                ((2, 3, 45, 20, 41), (((bf16, bf16), None),
                                      ((f32, bf16), "lin"),
                                      ((bf16, f32), "pow")))):
            for dts, quant in cases:
                seed += 1
                dt = f"{str(dts[0])[6:]}/{str(dts[1])[6:]}"
                self.k13(f"ragged[{'x'.join(map(str, shape[:4]))}]({dt},"
                         f"{quant or 'float'})", *shape, dts, quant, seed)

    def run_gather_kernels(self, cfg):
        """K14 on ViT-B's four block weights (int8, packed int4 and bf16
        bytes) and K15 at tp = 1: at ViT-B/16's width at the batch's rows
        and ragged ones, and at ViT-H/14's (the first K15 refused it) at
        batch 32's and 2's rows and a ragged count."""
        b, _, d, _, n_pad, *_ = shapes(cfg)
        for kind in ("int8", "int4", "bf16"):
            for row in gather_case(self.dev, None, cfg, kind, 900):
                self.add(row)
        m = b * n_pad
        self.k15(f"main[{m}x{d}]", m, cfg, 910)
        for i, mr in enumerate(K15_RAGGED_M):
            self.k15(f"ragged[{mr}x{d}]", mr, cfg, 911 + i)
        self.k15(f"ragged[{K15_RAGGED_M[0]}x{d}](pow,f32)", K15_RAGGED_M[0],
                 cfg, 915, pow_=True, stream=torch.float32)
        cfg_h = vit_h_cfg()
        n_h, d_h = vit_h_shapes(cfg_h)[3], cfg_h.embed_dim
        m_h = [bk * n_h for bk in (max(VIT_H_BATCHES), 2)]
        for i, mh in enumerate(m_h + [K15_RAGGED_M[1]]):
            self.k15(f"vith[{mh}x{d_h}]", mh, cfg_h, 916 + i)

    def run_all(self, cfg):
        t0 = time.time()
        seed = 0
        b, p, d, n_real, n_pad, kp, hid, ncls, heads = shapes(cfg)
        m = b * n_pad
        for fmt in ("int4", "int8"):
            for pow_ in (False, True):
                tag = f"{fmt},{'pow' if pow_ else 'lin'}"
                seed += 1
                self.k1(f"patch_embed[{b * p}x{kp}x{d}]({tag})", b * p, kp,
                        d, fmt, pow_, "quant", None, seed)
                self.k1(f"head[{b}x{d}x{ncls}]({tag})", b, d, ncls, fmt,
                        pow_, "quant", None, seed)
                self.k2(f"main[{m}x{d}x{hid}]({tag})", m, d, hid, fmt, fmt,
                        pow_, seed)
                self.k3(f"main[{b}x{n_pad}x{d},h{heads}]({tag})", b, n_pad,
                        d, heads, n_real, fmt, fmt, pow_, seed)
            self.k1(f"attn_proj[{m}x{d}x{d}]({fmt})", m, d, d, fmt, False,
                    None, "residual", seed)
        self.k4(f"main[{b}x{p}x{d}->{n_pad}](bf16)", b, p, d, n_pad,
                torch.bfloat16, 1)
        self.k4(f"main[{b}x{p}x{d}->{n_pad}](f32)", b, p, d, n_pad,
                torch.float32, 2)
        # small ragged shapes: every prologue x epilogue of K1, mixed
        # weight formats for K2/K3
        for fmt in ("int4", "int8"):
            for pow_ in (False, True):
                tag = f"{fmt},{'pow' if pow_ else 'lin'}"
                for pro in (None, "quant", "ln_quant", "gelu_quant"):
                    for epi in (None, "residual", "quant", "gelu_quant"):
                        seed += 1
                        self.k1(f"small[50x96x72,{pro}->{epi}]({tag})", 50,
                                96, 72, fmt, pow_, pro, epi, seed)
                self.k2(f"small[45x96x160]({tag})", 45, 96, 160, fmt, fmt,
                        pow_, seed)
                self.k3(f"small[3x40x96,h3]({tag})", 3, 40, 96, 3, 29, fmt,
                        fmt, pow_, seed)
        # shapes off the 16-byte paths (K, H, D not multiples of 16 / 32):
        # the kernels' byte-wise fallbacks (K1's own plan pads such a
        # weight; on a shared copy it reads it byte by byte)
        for fmt in ("int4", "int8"):
            for pro, epi in ((None, "residual"), ("ln_quant", "gelu_quant"),
                             ("quant", None)):
                seed += 1
                self.k1(f"small[50x40x72,{pro}->{epi}]({fmt})", 50, 40, 72,
                        fmt, False, pro, epi, seed)
                self.k1(f"small[50x40x72,{pro}->{epi}]({fmt},byte-wise)",
                        50, 40, 72, fmt, False, pro, epi, seed,
                        byte_wise=True)
            self.k2(f"small[45x72x40]({fmt})", 45, 72, 40, fmt, fmt, False,
                    seed)
            self.k3(f"small[3x40x72,h3]({fmt})", 3, 40, 72, 3, 29, fmt, fmt,
                    False, seed)
        self.k2("small[45x96x160](int8/int4)", 45, 96, 160, "int8", "int4",
                False, 7)
        self.k3("small[3x40x96,h3](int8/int4)", 3, 40, 96, 3, 29, "int8",
                "int4", False, 7)
        # the f32 residual stream (vit_int4_forward's default float_dtype)
        for fmt in ("int4", "int8"):
            self.k2(f"small[45x96x160](f32,{fmt})", 45, 96, 160, fmt, fmt,
                    False, 8, torch.float32)
            self.k3(f"small[3x40x96,h3](f32,{fmt})", 3, 40, 96, 3, 29, fmt,
                    fmt, False, 8, torch.float32)
        self.k4("small[3x4x72->16]", 3, 4, 72, 16, torch.bfloat16, 3)
        self.run_k1_sites(cfg)
        self.run_small_batch_kernels(cfg)
        self.run_mlp_kernels(cfg)
        self.run_vit_h_kernels()
        self.run_chunked_kernels(cfg)
        self.run_heads_tiles()
        self.run_qkv_attn_tiles()
        self.run_qkv_proj_kernels(cfg)
        self.run_qkv_proj_layouts()
        self.run_int_matmul_kernels(cfg)
        self.run_flash_kernels(cfg)
        self.run_gather_kernels(cfg)
        self.run_quant_bwd(cfg)
        sync()
        n_ok = sum(r["ok"] for r in self.rows)
        n_exact = sum(r["bit_exact"] for r in self.rows)
        log(f"[parity] {n_ok}/{len(self.rows)} cases pass, {n_exact} "
            f"bit-exact ({time.time() - t0:.1f} s)")
        for r in self.rows:
            if not r["ok"] or "small" not in r["case"]:
                log(f"  {'ok ' if r['ok'] else 'BAD'} {r['kernel']:18s} "
                    f"{r['case']:44s} max {r['max_abs_err']:.3g} "
                    f"share {r['share_differ']:.2e}")


def k7_sites(cfg):
    """(site, shape, launches per training step) of every nonlinear
    quantizer of the ViT training step at BATCH: K7 runs once for each
    weight quantizer and once for each activation quantizer."""
    b, p, d, n_real, _, kp, hid, ncls, _ = shapes(cfg)
    ps, rows, depth = cfg.patch_size, b * n_real, cfg.depth
    return [("patch_act", (b * p, kp), 1),
            ("patch_wt", (ps, ps, cfg.in_channels, d), 1),
            ("qkv_act", (rows, d), depth), ("qkv_wt", (d, 3 * d), depth),
            ("proj_act", (rows, d), depth), ("proj_wt", (d, d), depth),
            ("fc1_act", (rows, d), depth), ("fc1_wt", (d, hid), depth),
            ("fc2_act", (rows, hid), depth), ("fc2_wt", (hid, d), depth),
            ("head_act", (b, d), 1), ("head_wt", (d, ncls), 1)]


# ---------------------------------------------------------------------------
# phase 3: the main path, one batch-32 forward
# ---------------------------------------------------------------------------

def expected_launches(depth, route="block", mlp="fused_mlp"):
    """Launches of one forward. ``block`` (batch >= 4): K1 for the patch
    embed, each block's proj and the head, K3 once per block, K4 once.
    ``chain`` (batch 1-3): K1 also for each block's qkv, K6 in place of
    K3. The MLP once per block: ``fused_mlp`` (K2), ``fused_mlp_chunked``
    (K8), or ``chain``, two K1 launches (fc1, fc2). ``latency``: K1 twice,
    K4 and K5 once. ``fsdp``: the FSDP forward (a process's batch >= 4),
    the block route with K15 for the MLP and one K14 (block 0's
    gather)."""
    none = {"fused_quant_matmul": 0, "fused_mlp": 0, "attention_block": 0,
            "patch_finalize": 1, "attention_qkv": 0, "block_stack": 0,
            "quant_bwd": 0, "fused_mlp_chunked": 0, "attention_qkv_proj": 0,
            "int4_matmul": 0, "int8_matmul": 0, "quant_matmul_fa": 0,
            "flash_attention": 0, "gather_rows": 0, "fused_mlp_gather": 0}
    if route == "latency":
        return dict(none, fused_quant_matmul=2, block_stack=1)
    if route == "fsdp":
        return dict(none, fused_quant_matmul=2 + depth,
                    attention_block=depth, gather_rows=1,
                    fused_mlp_gather=depth)
    out = dict(none, fused_quant_matmul=2 + depth * (2 if route == "chain"
                                                     else 1))
    out["attention_qkv" if route == "chain" else "attention_block"] = depth
    if mlp == "chain":
        out["fused_quant_matmul"] += 2 * depth
    else:
        out[mlp] = depth
    return out


# Logit tolerance vs the plain path: every kernel repeats its plain
# version's f32 arithmetic (sums in f64), so the logits should agree to the
# last bit; a rare level flip at a rounding tie in an early block moves a
# logit by about scale*top*|w| ~ 1e-3*7*7 ~ 0.05 at most.
LOGIT_TOL = 0.05
CHAIN_BATCHES = (1, 2, 3)
# the batches at which both attention routes' branches are timed
ROUTE_BATCHES = (2, 3, 4, 8, 16, 32)
# the MLP kernel of the ViT-B chain forwards (int8-stored levels, bf16):
# the JAX routing (fused.py:916-929) streams the weights in hidden chunks
# at batch 3, whose 624 rows leave the resident TPU kernel a 128-row tile
CHAIN_MLP = {1: "fused_mlp", 2: "fused_mlp", 3: "fused_mlp_chunked"}
# ViT-H/14's MLP per batch (int8, bf16): K8 at 272 and 544 rows, the K1
# chain above 576 (vit_int4.py:323-356)
VIT_H_MLP = {1: "fused_mlp_chunked", 2: "fused_mlp_chunked"}


def check_forward(record, dev, tag, fn, plain, want_launches, batch, cfg):
    """One forward through the kernels with the launch counters set to 0
    just before and read just after; logits against ``plain``."""
    from quantized_vit_tpu_torch.ops import _build

    _build.reset_launches()
    logits = fn()
    sync()
    launches = dict(_build.LAUNCHES)
    ref = plain()
    sync()
    d = (logits - ref).abs()
    rec = {"forward": tag, "batch": batch, "launches": launches,
           "logits_shape": list(logits.shape),
           "max_abs_diff": float(d.max()),
           "share_differ": float((d > 0).float().mean()),
           "logits_equal": bool(torch.equal(logits, ref)),
           "argmax_agree": float((logits.argmax(1) == ref.argmax(1))
                                 .float().mean()),
           "logit_absmax": float(ref.abs().max())}
    record.setdefault("forward", []).append(rec)
    log(f"[forward {tag} b{batch}] launches {launches} max|dlogit| "
        f"{rec['max_abs_diff']:.3g} equal {rec['logits_equal']} "
        f"|logit|max {rec['logit_absmax']:.3g}")
    if dev.type == "cuda" and launches != want_launches:
        raise Failed(f"forward {tag} b{batch} launches {launches} != "
                     f"{want_launches}")
    if (tuple(logits.shape) != (batch, cfg.num_classes)
            or not torch.isfinite(logits).all()):
        raise Failed(f"forward {tag} logits {tuple(logits.shape)} not "
                     "finite or wrong shape")
    if rec["max_abs_diff"] > LOGIT_TOL:
        raise Failed(f"forward {tag} logits differ from the plain path by "
                     f"{rec['max_abs_diff']} > {LOGIT_TOL}")
    return launches


def forward_phase(dev, record):
    """The batch-32 forward (K3 + K2 route) for both weight storages, the
    chain forward at batch 1-3, ``int_attention`` on both routes, and the
    batch-1 latency forward (K5)."""
    from quantized_vit_tpu_torch.serve import (prepare_kernels,
                                               prepare_latency_artifact,
                                               random_vit_int4_artifact,
                                               vit_int4_forward,
                                               vit_int4_forward_latency)
    from quantized_vit_tpu_torch.utils import patchify_batch

    cfg = main_cfg()
    rng = np.random.default_rng(0)
    images = rng.standard_normal(
        (BATCH, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
    out = {"cfg": cfg, "x": x, "launches": {}}
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    for pack in (False, True):
        art = random_vit_int4_artifact(cfg, seed=0, pack_weights=pack,
                                       device=dev)
        # the weights' kernel layout and folded constants, once per
        # artifact (as the serve CLI does at load); no kernel launches
        t0 = time.perf_counter()
        plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
        sync()
        plan_ms = (time.perf_counter() - t0) * 1e3
        tag = "int4-packed" if pack else "int8-stored"
        launches = check_forward(
            record, dev, tag,
            lambda: vit_int4_forward(art, x, cfg, plan=plan, **kw),
            lambda: vit_int4_forward(art, x, cfg, use_kernels=False, **kw),
            expected_launches(cfg.depth), BATCH, cfg)
        record["forward"][-1]["prepare_kernels_host_ms"] = plan_ms
        if pack:
            out["art_packed"] = art
            continue
        out.update(art=art, plan=plan)
        out["launches"]["block"] = launches
        # the chain route (the JAX gate: batch < 4), same artifact
        for b in CHAIN_BATCHES:
            xb = x[:b]
            launches = check_forward(
                record, dev, f"chain,{tag}",
                lambda: vit_int4_forward(art, xb, cfg, plan=plan, **kw),
                lambda: vit_int4_forward(art, xb, cfg, use_kernels=False,
                                         **kw),
                expected_launches(cfg.depth, "chain", CHAIN_MLP[b]), b, cfg)
            out["launches"][f"chain_b{b}"] = launches
        # int_attention (the variant bench.py times) on both routes
        for b, route in ((4, "block"), (2, "chain")):
            xb = x[:b]
            check_forward(
                record, dev, f"{route},int_attn,{tag}",
                lambda: vit_int4_forward(art, xb, cfg, plan=plan,
                                         int_attention=True, **kw),
                lambda: vit_int4_forward(art, xb, cfg, use_kernels=False,
                                         int_attention=True, **kw),
                expected_launches(cfg.depth, route), b, cfg)
    # the batch-1 latency entry on the packed artifact (the JAX package's
    # latency format); the JAX bench demands its logits equal the chain's
    art = out["art_packed"]
    t0 = time.perf_counter()
    lat, meta = prepare_latency_artifact(art, cfg)
    sync()
    lat_ms = (time.perf_counter() - t0) * 1e3
    x1 = x[:1]
    out["launches"]["latency"] = check_forward(
        record, dev, "latency,int4-packed",
        lambda: vit_int4_forward_latency(lat, x1, cfg, meta, **kw),
        lambda: vit_int4_forward(art, x1, cfg, use_kernels=False, **kw),
        expected_launches(cfg.depth, "latency"), 1, cfg)
    record["forward"][-1]["prepare_latency_host_ms"] = lat_ms
    out.update(lat=lat, meta=meta)
    b384 = dict(CFG_KW, **B384_KW)
    out["launches"]["chain384_b1"] = limit_forward(dev, record, b384, "384",
                                                   1, torch.float32)
    out["launches"]["block384_b4"] = limit_forward(dev, record, b384, "384",
                                                   4, torch.bfloat16)
    out["launches"]["block_vith14_f32_b4"] = limit_forward(
        dev, record, dict(VIT_H_KW, depth=2), "_vith14", 4, torch.float32)
    # ViT-H/14 with packed int4 at batch 1-2: K2 at K = 1280
    for bk in (1, 2):
        out["launches"][f"chain_vith14_int4_b{bk}"] = limit_forward(
            dev, record, dict(VIT_H_KW, depth=2), "_vith14", bk,
            torch.bfloat16, pack=True)
    return out


def limit_forward(dev, record, cfg_kw, name, batch, float_dtype,
                  pack=False):
    """The forward of a configuration a first kernel refused (int8-stored
    levels from seed 0, or packed int4 with ``pack``), launches checked,
    logits against the plain path: the 384-px ViT-B/16 (``B384_KW`` over
    the main configuration) at batch 1 in f32 on the chain (K6 on 592
    tokens at head_dim 64) and at batch 4 in bf16 on the K3 route (592
    tokens); ViT-H/14 at depth 2 in f32 at batch 4 on the K3 route (272
    tokens x head_dim 80 in f32), and with packed int4 at batch 1 and 2
    in bf16 on the chain (K2 at K 1280). On the K3 route and with packed
    int4 the logits must equal the plain path's."""
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.serve import (prepare_kernels,
                                               random_vit_int4_artifact,
                                               uses_chain, vit_int4_forward)
    from quantized_vit_tpu_torch.serve.vit_int4 import mlp_route
    from quantized_vit_tpu_torch.utils import patchify_batch

    cfg = ViTConfig(**cfg_kw)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=pack,
                                   device=dev)
    plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
    images = np.random.default_rng(6).standard_normal(
        (batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
    kw = dict(float_dtype=float_dtype, images_layout="patches")
    n_pad = -(-cfg.num_tokens // 16) * 16
    mlp = mlp_route(batch * n_pad, cfg.embed_dim,
                    int(cfg.embed_dim * cfg.mlp_ratio),
                    "int4" if pack else "int8",
                    itemsize=float_dtype.itemsize)
    route = "chain" if uses_chain(batch) else "block"
    dt = "f32" if float_dtype == torch.float32 else "bf16"
    tag = f"{route}{name},{dt},{'int4-packed' if pack else 'int8-stored'}"
    launches = check_forward(
        record, dev, tag,
        lambda: vit_int4_forward(art, x, cfg, plan=plan, **kw),
        lambda: vit_int4_forward(art, x, cfg, use_kernels=False, **kw),
        expected_launches(cfg.depth, route, mlp), batch, cfg)
    if ((route == "block" or pack)
            and not record["forward"][-1]["logits_equal"]):
        raise Failed(f"forward {tag} b{batch}: logits differ from the "
                     "plain path's")
    return launches


def vit_h_phase(dev, record):
    """ViT-H/14 at full width and depth (int8-stored levels from seed 0,
    host-patchified input, bf16 residual stream) through the forward at
    batch 1, 2 and 32, each with the launch counters set to 0 just before
    and read just after, logits against the plain path: batch 1 and 2 run
    K1 qkv + K6 + K1 proj + K8 per block, batch 32 K3 + K1 proj + the
    K1 fc1/fc2 chain."""
    from quantized_vit_tpu_torch.serve import (prepare_kernels,
                                               random_vit_int4_artifact,
                                               vit_int4_forward)

    cfg = vit_h_cfg()
    t0 = time.perf_counter()
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False,
                                   device=dev)
    sync()
    art_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
    sync()
    plan_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(5)
    kp = cfg.patch_size**2 * cfg.in_channels
    x = torch.from_numpy(rng.standard_normal(
        (max(VIT_H_BATCHES), cfg.num_patches, kp)).astype(np.float32)).to(dev)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    out = {"cfg": cfg, "art": art, "plan": plan, "x": x, "launches": {}}
    for b in VIT_H_BATCHES:
        xb = x[:b]
        route = "chain" if b < 4 else "block"
        out["launches"][f"vith_b{b}"] = check_forward(
            record, dev, "vit_h14,int8-stored",
            lambda: vit_int4_forward(art, xb, cfg, plan=plan, **kw),
            lambda: vit_int4_forward(art, xb, cfg, use_kernels=False, **kw),
            expected_launches(cfg.depth, route, VIT_H_MLP.get(b, "chain")),
            b, cfg)
    record["vit_h"] = {"config": dict(VIT_H_KW), "artifact_s": art_s,
                       "prepare_kernels_host_ms": plan_ms}
    log(f"[vit_h] artifact {art_s:.1f} s, prepare_kernels {plan_ms:.1f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 3b: the kernel-level paths of bench.py and the JAX package's tools
# ---------------------------------------------------------------------------


def run_path(dev, tag, fn, want):
    """``fn()`` with the launch counters set to 0 just before and read just
    after; on the card the launches must be ``want`` (kernel: count).
    Returns the result and every counter."""
    from quantized_vit_tpu_torch.ops import _build

    _build.reset_launches()
    out = fn()
    sync()
    launches = dict(_build.LAUNCHES)
    got = {k: v for k, v in launches.items() if v}
    log(f"[path {tag}] launches {got}")
    if dev.type == "cuda" and got != want:
        raise Failed(f"path {tag}: launches {got} != {want}")
    return out, launches


def path_check(rec, tag, got, want, tol=None, levels=False):
    """``got`` against ``want`` into ``rec[tag]``: the attention contract
    (within 0.1, differing at <= 1% of positions), with ``levels`` the
    levels contract (within 1 level at <= 0.5% of positions) or, with
    ``tol``, allclose at rtol = atol = tol; raises Failed otherwise."""
    mx, share = float_diff(got, want)
    if levels:
        ok = mx <= 1 and share <= 0.005
    elif tol is None:
        ok = mx <= 0.1 and share <= 0.01
    else:
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
    ok = ok and tuple(got.shape) == tuple(want.shape) and bool(
        torch.isfinite(got.float()).all())
    rec[tag] = {"max_abs_diff": mx, "share_differ": share,
                "bit_equal": mx == 0.0, "ok": ok}
    log(f"  {tag}: max {mx:.3g} share {share:.2e} equal {mx == 0.0} ok {ok}")
    if not ok:
        raise Failed(f"{tag}: max {mx}, share {share}")


def kernel_paths_phase(dev, record, fwd):
    """The kernel-level entry points as bench.py and the JAX package's
    tools drive them, at full width, each path with the launch counters
    set to 0 just before and read just after:

    - bench.py's parity preamble (bench.py:165-185): K9 on qkv
      [2, 64, 384] against its plain pair;
    - tools/exp_vith.py: the ViT-H/14 attention branch at batch 8 on block
      0 of the seed-0 artifact and seeded input, K1 qkv (LayerNorm + quant
      prologue, bf16 out) then K9, against K3's branch (its heads launch
      and its K1 proj) on the same x: one function of the same weights,
      so within the attention contract;
    - tools/profile_kernels.py: at ViT-B/16's four layer shapes,
      quant_matmul_fa (int4, bf16 x and out, t = 1), int4_matmul (f32
      out) and int8_matmul on the same levels with int8 weights, each
      exact against its plain version;
    - tests/ops/test_int4_matmul.py:89-120 at ViT-B/16's fc1 (768 ->
      3072) on M = 1664 seeded rows: 4-bit LSFQ levels through
      int4_matmul, the float x through quant_matmul_fa, both within 1e-4
      of the fake-quant float product;
    - K13 (``flash_attention``, which nothing in the JAX package calls) on
      the q/k/v of block 0 of the seed-0 artifacts (:func:`block0_qkv`),
      ViT-B/16 at batch 32 and ViT-H/14 at batch 1 and 8, the bf16 output
      (attention contract) and the proj's int8 levels (levels contract)
      against its plain version.
    """
    from quantized_vit_tpu_torch.ops import (attention_block,
                                             attention_qkv_proj,
                                             attention_qkv_proj_plain,
                                             flash_attention,
                                             flash_attention_plain,
                                             fused_quant_matmul, int4_matmul,
                                             int4_matmul_plain, int8_matmul,
                                             int8_matmul_plain,
                                             quant_matmul_fa,
                                             quant_matmul_fa_plain)
    from quantized_vit_tpu_torch.quant import (init_quant_params,
                                               lsfq_levels, lsfq_nonlinear,
                                               lsfq_top_level, pack_int4)
    from quantized_vit_tpu_torch.serve.vit_int4 import _attention_layer

    bf16, f32 = torch.bfloat16, torch.float32
    rec, launches = {}, {}

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x.to(dtype) if dtype else x

    def scal(v):
        return torch.full((), v, dtype=f32, device=dev)

    # bench.py's parity preamble
    rng = np.random.default_rng(7)
    qkv = t(rng.standard_normal((2, 64, 3 * 128)) * 0.1, bf16)
    wp = t(rng.integers(-7, 8, (128, 256)).astype(np.int8))
    bp = t(rng.standard_normal(256) * 0.01, f32)
    resp = t(rng.standard_normal((2, 64, 256)) * 0.1, bf16)
    akw = dict(heads=2, sm_scale=0.125, n_valid=50, out_d=scal(0.05),
               out_t=scal(1.0), out_top=7, fmt="int8")
    got, launches["bench_preamble"] = run_path(
        dev, "bench_preamble",
        lambda: attention_qkv_proj(qkv, wp, scal(1e-3), bp, resp, **akw),
        {"attention_qkv_proj": 1})
    path_check(rec, "bench_preamble", got, attention_qkv_proj_plain(
        qkv, wp, scal(1e-3), bp, resp, **akw))

    # tools/exp_vith.py: the ViT-H/14 attention branch at batch 8
    vh = fwd["vit_h"]
    _, d, n_real, n_pad, _, heads = vit_h_shapes(vh["cfg"])
    hd = d // heads
    bh = VIT_H_BRANCH_BATCH
    blk = vh["art"]["blocks"][0]
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    layer = _attention_layer(blk, hd, hd**-0.5)
    x = t(np.random.default_rng(9).standard_normal((bh * n_pad, d)) * 0.5,
          bf16)
    x3 = x.reshape(bh, n_pad, d)
    proj_q = {k: layer[k] for k in ("heads", "sm_scale", "out_d", "out_t",
                                    "out_top", "out_pow")}

    def k1_k9():
        q = fused_quant_matmul(
            x, qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
            prologue="ln_quant", act_d=layer["act_d"], act_t=layer["act_t"],
            act_top=layer["act_top"], act_pow=layer["act_pow"],
            ln_scale=layer["ln_scale"], ln_bias=layer["ln_bias"],
            out_dtype=bf16)
        return attention_qkv_proj(
            q.reshape(bh, n_pad, -1), proj_e.w, proj_e.scale, proj_e.bias,
            x3, n_valid=n_real, fmt=proj_e.fmt, out_dtype=bf16, **proj_q)

    tag = f"vith_branch_b{bh}"
    k9_out, launches[tag] = run_path(
        dev, tag + " K1+K9", k1_k9,
        {"fused_quant_matmul": 1, "attention_qkv_proj": 1})
    k3_out, launches[tag + "_k3"] = run_path(
        dev, tag + " K3 branch",
        lambda: attention_block(
            x3, qkv_e.w, qkv_e.scale, qkv_e.bias, proj_e.w, proj_e.scale,
            proj_e.bias, fmt_proj=proj_e.fmt, n_valid=n_real,
            out_dtype=bf16, **layer),
        {"attention_block": 1, "fused_quant_matmul": 1})
    path_check(rec, tag + " K1+K9 vs K3 branch", k9_out, k3_out)

    # tools/profile_kernels.py's GEMMs at ViT-B/16's layer shapes
    rng = np.random.default_rng(0)
    gemm = []
    for label, m, k, n in profile_shapes(main_cfg()):
        w_lv = t(rng.integers(-7, 8, (k, n)).astype(np.int8))
        gemm.append((label, t(rng.standard_normal((m, k)) * 0.1, bf16),
                     t(rng.integers(-7, 8, (m, k)).astype(np.int8)), w_lv,
                     pack_int4(w_lv, axis=0),
                     t(rng.standard_normal(n) * 0.01, f32)))
    fa_q = (scal(0.05), scal(1.0),
            torch.full((), 7, dtype=torch.int32, device=dev))
    sc = scal(1e-3)

    def profile():
        return [(quant_matmul_fa(xf, wp4, sc, b, *fa_q, fmt="int4",
                                 act_pow=False, out_dtype=bf16),
                 int4_matmul(xl, wp4, sc, b, out_dtype=f32),
                 int8_matmul(xl, w8, sc, b, out_dtype=f32))
                for _, xf, xl, w8, wp4, b in gemm]

    outs, launches["profile_kernels"] = run_path(
        dev, "profile_kernels", profile,
        {k: len(gemm) for k in ("quant_matmul_fa", "int4_matmul",
                                "int8_matmul")})
    for (label, xf, xl, w8, wp4, b), (fa, i4, i8) in zip(gemm, outs):
        path_check(rec, f"profile_{label} quant_matmul_fa", fa,
                   quant_matmul_fa_plain(xf, wp4, sc, b, *fa_q, fmt="int4",
                                         act_pow=False, out_dtype=bf16), 0.0)
        path_check(rec, f"profile_{label} int4_matmul", i4,
                   int4_matmul_plain(xl, wp4, sc, b), 0.0)
        path_check(rec, f"profile_{label} int8_matmul", i8,
                   int8_matmul_plain(xl, w8, sc, b), 0.0)
    del gemm, outs

    # the LSFQ pipeline at fc1's width
    _, m, k, n = profile_shapes(main_cfg())[2]
    rng = np.random.default_rng(8)
    xa = t(rng.standard_normal((m, k)) * 0.5, f32)
    wa = t(rng.standard_normal((k, n)) * 0.05, f32)
    d_w, qm_w, t_w = init_quant_params(wa, num_bits=4, nonlinear=True)
    d_a, qm_a, t_a = init_quant_params(xa, num_bits=4, nonlinear=True)
    clip = torch.tensor([-2.0, 2.0], device=dev)
    float_out = (lsfq_nonlinear(xa, d_a, qm_a, t_a, clip)
                 @ lsfq_nonlinear(wa, d_w, qm_w, t_w, clip))
    w_packed = pack_int4(lsfq_levels(wa, d_w, qm_w, t_w).to(torch.int8))
    x_lv = lsfq_levels(xa, d_a, qm_a, t_a).to(torch.int8)
    scale = (d_w * d_a)[0]
    top = lsfq_top_level(d_a, qm_a, t_a)[0]
    (i4, fa), launches["lsfq_fc1"] = run_path(
        dev, "lsfq_fc1",
        lambda: (int4_matmul(x_lv, w_packed, scale),
                 quant_matmul_fa(xa, w_packed, scale, None, d_a[0], t_a[0],
                                 top, act_pow=True)),
        {"int4_matmul": 1, "quant_matmul_fa": 1})
    path_check(rec, f"lsfq_fc1[{m}x{k}x{n}] int4_matmul", i4, float_out,
               1e-4)
    path_check(rec, f"lsfq_fc1[{m}x{k}x{n}] quant_matmul_fa", fa,
               float_out, 1e-4)

    # K13's kernel path (nothing in the JAX package calls it): q/k/v of
    # block 0 of the seed-0 artifacts, ViT-B/16 at batch 32 and ViT-H/14
    # at batch 1 and 8, the float output and the proj's int8 levels
    k13 = {}
    for tag, cfg_, art, plan, b, seed in (
            (f"k13_vitb_b{BATCH}", fwd["cfg"], fwd["art"], fwd["plan"], BATCH,
             0),
            *((f"k13_vith_b{bk}", vh["cfg"], vh["art"], vh["plan"], bk, 5)
              for bk in K13_VIT_H_BATCHES)):
        q, k, v, kw = block0_qkv(dev, cfg_, art, plan, b, seed)
        k13[tag] = (q, k, v, kw)
        proj_e = art["blocks"][0]["proj"]
        for quant in (False, True):
            qkw = dict(kw, out_d=proj_e.act["d"], out_t=proj_e.act["t"],
                       out_top=proj_e.top, out_pow=proj_e.act_pow) \
                if quant else kw
            ptag = tag + (":int8" if quant else "")
            got, launches[ptag] = run_path(
                dev, ptag, lambda qkw=qkw: flash_attention(q, k, v, **qkw),
                {"flash_attention": 1})
            path_check(rec, f"{ptag} [{'x'.join(map(str, q.shape))}]", got,
                       flash_attention_plain(q, k, v, **qkw),
                       levels=quant)
    record["paths"] = {"checks": rec, "launches": launches}
    return {"launches": launches, "k13": k13}


def block0_qkv(dev, cfg, art, plan, b, seed):
    """q, k, v [b, H, N, hd] (bf16) of block 0 on ``b`` seeded
    host-patchified images: the embedded tokens (K1 + K4) through K1 with
    the LayerNorm + quant prologue (the chain's qkv launch), split and
    permuted; with K13's keywords (scale, n_valid, bf16 out)."""
    from quantized_vit_tpu_torch.ops import run_matmul
    from quantized_vit_tpu_torch.serve.vit_int4 import (_embed_kernels,
                                                        _embed_tokens,
                                                        _qmatmul)

    n_real = cfg.num_tokens
    n_pad = -(-n_real // 16) * 16
    d, heads = cfg.embed_dim, cfg.num_heads
    hd = d // heads
    kp = cfg.patch_size**2 * cfg.in_channels
    xp = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, cfg.num_patches, kp)).astype(np.float32)).to(dev)
    bf16 = torch.bfloat16
    blk = art["blocks"][0]
    if plan is not None:
        x2d = _embed_kernels(plan.embed, plan.cls_row,
                             xp.reshape(b * cfg.num_patches, kp), b, cfg, d,
                             n_pad, bf16, "patches")
        qkv = run_matmul(plan.chain[0][0], x2d, out_dtype=bf16)
    else:
        x2d = _embed_tokens(art, xp, cfg, bf16, "patches", n_pad)
        qkv = _qmatmul(x2d, blk["qkv"], bf16, prologue="ln_quant",
                       ln_scale=blk["norm1"]["scale"],
                       ln_bias=blk["norm1"]["bias"])
    q, k, v = qkv.reshape(b, n_pad, 3, heads, hd).permute(
        2, 0, 3, 1, 4).contiguous()
    return q, k, v, dict(sm_scale=hd**-0.5, n_valid=n_real, out_dtype=bf16)


# ---------------------------------------------------------------------------
# phase 3c: FSDP serving, the forward with in-kernel weight gathers
# ---------------------------------------------------------------------------


def vit_b_block_weights(cfg, kind, seed, dev):
    """One block's four weights as the FSDP forward gathers them (qkv
    [D, 3D], proj [D, D], fc1 [D, hid], fc2 [hid, D]): int8 levels,
    packed int4 bytes ([K/2, N]) or bf16 values (the int8 shapes)."""
    d, hid = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    shp = [(d, 3 * d), (d, d), (d, hid), (hid, d)]
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(dev, torch.bfloat16) for s in shp]
    if kind == "int4":
        shp = [(k // 2, n) for k, n in shp]
    return [torch.from_numpy(rng.integers(-128, 128, s).astype(np.int8))
            .to(dev) for s in shp]


def _rows_of(t, rank, tp):
    r = t.shape[0] // tp
    return t[rank * r:(rank + 1) * r].contiguous()


_BLOCK_NAMES = ("qkv", "proj", "fc1", "fc2")


def gather_case(dev, peers, cfg, kind, seed):
    """K14 (``gather_rows``) of this process's row shards of one block's
    four weights (:func:`vit_b_block_weights`): each result against the
    full weight, the shards concatenated in rank order, byte for byte."""
    from quantized_vit_tpu_torch.ops import gather_rows

    rank, tp = (0, 1) if peers is None else (peers.rank, peers.tp)
    full = vit_b_block_weights(cfg, kind, seed, dev)
    got = gather_rows([_rows_of(f, rank, tp) for f in full], peers=peers)
    return [parity_row(
        "gather_rows", f"block.{nm}[{'x'.join(map(str, f.shape))}]({kind},"
        f"tp={tp},rank={rank})", "exact", raw_bytes(g), raw_bytes(f))
        for nm, g, f in zip(_BLOCK_NAMES, got, full)]


def mlp_gather_case(dev, peers, cfg, m, seed, pow_=False,
                    stream=torch.bfloat16):
    """K15 (``fused_mlp_gather``) on ``m`` seeded rows of ``cfg``'s width
    with this process's shards of one block's int8 weights: the MLP
    against ``fused_mlp_plain``, each gathered weight against the full
    one, byte for byte. Rows' cases start with "(tp=..)"."""
    from quantized_vit_tpu_torch.ops import fused_mlp_gather, fused_mlp_plain

    rank, tp = (0, 1) if peers is None else (peers.rank, peers.tp)
    d, hid = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    rng = np.random.default_rng(seed)
    f32 = torch.float32

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x.to(dt) if dt else x

    def scal(v):
        return torch.full((), v, dtype=f32, device=dev)

    x = t(rng.standard_normal((m, d)) * 0.5, stream)
    w1 = t(rng.integers(-7, 8, (d, hid)).astype(np.int8))
    w2 = t(rng.integers(-7, 8, (hid, d)).astype(np.int8))
    args = (x, w1, scal(1e-3), t(rng.standard_normal(hid) * 0.01, f32), w2,
            scal(1e-3), t(rng.standard_normal(d) * 0.01, f32))
    kw = dict(ln_scale=t(rng.standard_normal(d) * 0.1 + 1, f32),
              ln_bias=t(rng.standard_normal(d) * 0.01, f32),
              act_d=scal(0.05), act_t=scal(1.08 if pow_ else 1.0),
              act_top=127, act_pow=pow_, hid_d=scal(0.05),
              hid_t=scal(0.93 if pow_ else 1.0), hid_top=127, hid_pow=pow_,
              fmt="int8", out_dtype=stream)
    full = vit_b_block_weights(cfg, "int8", seed + 1, dev)
    y, gath = fused_mlp_gather(
        *args, next_shards=[_rows_of(f, rank, tp) for f in full],
        peers=peers, **kw)
    tag = f"(tp={tp},rank={rank})"
    return [parity_row("fused_mlp_gather", tag, "mlp", y,
                       fused_mlp_plain(*args, **kw))] + [
        parity_row("fused_mlp_gather", f"{tag}:gather.{nm}", "exact",
                   raw_bytes(g), raw_bytes(f))
        for nm, g, f in zip(_BLOCK_NAMES, gath, full)]


def fsdp_rank(peers, cfg, x_np, iters):
    """This process's FSDP forward of ``x_np`` (host-patchified, the whole
    batch) on its shard of the seed-0 int8-stored artifact (bf16
    residual stream): the logits, the launches of one forward (counters
    set to 0 just before, read just after), and the host time of
    ``iters`` forwards, each started after a host barrier and ended by a
    synchronize."""
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import (prepare_fsdp_rdma_kernels,
                                               random_vit_int4_artifact,
                                               shard_fsdp_rdma_artifact,
                                               vit_int4_forward_fsdp_rdma)

    dev = peers.device
    cuda = dev.type == "cuda"
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False,
                                   device=dev)
    fart = shard_fsdp_rdma_artifact(art, peers.rank, peers.tp)
    del art
    x = torch.from_numpy(x_np).to(dev)
    plan = prepare_fsdp_rdma_kernels(fart, cfg, peers) if cuda else None

    def fwd():
        return vit_int4_forward_fsdp_rdma(
            fart, x, cfg, peers, float_dtype=torch.bfloat16,
            images_layout="patches", plan=plan)

    def done():
        if cuda:
            torch.cuda.synchronize(dev)

    peers.barrier()
    _build.reset_launches()
    logits = fwd()
    done()
    launches = dict(_build.LAUNCHES)
    ms = []
    for _ in range(iters):
        peers.barrier()
        t0 = time.perf_counter()
        fwd()
        done()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"logits": logits.float().cpu().numpy(), "launches": launches,
            "ms": ms, "shard_bytes": sum(
                b[k].w.numel() * b[k].w.element_size()
                for b in fart["blocks"] for k in _BLOCK_NAMES)}


def spawned_worker(rank, tp, init_method, dev, cfg_kw, cases):
    """One of tp processes sharing the card (``run_processes``): the gloo
    group, then each case, in order on every process: ("gather", kind,
    seed), ("mlp_gather", name, m, seed, cfg_kw) (None: the main
    config) or ("fsdp", key, x, iters, cfg_kw). Returns the parity rows
    and each FSDP forward's result under its key."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    peers = initialize_distributed(init_method, tp, rank, device=dev)
    cfg = ViTConfig(**cfg_kw)
    out = {"rows": []}
    try:
        for case in cases:
            if case[0] == "gather":
                out["rows"] += gather_case(peers.device, peers, cfg, *case[1:])
            elif case[0] == "mlp_gather":
                name, m, seed, ckw = case[1:]
                ccfg = cfg if ckw is None else ViTConfig(**ckw)
                out["rows"] += [dict(r, case=name + r["case"]) for r in
                                mlp_gather_case(peers.device, peers, ccfg,
                                                m, seed)]
            else:
                key, x_np, iters, fcfg = case[1:]
                out[key] = fsdp_rank(peers, ViTConfig(**fcfg), x_np, iters)
    finally:
        peers.close()
    return out


def fsdp_phase(dev, record, parity, fwd):
    """The FSDP forward of serve/vit_fsdp.py on the main path's artifact
    (seed 0, int8-stored levels, bf16 residual stream) and batch, and on
    ViT-H/14's (vit_h_phase's, full depth, batch 32), each run with the
    launch counters set to 0 just before and read just after, logits
    against ``vit_int4_forward`` on the same artifact and images, bit for
    bit: at tp = 1 in this process (K1, K4, K14 once, then per block K3 +
    K1 proj and K15), and at FSDP_TP as spawned processes sharing the
    card (ViT-H/14 at depth VIT_H_FSDP_TP_DEPTH), the batch split over
    them. The same spawned groups (every tp of GATHER_TPS above 1) hold
    K14 and K15 against the full weights and ``fused_mlp_plain``, K15 at
    ViT-B/16's and ViT-H/14's widths; their rows join phase 2's."""
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.parallel import run_processes
    from quantized_vit_tpu_torch.serve import (prepare_fsdp_rdma_kernels,
                                               prepare_kernels,
                                               random_vit_int4_artifact,
                                               shard_fsdp_rdma_artifact,
                                               vit_int4_forward,
                                               vit_int4_forward_fsdp_rdma)

    cuda = dev.type == "cuda"
    cfg, art, x = fwd["cfg"], fwd["art"], fwd["x"]
    _, _, d, _, n_pad, _, _, _, _ = shapes(cfg)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    ref = vit_int4_forward(art, x, cfg, plan=fwd["plan"], **kw)
    sync()
    t0 = time.perf_counter()
    fart = shard_fsdp_rdma_artifact(art, 0, 1)
    fplan = prepare_fsdp_rdma_kernels(fart, cfg) if cuda else None
    sync()
    rec = {"prepare_host_ms": (time.perf_counter() - t0) * 1e3}
    want = expected_launches(cfg.depth, "fsdp")
    launches = {"fsdp_tp1": check_forward(
        record, dev, "fsdp_rdma,tp=1,int8-stored",
        lambda: vit_int4_forward_fsdp_rdma(fart, x, cfg, plan=fplan, **kw),
        lambda: ref, want, BATCH, cfg)}
    if not record["forward"][-1]["logits_equal"]:
        raise Failed("FSDP forward at tp=1: logits differ from "
                     "vit_int4_forward's")
    # ViT-H/14 at tp = 1 on vit_h_phase's artifact: K15 at K = 1280 (the
    # first K15 refused it), logits against the single-device forward's
    # (K3 + K1 proj + the K1 fc1/fc2 chain: the same bits as K2's)
    vh = fwd["vit_h"]
    cfg_h, xh = vh["cfg"], vh["x"]
    ref_h = vit_int4_forward(vh["art"], xh, cfg_h, plan=vh["plan"], **kw)
    sync()
    t0 = time.perf_counter()
    fart_h = shard_fsdp_rdma_artifact(vh["art"], 0, 1)
    fplan_h = prepare_fsdp_rdma_kernels(fart_h, cfg_h) if cuda else None
    sync()
    rec["vith_prepare_host_ms"] = (time.perf_counter() - t0) * 1e3
    launches["fsdp_vith_tp1"] = check_forward(
        record, dev, "fsdp_rdma_vith14,tp=1,int8-stored",
        lambda: vit_int4_forward_fsdp_rdma(fart_h, xh, cfg_h, plan=fplan_h,
                                           **kw),
        lambda: ref_h, expected_launches(cfg_h.depth, "fsdp"),
        xh.shape[0], cfg_h)
    if not record["forward"][-1]["logits_equal"]:
        raise Failed("ViT-H/14 FSDP forward at tp=1: logits differ from "
                     "vit_int4_forward's")
    # the depth-cut ViT-H/14 of the spawned forward, and its reference
    hkw = dict(VIT_H_KW, depth=min(VIT_H_KW["depth"], VIT_H_FSDP_TP_DEPTH))
    cfg_hc = ViTConfig(**hkw)
    art_hc = random_vit_int4_artifact(cfg_hc, seed=0, pack_weights=False,
                                      device=dev)
    ref_hc = vit_int4_forward(
        art_hc, xh, cfg_hc,
        plan=prepare_kernels(art_hc, cfg_hc) if cuda else None, **kw)
    del art_hc
    forwards = {"fsdp": (ref, want, CFG_KW, x),
                "fsdp_vith": (ref_hc, expected_launches(cfg_hc.depth,
                                                        "fsdp"), hkw, xh)}
    rows = []
    for tp in sorted(set(GATHER_TPS + (FSDP_TP,)) - {1}):
        cases = [("gather", k, 900) for k in ("int8", "int4", "bf16")]
        # K15 at a process's rows of the batch-32 forwards
        m, m_h = BATCH // tp * n_pad, xh.shape[0] // tp * vit_h_shapes(
            cfg_h)[3]
        cases += [("mlp_gather", f"main[{m}x{d}]", m, 910, None),
                  ("mlp_gather", f"vith[{m_h}x{cfg_h.embed_dim}]", m_h, 916,
                   dict(VIT_H_KW))]
        if tp == FSDP_TP:
            cases += [("mlp_gather", f"ragged[{mr}x{d}]", mr, 911 + i, None)
                      for i, mr in enumerate(K15_RAGGED_M)]
            cases += [("fsdp", key, xf.cpu().numpy(), FSDP_TP_ITERS,
                       dict(fkw)) for key, (_, _, fkw, xf) in
                      forwards.items()]
        t0 = time.time()
        try:
            res = run_processes(spawned_worker, tp,
                                os.path.join(OUT_DIR, "dist"),
                                args=(DEV, dict(CFG_KW), cases),
                                timeout_s=SPAWN_TIMEOUT_S)
        except RuntimeError as e:
            raise Failed(f"spawned processes at tp={tp}: {e}")
        rec[f"spawn_tp{tp}_s"] = round(time.time() - t0, 1)
        for r in res:
            rows += r["rows"]
        if tp != FSDP_TP:
            continue
        for key, (ref_k, want_k, _, _) in forwards.items():
            fs = [r[key] for r in res]
            got = torch.from_numpy(np.concatenate([f["logits"]
                                                   for f in fs]))
            equal = bool(torch.equal(got, ref_k.float().cpu()))
            tag = f"{key[5:] + '_' if key != 'fsdp' else ''}tp{tp}"
            rec[tag] = {
                "logits_equal": equal,
                "max_abs_diff": float((got - ref_k.float().cpu()).abs()
                                      .max()),
                "launches_per_rank": [f["launches"] for f in fs],
                "shard_bytes_per_rank": [f["shard_bytes"] for f in fs],
                # host time, barrier to synchronize: two time-sliced
                # contexts on one card, not a scaling number
                "wall_ms_per_rank": [statistics.median(f["ms"])
                                     for f in fs]}
            launches[f"{key}_tp{tp}"] = fs[0]["launches"]
            used = [{k: v for k, v in f["launches"].items() if v}
                    for f in fs]
            log(f"[{key} tp={tp}] logits equal {equal}, launches {used}"
                f", wall {rec[tag]['wall_ms_per_rank']} ms "
                f"({rec[f'spawn_tp{tp}_s']} s spawned)")
            if not equal:
                raise Failed(f"{key} forward at tp={tp}: logits differ from "
                             f"vit_int4_forward's by {rec[tag]}")
            if cuda and any(f["launches"] != want_k for f in fs):
                raise Failed(f"{key} forward at tp={tp}: launches "
                             f"{[f['launches'] for f in fs]} != {want_k}")
    rec["vith_tp_depth"] = cfg_hc.depth
    for row in rows:
        parity.add(row)
    bad = [r for r in rows if not r["ok"]]
    log(f"[fsdp] {len(rows) - len(bad)}/{len(rows)} spawned parity rows "
        f"pass, {sum(r['bit_exact'] for r in rows)} bit-exact")
    if bad:
        raise Failed("spawned parity: " + "; ".join(
            f"{r['kernel']} {r['case']}: max {r['max_abs_err']}"
            for r in bad[:8]))
    record["fsdp"] = rec
    return {"launches": launches, "fart": fart, "plan": fplan,
            "fart_h": fart_h, "plan_h": fplan_h}


# ---------------------------------------------------------------------------
# phase 4: the serving CLI
# ---------------------------------------------------------------------------


def serve_phase(dev, record, fwd):
    """The serve CLI's forward behind a batcher: first a few requests one
    at a time and in pairs (buckets 1 and 2, the chain with K6), then the
    CLI's own burst of 64 requests at max batch 8. Every answer equals a
    direct forward of the same images."""
    from quantized_vit_tpu_torch.artifact import (load_vit_int4_artifact,
                                                  save_vit_int4_artifact)
    from quantized_vit_tpu_torch.cli import serve
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import (ContinuousBatcher,
                                               vit_int4_forward)
    from quantized_vit_tpu_torch.utils import patchify_batch

    art_dir = ART_DIR
    save_vit_int4_artifact(art_dir, fwd["art"], fwd["cfg"])
    art, cfg = load_vit_int4_artifact(art_dir, device=dev)

    def direct(images):
        x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
        return vit_int4_forward(art, x, cfg, float_dtype=serve.SERVE_DTYPE,
                                images_layout="patches").cpu().numpy()

    # small flushes: three single requests, then two pairs
    forward, _ = serve.build_forward(serve.parse_args(
        ["--artifact", art_dir, "--device", str(dev)]))
    imgs = serve.request_images(cfg, 7, False)
    batcher = ContinuousBatcher(forward, max_batch=8, max_delay_ms=5.0)
    batcher.warmup(imgs[0])
    _build.reset_launches()
    small_equal = True
    with batcher:
        for i in range(3):
            got = batcher.submit(imgs[i]).result(timeout=120)
            small_equal &= bool(np.array_equal(got, direct(imgs[i:i + 1])[0]))
        for i in (3, 5):
            futs = [batcher.submit(imgs[i]), batcher.submit(imgs[i + 1])]
            got = np.stack([f.result(timeout=120) for f in futs])
            small_equal &= bool(np.array_equal(got, direct(imgs[i:i + 2])))
    small = {"batch_hist": dict(batcher.stats["batch_hist"]),
             "launches": dict(_build.LAUNCHES),
             "answers_equal_direct": small_equal}
    log(f"[serve small flushes] buckets {small['batch_hist']} launches "
        f"{small['launches']} equal {small_equal}")

    t0 = time.time()
    res = serve.main(["--artifact", art_dir, "--requests", "64",
                      "--max-batch", "8", "--device", str(dev)])
    got = np.concatenate([direct(res["images"][i:i + 8])
                          for i in range(0, len(res["images"]), 8)])
    equal = bool(np.array_equal(res["answers"], got))
    summary = {k: v for k, v in res.items() if k not in ("images", "answers")}
    summary["answers_equal_direct"] = equal
    summary["max_abs_diff"] = float(np.abs(res["answers"] - got).max())
    summary["phase_s"] = round(time.time() - t0, 1)
    summary["small_flushes"] = small
    record["serve"] = summary
    log(f"[serve] {summary}")
    if not equal or summary["batches"] < 64 // 8:
        raise Failed(f"serve answers differ from direct forwards: {summary}")
    if not small_equal or not {1, 2} <= set(small["batch_hist"]):
        raise Failed(f"small flushes: {small}")
    if dev.type == "cuda" and small["launches"]["attention_qkv"] == 0:
        raise Failed("buckets 1 and 2 did not run attention_qkv (K6)")


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters=ITERS, warmup=3):
    """Median ms of ``iters`` timed runs (CUDA events), after warm-up; at
    least ``SHORT_ITERS`` runs when one run takes under 1 ms."""
    for _ in range(warmup):
        fn()
    if DEV != "cuda":  # CPU rehearsal: host clock, never a device number
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    if s.elapsed_time(e) < 1.0:
        iters = max(iters, SHORT_ITERS)
    ev = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def int_mm_ms(shapes):
    """``torch._int_mm`` on the kernel's GEMM shapes, as one timed call
    sequence (a yardstick; the port never calls it). None if this card's
    PyTorch refuses a shape."""
    mats = []
    for m, k, n in shapes:
        a = torch.randint(-7, 8, (m, k), dtype=torch.int8, device=DEV)
        b = torch.randint(-7, 8, (n, k), dtype=torch.int8, device=DEV).t()
        mats.append((a, b))
    try:
        return cuda_ms(lambda: [torch._int_mm(a, b) for a, b in mats])
    except RuntimeError as e:
        log(f"  _int_mm yardstick unavailable: {e}")
        return None


def timing_phase(dev, record, fwd, peaks):
    from quantized_vit_tpu_torch.ops import (attention_heads,
                                             attention_heads_plain,
                                             attention_qkv,
                                             attention_qkv_plain,
                                             fused_mlp, fused_mlp_plain,
                                             fused_quant_matmul,
                                             fused_quant_matmul_plain,
                                             patch_finalize,
                                             patch_finalize_plain,
                                             run_attention_block,
                                             run_attention_heads,
                                             run_attention_qkv,
                                             run_block_stack, run_matmul,
                                             run_mlp, run_mlp_chunked,
                                             vit_block_stack_plain)
    from quantized_vit_tpu_torch.serve import (vit_int4_forward,
                                               vit_int4_forward_fsdp_rdma,
                                               vit_int4_forward_latency)
    from quantized_vit_tpu_torch.serve.vit_int4 import _chain_attention

    int8_peak, bf16_peak, bw, fp64_peak = peaks
    cfg, art, x = fwd["cfg"], fwd["art"], fwd["x"]
    b, p, d, n_real, n_pad, kp, hid, ncls, heads = shapes(cfg)
    hd = d // heads
    m = b * n_pad
    nk = -(-n_real // 16) * 16  # key rows of the bf16 attention
    blk = art["blocks"][0]
    qkv_e, proj_e, fc1_e, fc2_e = (blk[k] for k in ("qkv", "proj", "fc1",
                                                    "fc2"))
    bf16 = torch.bfloat16

    def bound(bytes_, int8_ops=0.0, bf16_ops=0.0):
        t_ops = int8_ops / int8_peak + bf16_ops / bf16_peak
        t_mem = bytes_ / bw
        return max(t_ops, t_mem) * 1e3, ("bytes" if t_mem >= t_ops
                                         else "operations")

    g = torch.Generator(device=DEV).manual_seed(0)
    xs = torch.randn((m, d), generator=g, device=DEV).to(bf16)
    x3 = xs.reshape(b, n_pad, d)
    xpatch = x.reshape(b * p, kp)
    xhead = torch.randn((b, d), generator=g, device=DEV)
    alv = torch.randint(-7, 8, (m, d), dtype=torch.int8, device=DEV,
                        generator=g)
    acc = torch.randn((b, p, d), generator=g, device=DEV) * 300
    pos = torch.randn((p, d), generator=g, device=DEV) * 0.02
    cls = torch.randn((d,), generator=g, device=DEV) * 0.02
    one = torch.ones((), device=DEV)
    # K6's input: the chain's qkv tensor at batch 2 (and batch 32)
    qkv2 = (torch.randn((2, n_pad, 3 * d), generator=g, device=DEV)
            * 0.7).to(bf16)
    qkv32 = (torch.randn((b, n_pad, 3 * d), generator=g, device=DEV)
             * 0.7).to(bf16)
    pe = art["patch_embed"]

    def q(e):
        return dict(act_d=e.act["d"], act_t=e.act["t"], act_top=e.top,
                    act_pow=e.act_pow)

    he = art["head"]
    mlp_kw = dict(ln_scale=blk["norm2"]["scale"], ln_bias=blk["norm2"]["bias"],
                  act_d=fc1_e.act["d"], act_t=fc1_e.act["t"],
                  act_top=fc1_e.top, act_pow=fc1_e.act_pow,
                  hid_d=fc2_e.act["d"], hid_t=fc2_e.act["t"],
                  hid_top=fc2_e.top, hid_pow=fc2_e.act_pow, fmt=fc1_e.fmt,
                  fmt2=fc2_e.fmt, out_dtype=bf16)
    attn_kw = dict(ln_scale=blk["norm1"]["scale"],
                   ln_bias=blk["norm1"]["bias"], heads=heads,
                   sm_scale=hd**-0.5, n_valid=n_real, act_d=qkv_e.act["d"],
                   act_t=qkv_e.act["t"], act_top=qkv_e.top,
                   act_pow=qkv_e.act_pow, out_d=proj_e.act["d"],
                   out_t=proj_e.act["t"], out_top=proj_e.top,
                   out_pow=proj_e.act_pow, fmt=qkv_e.fmt, out_dtype=bf16)
    qkv_kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=n_real,
                  out_d=proj_e.act["d"], out_t=proj_e.act["t"],
                  out_top=proj_e.top, out_pow=proj_e.act_pow, out_dtype=bf16)
    lat, meta = fwd["lat"], fwd["meta"]
    stack = lat["stack"]
    x1 = xs[:n_pad]
    x2 = xs[:2 * n_pad]  # the chain at batch 2
    # each site: (kernel call as the main path makes it, plain version).
    # On the card the kernel call is the launch on the forward's prepared
    # plan (run_*); the CPU rehearsal has no plan and calls the wrapper.
    plain = {
        "patch_embed": lambda: fused_quant_matmul_plain(
            xpatch, pe.w, pe.scale, pe.bias, fmt=pe.fmt, prologue="quant",
            out_dtype=torch.float32, **q(pe)),
        "attn_proj": lambda: fused_quant_matmul_plain(
            alv, proj_e.w, proj_e.scale, proj_e.bias, fmt=proj_e.fmt,
            prologue=None, epilogue="residual", residual=xs, out_dtype=bf16),
        "head": lambda: fused_quant_matmul_plain(
            xhead, he.w, he.scale, he.bias, fmt=he.fmt, prologue="quant",
            out_dtype=torch.float32, **q(he)),
        "mlp": lambda: fused_mlp_plain(
            xs, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
            fc2_e.bias, **mlp_kw),
        "heads": lambda: attention_heads_plain(
            x3, qkv_e.w, qkv_e.scale, qkv_e.bias, **attn_kw),
        "embed": lambda: patch_finalize_plain(acc, pos, cls, one, n_pad=n_pad,
                                              out_dtype=bf16),
        "qkv_attn_b2": lambda: attention_qkv_plain(qkv2, **qkv_kw),
        "qkv_attn_b32": lambda: attention_qkv_plain(qkv32, **qkv_kw),
        "qkv_attn_int_b2": lambda: attention_qkv_plain(
            qkv2, int_attention=True, **qkv_kw),
        "qkv_attn_int_b32": lambda: attention_qkv_plain(
            qkv32, int_attention=True, **qkv_kw),
        "stack_b1": lambda: vit_block_stack_plain(stack, x1, n_valid=n_real,
                                                  out_dtype=bf16),
        "chain_qkv_b2": lambda: fused_quant_matmul_plain(
            x2, qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
            prologue="ln_quant", ln_scale=blk["norm1"]["scale"],
            ln_bias=blk["norm1"]["bias"], out_dtype=bf16, **q(qkv_e)),
        "mlp_b2": lambda: fused_mlp_plain(
            x2, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
            fc2_e.bias, **mlp_kw),
    }
    # K2 at the chain's batch 1, K8 on the same int8 weights at batch 32,
    # 2 and 1 (the same function: the plain version is K2's)
    plain["mlp_b1"] = lambda: fused_mlp_plain(
        x1, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
        fc2_e.bias, **mlp_kw)
    x3r = xs[:3 * n_pad]  # the chain at batch 3, where K8 runs
    plain["mlp_b3"] = lambda: fused_mlp_plain(
        x3r, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
        fc2_e.bias, **mlp_kw)
    # the 384-px ViT-B/16 chain at batch 1: 592 rows, f32 residual stream
    n384 = -(-((384 // cfg.patch_size)**2 + 1) // 16) * 16
    x384 = torch.randn((n384, d), generator=g, device=DEV)
    plain["mlp_384_f32"] = lambda: fused_mlp_plain(
        x384, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
        fc2_e.bias, **dict(mlp_kw, out_dtype=torch.float32))
    for bk, site in ((b, "mlp"), (2, "mlp_b2"), (1, "mlp_b1"), (3, "mlp_b3"),
                     ("384_f32", "mlp_384_f32")):
        plain[f"mlp_k8_b{bk}"] = plain[site]
    plan = fwd["plan"]
    if plan is not None:
        attn_p, mlp_p = plan.blocks[0][0], plan.blocks[0][1].resident
        k6_p = plan.chain[0][1]
        kern = {
            "patch_embed": lambda: run_matmul(
                plan.embed["patches"][0], xpatch, out_dtype=torch.float32),
            "attn_proj": lambda: run_matmul(attn_p.proj, alv, residual=xs,
                                            out_dtype=bf16),
            "head": lambda: run_matmul(plan.head, xhead,
                                       out_dtype=torch.float32),
            "mlp": lambda: run_mlp(mlp_p, xs, out_dtype=bf16),
            "heads": lambda: run_attention_heads(attn_p.heads, x3,
                                                 n_valid=n_real,
                                                 out_dtype=bf16),
            "qkv_attn_b2": lambda: run_attention_qkv(
                k6_p, qkv2, n_valid=n_real, out_dtype=bf16),
            "qkv_attn_b32": lambda: run_attention_qkv(
                k6_p, qkv32, n_valid=n_real, out_dtype=bf16),
            "qkv_attn_int_b2": lambda: run_attention_qkv(
                k6_p, qkv2, n_valid=n_real, out_dtype=bf16,
                int_attention=True),
            "qkv_attn_int_b32": lambda: run_attention_qkv(
                k6_p, qkv32, n_valid=n_real, out_dtype=bf16,
                int_attention=True),
            "stack_b1": lambda: run_block_stack(stack, x1, n_valid=n_real,
                                                out_dtype=bf16),
            "chain_qkv_b2": lambda: run_matmul(plan.chain[0][0], x2,
                                               out_dtype=bf16),
            "mlp_b2": lambda: run_mlp(mlp_p, x2, out_dtype=bf16),
            "mlp_b1": lambda: run_mlp(mlp_p, x1, out_dtype=bf16),
        }
        k8_p = plan.blocks[0][1].chunked
        for bk, xm in ((b, xs), (2, x2), (1, x1), (3, x3r)):
            kern[f"mlp_k8_b{bk}"] = (
                lambda xm=xm: run_mlp_chunked(k8_p, xm, out_dtype=bf16))
        kern["mlp_b3"] = lambda: run_mlp(mlp_p, x3r, out_dtype=bf16)
        kern["mlp_k8_b384_f32"] = lambda: run_mlp_chunked(
            k8_p, x384, out_dtype=torch.float32)
        kern["mlp_384_f32"] = lambda: run_mlp(mlp_p, x384,
                                              out_dtype=torch.float32)
    else:
        kern = {
            "patch_embed": lambda: fused_quant_matmul(
                xpatch, pe.w, pe.scale, pe.bias, fmt=pe.fmt,
                prologue="quant", out_dtype=torch.float32, **q(pe)),
            "attn_proj": lambda: fused_quant_matmul(
                alv, proj_e.w, proj_e.scale, proj_e.bias, fmt=proj_e.fmt,
                prologue=None, epilogue="residual", residual=xs,
                out_dtype=bf16),
            "head": lambda: fused_quant_matmul(
                xhead, he.w, he.scale, he.bias, fmt=he.fmt, prologue="quant",
                out_dtype=torch.float32, **q(he)),
            "mlp": lambda: fused_mlp(
                xs, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
                fc2_e.bias, **mlp_kw),
            "heads": lambda: attention_heads(
                x3, qkv_e.w, qkv_e.scale, qkv_e.bias, **attn_kw),
            "qkv_attn_b2": lambda: attention_qkv(qkv2, **qkv_kw),
            "qkv_attn_b32": lambda: attention_qkv(qkv32, **qkv_kw),
            "qkv_attn_int_b2": lambda: attention_qkv(
                qkv2, int_attention=True, **qkv_kw),
            "qkv_attn_int_b32": lambda: attention_qkv(
                qkv32, int_attention=True, **qkv_kw),
            "stack_b1": plain["stack_b1"],
            "chain_qkv_b2": lambda: fused_quant_matmul(
                x2, qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
                prologue="ln_quant", ln_scale=blk["norm1"]["scale"],
                ln_bias=blk["norm1"]["bias"], out_dtype=bf16, **q(qkv_e)),
            "mlp_b2": lambda: fused_mlp(
                x2, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
                fc2_e.bias, **mlp_kw),
        }
        for site in ("mlp_b1", f"mlp_k8_b{b}", "mlp_k8_b2", "mlp_k8_b1",
                     "mlp_b3", "mlp_k8_b3", "mlp_384_f32",
                     "mlp_k8_b384_f32"):
            kern[site] = plain[site]
    kern["embed"] = lambda: patch_finalize(acc, pos, cls, one, n_pad=n_pad,
                                           out_dtype=bf16)
    # K1 at the chain's other sites (batch 1-3) and the head at one row
    # (not on the batch-32 forward: 0 launches there)
    k1_sites = {"head_b1": (dict(x=xhead[:1], w=he, prologue="quant",
                                 layer=q(he), out_dtype=torch.float32),
                            plan.head if plan is not None else None)}
    for bk in CHAIN_BATCHES:
        mk = bk * n_pad
        if bk != 2:
            k1_sites[f"chain_qkv_b{bk}"] = (dict(
                x=xs[:mk], w=qkv_e, prologue="ln_quant", layer=dict(
                    q(qkv_e), ln_scale=blk["norm1"]["scale"],
                    ln_bias=blk["norm1"]["bias"]), out_dtype=bf16),
                plan.chain[0][0] if plan is not None else None)
        k1_sites[f"chain_proj_b{bk}"] = (dict(
            x=alv[:mk], w=proj_e, prologue=None, layer=dict(
                epilogue="residual", residual=xs[:mk]), out_dtype=bf16),
            attn_p.proj if plan is not None else None)
    for site, (c, k1_plan) in k1_sites.items():
        layer = dict(c["layer"])
        res = layer.pop("residual", None)

        def plain_k1(c=c, layer=layer, res=res):
            return fused_quant_matmul_plain(
                c["x"], c["w"].w, c["w"].scale, c["w"].bias, fmt=c["w"].fmt,
                prologue=c["prologue"], residual=res,
                out_dtype=c["out_dtype"], **layer)

        plain[site] = plain_k1
        kern[site] = plain_k1 if k1_plan is None else (
            lambda c=c, p=k1_plan, res=res: run_matmul(
                p, c["x"], residual=res, out_dtype=c["out_dtype"]))

    def sdpa(bk):
        return sdpa_call(bk, heads, n_pad, nk, hd, g)

    w1b = 1 if pe.fmt == "int8" else 0.5
    wpk = 0.5 if meta.fmt == "int4" else 1
    w_blk = d * 3 * d + d * d + 2 * d * hid  # levels of one block's weights
    attn_ops = 2 * heads * n_pad * nk * hd * 2  # one image's QK^T and PV
    sites = [
        # kernel, site, launches/forward, bound, GEMMs, library call
        ("fused_quant_matmul", "patch_embed", 1,
         bound(b * p * kp * 4 + kp * d * w1b + b * p * d * 4,
               2 * b * p * kp * d), [(b * p, kp, d)], None),
        ("fused_quant_matmul", "attn_proj", cfg.depth,
         bound(m * d + d * d * w1b + 2 * m * d * 2, 2 * m * d * d),
         [(m, d, d)], None),
        ("fused_quant_matmul", "head", 1,
         bound(b * d * 4 + d * ncls * w1b + b * ncls * 4, 2 * b * d * ncls),
         [(b, d, ncls)], None),
        ("fused_mlp", "mlp", cfg.depth,
         bound(2 * m * d * 2 + 2 * d * hid * w1b, 4 * m * d * hid),
         [(m, d, hid), (m, hid, d)], None),
        ("attention_block", "heads", cfg.depth,
         bound(m * d * 2 + 3 * d * d * w1b + m * d, 2 * m * d * 3 * d,
               b * attn_ops), [(m, d, 3 * d)], None),
        ("patch_finalize", "embed", 1,
         bound(b * p * d * 4 + p * d * 4 + d * 4 + m * d * 2), [], None),
        # K6 on the chain forward at batch 2 (12 launches), and at batch 32
        ("attention_qkv", "qkv_attn_b2", cfg.depth,
         bound(2 * n_pad * 3 * d * 2 + 2 * n_pad * d, 0, 2 * attn_ops), [],
         sdpa(2)),
        ("attention_qkv", "qkv_attn_b32", 0,
         bound(b * n_pad * 3 * d * 2 + b * n_pad * d, 0, b * attn_ops), [],
         sdpa(b)),
        # K6 with int_attention (the variant bench.py times) at batch 2 and
        # 32: no library call computes it
        ("attention_qkv", "qkv_attn_int_b2", 0,
         bound(2 * n_pad * 3 * d * 2 + 2 * n_pad * d, 0, 2 * attn_ops), [],
         None),
        ("attention_qkv", "qkv_attn_int_b32", 0,
         bound(b * n_pad * 3 * d * 2 + b * n_pad * d, 0, b * attn_ops), [],
         None),
        # the chain's K1 qkv and K2 at batch 2 (not on the batch-32
        # forward: 0 launches there), to split the chain's time
        ("fused_quant_matmul", "chain_qkv_b2", 0,
         bound(2 * n_pad * d * 2 + 3 * d * d * w1b + 2 * n_pad * 3 * d * 2,
               2 * 2 * n_pad * d * 3 * d), [(2 * n_pad, d, 3 * d)], None),
        ("fused_mlp", "mlp_b2", 0,
         bound(2 * 2 * n_pad * d * 2 + 2 * d * hid * w1b,
               4 * 2 * n_pad * d * hid),
         [(2 * n_pad, d, hid), (2 * n_pad, hid, d)], None),
        *[("fused_quant_matmul", f"chain_qkv_b{bk}", 0,
           bound(bk * n_pad * d * 2 + 3 * d * d * w1b
                 + bk * n_pad * 3 * d * 2, 2 * bk * n_pad * d * 3 * d),
           [(bk * n_pad, d, 3 * d)], None) for bk in CHAIN_BATCHES
          if bk != 2],
        *[("fused_quant_matmul", f"chain_proj_b{bk}", 0,
           bound(bk * n_pad * d + d * d * w1b + 2 * bk * n_pad * d * 2,
                 2 * bk * n_pad * d * d), [(bk * n_pad, d, d)], None)
          for bk in CHAIN_BATCHES],
        ("fused_quant_matmul", "head_b1", 0,
         bound(d * 4 + d * ncls * w1b + ncls * 4, 2 * d * ncls),
         [(1, d, ncls)], None),
        ("fused_mlp", "mlp_b1", 0,
         bound(2 * n_pad * d * 2 + 2 * d * hid * w1b, 4 * n_pad * d * hid),
         [(n_pad, d, hid), (n_pad, hid, d)], None),
        # K8 on the same int8 weights at batch 32, 2, 1 and 3 (ViT-B's
        # chain at batch 3 runs it: 0 launches here), K2 at batch 3
        *[("fused_mlp_chunked", f"mlp_k8_b{bk}", 0,
           bound(2 * bk * n_pad * d * 2 + 2 * d * hid,
                 4 * bk * n_pad * d * hid),
           [(bk * n_pad, d, hid), (bk * n_pad, hid, d)], None)
          for bk in (b, 2, 1, 3)],
        ("fused_mlp", "mlp_b3", 0,
         bound(2 * 3 * n_pad * d * 2 + 2 * d * hid, 4 * 3 * n_pad * d * hid),
         [(3 * n_pad, d, hid), (3 * n_pad, hid, d)], None),
        # the 384-px chain at batch 1 (f32 residual stream): K8, K2 beside
        *[(kn, site, 0, bound(2 * n384 * d * 4 + 2 * d * hid,
                              4 * n384 * d * hid),
           [(n384, d, hid), (n384, hid, d)], None)
          for kn, site in (("fused_mlp_chunked", "mlp_k8_b384_f32"),
                           ("fused_mlp", "mlp_384_f32"))],
        # K5 on the latency forward: one launch, all the depth
        ("block_stack", "stack_b1", 1,
         bound(cfg.depth * w_blk * wpk + 2 * n_pad * d * 2,
               cfg.depth * 2 * n_pad * w_blk, cfg.depth * attn_ops), [],
         None),
    ]
    # K6's and K3's sites: the FLOP of the attention's two products (exact
    # only on the f64 MMA), over the FP64 tensor cores' rate, as the
    # attention's ceiling
    fp64_flop = {f"qkv_attn{v}_b{bk}": bk * attn_ops for bk in (2, b)
                 for v in ("", "_int")}
    fp64_flop["heads"] = b * attn_ops
    sites += vit_h_sites(fwd["vit_h"], kern, plain, bound, fp64_flop)
    sites += path_sites(fwd, kern, plain, bound)
    sites += fsdp_sites(fwd, kern, plain, bound, xs)
    per_site = []
    for name, site, nl, (bms, by), gemms, lib, *extra in sites:
        ms = cuda_ms(kern[site])
        pms = cuda_ms(plain[site], iters=5, warmup=1)
        ims = int_mm_ms(gemms) if gemms else None
        lms = cuda_ms(lib) if lib is not None else None
        # yardsticks the port never calls beside the kernel: K1 with the
        # quant prologue at K12's shapes, K6 + K1 and K3's branch at K9's
        yard = {k: cuda_ms(fn) * 1e3 for k, fn in (extra[0] if extra
                                                    else {}).items()}
        per_site.append({"kernel": name, "site": site, "launches": nl,
                         "us": ms * 1e3, "plain_us": pms * 1e3,
                         "bound_us": bms * 1e3, "bound_by": by,
                         "int_mm_us": None if ims is None else ims * 1e3,
                         "library_us": None if lms is None else lms * 1e3,
                         "yardsticks_us": yard})
        if name in ("flash_attention", "attention_qkv", "attention_block",
                    "fused_mlp", "fused_mlp_chunked", "fused_quant_matmul"):
            # how much of the time is the host's, the kernel's and SDPA's
            split = host_split(kern[site], ms * 1e3)
            per_site[-1].update(split)
            splits = [(name, split)]
            if lib is not None:
                lsplit = host_split(lib, lms * 1e3)
                per_site[-1]["library_split"] = lsplit
                splits.append(("library", lsplit))
            for who, sp in splits:
                dv, share = sp["device_us"], sp["card_share"]
                log(f"[time] {who:18s} {site:12s} host {sp['host_us']:.1f} "
                    f"us a call; on the card "
                    f"{'n/a' if dv is None else f'{dv:.1f}'} us, "
                    f"{'n/a' if share is None else f'{share:.3f}'} of the "
                    "time")
        if site in fp64_flop:
            per_site[-1]["fp64_ceiling_us"] = (fp64_flop[site] / fp64_peak
                                               * 1e6)
            log(f"[time] {name:18s} {site:12s} FP64 MMA ceiling "
                f"{per_site[-1]['fp64_ceiling_us']:.1f} us")
        log(f"[time] {name:18s} {site:12s} {ms * 1e3:9.1f} us  plain "
            f"{pms * 1e3:9.1f}  bound {bms * 1e3:7.1f} ({by})  _int_mm "
            f"{'n/a' if ims is None else f'{ims * 1e3:.1f}'}  library "
            f"{'n/a' if lms is None else f'{lms * 1e3:.1f}'}"
            + "".join(f"  {k} {v:.1f}" for k, v in yard.items()))
    record["per_site"] = per_site

    # the attention branch of both routes at batch 2-32: K3 (alone and
    # with its K1 proj) against K1 qkv + K6 + K1 proj, on the same plans
    # (the data for BLOCK_ROUTE_MIN_BATCH, serve/vit_int4.py)
    if plan is not None:
        routes = {}
        for bk in ROUTE_BATCHES:
            xb = xs[:bk * n_pad]
            x3b = xb.reshape(bk, n_pad, d)
            r = routes[f"b{bk}"] = {
                "k3_ms": cuda_ms(lambda: run_attention_heads(
                    attn_p.heads, x3b, n_valid=n_real, out_dtype=bf16)),
                "block_ms": cuda_ms(lambda: run_attention_block(
                    attn_p, x3b, n_valid=n_real, out_dtype=bf16)),
                "chain_ms": cuda_ms(lambda: _chain_attention(
                    plan.chain[0], attn_p, xb, b=bk, n_pad=n_pad,
                    n_real=n_real, float_dtype=bf16, int_attention=False))}
            log(f"[time] attention branch b{bk}: K3 {r['k3_ms'] * 1e3:.1f}"
                f" us, K3+K1 {r['block_ms'] * 1e3:.1f} us, K1+K6+K1 "
                f"{r['chain_ms'] * 1e3:.1f} us")
        record["attention_routes"] = routes

    kw = dict(float_dtype=bf16, images_layout="patches")
    ms_fwd = cuda_ms(lambda: vit_int4_forward(art, x, cfg, plan=plan, **kw))
    ms_bf16 = cuda_ms(bf16_vit_forward(cfg, x))
    small = {"latency_b1_ms": cuda_ms(lambda: vit_int4_forward_latency(
        lat, x[:1], cfg, meta, **kw))}
    for bk in CHAIN_BATCHES:
        small[f"chain_b{bk}_ms"] = cuda_ms(lambda: vit_int4_forward(
            art, x[:bk], cfg, plan=plan, **kw))
    for bk in (1, 2):
        small[f"bf16_torch_b{bk}_ms"] = cuda_ms(bf16_vit_forward(cfg,
                                                                 x[:bk]))
    record["forward_timing"] = {
        "batch": b, "ms_per_batch": ms_fwd, "img_per_s": b / ms_fwd * 1e3,
        "bf16_torch_ms_per_batch": ms_bf16,
        "bf16_torch_img_per_s": b / ms_bf16 * 1e3,
        "ratio_vs_bf16": ms_bf16 / ms_fwd,
        "kernel_ms_sum": sum(s["us"] * s["launches"] for s in per_site
                             if s["kernel"] in ("fused_quant_matmul",
                                                "fused_mlp",
                                                "attention_block",
                                                "patch_finalize")) / 1e3,
        **small}
    log(f"[time] forward b{b} bf16: {ms_fwd:.3f} ms/batch "
        f"({b / ms_fwd * 1e3:.1f} img/s); plain bf16 torch ViT-B/16 "
        f"{ms_bf16:.3f} ms ({b / ms_bf16 * 1e3:.1f} img/s); ratio "
        f"{ms_bf16 / ms_fwd:.3f}")
    log("[time] small batches (ms): " + ", ".join(
        f"{k[:-3]} {v:.3f}" for k, v in small.items()))
    vh = fwd["vit_h"]
    vh_t = {}
    for bk in VIT_H_BATCHES:
        vh_t[f"b{bk}_ms"] = cuda_ms(lambda: vit_int4_forward(
            vh["art"], vh["x"][:bk], vh["cfg"], plan=vh["plan"], **kw))
        vh_t[f"bf16_torch_b{bk}_ms"] = cuda_ms(bf16_vit_forward(
            vh["cfg"], vh["x"][:bk]))
        vh_t[f"ratio_vs_bf16_b{bk}"] = (vh_t[f"bf16_torch_b{bk}_ms"]
                                        / vh_t[f"b{bk}_ms"])
    record["vit_h"]["forward_timing"] = vh_t
    log("[time] ViT-H/14 forwards (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in vh_t.items()))

    # the FSDP forward at tp = 1 against vit_int4_forward on this card;
    # tp = 2's host wall time is fsdp_phase's (two contexts time-sliced)
    fs = fwd["fsdp"]
    ms_fsdp = cuda_ms(lambda: vit_int4_forward_fsdp_rdma(
        fs["fart"], x, cfg, plan=fs["plan"], **kw))
    bh = vh["x"].shape[0]
    ms_fsdp_h = cuda_ms(lambda: vit_int4_forward_fsdp_rdma(
        fs["fart_h"], vh["x"], vh["cfg"], plan=fs["plan_h"], **kw))
    record["fsdp"]["forward_timing"] = {
        "tp1_ms": ms_fsdp, "vit_int4_forward_ms": ms_fwd,
        "ratio_vs_single_device": ms_fwd / ms_fsdp,
        f"vith_tp1_b{bh}_ms": ms_fsdp_h,
        f"vith_vit_int4_forward_b{bh}_ms": vh_t[f"b{bh}_ms"],
        "vith_ratio_vs_single_device": vh_t[f"b{bh}_ms"] / ms_fsdp_h}
    log(f"[time] FSDP forward tp=1 b{b}: {ms_fsdp:.3f} ms (single-device "
        f"forward {ms_fwd:.3f} ms); ViT-H/14 b{bh}: {ms_fsdp_h:.3f} ms "
        f"(single-device {vh_t[f'b{bh}_ms']:.3f} ms)")
    record["overlap"] = overlap_sweep(cfg)

    rel = {"fused_quant_matmul": (
               "quantized_vit_tpu_torch/csrc/fused_quant_matmul.cu",
               "quantized_vit_tpu/ops/fused.py:556", "block"),
           "fused_mlp": ("quantized_vit_tpu_torch/csrc/fused_mlp.cu",
                         "quantized_vit_tpu/ops/fused.py:977", "block"),
           "attention_block": (
               "quantized_vit_tpu_torch/csrc/attention_block.cu",
               "quantized_vit_tpu/ops/attention.py:667", "block"),
           "patch_finalize": (
               "quantized_vit_tpu_torch/csrc/patch_finalize.cu",
               "quantized_vit_tpu/ops/patch.py:52", "block"),
           "attention_qkv": (
               "quantized_vit_tpu_torch/csrc/attention_qkv.cu",
               "quantized_vit_tpu/ops/attention.py:859", "chain_b2"),
           "block_stack": (
               "quantized_vit_tpu_torch/csrc/block_stack.cu",
               "quantized_vit_tpu/ops/block_stack.py:341", "latency"),
           "fused_mlp_chunked": (
               "quantized_vit_tpu_torch/csrc/fused_mlp_chunked.cu",
               "quantized_vit_tpu/ops/fused.py:1065", "vith_b1"),
           "attention_qkv_proj": (
               "quantized_vit_tpu_torch/csrc/attention_proj.cu",
               "quantized_vit_tpu/ops/attention.py:770",
               f"vith_branch_b{VIT_H_BRANCH_BATCH}"),
           "int4_matmul": ("quantized_vit_tpu_torch/csrc/int_matmul.cu",
                           "quantized_vit_tpu/ops/int4_matmul.py:193",
                           "profile_kernels"),
           "int8_matmul": ("quantized_vit_tpu_torch/csrc/int_matmul.cu",
                           "quantized_vit_tpu/ops/int4_matmul.py:273",
                           "profile_kernels"),
           "quant_matmul_fa": ("quantized_vit_tpu_torch/csrc/int_matmul.cu",
                               "quantized_vit_tpu/ops/int4_matmul.py:480",
                               "profile_kernels"),
           "flash_attention": (
               "quantized_vit_tpu_torch/csrc/flash_attention.cu",
               "quantized_vit_tpu/ops/attention.py:119",
               f"k13_vitb_b{BATCH}"),
           "gather_rows": ("quantized_vit_tpu_torch/csrc/ring_gather.cu",
                           "quantized_vit_tpu/ops/ring_gather.py:154",
                           "fsdp_tp1"),
           "fused_mlp_gather": (
               "quantized_vit_tpu_torch/csrc/fused_mlp.cu",
               "quantized_vit_tpu/ops/ring_gather.py:314", "fsdp_tp1")}
    launches = dict(fwd["launches"], **fwd["vit_h"]["launches"],
                    **fwd["paths"]["launches"], **fwd["fsdp"]["launches"])
    kernels = []
    for name, (src, rep, path) in rel.items():
        ss = [s for s in per_site if s["kernel"] == name]
        errs = [r for r in record["parity"]
                if r["kernel"] == name and "small" not in r["case"]]
        tot = lambda key: sum(s[key] * s["launches"] for s in ss
                              if s["launches"]) / 1e3
        # the sites on the kernel's own forward (launches > 0)
        im = [s["int_mm_us"] for s in ss if s["launches"]]
        lib = [s["library_us"] for s in ss if s["launches"]]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            # counted on the path that runs the kernel: the batch-32
            # forward, the chain forward at batch 2, the latency forward,
            # ViT-H/14's forward at batch 1, the kernel paths of phase 3b
            "launches": launches[path][name], "path": path,
            "max_abs_err": max(r["max_abs_err"] for r in errs),
            "share_differ": max(r["share_differ"] for r in errs),
            "bit_exact": all(r["bit_exact"] for r in errs),
            # per forward: the kernel's launches at their main-path shapes
            "ms": tot("us"), "plain_ms": tot("plain_us"),
            "bound_ms": tot("bound_us"),
            "bound_by": max(ss, key=lambda s: s["bound_us"] * s["launches"])
            ["bound_by"],
            "library_ms": (None if not lib or any(v is None for v in lib)
                           else tot("library_us")),
            "int_mm_ms": (None if not im or any(v is None for v in im)
                          else tot("int_mm_us")),
            "us_per_launch": {s["site"]: s["us"] for s in ss},
            "bound_us_per_launch": {s["site"]: s["bound_us"] for s in ss},
        })
    record["kernels"] = kernels


def k9_site_calls(blk, plan, qkv, x3, hd, n_real):
    """(K9, its plain version, K6 + K1, K3's branch) on block ``blk``'s
    layers, as calls on ``qkv`` [B, N, 3D] and the residual ``x3``; on the
    card each kernel launches on a plan (K6, K3 and the proj K1 on the
    forward's ``plan``), in a CPU rehearsal the wrappers take their plain
    versions."""
    from quantized_vit_tpu_torch.ops import (
        attention_block, attention_qkv, attention_qkv_proj,
        attention_qkv_proj_plain, fused_quant_matmul,
        plan_attention_qkv_proj, run_attention_block, run_attention_qkv,
        run_attention_qkv_proj, run_matmul)
    from quantized_vit_tpu_torch.serve.vit_int4 import _attention_layer

    bf16 = torch.bfloat16
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    layer = _attention_layer(blk, hd, hd**-0.5)
    q = {k: layer[k] for k in ("heads", "sm_scale", "out_d", "out_t",
                               "out_top", "out_pow")}
    kq = dict(n_valid=n_real, out_dtype=bf16)
    proj = (proj_e.w, proj_e.scale, proj_e.bias)
    m = x3.shape[0] * x3.shape[1]
    x2 = x3.reshape(m, -1)

    def plain():
        return attention_qkv_proj_plain(qkv, *proj, x3, fmt=proj_e.fmt, **q,
                                        **kq)

    if plan is None:
        def k9():
            return attention_qkv_proj(qkv, *proj, x3, fmt=proj_e.fmt, **q,
                                      **kq)

        def k6_k1():
            alv = attention_qkv(qkv, **q, **kq)
            return fused_quant_matmul(alv.reshape(m, -1), *proj,
                                      fmt=proj_e.fmt, prologue=None,
                                      epilogue="residual", residual=x2,
                                      out_dtype=bf16)

        def k3():
            return attention_block(x3, qkv_e.w, qkv_e.scale, qkv_e.bias,
                                   *proj, fmt_proj=proj_e.fmt, **layer, **kq)

        return k9, plain, k6_k1, k3
    attn_p, k6_p = plan.blocks[0][0], plan.chain[0][1]
    k9_p = plan_attention_qkv_proj(*proj, fmt=proj_e.fmt, **q)

    def k6_k1():
        alv = run_attention_qkv(k6_p, qkv, **kq)
        return run_matmul(attn_p.proj, alv.reshape(m, -1), residual=x2,
                          out_dtype=bf16)

    return (lambda: run_attention_qkv_proj(k9_p, qkv, x3, **kq), plain,
            k6_k1, lambda: run_attention_block(attn_p, x3, **kq))


def path_sites(fwd, kern, plain, bound):
    """The timing sites of phase 3b's kernels, added to ``kern``/``plain``:
    K9 at ViT-H/14's batch 8 (its launch on the exp_vith path) and
    ViT-B/16's batch 32, with SDPA + ``torch._int_mm`` on the proj as the
    library yardstick and, beside it, K6 + K1 (the function's plain
    structure on kernels) and K3's branch; K10-K12 at profile_kernels'
    four shapes (one launch each on that path), ``torch._int_mm`` as the
    library call and, for K12, K1 with the quant prologue (1/d, not the
    division) as a yardstick."""
    from quantized_vit_tpu_torch.ops import (fused_quant_matmul,
                                             int4_matmul_plain,
                                             int8_matmul_plain,
                                             plan_int_matmul, plan_matmul,
                                             quant_matmul_fa_plain,
                                             run_int_matmul, run_matmul)
    from quantized_vit_tpu_torch.quant import pack_int4

    bf16 = torch.bfloat16
    g = torch.Generator(device=DEV).manual_seed(11)
    sites = []
    vh = fwd["vit_h"]
    vb = shapes(fwd["cfg"])
    for site, art, plan, b, d, n_real, n_pad, heads, nl in (
            (f"k9_vith_b{VIT_H_BRANCH_BATCH}", vh["art"], vh["plan"],
             VIT_H_BRANCH_BATCH, *vit_h_shapes(vh["cfg"])[1:4],
             vit_h_shapes(vh["cfg"])[5], 1),
            (f"k9_vitb_b{BATCH}", fwd["art"], fwd["plan"], BATCH, vb[2],
             vb[3], vb[4], vb[8], 0)):
        hd = d // heads
        nk = -(-n_real // 16) * 16
        m = b * n_pad
        qkv = (torch.randn((b, n_pad, 3 * d), generator=g, device=DEV)
               * 0.7).to(bf16)
        x3 = torch.randn((b, n_pad, d), generator=g, device=DEV).to(bf16)
        kern[site], plain[site], k6_k1, k3 = k9_site_calls(
            art["blocks"][0], plan, qkv, x3, hd, n_real)
        proj_e = art["blocks"][0]["proj"]
        alv = torch.randint(-7, 8, (m, d), dtype=torch.int8, device=DEV,
                            generator=g)
        wt = torch.randint(-7, 8, (d, d), dtype=torch.int8, device=DEV,
                           generator=g).t()
        attn = sdpa_call(b, heads, n_pad, nk, hd, g)

        def lib(attn=attn, alv=alv, wt=wt):
            attn()
            return torch._int_mm(alv, wt)

        wb = d * d * (0.5 if proj_e.fmt == "int4" else 1)
        attn_ops = b * 2 * heads * n_pad * nk * hd * 2
        sites.append((
            "attention_qkv_proj", site, nl,
            bound(m * 3 * d * 2 + 2 * m * d * 2 + wb + 8 * d, 2 * m * d * d,
                  attn_ops), [], lib, {"k6_k1": k6_k1, "k3_branch": k3}))
    sc = torch.full((), 1e-3, device=DEV)
    fa_q = dict(act_d=torch.full((), 0.05, device=DEV),
                act_t=torch.full((), 1.0, device=DEV), act_top=7,
                act_pow=False)
    for label, m, k, n in profile_shapes(fwd["cfg"]):
        xf = (torch.randn((m, k), generator=g, device=DEV) * 0.1).to(bf16)
        xl = torch.randint(-7, 8, (m, k), dtype=torch.int8, device=DEV,
                           generator=g)
        w8 = torch.randint(-7, 8, (k, n), dtype=torch.int8, device=DEV,
                           generator=g)
        w4 = pack_int4(w8, axis=0)
        bias = torch.randn((n,), generator=g, device=DEV) * 0.01
        fa_args = (fa_q["act_d"], fa_q["act_t"], fa_q["act_top"])
        plain.update({
            f"int4_{label}": lambda xl=xl, w4=w4, bias=bias:
                int4_matmul_plain(xl, w4, sc, bias),
            f"int8_{label}": lambda xl=xl, w8=w8, bias=bias:
                int8_matmul_plain(xl, w8, sc, bias),
            f"fa_{label}": lambda xf=xf, w4=w4, bias=bias:
                quant_matmul_fa_plain(xf, w4, sc, bias, *fa_args, fmt="int4",
                                      act_pow=False, out_dtype=bf16)})
        if DEV != "cuda":  # CPU rehearsal: the plain versions
            for kk in ("int4", "int8", "fa"):
                kern[f"{kk}_{label}"] = plain[f"{kk}_{label}"]
            k1 = (lambda xf=xf, w4=w4, bias=bias: fused_quant_matmul(
                xf, w4, sc, bias, fmt="int4", prologue="quant",
                out_dtype=bf16, **fa_q))
        else:
            p4 = plan_int_matmul(w4, sc, bias, fmt="int4")
            p8 = plan_int_matmul(w8, sc, bias, fmt="int8")
            pfa = plan_int_matmul(w4, sc, bias, fmt="int4", **fa_q)
            p1 = plan_matmul(w4, sc, bias, fmt="int4", prologue="quant",
                             **fa_q)
            kern.update({
                f"int4_{label}": lambda p4=p4, xl=xl: run_int_matmul(p4, xl),
                f"int8_{label}": lambda p8=p8, xl=xl: run_int_matmul(p8, xl),
                f"fa_{label}": lambda pfa=pfa, xf=xf: run_int_matmul(
                    pfa, xf, out_dtype=bf16)})
            k1 = (lambda p1=p1, xf=xf: run_matmul(p1, xf, out_dtype=bf16))
        ops = 2 * m * k * n
        mm = (lambda xl=xl, w8t=w8.t().contiguous().t():
              torch._int_mm(xl, w8t))
        sites += [
            ("int4_matmul", f"int4_{label}", 1,
             bound(m * k + k * n / 2 + m * n * 4 + 8 * n, ops), [], mm),
            ("int8_matmul", f"int8_{label}", 1,
             bound(m * k + k * n + m * n * 4 + 8 * n, ops), [], mm),
            ("quant_matmul_fa", f"fa_{label}", 1,
             bound(m * k * 2 + k * n / 2 + m * n * 2 + 8 * n, ops), [], mm,
             {"k1_quant": k1})]
    return sites


def fsdp_sites(fwd, kern, plain, bound, xs):
    """The timing sites of K13, K14 and K15, added to ``kern``/``plain``:
    K13 on its path's q/k/v (ViT-B/16 batch 32: the launch of its path;
    ViT-H/14 batch 1 and 8) with ``scaled_dot_product_attention`` on the
    same q/k/v as the library call (no mask: the padded keys count); K14
    on block 0's gather of the FSDP forward at tp = 1 (one launch a
    forward), ``torch.cat`` of the shards as the library call; K15 on
    block 0's MLP + gather of block 1 at the batch's rows (12 launches a
    forward), and at ViT-H/14's (its FSDP forward's 32 launches counted
    on their own path), with K2 on the same plan as a yardstick (no
    PyTorch call computes it)."""
    import torch.nn.functional as F

    from quantized_vit_tpu_torch.ops import (flash_attention,
                                             flash_attention_plain,
                                             fused_mlp_gather_plain,
                                             gather_rows_plain,
                                             run_gather_rows, run_mlp,
                                             run_mlp_gather)
    from quantized_vit_tpu_torch.serve.vit_fsdp import (_SHARDED, _logical,
                                                        _mlp_args,
                                                        _with_weights)

    sites = []
    for site, (q, k, v, kw) in fwd["paths"]["k13"].items():
        kern[site] = lambda q=q, k=k, v=v, kw=kw: flash_attention(q, k, v,
                                                                  **kw)
        plain[site] = lambda q=q, k=k, v=v, kw=kw: flash_attention_plain(
            q, k, v, **kw)
        b, h, n, hd = q.shape
        nbytes = 4 * q.numel() * q.element_size()
        sites.append((
            "flash_attention", site, int(site == f"k13_vitb_b{BATCH}"),
            bound(nbytes, 0, 2 * b * h * n * n * hd * 2), [],
            lambda q=q, k=k, v=v, kw=kw: F.scaled_dot_product_attention(
                q, k, v, scale=kw["sm_scale"])))
    fs = fwd["fsdp"]
    vh = fwd["vit_h"]
    xh = (torch.randn((vh["x"].shape[0] * vit_h_shapes(vh["cfg"])[3],
                       vh["cfg"].embed_dim), device=DEV,
                      generator=torch.Generator(DEV).manual_seed(3))
          * 0.5).to(torch.bfloat16)
    kg = []
    for tag, fart, plan, x, nl in (("", fs["fart"], fs["plan"], xs,
                                    fwd["cfg"].depth),
                                   ("_vith", fs["fart_h"], fs["plan_h"], xh,
                                    0)):
        blk0, blk1 = fart["blocks"][0], fart["blocks"][1]
        shards0 = [blk0[k].w for k in _SHARDED]
        shards1 = [blk1[k].w for k in _SHARDED]
        moved = sum(s.numel() * s.element_size() for s in shards1)
        full0 = _with_weights(blk0, [_logical(s) for s in shards0])
        args, layer = _mlp_args(full0)
        plain["mlp_gather" + tag] = (
            lambda x=x, args=args, shards1=shards1, layer=layer:
            fused_mlp_gather_plain(x, *args, next_shards=shards1,
                                   out_dtype=torch.bfloat16, **layer))
        yard = {}
        if plan is not None:
            _, _, mlp0, gather1 = plan.blocks[0]
            kern["mlp_gather" + tag] = (
                lambda mlp0=mlp0, gather1=gather1, x=x: run_mlp_gather(
                    mlp0, gather1, x, out_dtype=torch.bfloat16))
            yard["k2_same_plan"] = (lambda mlp0=mlp0, x=x: run_mlp(
                mlp0, x, out_dtype=torch.bfloat16))
        else:
            kern["mlp_gather" + tag] = plain["mlp_gather" + tag]
        m, d = x.shape
        hid = args[0].shape[1]
        kg.append(("fused_mlp_gather", "mlp_gather" + tag, nl,
                   bound(2 * m * d * 2 + 2 * d * hid + 2 * moved,
                         4 * m * d * hid),
                   [(m, d, hid), (m, hid, d)], None, yard))
        if not tag:
            plain["gather_b0"] = lambda shards0=shards0: gather_rows_plain(
                shards0)
            kern["gather_b0"] = (plain["gather_b0"] if plan is None else
                                 lambda plan=plan: run_gather_rows(
                                     plan.boot))
            kg.append(("gather_rows", "gather_b0", 1,
                       bound(2 * sum(s.numel() * s.element_size()
                                     for s in shards0)), [],
                       lambda shards0=shards0: [torch.cat([s])
                                                for s in shards0]))
    # K14's site first, as the kernels line lists them
    return sites + kg[1:2] + kg[:1] + kg[2:]


def overlap_sweep(cfg):
    """tools/exp_rdma_overlap.py's single-chip question (:80-134) on this
    card at tp = 1: K2 alone at M = BATCH x the padded tokens (the
    script's 32 x 208, D 768, hidden 3072, int8, t = 1, top 7), then K15
    on the same plan gathering 4, 8, 16 and 31 MB of dummy int8 shards,
    and K14 alone on the same shards. A flat K15 time means the copy
    hides under the MLP. (Its AOT leg, a TPU v5e topology compile, has no
    counterpart on this card.)"""
    from quantized_vit_tpu_torch.ops import (fused_mlp_gather_plain,
                                             fused_mlp_plain, plan_gather_rows,
                                             plan_mlp, run_gather_rows,
                                             run_mlp, run_mlp_gather)

    _, _, d, _, n_pad, _, hid, _, _ = shapes(cfg)
    m = BATCH * n_pad
    rng = np.random.default_rng(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
        return x.to(dt) if dt else x

    def scal(v):
        return torch.full((), v, dtype=f32, device=DEV)

    x = t(rng.standard_normal((m, d)) * 0.2, bf16)
    w1 = t(rng.integers(-7, 8, (d, hid)).astype(np.int8))
    w2 = t(rng.integers(-7, 8, (hid, d)).astype(np.int8))
    args = (w1, scal(1e-3), t(rng.standard_normal(hid) * 0.01, f32), w2,
            scal(1e-3), t(rng.standard_normal(d) * 0.01, f32))
    kw = dict(ln_scale=torch.ones((d,), device=DEV),
              ln_bias=torch.zeros((d,), device=DEV), act_d=scal(0.05),
              act_t=scal(1.0), act_top=7, act_pow=False, hid_d=scal(0.05),
              hid_t=scal(1.0), hid_top=7, hid_pow=False, fmt="int8")
    cuda = DEV == "cuda"
    plan = plan_mlp(*args, **kw) if cuda else None
    out = {"m": m, "k": d, "hid": hid,
           "k2_us": 1e3 * cuda_ms(
               (lambda: run_mlp(plan, x)) if cuda else
               (lambda: fused_mlp_plain(x, *args, **kw))), "sweep": {}}
    for mb in OVERLAP_MB:
        rows = (mb * 2**20) // d
        rows -= rows % 32
        dummy = torch.randint(-7, 8, (rows, d), dtype=torch.int8, device=DEV)
        if cuda:
            gp = plan_gather_rows([dummy])
            k15 = cuda_ms(lambda: run_mlp_gather(plan, gp, x))
            k14 = cuda_ms(lambda: run_gather_rows(gp))
            del gp
        else:
            k15 = cuda_ms(lambda: fused_mlp_gather_plain(
                x, *args, next_shards=[dummy], **kw))
            k14 = None
        out["sweep"][f"{mb}MB"] = {
            "k15_us": k15 * 1e3, "k15_minus_k2_us": k15 * 1e3 - out["k2_us"],
            "k14_alone_us": None if k14 is None else k14 * 1e3,
            "bytes": rows * d}
        del dummy
    log(f"[time] overlap sweep (M {m}): K2 {out['k2_us']:.1f} us; " +
        ", ".join(f"K15 + {k} {v['k15_us']:.1f} us (K14 alone "
                  f"{v['k14_alone_us'] or 0:.1f})"
                  for k, v in out["sweep"].items()))
    return out


def sdpa_call(b, heads, nq, nk, hd, g):
    """scaled_dot_product_attention on q [b, heads, nq, hd] and k = v
    [b, heads, nk, hd] in bf16: a yardstick (no exp2 clamp, no quantizing
    epilogue) the port never calls."""
    import torch.nn.functional as F

    qq = torch.randn((b, heads, nq, hd), generator=g, device=DEV).to(
        torch.bfloat16)
    kk = torch.randn((b, heads, nk, hd), generator=g, device=DEV).to(
        torch.bfloat16)
    return lambda: F.scaled_dot_product_attention(qq, kk, kk)


def vit_h_sites(vh, kern, plain, bound, fp64_flop):
    """The ViT-H/14 phase's timing sites, added to ``kern``/``plain``: K8
    per launch at batch 1 (32 launches a forward) and 2; K1's patch embed
    (K = 588), chain qkv and fc1/fc2 chain at batch 32; K3 at batch 32 and
    K6 at batch 1 and 2 (head_dim 80; the attention FLOP of K3's and K6's
    sites into ``fp64_flop``). Only
    K8's batch-1 site counts launches: the ViT-B forward's per-forward
    totals stay ViT-B's."""
    from quantized_vit_tpu_torch.ops import (attention_heads_plain,
                                             attention_qkv_plain,
                                             fused_mlp_plain,
                                             fused_quant_matmul_plain,
                                             run_attention_heads,
                                             run_attention_qkv, run_matmul,
                                             run_mlp, run_mlp_chunked)
    from quantized_vit_tpu_torch.ops.fused import plan_mlp, plan_mlp_chunked
    from quantized_vit_tpu_torch.quant import pack_int4
    from quantized_vit_tpu_torch.serve.vit_int4 import (_attention_layer,
                                                        _mlp_layer)

    cfg, art, plan = vh["cfg"], vh["art"], vh["plan"]
    p, d, n_real, n_pad, hid, heads = vit_h_shapes(cfg)
    hd = d // heads
    kp = cfg.patch_size**2 * cfg.in_channels
    bb = max(VIT_H_BATCHES)
    mb = bb * n_pad
    bf16 = torch.bfloat16
    blk = art["blocks"][0]
    g = torch.Generator(device=DEV).manual_seed(3)
    xs = torch.randn((mb, d), generator=g, device=DEV).to(bf16)
    hlv = torch.randint(-7, 8, (mb, hid), dtype=torch.int8, device=DEV,
                        generator=g)
    qkvs = {b: (torch.randn((b, n_pad, 3 * d), generator=g, device=DEV)
                * 0.7).to(bf16) for b in (1, 2)}
    xpatch = vh["x"][:bb].reshape(bb * p, kp)
    mlp_kw = dict(_mlp_layer(blk), out_dtype=bf16)
    attn_kw = dict(_attention_layer(blk, hd, hd**-0.5), n_valid=n_real,
                   out_dtype=bf16)
    qkv_kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=n_real,
                  out_d=blk["proj"].act["d"], out_t=blk["proj"].act["t"],
                  out_top=blk["proj"].top, out_pow=blk["proj"].act_pow,
                  out_dtype=bf16)
    e = {k: blk[k] for k in ("qkv", "proj", "fc1", "fc2")}
    # the attention's levels, the chain proj's input
    alv = torch.randint(-7, 8, (2 * n_pad, d), dtype=torch.int8,
                        device=DEV, generator=g)
    pe = art["patch_embed"]

    def q(le):
        return dict(act_d=le.act["d"], act_t=le.act["t"], act_top=le.top,
                    act_pow=le.act_pow)

    def mlp_plain(m):
        return lambda: fused_mlp_plain(
            xs[:m], e["fc1"].w, e["fc1"].scale, e["fc1"].bias, e["fc2"].w,
            e["fc2"].scale, e["fc2"].bias, **mlp_kw)

    # K2 on block 0's weights packed to int4 (the packed artifact's
    # format), which its first design refused at K = 1280
    w4 = [pack_int4(e[k].w, axis=0) for k in ("fc1", "fc2")]
    mlp4_kw = dict(mlp_kw, fmt="int4", fmt2="int4")
    for bk in (1, 2):
        plain[f"vith_mlp_int4_b{bk}"] = (
            lambda m=bk * n_pad: fused_mlp_plain(
                xs[:m], w4[0], e["fc1"].scale, e["fc1"].bias, w4[1],
                e["fc2"].scale, e["fc2"].bias, **mlp4_kw))

    # K8 past its first design's width limit (K = 1536 at ViT-H/14's),
    # random int8 levels, beside K2 on the same weights
    wide = 6 * d // 5
    gw = np.random.default_rng(11)
    wkw = dict(mlp_kw, fmt="int8", fmt2="int8")
    ww = [torch.from_numpy(gw.integers(-7, 8, shp).astype(np.int8)).to(DEV)
          for shp in ((wide, 4 * wide), (4 * wide, wide))]
    wsb = [torch.full((), 1e-3, device=DEV), None]
    wln = dict(ln_scale=torch.ones(wide, device=DEV),
               ln_bias=torch.zeros(wide, device=DEV))
    xw = torch.randn((bb * n_pad, wide), generator=g, device=DEV).to(bf16)
    wkw.update(wln)
    for bk in (1, 2):
        plain[f"vith_wide_mlp_b{bk}"] = (
            lambda m=bk * n_pad: fused_mlp_plain(
                xw[:m], ww[0], wsb[0], wsb[1], ww[1], wsb[0], wsb[1], **wkw))
        plain[f"vith_wide_mlp_k2_b{bk}"] = plain[f"vith_wide_mlp_b{bk}"]
        plain[f"vith_mlp_k2_b{bk}"] = mlp_plain(bk * n_pad)
    plain.update({
        "vith_mlp_b1": mlp_plain(n_pad), "vith_mlp_b2": mlp_plain(2 * n_pad),
        "vith_patch_embed_b32": lambda: fused_quant_matmul_plain(
            xpatch, pe.w, pe.scale, pe.bias, fmt=pe.fmt, prologue="quant",
            out_dtype=torch.float32, **q(pe)),
        **{f"vith_chain_qkv_b{bk}": (
            lambda m=bk * n_pad: fused_quant_matmul_plain(
                xs[:m], e["qkv"].w, e["qkv"].scale, e["qkv"].bias,
                fmt="int8", prologue="ln_quant",
                ln_scale=blk["norm1"]["scale"],
                ln_bias=blk["norm1"]["bias"], out_dtype=bf16,
                **q(e["qkv"]))) for bk in (1, 2)},
        **{f"vith_chain_proj_b{bk}": (
            lambda m=bk * n_pad: fused_quant_matmul_plain(
                alv[:m], e["proj"].w, e["proj"].scale, e["proj"].bias,
                fmt="int8", prologue=None, epilogue="residual",
                residual=xs[:m], out_dtype=bf16)) for bk in (1, 2)},
        "vith_fc1_b32": lambda: fused_quant_matmul_plain(
            xs, e["fc1"].w, e["fc1"].scale, e["fc1"].bias, fmt="int8",
            prologue="ln_quant", ln_scale=blk["norm2"]["scale"],
            ln_bias=blk["norm2"]["bias"], epilogue="gelu_quant",
            out_d=e["fc2"].act["d"], out_t=e["fc2"].act["t"],
            out_top=e["fc2"].top, out_pow=e["fc2"].act_pow, **q(e["fc1"])),
        "vith_fc2_b32": lambda: fused_quant_matmul_plain(
            hlv, e["fc2"].w, e["fc2"].scale, e["fc2"].bias, fmt="int8",
            prologue=None, epilogue="residual", residual=xs, out_dtype=bf16),
        "vith_heads_b32": lambda: attention_heads_plain(
            xs.reshape(bb, n_pad, d), e["qkv"].w, e["qkv"].scale,
            e["qkv"].bias, **attn_kw),
        "vith_qkv_attn_b1": lambda: attention_qkv_plain(qkvs[1], **qkv_kw),
        "vith_qkv_attn_b2": lambda: attention_qkv_plain(qkvs[2], **qkv_kw),
    })
    if plan is None:  # CPU rehearsal: the plain versions
        kern.update({k: plain[k] for k in plain if k.startswith("vith_")})
    else:
        attn_p, mlps = plan.blocks[0]
        p4 = plan_mlp(w4[0], e["fc1"].scale, e["fc1"].bias, w4[1],
                      e["fc2"].scale, e["fc2"].bias,
                      **{k: v for k, v in mlp4_kw.items()
                         if k != "out_dtype"})
        pkw = {k: v for k, v in wkw.items() if k != "out_dtype"}
        pw8 = plan_mlp_chunked(ww[0], wsb[0], wsb[1], ww[1], wsb[0], wsb[1],
                               **pkw)
        pw2 = plan_mlp(ww[0], wsb[0], wsb[1], ww[1], wsb[0], wsb[1], **pkw)
        for bk in (1, 2):
            kern[f"vith_mlp_int4_b{bk}"] = (
                lambda m=bk * n_pad: run_mlp(p4, xs[:m], out_dtype=bf16))
            kern[f"vith_mlp_k2_b{bk}"] = (
                lambda m=bk * n_pad: run_mlp(mlps.resident, xs[:m],
                                             out_dtype=bf16))
            kern[f"vith_wide_mlp_b{bk}"] = (
                lambda m=bk * n_pad: run_mlp_chunked(pw8, xw[:m],
                                                     out_dtype=bf16))
            kern[f"vith_wide_mlp_k2_b{bk}"] = (
                lambda m=bk * n_pad: run_mlp(pw2, xw[:m], out_dtype=bf16))
        kern.update({
            "vith_mlp_b1": lambda: run_mlp_chunked(mlps.chunked, xs[:n_pad],
                                                   out_dtype=bf16),
            "vith_mlp_b2": lambda: run_mlp_chunked(
                mlps.chunked, xs[:2 * n_pad], out_dtype=bf16),
            "vith_patch_embed_b32": lambda: run_matmul(
                plan.embed["patches"][0], xpatch, out_dtype=torch.float32),
            **{f"vith_chain_qkv_b{bk}": (
                lambda m=bk * n_pad: run_matmul(plan.chain[0][0], xs[:m],
                                                out_dtype=bf16))
               for bk in (1, 2)},
            **{f"vith_chain_proj_b{bk}": (
                lambda m=bk * n_pad: run_matmul(
                    attn_p.proj, alv[:m], residual=xs[:m], out_dtype=bf16))
               for bk in (1, 2)},
            "vith_fc1_b32": lambda: run_matmul(mlps.fc1, xs),
            "vith_fc2_b32": lambda: run_matmul(mlps.fc2, hlv, residual=xs,
                                               out_dtype=bf16),
            "vith_heads_b32": lambda: run_attention_heads(
                attn_p.heads, xs.reshape(bb, n_pad, d), n_valid=n_real,
                out_dtype=bf16),
            "vith_qkv_attn_b1": lambda: run_attention_qkv(
                plan.chain[0][1], qkvs[1], n_valid=n_real, out_dtype=bf16),
            "vith_qkv_attn_b2": lambda: run_attention_qkv(
                plan.chain[0][1], qkvs[2], n_valid=n_real, out_dtype=bf16),
        })
    nk = -(-n_real // 16) * 16
    attn_ops = 2 * heads * n_pad * nk * hd * 2  # one image's QK^T and PV
    fp64_flop.update({f"vith_qkv_attn_b{bk}": bk * attn_ops
                      for bk in (1, 2)})
    fp64_flop["vith_heads_b32"] = bb * attn_ops

    def mlp_bound(m, wbytes=1):
        return bound(2 * m * d * 2 + 2 * d * hid * wbytes, 4 * m * d * hid)

    return [
        ("fused_mlp", "vith_mlp_int4_b1", 0, mlp_bound(n_pad, 0.5),
         [(n_pad, d, hid), (n_pad, hid, d)], None),
        ("fused_mlp", "vith_mlp_int4_b2", 0, mlp_bound(2 * n_pad, 0.5),
         [(2 * n_pad, d, hid), (2 * n_pad, hid, d)], None),
        ("fused_mlp_chunked", "vith_mlp_b1", cfg.depth, mlp_bound(n_pad),
         [(n_pad, d, hid), (n_pad, hid, d)], None),
        ("fused_mlp_chunked", "vith_mlp_b2", 0, mlp_bound(2 * n_pad),
         [(2 * n_pad, d, hid), (2 * n_pad, hid, d)], None),
        # K2 on the same int8 plan (the same function), K8's yardstick
        *[("fused_mlp", f"vith_mlp_k2_b{bk}", 0, mlp_bound(bk * n_pad),
           [(bk * n_pad, d, hid), (bk * n_pad, hid, d)], None)
          for bk in (1, 2)],
        # K = 1536 (H 6144): K8 past its first design's width, K2 beside
        *[(kn, f"vith_wide_mlp{sfx}_b{bk}", 0, bound(
            2 * bk * n_pad * wide * 2 + 2 * wide * 4 * wide,
            4 * bk * n_pad * wide * 4 * wide),
           [(bk * n_pad, wide, 4 * wide), (bk * n_pad, 4 * wide, wide)],
           None) for bk in (1, 2)
          for kn, sfx in (("fused_mlp_chunked", ""), ("fused_mlp", "_k2"))],
        ("fused_quant_matmul", "vith_patch_embed_b32", 0,
         bound(bb * p * kp * 4 + kp * d + bb * p * d * 4,
               2 * bb * p * kp * d), [(bb * p, kp, d)], None),
        *[("fused_quant_matmul", f"vith_chain_qkv_b{bk}", 0,
           bound(bk * n_pad * d * 2 + 3 * d * d + bk * n_pad * 3 * d * 2,
                 2 * bk * n_pad * d * 3 * d), [(bk * n_pad, d, 3 * d)],
           None) for bk in (1, 2)],
        *[("fused_quant_matmul", f"vith_chain_proj_b{bk}", 0,
           bound(bk * n_pad * d + d * d + 2 * bk * n_pad * d * 2,
                 2 * bk * n_pad * d * d), [(bk * n_pad, d, d)], None)
          for bk in (1, 2)],
        ("fused_quant_matmul", "vith_fc1_b32", 0,
         bound(mb * d * 2 + d * hid + mb * hid, 2 * mb * d * hid),
         [(mb, d, hid)], None),
        ("fused_quant_matmul", "vith_fc2_b32", 0,
         bound(mb * hid + hid * d + 2 * mb * d * 2, 2 * mb * hid * d),
         [(mb, hid, d)], None),
        ("attention_block", "vith_heads_b32", 0,
         bound(mb * d * 2 + 3 * d * d + mb * d, 2 * mb * d * 3 * d,
               bb * attn_ops), [(mb, d, 3 * d)], None),
        ("attention_qkv", "vith_qkv_attn_b1", 0,
         bound(n_pad * 3 * d * 2 + n_pad * d, 0, attn_ops), [],
         sdpa_call(1, heads, n_pad, nk, hd, g)),
        ("attention_qkv", "vith_qkv_attn_b2", 0,
         bound(2 * n_pad * 3 * d * 2 + 2 * n_pad * d, 0, 2 * attn_ops), [],
         sdpa_call(2, heads, n_pad, nk, hd, g)),
    ]


# ---------------------------------------------------------------------------
# phase 6: QAT + GETA training, full width
# ---------------------------------------------------------------------------


class StepProbe:
    """The optimizer as the training loop sees it: per step, the K7
    launches of the step's backward (read when the loop clips the
    gradients), GETA.step's host time (until it returns) and its time to
    the end of its device work, and the schedule's state after the step."""

    def __init__(self, opt):
        self.opt = opt
        self.rows = []
        self._seen = 0
        self._gc_ms = 0.0
        self._gc_t0 = 0.0

    def gc_callback(self, phase, info):
        """Python's garbage collections, timed (a share of GETA.step's
        host time)."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self._gc_ms += (time.perf_counter() - self._gc_t0) * 1e3

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def _active(self):
        return any(st["active_redundant"] for st in self.opt.state.values())

    def clip_grads(self, grads):
        from quantized_vit_tpu_torch.ops import _build

        n = _build.LAUNCHES["quant_bwd"]
        self.rows.append({"k7_launches": n - self._seen})
        self._seen = n
        return self.opt.clip_grads(grads)

    def step(self, params, grads):
        active = self._active()
        self._gc_ms = 0.0
        t0 = time.perf_counter()
        out = self.opt.step(params, grads)
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        o = self.opt
        self.rows[-1].update(
            step=o.num_steps, geta_host_ms=(t1 - t0) * 1e3,
            geta_ms=(t2 - t0) * 1e3, gc_ms=self._gc_ms,
            max_bit_wt=o.max_bit_wt,
            pruning_period=o.curr_pruning_period,
            prune_mode=active or self._active(),
            n_pruned=len(o.pruned_group_idxes),
            bits_frozen=bool(o.bit_layers))
        return out


def phase_of(n):
    g = GETA_KW
    if n <= g["start_projection_step"]:
        return "warmup"
    if n > g["start_pruning_step"] + g["pruning_steps"]:
        return "fix"
    return "range"


def train_phase(dev, record, peaks):
    """ViT-B/16 QAT (fused_vjp: K7 for every nonlinear quantizer's
    backward) with GETA at batch BATCH, driven by TrainLoop through
    warmup, range projection, two pruning periods and fix; then evaluate,
    a checkpoint round trip, the plain chain against K7 on one step, and
    the timings."""
    import dataclasses

    from quantized_vit_tpu_torch.graph import OTO
    from quantized_vit_tpu_torch.models import (QuantConfig,
                                                VisionTransformer, apply,
                                                flatten_tree,
                                                init_quant_params_tree,
                                                tree_map)
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.opt import (GETA, load_checkpoint,
                                             save_checkpoint)
    from quantized_vit_tpu_torch.utils import (ArrayDataset, DataLoader,
                                               TrainLoop, evaluate)

    t_phase = time.time()
    base = main_cfg()
    cfg = dataclasses.replace(
        base, quant=QuantConfig(enabled=True, fused_vjp=True))
    model = VisionTransformer(cfg, seed=0, device=dev)
    # the quantizer scalars at 32 bits, as cli/train.py initialises them
    params = init_quant_params_tree(
        tree_map(lambda p: p.detach().clone(), model.param_tree()),
        init_bits=32.0)
    rng = np.random.default_rng(0)
    hw = (cfg.img_size, cfg.img_size, cfg.in_channels)
    images = rng.standard_normal((TRAIN_STEPS * BATCH, *hw),
                                 dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, TRAIN_STEPS * BATCH)
    held_x = rng.standard_normal((2 * BATCH - 3, *hw), dtype=np.float32)
    held_y = rng.integers(0, cfg.num_classes, 2 * BATCH - 3)

    oto = OTO(model, params)
    oto.mark_unprunable_by_param_names(["patch_embed", "pos_embed",
                                        "cls_token", "head"])
    opt = oto.geta(**GETA_KW)
    probe = StepProbe(opt)
    gen = torch.Generator(device=dev).manual_seed(0)

    def train_apply(p, x, g):
        return apply(model, p, x, deterministic=False, generator=g)

    loop = TrainLoop(apply_fn=train_apply, optimizer=probe,
                     num_classes=cfg.num_classes, device=dev)
    loader = DataLoader(ArrayDataset(images, labels), BATCH, shuffle=True,
                        seed=0)
    gc.callbacks.append(probe.gc_callback)
    _build.reset_launches()
    try:
        # under a CUDA trace: K7's device time over the launches counted
        (params, tm), kern = traced(
            lambda: loop.train_one_epoch(params, loader, 0, gen))
    finally:
        gc.callbacks.remove(probe.gc_callback)
    launches = dict(_build.LAUNCHES)
    steps = tm["steps"]
    ev = evaluate(lambda p, x: apply(model, p, x), params,
                  DataLoader(ArrayDataset(held_x, held_y), BATCH,
                             pad_last=True), device=dev)
    metrics = opt.compute_metrics(params)
    bits_now = opt.bitwidth_dict(params)
    out = {"steps": steps, "losses": tm["step_losses"],
           "seconds": tm["seconds"], "per_step": probe.rows,
           "phases": [phase_of(r["step"]) for r in probe.rows],
           "launches": launches, "eval": ev,
           "group_sparsity": metrics["group_sparsity"],
           "num_zero_groups": metrics["num_zero_groups"],
           "target_redundant_groups": opt.target_num_redundant_groups,
           "bit_layers_frozen": opt.bit_layers == bits_now,
           "bit_layers": opt.bit_layers, "k7_trace": k7_in_trace(kern)}
    del kern
    record["train"] = out
    log(f"[train] {steps} steps, losses {[round(v, 4) for v in out['losses']]}"
        f", {tm['seconds']:.1f} s; phases {out['phases']}")
    for r in probe.rows:
        log(f"  step {r['step']:2d} K7 {r['k7_launches']:3d} GETA host "
            f"{r['geta_host_ms']:.1f} ms (gc {r['gc_ms']:.1f}) total "
            f"{r['geta_ms']:.1f} ms "
            f"max_bit {r['max_bit_wt']} period {r['pruning_period']} prune "
            f"{r['prune_mode']} pruned {r['n_pruned']}")
    log(f"[train] K7 in the run's trace: {out['k7_trace']}")
    log(f"[train] sparsity {metrics['group_sparsity']:.4f} "
        f"({metrics['num_zero_groups']} of {opt.total_num_groups} groups, "
        f"target {opt.target_num_redundant_groups}); eval {ev}")
    per_step = sum(n for _, _, n in k7_sites(cfg))
    if steps != TRAIN_STEPS or not all(np.isfinite(out["losses"])):
        raise Failed(f"training: {steps} steps, losses {out['losses']}")
    if not all(np.isfinite([ev["loss"], ev["top1"], ev["top5"]])):
        raise Failed(f"evaluate: {ev}")
    if dev.type == "cuda" and (
            any(r["k7_launches"] != per_step for r in probe.rows)
            or launches["quant_bwd"] != per_step * steps):
        raise Failed(f"K7 launches per step "
                     f"{[r['k7_launches'] for r in probe.rows]} != "
                     f"{per_step}")
    if metrics["num_zero_groups"] != opt.target_num_redundant_groups:
        raise Failed(f"group sparsity: {metrics['num_zero_groups']} zero "
                     f"groups, target {opt.target_num_redundant_groups}")
    ramps = [r["max_bit_wt"] for r in probe.rows]
    if (set(out["phases"]) != {"warmup", "range", "fix"}
            or min(ramps) >= GETA_KW["max_bit_wt"]
            or probe.rows[-1]["pruning_period"] < 2
            or sum(r["prune_mode"] for r in probe.rows) < 2
            or not opt.bit_layers or not out["bit_layers_frozen"]):
        raise Failed(f"schedule not walked: {probe.rows}")

    # checkpoint round trip
    path = os.path.join(TRAIN_CKPT, f"ckpt_{opt.num_steps}")
    save_checkpoint(path, params, opt.state_dict(), {"steps": steps})
    params2, state2, extra2 = load_checkpoint(path, device=dev)
    opt2 = GETA(oto.node_groups, params2, opt.cfg)
    opt2.load_state_dict(state2)
    flat, flat2 = flatten_tree(params), flatten_tree(params2)
    m1, m12 = flatten_tree(opt.m1), flatten_tree(opt2.m1)
    ckpt_ok = (set(flat) == set(flat2)
               and all(torch.equal(flat[k], flat2[k]) for k in flat)
               and all(torch.equal(m1[k], m12[k]) for k in m1)
               and opt2.num_steps == opt.num_steps
               and opt2.bit_layers == opt.bit_layers
               and opt2.pruned_group_idxes == opt.pruned_group_idxes
               and extra2 == {"steps": steps})
    out["checkpoint_roundtrip"] = ckpt_ok
    log(f"[train] checkpoint round trip {ckpt_ok}")
    if not ckpt_ok:
        raise Failed("checkpoint round trip")
    del params2, opt2, state2, flat2, m12

    # the plain chain against K7 on one step: same params, batch and card
    x0 = torch.from_numpy(images[:BATCH]).to(dev)
    y0 = torch.from_numpy(labels[:BATCH]).to(dev)
    model_plain = VisionTransformer(dataclasses.replace(
        base, quant=QuantConfig(enabled=True, fused_vjp=False)), device=dev)
    loop_plain = TrainLoop(
        apply_fn=lambda p, x, g: apply(model_plain, p, x,
                                       deterministic=False, generator=g),
        optimizer=opt, num_classes=cfg.num_classes, device=dev)
    out["plain_vs_k7"], sites = compare_plain_step(loop, loop_plain, params,
                                                   x0, y0)
    if not out["plain_vs_k7"]["ok"]:
        raise Failed(f"plain chain vs K7 step: {out['plain_vs_k7']}")

    train_timing(dev, record, peaks, cfg, loop, loop_plain, opt, params,
                 x0, y0, steps, sites)
    out["phase_s"] = round(time.time() - t_phase, 1)
    log(f"[train] phase {out['phase_s']} s")


def compare_plain_step(loop, loop_plain, params, x, y):
    """One step's loss and gradients with K7 and with the plain chain:
    the losses equal, every gradient but the quantizer scalars'
    bit-identical, each d/q_m/t gradient within 1e-5 of the L1 mass of its
    summands (recorded from the plain chain's terms). Returns the result
    and the step's quantizer sites: the inputs of each backward, (path,
    (x, g, d, q_m, t), keywords), for the timings."""
    from quantized_vit_tpu_torch.models import flatten_tree
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.ops import quant_vjp

    ptr_path = {v.data_ptr(): k for k, v in flatten_tree(params).items()
                if k.rsplit("/", 1)[-1].startswith("d_quant")}
    masses = {}
    sites = []
    plain = quant_vjp.lsfq_nonlinear_bwd_plain

    def recording(x_, g_, d_, q_m_, t_, **kw):
        terms = quant_vjp.nonlinear_bwd_terms(x_, g_, d_, q_m_, t_, **kw)
        path = ptr_path[d_.data_ptr()]
        masses[path] = [float(v.abs().sum(dtype=torch.float64))
                        for v in terms[1:]]
        sites.append((path, (x_, g_, d_, q_m_, t_), kw))
        return plain(x_, g_, d_, q_m_, t_, **kw)

    before = _build.LAUNCHES["quant_bwd"]
    loss_f, _, grads_f = loop.loss_and_grads(params, x, y)
    sync()
    k7_launches = _build.LAUNCHES["quant_bwd"] - before
    quant_vjp.lsfq_nonlinear_bwd_plain = recording
    try:
        loss_p, _, grads_p = loop_plain.loss_and_grads(params, x, y)
        sync()
    finally:
        quant_vjp.lsfq_nonlinear_bwd_plain = plain
    gf, gp = flatten_tree(grads_f), flatten_tree(grads_p)
    exact = scalar_exact = 0
    differ, worst = [], 0.0
    for k in gf:
        layer, _, leaf = k.rpartition("/")
        if leaf.startswith(("d_quant", "q_m", "t_quant")):
            suffix = leaf.rsplit("_", 1)[-1]
            which = ("d_quant", "q_m", "t_quant").index(
                leaf[:-len(suffix) - 1])
            mass = masses[f"{layer}/d_quant_{suffix}"][which]
            err = float((gf[k] - gp[k]).abs().max())
            scalar_exact += err == 0.0
            worst = max(worst, err / mass if mass else err)
            if err > 1e-5 * mass:
                differ.append(k)
        elif torch.equal(gf[k], gp[k]):
            exact += 1
        else:
            differ.append(k)
    n_scalar = sum(1 for k in gf if k.rsplit("/", 1)[-1].startswith(
        ("d_quant", "q_m", "t_quant")))
    res = {"loss_equal": bool(torch.equal(loss_f, loss_p)),
           "loss": float(loss_f), "grads_bit_identical": exact,
           "grads_other": len(gf) - n_scalar,
           "quant_scalar_grads": n_scalar,
           "quant_scalar_grads_exact": scalar_exact,
           "quant_scalar_max_err_over_l1": worst,
           "k7_launches": k7_launches, "failing": differ[:10]}
    res["ok"] = (res["loss_equal"] and not differ
                 and len(masses) == n_scalar // 3)
    log(f"[train] plain chain vs K7 step: {res}")
    return res, sites


def time_k7_sites(record, peaks, sites):
    """K7 and its plain version on the inputs of every quantizer site of
    one training step (``compare_plain_step``'s capture), grouped by
    shape: per launch, the median over the group's sites of CUDA events
    around one call, and the kernels' device time from one torch.profiler
    trace of the whole group; with the bound; and each summed over the
    step's launches."""
    from quantized_vit_tpu_torch.ops.quant_vjp import (
        lsfq_nonlinear_bwd_fused, lsfq_nonlinear_bwd_plain)

    bw = peaks[2]
    f32_peak = next((v for k, v in F32_PEAKS.items()
                     if k in record["device"]), F32_PEAKS["SXM"])
    groups = {}
    for site in sites:
        groups.setdefault(tuple(site[1][0].shape), []).append(site)
    by_shape = {}
    for shape, ss in groups.items():
        n = int(np.prod(shape))
        # 12 bytes per element (x, g read; grad_x written); 25 f32
        # operations per element (the TPU kernel's cost estimate)
        t_mem, t_ops = 12 * n / bw, 25 * n / f32_peak

        def each(fn):
            return lambda: [fn(*a, **kw) for _, a, kw in ss]

        k7 = each(lsfq_nonlinear_bwd_fused)
        pl = each(lsfq_nonlinear_bwd_plain)
        dev_k7 = kernel_device_us(k7, reps=5)
        dev_pl = kernel_device_us(pl, reps=2)
        by_shape[shape] = {
            "sites": [p.rsplit("/", 1)[0] + "/" + p.rsplit("_", 1)[-1]
                      for p, _, _ in ss],
            "us": statistics.median(
                cuda_ms(lambda: lsfq_nonlinear_bwd_fused(*a, **kw)) * 1e3
                for _, a, kw in ss),
            # the kernels' own time on the card, without the host work
            # between launches that the events above enclose
            "device_us": None if dev_k7 is None else dev_k7 / len(ss),
            "plain_us": statistics.median(
                cuda_ms(lambda: lsfq_nonlinear_bwd_plain(*a, **kw),
                        iters=5, warmup=1) * 1e3 for _, a, kw in ss),
            "plain_device_us": None if dev_pl is None else dev_pl / len(ss),
            "bound_us": max(t_mem, t_ops) * 1e6,
            "bound_by": "bytes" if t_mem >= t_ops else "operations"}
    per_step = {}  # ms over the step's launches; None off the card
    for k in ("us", "device_us", "plain_us", "plain_device_us", "bound_us"):
        vals = [v[k] and v[k] * len(v["sites"]) for v in by_shape.values()]
        per_step[k] = None if None in vals else sum(vals) / 1e3
    for shape, v in by_shape.items():
        log(f"[time] quant_bwd {'x'.join(map(str, shape)):16s} "
            f"{v['us']:8.1f} us (device {v['device_us']})  plain "
            f"{v['plain_us']:8.1f} (device {v['plain_device_us']})  bound "
            f"{v['bound_us']:6.1f} ({v['bound_by']})  {len(v['sites'])} "
            f"sites")
    log(f"[time] quant_bwd on one step's {len(sites)} sites (ms): {per_step}")
    return by_shape, per_step


def train_timing(dev, record, peaks, cfg, loop, loop_plain, opt, params, x,
                 y, steps, sites):
    """K7 per launch at each quantizer site of a training step, on that
    step's inputs, against its bound and its plain version; the whole
    training step with K7 and with the plain chain (in turns: plain, K7,
    K7, plain); a plain PyTorch ViT-B/16 training step (f32 and bf16
    autocast, torch.optim.Adam) as the yardstick."""
    by_shape, per_step = time_k7_sites(record, peaks, sites)
    sites.clear()  # the captured activations and cotangents

    def step_times(lp):
        """ms of forward + backward, clip_grads, GETA.step (host share
        and to the end of its device work), one step."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if dev.type == "cuda" else None
        sync()
        h0 = time.perf_counter()
        if ev:
            ev[0].record()
        _, _, grads = lp.loss_and_grads(params, x, y)
        if ev:
            ev[1].record()
        grads = opt.clip_grads(grads)
        sync()
        h1 = time.perf_counter()
        opt.step(params, grads)  # a fix-phase step; the result is dropped
        h2 = time.perf_counter()
        if ev:
            ev[2].record()
        sync()
        h3 = time.perf_counter()
        fb = ev[0].elapsed_time(ev[1]) if ev else (h1 - h0) * 1e3
        return {"fwd_bwd_ms": fb, "to_geta_ms": (h1 - h0) * 1e3,
                "geta_host_ms": (h2 - h1) * 1e3,
                "geta_ms": (h3 - h1) * 1e3, "step_ms": (h3 - h0) * 1e3}

    reps = 3 if dev.type == "cuda" else 1
    runs = {"plain": [], "k7": []}
    step_times(loop)  # warm-up
    step_times(loop_plain)
    for which in ("plain", "k7", "k7", "plain"):
        lp = loop if which == "k7" else loop_plain
        runs[which] += [step_times(lp) for _ in range(reps)]
    step = {w: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
            for w, rs in runs.items()}
    prof = {w: profile_step(lambda: step_times(lp))
            for w, lp in (("k7", loop), ("plain", loop_plain))}
    for w, pr in prof.items():
        if pr is not None:  # against the step without the profiler
            pr["idle_share_of_step"] = max(
                0.0, 1.0 - pr["kernel_ms"] / step[w]["step_ms"])
    yard = {"f32_ms": cuda_ms(torch_vit_train_step(cfg, x, y, False),
                              iters=5, warmup=2),
            "bf16_autocast_ms": cuda_ms(torch_vit_train_step(cfg, x, y, True),
                                        iters=5, warmup=2)}
    record["train_timing"] = {"k7_by_shape": {
        "x".join(map(str, s)): v for s, v in by_shape.items()},
        "k7_per_step_ms": per_step, "step": step, "runs": runs,
        "step_profile": prof,
        "torch_vit_train_step": yard, "batch": BATCH}
    log(f"[time] train step b{BATCH}: K7 {step['k7']} ; plain chain "
        f"{step['plain']} ; plain PyTorch ViT step f32 "
        f"{yard['f32_ms']:.1f} ms, bf16 autocast "
        f"{yard['bf16_autocast_ms']:.1f} ms")
    for w, pr in prof.items():
        if pr is not None:
            log(f"[time] {w} step profile: wall {pr['wall_ms']:.1f} ms, "
                f"kernels {pr['kernel_ms']:.1f} ms ({pr['kernels']} "
                f"launches), idle {pr['idle_share']:.3f} (of the "
                f"unprofiled step {pr['idle_share_of_step']:.3f}); top "
                f"{[(n[:40], round(ms, 2), c) for n, ms, c in pr['top']]}")

    errs = [r for r in record["parity"]
            if r["kernel"] == "quant_bwd" and "small" not in r["case"]]
    train = record["train"]
    trace = train["k7_trace"]
    per_run = sorted({r["k7_launches"] for r in train["per_step"]})
    plain_step = (per_step["plain_device_us"] if per_step["plain_device_us"]
                  is not None else per_step["plain_us"])
    by = lambda key: {"x".join(map(str, s)): v[key]  # noqa: E731
                      for s, v in by_shape.items()}
    record["kernels"].append({
        "name": "quant_bwd", "route": "cuda",
        "source": "quantized_vit_tpu_torch/csrc/quant_bwd.cu",
        "replaces": "quantized_vit_tpu/ops/quant_vjp.py:172",
        # counted over the training run (TRAIN_STEPS steps)
        "launches": train["launches"]["quant_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in errs),
        "share_differ": max(r["share_differ"] for r in errs),
        "bit_exact": all(r["bit_exact"] for r in errs),
        # K7's device time over those launches, from the run's CUDA trace
        # (off the card: one step's sites timed with events, times steps)
        "ms": trace["device_ms"] if trace else per_step["us"] * steps,
        "ms_from": ("trace of the training run" if trace
                    else "one step's sites x steps"),
        # the run launched no plain chain: the plain version's device time
        # on one training step's site inputs, times the run's steps
        "plain_ms": plain_step * steps,
        "plain_ms_from": "one step's sites x steps",
        # every step quantizes the same sites (the launch check holds it)
        "bound_ms": per_step["bound_us"] * steps, "bound_by": "bytes",
        "library_ms": None,
        "launches_per_step": per_run[0] if len(per_run) == 1 else per_run,
        "ms_per_step": {
            "trace": trace["device_ms"] / steps if trace else None,
            "sites_device": per_step["device_us"],
            "sites_events": per_step["us"],
            "profiled_step": (prof["k7"] or {}).get("quant_bwd_ms")},
        "device_us_per_launch": by("device_us"),
        "us_per_launch": by("us"), "plain_us_per_launch": by("plain_us"),
        "bound_us_per_launch": by("bound_us"),
    })


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def traced(fn):
    """``fn()`` under torch.profiler's CUDA trace: (its result, the
    trace's kernel events); no trace (None) off the card."""
    if DEV != "cuda":
        return fn(), None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    return out, _kernel_events(prof)


def k7_in_trace(kern):
    """K7's launches (its main kernel's count) and device ms (both of its
    kernels) in a trace's kernel events; None without them."""
    k7 = [e for e in kern or () if "quant_bwd" in e.name]
    if not k7:
        return None
    return {"launches": sum("quant_bwd_kernel" in e.name for e in k7),
            "device_ms": sum(e.device_time_total for e in k7) / 1e3,
            "kernels_in_trace": len(kern)}


def host_split(fn, us, reps: int = 50):
    """Where the ``us`` of one timed call of ``fn`` go: ``host_us``, the
    host's time to issue one call (``reps`` calls back to back on the host
    clock, with no wait for the card), ``device_us``, its kernels' device
    time (:func:`kernel_device_us`), and ``card_share``, device_us / us
    (the rest of ``us`` is the card waiting for the host)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e6 / reps
    sync()
    dev = kernel_device_us(fn)
    return {"host_us": host, "device_us": dev,
            "card_share": None if dev is None else dev / us}


def kernel_device_us(fn, reps: int = 20):
    """The summed device time of every kernel ``fn`` launches, per call,
    from torch.profiler's CUDA trace; None off the card or when the trace
    holds no device time."""
    if DEV != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):  # a trace now and then comes back empty: retry
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        tot = sum(e.device_time_total for e in _kernel_events(prof))
        if tot > 0:
            return tot / reps
    return None


def profile_step(fn):
    """One call of ``fn`` (a whole training step) under torch.profiler:
    wall ms, the summed time of its kernels, their count, the card's idle
    share of the wall time, K7's device ms and the ten kernels that took
    the most time; None off the card or when the trace holds no device
    time."""
    if DEV != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kern = _kernel_events(prof)
    if not kern:
        return None
    by_name = {}
    for e in kern:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    k7 = k7_in_trace(kern)
    return {"wall_ms": wall, "kernel_ms": busy, "kernels": len(kern),
            "idle_share": max(0.0, 1.0 - busy / wall),
            "quant_bwd_ms": k7["device_ms"] if k7 else 0.0,
            "top": [(n, ms, c) for n, (ms, c) in top]}


def torch_vit_train_step(cfg, x, y, bf16: bool):
    """One training step of a plain unquantized PyTorch ViT of the same
    architecture (nn.Linear / LayerNorm / scaled_dot_product_attention,
    torch.optim.Adam), f32 or under bf16 autocast: a yardstick, never
    called by the port."""
    import torch.nn.functional as F
    from torch import nn

    d, heads = cfg.embed_dim, cfg.num_heads
    hid = int(d * cfg.mlp_ratio)
    torch.manual_seed(1)

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.n1, self.n2 = nn.LayerNorm(d, 1e-6), nn.LayerNorm(d, 1e-6)
            self.qkv, self.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)
            self.fc1, self.fc2 = nn.Linear(d, hid), nn.Linear(hid, d)

        def forward(self, t):
            b, n, _ = t.shape
            qkv = self.qkv(self.n1(t)).reshape(
                b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            t = t + self.proj(o.transpose(1, 2).reshape(b, n, d))
            return t + self.fc2(F.gelu(self.fc1(self.n2(t))))

    class ViT(nn.Module):
        def __init__(self):
            super().__init__()
            p = cfg.patch_size
            self.pe = nn.Conv2d(cfg.in_channels, d, p, p)
            self.cls = nn.Parameter(torch.zeros(1, 1, d))
            self.pos = nn.Parameter(torch.randn(1, cfg.num_tokens, d) * .02)
            self.blocks = nn.ModuleList(Block() for _ in range(cfg.depth))
            self.norm = nn.LayerNorm(d, 1e-6)
            self.head = nn.Linear(d, cfg.num_classes)

        def forward(self, img):
            t = self.pe(img.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
            t = torch.cat([self.cls.expand(t.shape[0], 1, d), t], 1)
            t = t + self.pos
            for blk in self.blocks:
                t = blk(t)
            return self.head(self.norm(t)[:, 0])

    net = ViT().to(x.device)
    adam = torch.optim.Adam(net.parameters(), lr=1e-4)
    dt = torch.bfloat16 if bf16 else torch.float32

    def step():
        adam.zero_grad(set_to_none=True)
        with torch.autocast(x.device.type, dtype=dt, enabled=bf16):
            loss = F.cross_entropy(net(x), y.long())
        loss.backward()
        adam.step()

    return step


def bf16_vit_forward(cfg, x):
    """Plain bf16 PyTorch ViT-B/16 forward of the same architecture on the
    same patchified input (the yardstick bench.py uses on its chip); random
    weights. Never called by the port."""
    import torch.nn.functional as F

    g = torch.Generator(device=DEV).manual_seed(1)
    d, hid, heads = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio), \
        cfg.num_heads
    bf16 = torch.bfloat16

    def w(*shape):
        return (torch.randn(shape, generator=g, device=DEV) * 0.02).to(
            bf16)

    kp = cfg.patch_size**2 * cfg.in_channels
    pe_w, pe_b = w(d, kp), w(d)
    cls, pos = w(1, 1, d), w(1, cfg.num_tokens, d)
    blocks = [dict(g1=w(d) + 1, b1=w(d), wqkv=w(3 * d, d), bqkv=w(3 * d),
                   wp=w(d, d), bp=w(d), g2=w(d) + 1, b2=w(d), w1=w(hid, d),
                   bb1=w(hid), w2=w(d, hid), bb2=w(d))
              for _ in range(cfg.depth)]
    gn, bn, wh, bh = w(d) + 1, w(d), w(cfg.num_classes, d), w(
        cfg.num_classes)
    xb = x.to(bf16)
    b = xb.shape[0]

    def fwd():
        t = F.linear(xb, pe_w, pe_b)
        t = torch.cat([cls.expand(b, 1, d), t], dim=1) + pos
        n = t.shape[1]
        for p in blocks:
            h = F.layer_norm(t, (d,), p["g1"], p["b1"], 1e-6)
            qkv = F.linear(h, p["wqkv"], p["bqkv"]).reshape(
                b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            t = t + F.linear(o.transpose(1, 2).reshape(b, n, d), p["wp"],
                             p["bp"])
            h = F.layer_norm(t, (d,), p["g2"], p["b2"], 1e-6)
            t = t + F.linear(F.gelu(F.linear(h, p["w1"], p["bb1"])),
                             p["w2"], p["bb2"])
        h = F.layer_norm(t[:, 0], (d,), gn, bn, 1e-6)
        return F.linear(h, wh, bh)

    return fwd


if __name__ == "__main__":
    sys.exit(main())
