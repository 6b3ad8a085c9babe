#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: the ViT-B/16 W4A4 serving
paths and the ViT-B/16 QAT + GETA training path.

Run from the repository root (no arguments; one CUDA card):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel from ``quantized_vit_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel);
2. hold each kernel (K1 ``fused_quant_matmul``, K2 ``fused_mlp``, K3
   ``attention_block``, K4 ``patch_finalize``, K5 ``block_stack``, K6
   ``attention_qkv``) against its plain PyTorch version on the card, at
   the main paths' ViT-B shapes and at small ragged shapes, for packed
   int4 and int8 weights, the linear (t = 1) and pow (t != 1) quantizers,
   both residual dtypes and ``int_attention`` on and off, under the parity
   contract: int8 levels within 1 level at <= 0.5% of positions, the MLP
   block's output within 1e-5, attention outputs (K3's branch, K6's float
   output, K5's residual stream) within 0.1 everywhere and differing at
   <= 1% of positions, the rest exact; each row says whether it is
   bit-exact;
3. the forwards (random artifact from seed 0, host-patchified input, bf16
   residual stream), each with the launch counters set to 0 just before
   and read just after, logits against the plain path: batch 32 (K3 + K2
   route) for both weight storages, the chain at batch 1, 2 and 3 (K1 +
   K6 + K1 + K2), ``int_attention`` on both routes (batch 4 and 2), and
   the batch-1 latency entry (one K5 launch);
4. the serving CLI's forward behind a batcher: single requests and pairs
   (buckets 1 and 2, the chain through K6), then the CLI's own burst of 64
   requests at max batch 8 on the artifact saved by the port's writer;
   every answer equal to a direct forward of the same images;
5. timings with CUDA events (warm-up, then the median of 20 runs, 200
   under 1 ms): each kernel at its main-path shapes, its plain version,
   ``torch._int_mm`` on its GEMM shapes and
   ``scaled_dot_product_attention`` on K6's shapes (yardsticks the port
   never calls), both routes' attention branch at batch 2 and 3, the
   forwards, and a plain bf16 PyTorch ViT-B/16 forward of the same
   architecture at batch 32, 1 and 2;
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
ART_DIR = os.path.join(ROOT, "build", "smoke_artifact")  # serve phase

# H100 data-sheet peaks (dense): int8 TOP/s, bf16 FLOP/s, HBM bytes/s
PEAKS = {
    "SXM": (1979e12, 989e12, 3.35e12),
    "PCIe": (1513e12, 756e12, 2.0e12),
    "NVL": (1671e12, 835e12, 3.9e12),
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
                       "bytes_per_s": peaks[2]}
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
    serve_phase(dev, record, fwd)
    timing_phase(dev, record, fwd, peaks)
    del fwd
    train_phase(dev, record, peaks)


def main_cfg():
    from quantized_vit_tpu_torch.models import ViTConfig

    return ViTConfig(**CFG_KW)  # ViT-B/16 unless a rehearsal shrinks it


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


class Parity:
    """Kernel-vs-plain cases; each row: kernel, case, max diff, share of
    positions that differ, pass."""

    def __init__(self, dev):
        self.dev = dev
        self.rows = []
        self.failures = []

    def check(self, kernel, case, kind, got, want):
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
            ok = mx == 0.0
        if not torch.isfinite(got.float()).all():
            ok = False
        self.rows.append({"kernel": kernel, "case": case, "check": kind,
                          "max_abs_err": mx, "share_differ": frac,
                          "bit_exact": mx == 0.0, "ok": ok})
        if not ok:
            self.failures.append(f"{kernel} {case}: max {mx} share {frac}")
        return mx, frac

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

    def k1(self, case, m, k, n, fmt, pow_, prologue, epilogue, seed):
        from quantized_vit_tpu_torch.ops import (fused_quant_matmul,
                                                 fused_quant_matmul_plain)

        rng = np.random.default_rng(seed)
        f32, bf16 = torch.float32, torch.bfloat16
        if prologue is None:
            x = self.t(rng.integers(-7, 8, (m, k)).astype(np.int8))
        elif prologue == "ln_quant":
            x = self.t(rng.standard_normal((m, k)) * 0.5, bf16)
        else:
            x = self.t(rng.standard_normal((m, k)), f32)
        w = self.weight(rng, k, n, fmt)
        scale = self.t(rng.random(n) * 0.01 + 1e-3, f32)
        bias = self.t(rng.standard_normal(n) * 0.1, f32)
        out_dtype = bf16 if epilogue == "residual" else f32
        kw = dict(fmt=fmt, prologue=prologue, epilogue=epilogue,
                  out_dtype=out_dtype)
        if prologue is not None:
            kw.update(act_d=self.scal(0.05),
                      act_t=self.scal(1.08 if pow_ else 1.0),
                      act_top=127 if prologue == "ln_quant" else 7,
                      act_pow=pow_ and prologue != "gelu_quant")
        if prologue == "ln_quant":
            kw.update(ln_scale=self.t(rng.standard_normal(k) * 0.1 + 1, f32),
                      ln_bias=self.t(rng.standard_normal(k) * 0.01, f32))
        if epilogue == "residual":
            kw["residual"] = self.t(rng.standard_normal((m, n)), bf16)
        if epilogue in ("quant", "gelu_quant"):
            kw.update(out_d=self.scal(0.5), out_t=self.scal(
                0.93 if pow_ else 1.0), out_top=31, out_pow=pow_)
        got = fused_quant_matmul(x, w, scale, bias, **kw)
        want = fused_quant_matmul_plain(x, w, scale, bias, **kw)
        kind = ("levels" if epilogue in ("quant", "gelu_quant") else "exact")
        return self.check("fused_quant_matmul", case, kind, got, want)

    # -- K2 ---------------------------------------------------------------

    def k2(self, case, m, k, hid, fmt, fmt2, pow_, seed,
           stream=torch.bfloat16):
        from quantized_vit_tpu_torch.ops import fused_mlp, fused_mlp_plain

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        x = self.t(rng.standard_normal((m, k)) * 0.5, stream)
        w1 = self.weight(rng, k, hid, fmt)
        w2 = self.weight(rng, hid, k, fmt2)
        s1, b1 = self.scal(1e-3), self.t(rng.standard_normal(hid) * 0.01, f32)
        s2, b2 = self.scal(1e-3), self.t(rng.standard_normal(k) * 0.01, f32)
        kw = dict(ln_scale=self.t(rng.standard_normal(k) * 0.1 + 1, f32),
                  ln_bias=self.t(rng.standard_normal(k) * 0.01, f32),
                  act_d=self.scal(0.05), act_t=self.scal(
                      1.08 if pow_ else 1.0), act_top=127, act_pow=pow_,
                  hid_d=self.scal(0.05), hid_t=self.scal(
                      0.93 if pow_ else 1.0), hid_top=127, hid_pow=pow_,
                  fmt=fmt, fmt2=fmt2, out_dtype=stream)
        got = fused_mlp(x, w1, s1, b1, w2, s2, b2, **kw)
        want = fused_mlp_plain(x, w1, s1, b1, w2, s2, b2, **kw)
        return self.check("fused_mlp", case, "mlp", got, want)

    # -- K3 ---------------------------------------------------------------

    def k3(self, case, b, n, d, heads, n_valid, fmt, fmt_proj, pow_, seed,
           stream=torch.bfloat16, int_attn=False):
        from quantized_vit_tpu_torch.ops import (attention_block,
                                                 attention_block_plain,
                                                 attention_heads,
                                                 attention_heads_plain)

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
        self.check("attention_block", case + ":levels", "levels",
                   attention_heads(x, wq, qs, qb, fmt=fmt, **kw),
                   attention_heads_plain(x, wq, qs, qb, fmt=fmt, **kw))
        got = attention_block(x, wq, qs, qb, wp, ps, pb, fmt=fmt,
                              fmt_proj=fmt_proj, **kw)
        want = attention_block_plain(x, wq, qs, qb, wp, ps, pb, fmt=fmt,
                                     fmt_proj=fmt_proj, **kw)
        return self.check("attention_block", case, "attention", got, want)

    # -- K6 ---------------------------------------------------------------

    def k6(self, case, b, n, heads, hd, n_valid, dtype, quant, int_attn,
           seed):
        """quant: None (float out), "lin" (t = 1) or "pow" (t != 1)."""
        from quantized_vit_tpu_torch.ops import (attention_qkv,
                                                 attention_qkv_plain)

        rng = np.random.default_rng(seed)
        qkv = self.t(rng.standard_normal((b, n, 3 * heads * hd)) * 0.7,
                     dtype)
        kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=n_valid,
                  out_dtype=dtype, int_attention=int_attn)
        if quant:
            kw.update(out_d=self.scal(0.01), out_t=self.scal(
                0.93 if quant == "pow" else 1.0), out_top=31,
                out_pow=quant == "pow")
        got = attention_qkv(qkv, **kw)
        want = attention_qkv_plain(qkv, **kw)
        return self.check("attention_qkv", case,
                          "levels" if quant else "attention", got, want)

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
        # the kernels' byte-wise fallbacks
        for fmt in ("int4", "int8"):
            for pro, epi in ((None, "residual"), ("ln_quant", "gelu_quant"),
                             ("quant", None)):
                seed += 1
                self.k1(f"small[50x40x72,{pro}->{epi}]({fmt})", 50, 40, 72,
                        fmt, False, pro, epi, seed)
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
        self.run_small_batch_kernels(cfg)
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

def expected_launches(depth, route="block"):
    """Launches of one forward. ``block`` (batch >= 4): K1 for the patch
    embed, each block's proj and the head, K2 and K3 once per block, K4
    once. ``chain`` (batch 1-3): K1 also for each block's qkv, K6 in place
    of K3. ``latency``: K1 twice, K4 and K5 once."""
    none = {"fused_quant_matmul": 0, "fused_mlp": 0, "attention_block": 0,
            "patch_finalize": 1, "attention_qkv": 0, "block_stack": 0,
            "quant_bwd": 0}
    if route == "latency":
        return dict(none, fused_quant_matmul=2, block_stack=1)
    if route == "chain":
        return dict(none, fused_quant_matmul=2 + 2 * depth,
                    fused_mlp=depth, attention_qkv=depth)
    return dict(none, fused_quant_matmul=2 + depth, fused_mlp=depth,
                attention_block=depth)


# Logit tolerance vs the plain path: every kernel repeats its plain
# version's f32 arithmetic (sums in f64), so the logits should agree to the
# last bit; a rare level flip at a rounding tie in an early block moves a
# logit by about scale*top*|w| ~ 1e-3*7*7 ~ 0.05 at most.
LOGIT_TOL = 0.05
CHAIN_BATCHES = (1, 2, 3)


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
                expected_launches(cfg.depth, "chain"), b, cfg)
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
    return out


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
                                             run_mlp, vit_block_stack_plain)
    from quantized_vit_tpu_torch.serve import (vit_int4_forward,
                                               vit_int4_forward_latency)
    from quantized_vit_tpu_torch.serve.vit_int4 import _chain_attention

    int8_peak, bf16_peak, bw = peaks
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
    plan = fwd["plan"]
    if plan is not None:
        attn_p, mlp_p = plan.blocks[0]
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
            "stack_b1": lambda: run_block_stack(stack, x1, n_valid=n_real,
                                                out_dtype=bf16),
            "chain_qkv_b2": lambda: run_matmul(plan.chain[0][0], x2,
                                               out_dtype=bf16),
            "mlp_b2": lambda: run_mlp(mlp_p, x2, out_dtype=bf16),
        }
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
            "stack_b1": plain["stack_b1"],
            "chain_qkv_b2": lambda: fused_quant_matmul(
                x2, qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
                prologue="ln_quant", ln_scale=blk["norm1"]["scale"],
                ln_bias=blk["norm1"]["bias"], out_dtype=bf16, **q(qkv_e)),
            "mlp_b2": lambda: fused_mlp(
                x2, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
                fc2_e.bias, **mlp_kw),
        }
    kern["embed"] = lambda: patch_finalize(acc, pos, cls, one, n_pad=n_pad,
                                           out_dtype=bf16)

    def sdpa(bk):
        """scaled_dot_product_attention on K6's q/k/v shapes, bf16 (a
        yardstick: no exp2 clamp, no quantizing epilogue)."""
        import torch.nn.functional as F

        qq = torch.randn((bk, heads, n_pad, hd), generator=g,
                         device=DEV).to(bf16)
        kk = torch.randn((bk, heads, nk, hd), generator=g,
                         device=DEV).to(bf16)
        return lambda: F.scaled_dot_product_attention(qq, kk, kk)

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
        # the chain's K1 qkv and K2 at batch 2 (not on the batch-32
        # forward: 0 launches there), to split the chain's time
        ("fused_quant_matmul", "chain_qkv_b2", 0,
         bound(2 * n_pad * d * 2 + 3 * d * d * w1b + 2 * n_pad * 3 * d * 2,
               2 * 2 * n_pad * d * 3 * d), [(2 * n_pad, d, 3 * d)], None),
        ("fused_mlp", "mlp_b2", 0,
         bound(2 * 2 * n_pad * d * 2 + 2 * d * hid * w1b,
               4 * 2 * n_pad * d * hid),
         [(2 * n_pad, d, hid), (2 * n_pad, hid, d)], None),
        # K5 on the latency forward: one launch, all the depth
        ("block_stack", "stack_b1", 1,
         bound(cfg.depth * w_blk * wpk + 2 * n_pad * d * 2,
               cfg.depth * 2 * n_pad * w_blk, cfg.depth * attn_ops), [],
         None),
    ]
    per_site = []
    for name, site, nl, (bms, by), gemms, lib in sites:
        ms = cuda_ms(kern[site])
        pms = cuda_ms(plain[site], iters=5, warmup=1)
        ims = int_mm_ms(gemms) if gemms else None
        lms = cuda_ms(lib) if lib is not None else None
        per_site.append({"kernel": name, "site": site, "launches": nl,
                         "us": ms * 1e3, "plain_us": pms * 1e3,
                         "bound_us": bms * 1e3, "bound_by": by,
                         "int_mm_us": None if ims is None else ims * 1e3,
                         "library_us": None if lms is None else lms * 1e3})
        log(f"[time] {name:18s} {site:12s} {ms * 1e3:9.1f} us  plain "
            f"{pms * 1e3:9.1f}  bound {bms * 1e3:7.1f} ({by})  _int_mm "
            f"{'n/a' if ims is None else f'{ims * 1e3:.1f}'}  library "
            f"{'n/a' if lms is None else f'{lms * 1e3:.1f}'}")
    record["per_site"] = per_site

    # the attention branch of both routes at batch 2 and 3: K3 (alone and
    # with its K1 proj) against K1 qkv + K6 + K1 proj, on the same plans
    if plan is not None:
        routes = {}
        for bk in (2, 3):
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
                             if s["kernel"] not in ("attention_qkv",
                                                    "block_stack")) / 1e3,
        **small}
    log(f"[time] forward b{b} bf16: {ms_fwd:.3f} ms/batch "
        f"({b / ms_fwd * 1e3:.1f} img/s); plain bf16 torch ViT-B/16 "
        f"{ms_bf16:.3f} ms ({b / ms_bf16 * 1e3:.1f} img/s); ratio "
        f"{ms_bf16 / ms_fwd:.3f}")
    log("[time] small batches (ms): " + ", ".join(
        f"{k[:-3]} {v:.3f}" for k, v in small.items()))

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
               "quantized_vit_tpu/ops/block_stack.py:341", "latency")}
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
            # counted on the forward that runs the kernel: the batch-32
            # forward, the chain forward at batch 2, the latency forward
            "launches": fwd["launches"][path][name],
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
