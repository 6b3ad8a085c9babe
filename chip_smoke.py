#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the ViT-B/16 W4A4 serving path on one GPU.

Run from the repository root (no arguments; one CUDA card):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel from ``quantized_vit_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel);
2. hold each kernel (K1 ``fused_quant_matmul``, K2 ``fused_mlp``, K3
   ``attention_block``, K4 ``patch_finalize``) against its plain PyTorch
   version on the card, at the main path's ViT-B shapes and at small ragged
   shapes, for packed int4 and int8 weights and for the linear (t = 1) and
   pow (t != 1) quantizers, under the parity contract: int8 levels within 1
   level at <= 0.5% of positions, the MLP block's output within 1e-5, the
   attention branch within 0.1 everywhere and differing at <= 1% of
   positions, the rest exact;
3. one batch-32 bf16 forward of ViT-B/16 (random artifact from seed 0,
   host-patchified input) through the kernels, with the launch counters set
   to 0 just before and read just after; logits against the plain path;
4. the serving CLI (``quantized_vit_tpu_torch.cli.serve``) on that artifact
   saved by the port's writer: 64 requests at max batch 8, every answer
   equal to a direct forward of the same image;
5. timings with CUDA events (warm-up, then the median of 20 runs): each
   kernel at its main-path shapes, its plain version, ``torch._int_mm`` on
   its GEMM shapes (a yardstick the port never calls), the forward, and a
   plain bf16 PyTorch ViT-B/16 forward of the same architecture.

It prints ``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` reports them, then ``{"ok": true, "device": {...}}`` as the
last line, and writes the full record to ``build/chip_smoke.json``.
"""

from __future__ import annotations

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
                          "ok": ok})
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
           stream=torch.bfloat16):
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
                  out_dtype=stream)
        self.check("attention_block", case + ":levels", "levels",
                   attention_heads(x, wq, qs, qb, fmt=fmt, **kw),
                   attention_heads_plain(x, wq, qs, qb, fmt=fmt, **kw))
        got = attention_block(x, wq, qs, qb, wp, ps, pb, fmt=fmt,
                              fmt_proj=fmt_proj, **kw)
        want = attention_block_plain(x, wq, qs, qb, wp, ps, pb, fmt=fmt,
                                     fmt_proj=fmt_proj, **kw)
        return self.check("attention_block", case, "attention", got, want)

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
        sync()
        n_ok = sum(r["ok"] for r in self.rows)
        log(f"[parity] {n_ok}/{len(self.rows)} cases pass "
            f"({time.time() - t0:.1f} s)")
        for r in self.rows:
            if not r["ok"] or "small" not in r["case"]:
                log(f"  {'ok ' if r['ok'] else 'BAD'} {r['kernel']:18s} "
                    f"{r['case']:44s} max {r['max_abs_err']:.3g} "
                    f"share {r['share_differ']:.2e}")


# ---------------------------------------------------------------------------
# phase 3: the main path, one batch-32 forward
# ---------------------------------------------------------------------------

def expected_launches(depth):
    """Launches of one forward: K1 for the patch embed, each block's proj
    and the head; K2 and K3 once per block; K4 once."""
    return {"fused_quant_matmul": 2 + depth, "fused_mlp": depth,
            "attention_block": depth, "patch_finalize": 1}

# Logit tolerance vs the plain path: every kernel repeats its plain
# version's f32 arithmetic (sums in f64), so the logits should agree to the
# last bit; a rare level flip at a rounding tie in an early block moves a
# logit by about scale*top*|w| ~ 1e-3*7*7 ~ 0.05 at most.
LOGIT_TOL = 0.05


def forward_phase(dev, record):
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import (prepare_kernels,
                                               random_vit_int4_artifact,
                                               vit_int4_forward)
    from quantized_vit_tpu_torch.utils import patchify_batch

    cfg = main_cfg()
    rng = np.random.default_rng(0)
    images = rng.standard_normal(
        (BATCH, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
    out = {"cfg": cfg, "x": x}
    for pack in (False, True):
        art = random_vit_int4_artifact(cfg, seed=0, pack_weights=pack,
                                       device=dev)
        kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
        # the weights' kernel layout and folded constants, once per
        # artifact (as the serve CLI does at load); no kernel launches
        t0 = time.perf_counter()
        plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
        sync()
        plan_ms = (time.perf_counter() - t0) * 1e3
        _build.reset_launches()
        logits = vit_int4_forward(art, x, cfg, plan=plan, **kw)
        sync()
        launches = dict(_build.LAUNCHES)
        plain = vit_int4_forward(art, x, cfg, use_kernels=False, **kw)
        sync()
        d = (logits - plain).abs()
        tag = "int4-packed" if pack else "int8-stored"
        rec = {"weights": tag, "launches": launches,
               "prepare_kernels_host_ms": plan_ms,
               "logits_shape": list(logits.shape),
               "max_abs_diff": float(d.max()),
               "share_differ": float((d > 0).float().mean()),
               "argmax_agree": float((logits.argmax(1) == plain.argmax(1))
                                     .float().mean()),
               "logit_absmax": float(plain.abs().max())}
        record.setdefault("forward", []).append(rec)
        log(f"[forward b{BATCH} bf16 {tag}] launches {launches} "
            f"max|dlogit| {rec['max_abs_diff']:.3g} share "
            f"{rec['share_differ']:.3g} |logit|max {rec['logit_absmax']:.3g}")
        want = expected_launches(cfg.depth)
        if launches != want and dev.type == "cuda":
            raise Failed(f"forward launches {launches} != {want}")
        if (tuple(logits.shape) != (BATCH, cfg.num_classes)
                or not torch.isfinite(logits).all()):
            raise Failed(f"forward logits {tuple(logits.shape)} not finite "
                         "or wrong shape")
        if rec["max_abs_diff"] > LOGIT_TOL:
            raise Failed(f"forward logits differ from the plain path by "
                         f"{rec['max_abs_diff']} > {LOGIT_TOL}")
        if not pack:
            out.update(art=art, plan=plan, launches=launches)
    return out


# ---------------------------------------------------------------------------
# phase 4: the serving CLI
# ---------------------------------------------------------------------------


def serve_phase(dev, record, fwd):
    from quantized_vit_tpu_torch.artifact import (load_vit_int4_artifact,
                                                  save_vit_int4_artifact)
    from quantized_vit_tpu_torch.cli import serve
    from quantized_vit_tpu_torch.serve import vit_int4_forward
    from quantized_vit_tpu_torch.utils import patchify_batch

    art_dir = ART_DIR
    save_vit_int4_artifact(art_dir, fwd["art"], fwd["cfg"])
    t0 = time.time()
    res = serve.main(["--artifact", art_dir, "--requests", "64",
                      "--max-batch", "8", "--device", str(dev)])
    art, cfg = load_vit_int4_artifact(art_dir, device=dev)
    direct = []
    for i in range(0, len(res["images"]), 8):
        xb = torch.from_numpy(patchify_batch(res["images"][i:i + 8],
                                             cfg.patch_size)).to(dev)
        direct.append(vit_int4_forward(art, xb, cfg,
                                       float_dtype=serve.SERVE_DTYPE,
                                       images_layout="patches").cpu())
    direct = torch.cat(direct).numpy()
    equal = bool(np.array_equal(res["answers"], direct))
    summary = {k: v for k, v in res.items() if k not in ("images", "answers")}
    summary["answers_equal_direct"] = equal
    summary["max_abs_diff"] = float(np.abs(res["answers"] - direct).max())
    summary["phase_s"] = round(time.time() - t0, 1)
    record["serve"] = summary
    log(f"[serve] {summary}")
    if not equal or summary["batches"] < 64 // 8:
        raise Failed(f"serve answers differ from direct forwards: {summary}")


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters=ITERS, warmup=3):
    """Median ms of ``iters`` timed runs (CUDA events), after warm-up."""
    for _ in range(warmup):
        fn()
    if DEV != "cuda":  # CPU rehearsal: host clock, never a device number
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
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
                                             fused_mlp, fused_mlp_plain,
                                             fused_quant_matmul,
                                             fused_quant_matmul_plain,
                                             patch_finalize,
                                             patch_finalize_plain,
                                             run_attention_heads, run_matmul,
                                             run_mlp)
    from quantized_vit_tpu_torch.serve import vit_int4_forward

    int8_peak, bf16_peak, bw = peaks
    cfg, art, x = fwd["cfg"], fwd["art"], fwd["x"]
    b, p, d, n_real, n_pad, kp, hid, ncls, heads = shapes(cfg)
    hd = d // heads
    m = b * n_pad
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
    }
    plan = fwd["plan"]
    if plan is not None:
        attn_p, mlp_p = plan.blocks[0]
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
        }
    kern["embed"] = lambda: patch_finalize(acc, pos, cls, one, n_pad=n_pad,
                                           out_dtype=bf16)

    w1b = 1 if pe.fmt == "int8" else 0.5
    sites = [
        # kernel, site, launches/forward, bound, GEMMs
        ("fused_quant_matmul", "patch_embed", 1,
         bound(b * p * kp * 4 + kp * d * w1b + b * p * d * 4,
               2 * b * p * kp * d), [(b * p, kp, d)]),
        ("fused_quant_matmul", "attn_proj", cfg.depth,
         bound(m * d + d * d * w1b + 2 * m * d * 2, 2 * m * d * d),
         [(m, d, d)]),
        ("fused_quant_matmul", "head", 1,
         bound(b * d * 4 + d * ncls * w1b + b * ncls * 4, 2 * b * d * ncls),
         [(b, d, ncls)]),
        ("fused_mlp", "mlp", cfg.depth,
         bound(2 * m * d * 2 + 2 * d * hid * w1b, 4 * m * d * hid),
         [(m, d, hid), (m, hid, d)]),
        ("attention_block", "heads", cfg.depth,
         bound(m * d * 2 + 3 * d * d * w1b + m * d, 2 * m * d * 3 * d,
               2 * b * heads * n_pad * n_real * hd * 2),
         [(m, d, 3 * d)]),
        ("patch_finalize", "embed", 1,
         bound(b * p * d * 4 + p * d * 4 + d * 4 + m * d * 2), []),
    ]
    per_site = []
    for name, site, nl, (bms, by), gemms in sites:
        ms = cuda_ms(kern[site])
        pms = cuda_ms(plain[site], iters=5, warmup=1)
        ims = int_mm_ms(gemms) if gemms else None
        per_site.append({"kernel": name, "site": site, "launches": nl,
                         "us": ms * 1e3, "plain_us": pms * 1e3,
                         "bound_us": bms * 1e3, "bound_by": by,
                         "int_mm_us": None if ims is None else ims * 1e3})
        log(f"[time] {name:18s} {site:12s} {ms * 1e3:9.1f} us  plain "
            f"{pms * 1e3:9.1f}  bound {bms * 1e3:7.1f} ({by})  _int_mm "
            f"{'n/a' if ims is None else f'{ims * 1e3:.1f}'}")
    record["per_site"] = per_site

    ms_fwd = cuda_ms(lambda: vit_int4_forward(
        art, x, cfg, float_dtype=bf16, images_layout="patches", plan=plan))
    ms_bf16 = cuda_ms(bf16_vit_forward(cfg, x))
    record["forward_timing"] = {
        "batch": b, "ms_per_batch": ms_fwd, "img_per_s": b / ms_fwd * 1e3,
        "bf16_torch_ms_per_batch": ms_bf16,
        "bf16_torch_img_per_s": b / ms_bf16 * 1e3,
        "ratio_vs_bf16": ms_bf16 / ms_fwd,
        "kernel_ms_sum": sum(s["us"] * s["launches"] for s in per_site)
        / 1e3}
    log(f"[time] forward b{b} bf16: {ms_fwd:.3f} ms/batch "
        f"({b / ms_fwd * 1e3:.1f} img/s); plain bf16 torch ViT-B/16 "
        f"{ms_bf16:.3f} ms ({b / ms_bf16 * 1e3:.1f} img/s); ratio "
        f"{ms_bf16 / ms_fwd:.3f}")

    rel = {"fused_quant_matmul": (
               "quantized_vit_tpu_torch/csrc/fused_quant_matmul.cu",
               "quantized_vit_tpu/ops/fused.py:556"),
           "fused_mlp": ("quantized_vit_tpu_torch/csrc/fused_mlp.cu",
                         "quantized_vit_tpu/ops/fused.py:977"),
           "attention_block": (
               "quantized_vit_tpu_torch/csrc/attention_block.cu",
               "quantized_vit_tpu/ops/attention.py:667"),
           "patch_finalize": (
               "quantized_vit_tpu_torch/csrc/patch_finalize.cu",
               "quantized_vit_tpu/ops/patch.py:52")}
    kernels = []
    for name, (src, rep) in rel.items():
        ss = [s for s in per_site if s["kernel"] == name]
        errs = [r for r in record["parity"]
                if r["kernel"] == name and "small" not in r["case"]]
        tot = lambda key: sum(s[key] * s["launches"] for s in ss) / 1e3
        im = [s["int_mm_us"] for s in ss]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": fwd["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in errs),
            "share_differ": max(r["share_differ"] for r in errs),
            # per forward: the kernel's launches at their main-path shapes
            "ms": tot("us"), "plain_ms": tot("plain_us"),
            "bound_ms": tot("bound_us"),
            "bound_by": max(ss, key=lambda s: s["bound_us"] * s["launches"])
            ["bound_by"],
            "library_ms": None,
            "int_mm_ms": (None if any(v is None for v in im) else
                          sum(v * s["launches"] for v, s in zip(im, ss))
                          / 1e3),
            "us_per_launch": {s["site"]: s["us"] for s in ss},
            "bound_us_per_launch": {s["site"]: s["bound_us"] for s in ss},
        })
    record["kernels"] = kernels


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
