"""K1, K6, K3, K2 and the forwards that run them, timed on the card
through the package's public entry points only, so that one script times
any version of the package (run it from the root of a checkout):

    python3 -m quantized_vit_tpu_torch.tools.chain_timing

Prints one JSON object: the card (``nvidia-smi``'s name and power limit);
K6 (``run_attention_qkv`` on a prepared plan, random bf16 qkv at the
padded token counts, the proj quantizer's levels) at ViT-B/16 batch 2 and
32 and ViT-H/14 batch 1 and 2, and K3 (``run_attention_heads`` on a
prepared plan, random bf16 x and int8 weights) at ViT-B/16 and ViT-H/14
batch 32, and K2 (``run_mlp`` on a prepared plan, random bf16 x and
weights) at ViT-B/16 batch 32, 2 and 1 with int8 levels and at ViT-H/14
batch 1 and 2 with packed int4 (None where the version refuses the
width), K8 (``run_mlp_chunked`` on a prepared plan, random x and int8
weights) beside K2 on the same weights at its sites: ViT-H/14 batch 1
and 2, ViT-B/16's chain at batch 3, the 384-px ViT-B/16 chain at batch 1
(f32 x), ViT-B/16's batch-32 rows and K = 1536 at 272 and 544 rows (None
where the version refuses the width), and K1 (``run_matmul`` on a prepared plan, random x and int8
weights) at every site of the forwards (ViT-B/16's patch embed, proj and
head at batch 32, its head at batch 1, its chain qkv and proj at batch
1-3; ViT-H/14's patch embed at batch 32, its chain qkv and proj at
batch 1 and 2, fc1 and fc2 at batch 32), each as the median of
CUDA-event readings, the host's time to launch one call and its kernels'
device time from torch.profiler; and the forward (``vit_int4_forward``
on a prepared plan, int8-stored levels from seed 0, bf16 residual
stream) of ViT-B/16 and ViT-H/14 at batch 1, 2 and 3 (the chain; K8's
MLP at ViT-B batch 3 and ViT-H batch 1 and 2) and 32 (the K3 route),
CUDA-event medians in ms; and the batch-1 latency entry of ViT-B/16 at
224 and 384 px (packed int4 from seed 0, bf16): K5 (``run_block_stack``
on the prepared stack, random bf16 x at the padded tokens) as K6 above,
and ``vit_int4_forward_latency`` in ms (None where the version refuses
the geometry); K10-K12 (``run_int_matmul`` on a prepared plan,
``plan_int_matmul``) at ViT-B/16's four layer shapes at M = 1664
(tools/profile_kernels.py's: qkv, proj, fc1, fc2; random levels in [-7,
7], a bf16 x at 0.1): ``int4_matmul`` and ``int8_matmul`` with f32 out,
``quant_matmul_fa`` on the packed weight with bf16 x and out (d 0.05,
t 1, top 7), each beside two yardsticks on the same operands,
``torch._int_mm`` (the GEMM alone) and K1 with its quant prologue
(``run_matmul``, prologue ``quant``); and K4 (``patch_finalize``) at
ViT-B/16 batch 32 (random f32 accumulators, bf16 out).

    python3 -m quantized_vit_tpu_torch.tools.chain_timing [group ...]

With group names (``k1``, ``k6``, ``k3``, ``k2``, ``k8``, ``forward``,
``latency``, ``int_mm``, ``k4``) it times only those.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..models import ViTConfig
from ..ops import (patch_finalize, plan_attention_heads,
                   plan_attention_qkv, plan_int_matmul, plan_matmul,
                   plan_mlp, plan_mlp_chunked, run_attention_heads,
                   run_attention_qkv, run_block_stack, run_int_matmul,
                   run_matmul, run_mlp, run_mlp_chunked)
from ..quant import pack_int4
from ..serve import (prepare_kernels, prepare_latency_artifact,
                     random_vit_int4_artifact, vit_int4_forward,
                     vit_int4_forward_latency)

# (images, padded tokens, heads, head_dim, real tokens)
K6_SITES = {"vitb_b2": (2, 208, 12, 64, 197), "vitb_b32": (32, 208, 12, 64,
                                                            197),
            "vith_b1": (1, 272, 16, 80, 257), "vith_b2": (2, 272, 16, 80,
                                                          257)}
# (images, padded tokens, heads, head_dim, real tokens)
K3_SITES = {"vitb_b32": (32, 208, 12, 64, 197),
            "vith_b32": (32, 272, 16, 80, 257)}
# (rows, K, H, weight format)
K2_SITES = {"vitb_b32": (6656, 768, 3072, "int8"),
            "vitb_b2": (416, 768, 3072, "int8"),
            "vitb_b1": (208, 768, 3072, "int8"),
            "vith_b1_int4": (272, 1280, 5120, "int4"),
            "vith_b2_int4": (544, 1280, 5120, "int4")}
# K8's sites (and K2's on the same weights): (rows, K, H, x dtype)
K8_SITES = {"vith_b1": (272, 1280, 5120, torch.bfloat16),
            "vith_b2": (544, 1280, 5120, torch.bfloat16),
            "vitb_chain_b3": (624, 768, 3072, torch.bfloat16),
            "vitb384_chain_b1_f32": (592, 768, 3072, torch.float32),
            "vitb_b32": (6656, 768, 3072, torch.bfloat16),
            "wide_b1": (272, 1536, 6144, torch.bfloat16),
            "wide_b2": (544, 1536, 6144, torch.bfloat16)}
# (rows, K, N, prologue, epilogue, x dtype)
_B, _H = (208, 768), (272, 1280)
K1_SITES = {
    "vitb_patch_embed_b32": (6272, 768, 768, "quant", None, torch.float32),
    "vitb_proj_b32": (6656, 768, 768, None, "residual", torch.int8),
    "vitb_head_b32": (32, 768, 1000, "quant", None, torch.float32),
    "vitb_head_b1": (1, 768, 1000, "quant", None, torch.float32),
    **{f"vitb_chain_qkv_b{b}": (b * _B[0], _B[1], 3 * _B[1], "ln_quant",
                                None, torch.bfloat16) for b in (1, 2, 3)},
    **{f"vitb_chain_proj_b{b}": (b * _B[0], _B[1], _B[1], None, "residual",
                                 torch.int8) for b in (1, 2, 3)},
    "vith_patch_embed_b32": (8192, 588, 1280, "quant", None, torch.float32),
    **{f"vith_chain_qkv_b{b}": (b * _H[0], _H[1], 3 * _H[1], "ln_quant",
                                None, torch.bfloat16) for b in (1, 2)},
    **{f"vith_chain_proj_b{b}": (b * _H[0], _H[1], _H[1], None, "residual",
                                 torch.int8) for b in (1, 2)},
    "vith_fc1_b32": (32 * _H[0], _H[1], 4 * _H[1], "ln_quant",
                     "gelu_quant", torch.bfloat16),
    "vith_fc2_b32": (32 * _H[0], 4 * _H[1], _H[1], None, "residual",
                     torch.int8)}
# K10-K12's sites: ViT-B/16's layers at M = 8 images x 208 tokens (rows, K,
# N)
INT_MM_SITES = {"qkv": (1664, 768, 2304), "proj": (1664, 768, 768),
                "fc1": (1664, 768, 3072), "fc2": (1664, 3072, 768)}
# K4's: (images, patches, D, padded tokens)
K4_SITES = {"vitb_b32": (32, 196, 768, 208)}
GROUPS = ("k1", "k6", "k3", "k2", "k8", "forward", "latency", "int_mm",
          "k4")
MODELS = {"vitb": {}, "vith": dict(patch_size=14, embed_dim=1280, depth=32,
                                   num_heads=16, num_classes=1000)}
# the latency entry's configurations (ViT-B/16 at 224 and 384 px)
LATENCY = {"vitb": {}, "vitb384": dict(img_size=384)}
BATCHES = (1, 2, 3, 32)


def events_us(fn, iters=200, warmup=5):
    """Median of ``iters`` CUDA-event readings of one call, in us."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1e3


def host_us(fn, reps=50):
    """The host's time to issue one call (back to back, no waiting)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def device_us(fn, reps=20):
    """The device time of the kernels of one call (torch.profiler's CUDA
    trace); None if the trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = sum(e.device_time_total for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA)
    return tot / reps if tot > 0 else None


def timed(fn):
    """Events, the host's time a call and the device time of ``fn``."""
    return {"events": events_us(fn), "host": host_us(fn),
            "device": device_us(fn)}


def int_mm_sites(g, one):
    """K10-K12 at :data:`INT_MM_SITES`, each front end beside ``_int_mm``
    and K1's quant prologue on the same operands."""
    out = {}
    bf16 = torch.bfloat16
    fa = dict(act_d=0.05 * one, act_t=one, act_top=7, act_pow=False)
    for site, (m, k, n) in INT_MM_SITES.items():
        xl = torch.randint(-7, 8, (m, k), dtype=torch.int8, device="cuda",
                           generator=g)
        xf = (torch.randn((m, k), generator=g, device="cuda") * 0.1).to(
            bf16)
        w8 = torch.randint(-7, 8, (k, n), dtype=torch.int8, device="cuda",
                           generator=g)
        w4 = pack_int4(w8, axis=0)
        sc = 1e-3 * one
        bias = torch.randn((n,), generator=g, device="cuda") * 0.01
        p4 = plan_int_matmul(w4, sc, bias, fmt="int4")
        p8 = plan_int_matmul(w8, sc, bias, fmt="int8")
        pfa = plan_int_matmul(w4, sc, bias, fmt="int4", **fa)
        p1 = plan_matmul(w4, sc, bias, fmt="int4", prologue="quant", **fa)
        w8t = w8.t().contiguous().t()
        out[site] = {
            "int4_matmul": timed(lambda p=p4, x=xl: run_int_matmul(p, x)),
            "int8_matmul": timed(lambda p=p8, x=xl: run_int_matmul(p, x)),
            "quant_matmul_fa": timed(lambda p=pfa, x=xf: run_int_matmul(
                p, x, out_dtype=bf16)),
            "_int_mm": timed(lambda x=xl, w=w8t: torch._int_mm(x, w)),
            "k1_quant": timed(lambda p=p1, x=xf: run_matmul(
                p, x, out_dtype=bf16))}
    return out


def k4_sites(g):
    """K4 at :data:`K4_SITES`."""
    out = {}
    for site, (b, p, d, n_pad) in K4_SITES.items():
        acc = torch.randn((b, p, d), generator=g, device="cuda") * 50.0
        pos = torch.randn((p, d), generator=g, device="cuda")
        cls = torch.randn((d,), generator=g, device="cuda")
        sc = torch.full((), 1e-3, device="cuda")
        out[site] = timed(lambda: patch_finalize(acc, pos, cls, sc,
                                                 n_pad=n_pad))
    return out


def main():
    import sys

    only = set(sys.argv[1:]) or set(GROUPS)
    bad = only - set(GROUPS)
    if bad:
        raise SystemExit(f"unknown groups {sorted(bad)}; of {GROUPS}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"card": smi, "k1_us": {}, "k6_us": {}, "k3_us": {}, "k2_us": {},
           "k8_us": {}, "forward_ms": {}, "k5_us": {}, "latency_ms": {},
           "int_mm_us": {}, "k4_us": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    one = torch.ones((), device="cuda")
    if "int_mm" in only:
        out["int_mm_us"] = int_mm_sites(g, one)
    if "k4" in only:
        out["k4_us"] = k4_sites(g)
    for site, (m, k, n, pro, epi, xdt) in K1_SITES.items():
        if "k1" not in only:
            break
        w = torch.randint(-7, 8, (k, n), dtype=torch.int8, device="cuda",
                          generator=g)
        layer = {} if pro is None else dict(act_d=0.05 * one, act_t=one,
                                            act_top=127)
        if pro == "ln_quant":
            layer.update(ln_scale=torch.ones(k, device="cuda"),
                         ln_bias=torch.zeros(k, device="cuda"))
        if epi == "gelu_quant":
            layer.update(out_d=0.05 * one, out_t=one, out_top=127)
        plan = plan_matmul(w, 1e-3 * one, None, fmt="int8", prologue=pro,
                           epilogue=epi, **layer)
        x = (torch.randint(-7, 8, (m, k), dtype=torch.int8, device="cuda",
                           generator=g) if xdt == torch.int8 else
             torch.randn((m, k), generator=g, device="cuda").to(xdt))
        res = (torch.randn((m, n), generator=g, device="cuda").to(
            torch.bfloat16) if epi == "residual" else None)
        odt = torch.float32 if xdt == torch.float32 else torch.bfloat16

        def fn(plan=plan, x=x, res=res, odt=odt):
            return run_matmul(plan, x, residual=res, out_dtype=odt)

        out["k1_us"][site] = {"events": events_us(fn), "host": host_us(fn),
                              "device": device_us(fn)}
    for site, (b, n, heads, hd, n_real) in K6_SITES.items():
        if "k6" not in only:
            break
        qkv = (torch.randn((b, n, 3 * heads * hd), generator=g,
                           device="cuda") * 0.7).to(torch.bfloat16)
        plan = plan_attention_qkv("cuda", heads=heads, sm_scale=hd**-0.5,
                                  out_d=0.01 * one, out_t=one, out_top=31)

        def fn(plan=plan, qkv=qkv, n_real=n_real):
            return run_attention_qkv(plan, qkv, n_valid=n_real)

        out["k6_us"][site] = {"events": events_us(fn), "host": host_us(fn),
                              "device": device_us(fn)}
    for site, (b, n, heads, hd, n_real) in K3_SITES.items():
        if "k3" not in only:
            break
        d = heads * hd
        x = torch.randn((b, n, d), generator=g, device="cuda").to(
            torch.bfloat16)
        w = torch.randint(-7, 8, (d, 3 * d), dtype=torch.int8, device="cuda",
                          generator=g)
        plan = plan_attention_heads(
            w, 1e-3 * one, None, ln_scale=torch.ones(d, device="cuda"),
            ln_bias=torch.zeros(d, device="cuda"), heads=heads,
            sm_scale=hd**-0.5, act_d=0.05 * one, act_t=one, act_top=127,
            out_d=0.06 * one, out_t=one, out_top=31)

        def fn(plan=plan, x=x, n_real=n_real):
            return run_attention_heads(plan, x, n_valid=n_real)

        out["k3_us"][site] = {"events": events_us(fn), "host": host_us(fn),
                              "device": device_us(fn)}
    for site, (m, k, hid, fmt) in K2_SITES.items():
        if "k2" not in only:
            break
        x = torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16)
        w1 = torch.randint(-7, 8, (k, hid), dtype=torch.int8, device="cuda",
                           generator=g)
        w2 = torch.randint(-7, 8, (hid, k), dtype=torch.int8, device="cuda",
                           generator=g)
        if fmt == "int4":
            w1, w2 = pack_int4(w1, axis=0), pack_int4(w2, axis=0)
        try:
            plan = plan_mlp(
                w1, 1e-3 * one, None, w2, 1e-3 * one, None, fmt=fmt,
                ln_scale=torch.ones(k, device="cuda"),
                ln_bias=torch.zeros(k, device="cuda"), act_d=0.05 * one,
                act_t=one, act_top=127, hid_d=0.05 * one, hid_t=one,
                hid_top=127)
        except ValueError:  # a version with a width limit
            out["k2_us"][site] = None
            continue

        def fn(plan=plan, x=x):
            return run_mlp(plan, x)

        out["k2_us"][site] = {"events": events_us(fn), "host": host_us(fn),
                              "device": device_us(fn)}
    for site, (m, k, hid, xdt) in K8_SITES.items():
        if "k8" not in only:
            break
        x = torch.randn((m, k), generator=g, device="cuda").to(xdt)
        w1 = torch.randint(-7, 8, (k, hid), dtype=torch.int8, device="cuda",
                           generator=g)
        w2 = torch.randint(-7, 8, (hid, k), dtype=torch.int8, device="cuda",
                           generator=g)
        args = (w1, 1e-3 * one, None, w2, 1e-3 * one, None)
        layer = dict(fmt="int8", ln_scale=torch.ones(k, device="cuda"),
                     ln_bias=torch.zeros(k, device="cuda"),
                     act_d=0.05 * one, act_t=one, act_top=127,
                     hid_d=0.05 * one, hid_t=one, hid_top=127)
        res = {}
        for name, plan_fn, run_fn in (("k8", plan_mlp_chunked,
                                       run_mlp_chunked),
                                      ("k2", plan_mlp, run_mlp)):
            try:
                plan = plan_fn(*args, **layer)
            except ValueError:  # a version with a width limit
                res[name] = None
                continue

            def fn(plan=plan, x=x, run_fn=run_fn):
                return run_fn(plan, x, out_dtype=xdt)

            res[name] = {"events": events_us(fn), "host": host_us(fn),
                         "device": device_us(fn)}
        out["k8_us"][site] = res
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    for name, cfg_kw in MODELS.items():
        if "forward" not in only:
            break
        cfg = ViTConfig(**cfg_kw)
        art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False,
                                       device="cuda")
        plan = prepare_kernels(art, cfg)
        kp = cfg.patch_size**2 * cfg.in_channels
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (max(BATCHES), cfg.num_patches, kp)).astype(np.float32)).cuda()
        for b in BATCHES:
            out["forward_ms"][f"{name}_b{b}"] = events_us(
                lambda: vit_int4_forward(art, x[:b], cfg, plan=plan, **kw),
                iters=20, warmup=3) / 1e3
        del art, plan
    for name, cfg_kw in LATENCY.items():
        if "latency" not in only:
            break
        cfg = ViTConfig(**cfg_kw)
        art = random_vit_int4_artifact(cfg, seed=0, pack_weights=True,
                                       device="cuda")
        try:
            lat, meta = prepare_latency_artifact(art, cfg)
        except ValueError:  # a version that refuses the geometry
            out["k5_us"][name] = out["latency_ms"][name] = None
            continue
        n_pad = -(-cfg.num_tokens // 16) * 16
        xs = torch.randn((n_pad, cfg.embed_dim), generator=g,
                         device="cuda").to(torch.bfloat16)
        kp = cfg.patch_size**2 * cfg.in_channels
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, cfg.num_patches, kp)).astype(np.float32)).cuda()

        def k5(lat=lat, xs=xs, nv=cfg.num_tokens):
            return run_block_stack(lat["stack"], xs, n_valid=nv)

        def fwd(lat=lat, x=x, cfg=cfg, meta=meta):
            return vit_int4_forward_latency(lat, x, cfg, meta, **kw)

        out["k5_us"][name] = {"events": events_us(k5, iters=50),
                              "host": host_us(k5), "device": device_us(k5)}
        out["latency_ms"][name] = events_us(fwd, iters=20, warmup=3) / 1e3
        del art, lat
    print(json.dumps(out))


if __name__ == "__main__":
    main()
