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
CUDA-event medians in ms.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..models import ViTConfig
from ..ops import (plan_attention_heads, plan_attention_qkv, plan_matmul,
                   plan_mlp, plan_mlp_chunked, run_attention_heads,
                   run_attention_qkv, run_matmul, run_mlp, run_mlp_chunked)
from ..quant import pack_int4
from ..serve import (prepare_kernels, random_vit_int4_artifact,
                     vit_int4_forward)

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
MODELS = {"vitb": {}, "vith": dict(patch_size=14, embed_dim=1280, depth=32,
                                   num_heads=16, num_classes=1000)}
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


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"card": smi, "k1_us": {}, "k6_us": {}, "k3_us": {}, "k2_us": {},
           "k8_us": {}, "forward_ms": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    one = torch.ones((), device="cuda")
    for site, (m, k, n, pro, epi, xdt) in K1_SITES.items():
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
        qkv = (torch.randn((b, n, 3 * heads * hd), generator=g,
                           device="cuda") * 0.7).to(torch.bfloat16)
        plan = plan_attention_qkv("cuda", heads=heads, sm_scale=hd**-0.5,
                                  out_d=0.01 * one, out_t=one, out_top=31)

        def fn(plan=plan, qkv=qkv, n_real=n_real):
            return run_attention_qkv(plan, qkv, n_valid=n_real)

        out["k6_us"][site] = {"events": events_us(fn), "host": host_us(fn),
                              "device": device_us(fn)}
    for site, (b, n, heads, hd, n_real) in K3_SITES.items():
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
