"""Per-block phase timing of the K1, K3, K2, K8, K6, K9, K10-K12 and K13
kernels, and per-phase timing of K5, on the card.

Builds the phase-stamped variant of the kernels (``-DQVT_PROBE``:
``csrc/qvt_common.cuh`` has thread 0 of each block record
``%globaltimer`` at the phase boundaries the kernels mark with
``QVT_STAMP``, and thread 0 of K5's block 0 after each grid barrier,
``QVT_GRID_STAMP``; K3, K6 and K9 sum their repeated phases per block,
``qvt_common.cuh:PhaseClock``), runs each kernel once on a prepared plan,
and prints:

- ``attention_block`` (ViT-B/16 and ViT-H/14 at batch 32, bf16, with
  float attention and with ``int_attention``), per block of its
  persistent grid, each phase summed: LN + quant | first grid barrier |
  qkv GEMM | second grid barrier | attention, and the span;
- ``fused_mlp`` (ViT-B/16 at batch 32, 2 and 1 with int8 levels,
  ViT-H/14 at batch 1 and 2 with packed int4; random bf16 x), per block of
  its persistent grid, each phase summed: LN + quant | first grid
  barrier | fc1 | second grid barrier | fc2, and the span;
- ``fused_mlp_gather`` (K15: ViT-B/16's and ViT-H/14's MLP at batch 32
  gathering the next block's four int8 weights, beside K2 on the same
  plan), per block: LN + quant + copy | barrier 1 | fc1 | barrier 2 |
  fc2, and the span;
- ``fused_quant_matmul`` (ViT-B/16's patch embed and attention proj at
  batch 32, its chain qkv at batch 2, ViT-H/14's fc1 and fc2 at batch 32;
  int8 levels, random x), per block of its persistent grid, each phase
  summed: prologue | grid barrier | GEMM (with a split's partial sums) |
  epilogue, and the span (no prologue or barrier where x's levels are
  read in place);
- ``fused_mlp_chunked`` (K8 with int8 levels at ViT-H/14's MLP at batch
  1 and 2 and ViT-B/16's at the chain's batch 3; random bf16 x), per
  block of its persistent grid, each phase summed: LN + quant | first
  grid barrier | fc1 | second grid barrier | fc2, and the span;
- ``flash_attention`` (random bf16 q/k/v at K13's path shapes: ViT-B/16
  batch 32, ViT-H/14 batch 8 and 1, each at the query tile
  ``flash_tile_rows`` picks), per block: staging + scores | softmax |
  P.V + epilogue, and the span;
- ``attention_qkv_proj`` (random bf16 qkv and int8 ``w_proj`` at its two
  sites: ViT-H/14 batch 8 and ViT-B/16 batch 32, with float attention and
  with ``int_attention``), per block, summed over its heads and passes:
  staging | attention | level exchange | proj | epilogue | int scales
  (``int_attention``'s scan of each head's q, k and v rows), and the
  span;
- ``attention_qkv`` (random bf16 qkv at K6's sites, ViT-B/16 batch 2
  and 32, ViT-H/14 batch 1 and 2, each at the query tile
  ``qkv_attn_tile_rows`` picks, with
  float attention and with ``int_attention``), per block, summed over its
  steps: staging (q, the waits and barriers between chunk steps) |
  scores | p | P.V | int scales | epilogue, and the span;
- ``int_matmul`` (K10 and K12 at ViT-B/16's four layer shapes at M =
  1664, packed int4 weights, random int8 levels and bf16 x), per block:
  phase 1 (K12's levels) | grid barrier | GEMM + epilogues, and the span;
- ``block_stack`` (ViT-B/16 batch 1 at 224 and 384 px, packed int4,
  depth 12), per transformer block, mean over the 12: each phase from one
  grid barrier to the next (qkv, attention, proj with the LN2 tail, fc1,
  fc2 with the next block's LN1 tail).

    python3 -m quantized_vit_tpu_torch.tools.phase_probe [kernel ...]

With kernel names (``attention_qkv_proj``, ``flash_attention``, ...) it
runs only those.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops.attention import (_card_shape, flash_tile_rows, heads_tile_rows,
                             plan_attention_heads, plan_attention_qkv,
                             plan_attention_qkv_proj, qkv_attn_tile_rows,
                             run_attention_heads, run_attention_qkv,
                             run_attention_qkv_proj, run_flash_attention)
from ..ops.block_stack import run_block_stack
from ..ops.fused import (_launch_mlp_chunked, chunked_layout, matmul_layout,
                         mlp_layout, plan_matmul, plan_mlp, plan_mlp_chunked,
                         run_matmul, run_mlp)
from ..ops.int4_matmul import (_launch_int_matmul, int_matmul_layout,
                               plan_int_matmul)
from ..ops.ring_gather import _launch_mlp_gather, plan_gather_rows
from ..quant import pack_int4
from ..models import ViTConfig
from .chain_timing import INT_MM_SITES
from ..serve import prepare_latency_artifact, random_vit_int4_artifact

_K9_PHASES = ("staging", "attention", "level exchange", "proj",
              "epilogue", "int scales")
_K6_PHASES = ("staging", "scores", "p", "P.V", "int scales", "epilogue")
_K3_PHASES = ("LN + quant", "barrier 1", "qkv GEMM", "barrier 2",
              "attention")
_K2_PHASES = ("LN + quant", "barrier 1", "fc1", "barrier 2", "fc2")
# K2's sites: (rows, K, H, weight format)
_K2_SITES = {"vitb_b32": (6656, 768, 3072, "int8"),
             "vitb_b2": (416, 768, 3072, "int8"),
             "vitb_b1": (208, 768, 3072, "int8"),
             "vith_b1_int4": (272, 1280, 5120, "int4"),
             "vith_b2_int4": (544, 1280, 5120, "int4")}
# K15: K2's phases, the copy in phase 1; its sites: (rows, K, H),
# gathering the next block's four int8 weights
# K8: K2's phases; its sites: (rows, K, H), int8 weights
_K8_SITES = {"vith_b1": (272, 1280, 5120), "vith_b2": (544, 1280, 5120),
             "vitb_chain_b3": (624, 768, 3072)}
_K15_PHASES = ("LN + quant + copy", "barrier 1", "fc1", "barrier 2", "fc2")
_K15_SITES = {"vitb_b32": (6656, 768, 3072), "vith_b32": (8704, 1280, 5120)}
_K1_PHASES = ("prologue", "barrier", "GEMM", "epilogue")
# K10-K12's phases a block: phase 1 (K12's levels), the grid barrier, the
# GEMM with its epilogues (none of the first two where x's levels are
# read in place)
_INT_MM_PHASES = ("phase 1", "grid barrier", "GEMM + epilogues")
# K1's sites: (rows, K, N, prologue, epilogue, x dtype)
_K1_SITES = {
    "vitb_patch_embed_b32": (6272, 768, 768, "quant", None, torch.float32),
    "vitb_proj_b32": (6656, 768, 768, None, "residual", torch.int8),
    "vitb_chain_qkv_b2": (416, 768, 2304, "ln_quant", None, torch.bfloat16),
    "vith_fc1_b32": (8704, 1280, 5120, "ln_quant", "gelu_quant",
                     torch.bfloat16),
    "vith_fc2_b32": (8704, 5120, 1280, None, "residual", torch.int8)}
# K5's phases a transformer block, each to the end of its grid barrier
# (block 0's LN1 row phase comes first, once)
_STACK_PHASES = ("qkv GEMM", "attention", "proj GEMM + LN2", "fc1 GEMM",
                 "fc2 GEMM + next LN1")


def main():
    only = set(sys.argv[1:])
    _build.use_probe_build()
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    one = torch.ones((), device=dev)
    d05 = torch.full((), 0.05, device=dev)
    runs = {}
    for tag, (bk, hk, nk, hdk, nv) in (("vitb_b32", (32, 12, 208, 64, 197)),
                                       ("vith_b8", (8, 16, 272, 80, 257)),
                                       ("vith_b1", (1, 16, 272, 80, 257))):
        qkv = [torch.randn((bk, hk, nk, hdk), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(3)]
        qt = flash_tile_rows(bk, hk, nk, hdk, *_card_shape(0))
        runs[f"flash_attention:{tag}"] = (
            -(-nk // qt) * hk * bk,
            lambda qkv=qkv, hdk=hdk, nv=nv: run_flash_attention(
                *qkv, sm_scale=hdk**-0.5, n_valid=nv),
            (f"staging + scores (qt {qt})", "softmax", "P.V + epilogue"))
    buf = np.zeros(65536 * 4, np.uint64)
    print(torch.cuda.get_device_name(0))
    for tag, (rows, dk, hk, fmt) in _K2_SITES.items():
        if only and "fused_mlp" not in only:
            break
        lv1 = torch.randint(-7, 8, (dk, hk), dtype=torch.int8, device=dev)
        lv2 = torch.randint(-7, 8, (hk, dk), dtype=torch.int8, device=dev)
        pw = ((pack_int4(lv1, axis=0), pack_int4(lv2, axis=0))
              if fmt == "int4" else (lv1, lv2))
        pl = plan_mlp(pw[0], 1e-3 * one, None, pw[1], 1e-3 * one, None,
                      hid_d=d05, hid_t=one, hid_top=7, act_d=d05, act_t=one,
                      act_top=7, fmt=fmt, ln_scale=torch.ones(dk, device=dev),
                      ln_bias=torch.zeros(dk, device=dev))
        xk = torch.randn((rows, dk), generator=g, device=dev).to(
            torch.bfloat16)
        lay = mlp_layout(rows, dk, hk, 2, _card_shape(0)[0])
        summed_phases(buf, "fused_mlp", _K2_PHASES,
                      f"fused_mlp:{tag}:ln{lay.ln_threads}:t{lay.tile1}/"
                      f"{lay.tile2}:whole{lay.full2}:S{lay.splits}",
                      lambda pl=pl, xk=xk: run_mlp(pl, xk))
    for tag, (rows, dk, hk) in _K8_SITES.items():
        if only and "fused_mlp_chunked" not in only:
            break
        pl = plan_mlp_chunked(
            torch.randint(-7, 8, (dk, hk), dtype=torch.int8, device=dev),
            1e-3 * one, None,
            torch.randint(-7, 8, (hk, dk), dtype=torch.int8, device=dev),
            1e-3 * one, None, hid_d=d05, hid_t=one, hid_top=7, act_d=d05,
            act_t=one, act_top=7, fmt="int8",
            ln_scale=torch.ones(dk, device=dev),
            ln_bias=torch.zeros(dk, device=dev))
        xk = torch.randn((rows, dk), generator=g, device=dev).to(
            torch.bfloat16)
        lay = chunked_layout(rows, dk, hk, 2, _card_shape(0)[0])
        summed_phases(buf, "fused_mlp_chunked", _K2_PHASES,
                      f"fused_mlp_chunked:{tag}:ln{lay.ln_threads}:fc1 "
                      f"{lay.nc1}/{lay.nw1}x{lay.g1}:fc2 {lay.nc2}/"
                      f"{lay.nw2}x{lay.g2}:stages {lay.stages}",
                      lambda pl=pl, xk=xk, lay=lay:
                      _launch_mlp_chunked(pl, xk, lay))
    for site, (rows, dk, nk) in INT_MM_SITES.items():
        if only and "int_matmul" not in only:
            break
        w8 = torch.randint(-7, 8, (dk, nk), dtype=torch.int8, device=dev)
        xl = torch.randint(-7, 8, (rows, dk), dtype=torch.int8, device=dev)
        xf = (torch.randn((rows, dk), generator=g, device=dev) * 0.1).to(
            torch.bfloat16)
        for front, pl, xk, odt in (
                ("int4_matmul", plan_int_matmul(pack_int4(w8, axis=0),
                                                1e-3 * one), xl,
                 torch.float32),
                ("quant_matmul_fa", plan_int_matmul(
                    pack_int4(w8, axis=0), 1e-3 * one, act_d=d05, act_t=one,
                    act_top=7), xf, torch.bfloat16)):
            lay = int_matmul_layout(rows, dk, nk, True, xk.element_size(),
                                    True, odt.itemsize, _card_shape(0)[0])
            summed_phases(buf, "int_matmul", _INT_MM_PHASES,
                          f"int_matmul:{site}:{front}:nw{lay.nw}:"
                          f"S{lay.splits}",
                          lambda pl=pl, xk=xk, lay=lay, odt=odt:
                          _launch_int_matmul(pl, xk, lay, out_dtype=odt))
    for tag, (rows, dk, hk) in _K15_SITES.items():
        if only and "fused_mlp_gather" not in only:
            break
        pl = plan_mlp(
            torch.randint(-7, 8, (dk, hk), dtype=torch.int8, device=dev),
            1e-3 * one, None,
            torch.randint(-7, 8, (hk, dk), dtype=torch.int8, device=dev),
            1e-3 * one, None, hid_d=d05, hid_t=one, hid_top=7, act_d=d05,
            act_t=one, act_top=7, fmt="int8",
            ln_scale=torch.ones(dk, device=dev),
            ln_bias=torch.zeros(dk, device=dev))
        gp = plan_gather_rows([
            torch.randint(-128, 128, shp, dtype=torch.int8, device=dev)
            for shp in ((dk, 3 * dk), (dk, dk), (dk, hk), (hk, dk))])
        xk = torch.randn((rows, dk), generator=g, device=dev).to(
            torch.bfloat16)
        lay = mlp_layout(rows, dk, hk, 2, _card_shape(0)[0])
        summed_phases(buf, "fused_mlp", _K2_PHASES,
                      f"fused_mlp:{tag}:same plan",
                      lambda pl=pl, xk=xk: run_mlp(pl, xk))
        summed_phases(buf, "fused_mlp", _K15_PHASES,
                      f"fused_mlp_gather:{tag}:{gp.moved / 2**20:.2f} MB",
                      lambda pl=pl, gp=gp, xk=xk, lay=lay:
                      _launch_mlp_gather(pl, gp, xk, lay))
    for tag, (rows, dk, nk, pro, epi, xdt) in _K1_SITES.items():
        if only and "fused_quant_matmul" not in only:
            break
        wk = torch.randint(-7, 8, (dk, nk), dtype=torch.int8, device=dev)
        layer = {} if pro is None else dict(act_d=d05, act_t=one,
                                            act_top=127)
        if pro == "ln_quant":
            layer.update(ln_scale=torch.ones(dk, device=dev),
                         ln_bias=torch.zeros(dk, device=dev))
        if epi == "gelu_quant":
            layer.update(out_d=d05, out_t=one, out_top=127)
        pl = plan_matmul(wk, 1e-3 * one, None, fmt="int8", prologue=pro,
                         epilogue=epi, **layer)
        xk = (torch.randint(-7, 8, (rows, dk), dtype=torch.int8, device=dev,
                            generator=g) if xdt == torch.int8 else
              torch.randn((rows, dk), generator=g, device=dev).to(xdt))
        res = (torch.randn((rows, nk), generator=g, device=dev).to(
            torch.bfloat16) if epi == "residual" else None)
        out_dt = torch.float32 if xdt == torch.float32 else torch.bfloat16
        lay = matmul_layout(rows, dk, nk, pro, xk.element_size(),
                            _card_shape(0)[0])
        summed_phases(buf, "fused_quant_matmul", _K1_PHASES,
                      f"fused_quant_matmul:{tag}:ln{lay.ln_threads}:"
                      f"t{lay.tile}:whole{lay.full}:S{lay.splits}",
                      lambda pl=pl, xk=xk, res=res, out_dt=out_dt:
                      run_matmul(pl, xk, residual=res, out_dtype=out_dt))
    for tag, (bk, n, heads, hd, nv) in (("vitb_b32", (32, 208, 12, 64, 197)),
                                        ("vith_b32", (32, 272, 16, 80,
                                                      257))):
        if only and "attention_block" not in only:
            break
        dk = heads * hd
        xk = torch.randn((bk, n, dk), generator=g, device=dev).to(
            torch.bfloat16)
        wk = torch.randint(-7, 8, (dk, 3 * dk), dtype=torch.int8, device=dev)
        pl = plan_attention_heads(
            wk, 1e-3 * one, None, heads=heads, sm_scale=hd**-0.5, out_d=d05,
            out_t=one, out_top=7, act_d=d05, act_t=one, act_top=7,
            fmt="int8", ln_scale=torch.ones(dk, device=dev),
            ln_bias=torch.zeros(dk, device=dev))
        rows = heads_tile_rows(bk, n, heads, hd, 2, *_card_shape(0))
        for ia in (False, True):
            summed_phases(buf, "attention_block", _K3_PHASES,
                          f"attention_block:{tag}:R{rows}"
                          f"{':int_attention' if ia else ''}",
                          lambda pl=pl, xk=xk, nv=nv, ia=ia:
                          run_attention_heads(pl, xk, n_valid=nv,
                                              int_attention=ia))
    for tag, (bk, n, heads, hd, nv) in (("vith_b8", (8, 272, 16, 80, 257)),
                                        ("vitb_b32", (32, 208, 12, 64, 197))):
        if only and "attention_qkv_proj" not in only:
            break
        d = heads * hd
        qkv = (torch.randn((bk, n, 3 * d), generator=g, device=dev)
               * 0.7).to(torch.bfloat16)
        res = torch.randn((bk, n, d), generator=g, device=dev).to(
            torch.bfloat16)
        wp = torch.randint(-7, 8, (d, d), dtype=torch.int8, device=dev)
        pl = plan_attention_qkv_proj(wp, 2e-3 * one, None, heads=heads,
                                     sm_scale=hd**-0.5, out_d=0.01 * one,
                                     out_t=one, out_top=31)
        for ia in (False, True):
            summed_phases(buf, "attention_proj", _K9_PHASES,
                          f"attention_qkv_proj:{tag}"
                          f"{':int_attention' if ia else ''}",
                          lambda pl=pl, qkv=qkv, res=res, nv=nv, ia=ia:
                          run_attention_qkv_proj(pl, qkv, res, n_valid=nv,
                                                 int_attention=ia))
    for tag, (bk, n, heads, hd, nv) in (("vitb_b2", (2, 208, 12, 64, 197)),
                                        ("vitb_b32", (32, 208, 12, 64,
                                                      197)),
                                        ("vith_b1", (1, 272, 16, 80, 257)),
                                        ("vith_b2", (2, 272, 16, 80, 257))):
        if only and "attention_qkv" not in only:
            break
        qkv = (torch.randn((bk, n, 3 * heads * hd), generator=g, device=dev)
               * 0.7).to(torch.bfloat16)
        pl = plan_attention_qkv(dev, heads=heads, sm_scale=hd**-0.5,
                                out_d=0.01 * one, out_t=one, out_top=31)
        rows = qkv_attn_tile_rows(bk, n, heads, hd, 2, *_card_shape(0))
        for ia in (False, True):
            summed_phases(buf, "attention_qkv", _K6_PHASES,
                          f"attention_qkv:{tag}:R{rows}"
                          f"{':int_attention' if ia else ''}",
                          lambda pl=pl, qkv=qkv, nv=nv, ia=ia:
                          run_attention_qkv(pl, qkv, n_valid=nv,
                                            int_attention=ia))
    for name, (blocks, fn, names) in runs.items():
        if only and name.split(":")[0] not in only:
            continue
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        read = _build.library(name.split(":")[0]).qvt_probe_read
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        code = read(buf.ctypes.data_as(ctypes.c_void_p))
        if code:
            raise RuntimeError(f"reading the stamps failed ({code})")
        t = buf[: blocks * 4].reshape(blocks, 4).astype(np.int64)
        t -= t[:, 0].min()
        ph = np.diff(t, axis=1).mean(0) / 1e3
        print(f"{name}: {blocks} blocks, launch span {t[:, 3].max() / 1e3:.1f}"
              " us; per block " + ", ".join(
                  f"{nm} {v:.1f} us" for nm, v in zip(names, ph)))
    if not only or "block_stack" in only:
        stack_phases(buf)


def summed_phases(buf, stem, names, name, fn):
    """The per-block phase sums of K3, K6 or K9 (library ``stem``;
    ``PhaseClock.store``: start, end, six sums a block, named ``names``)
    of the last of three runs of ``fn``, the stamps zeroed before each;
    the blocks are those that wrote a start stamp."""
    lib = _build.library(stem)
    lib.qvt_probe_clear.restype = ctypes.c_int
    for _ in range(3):
        if lib.qvt_probe_clear():
            raise RuntimeError("clearing the stamps failed")
        fn()
    torch.cuda.synchronize()
    read = lib.qvt_probe_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    if read(buf.ctypes.data_as(ctypes.c_void_p)):
        raise RuntimeError("reading the stamps failed")
    t = buf.reshape(-1, 8).astype(np.int64)
    t = t[t[:, 0] != 0]
    span = (t[:, 1].max() - t[:, 0].min()) / 1e3
    ph = t[:, 2:2 + len(names)].mean(0) / 1e3
    print(f"{name}: {len(t)} blocks, launch span {span:.1f} us; per block "
          + ", ".join(f"{nm} {v:.1f} us" for nm, v in zip(names, ph))
          + f"; block time {((t[:, 1] - t[:, 0]).mean()) / 1e3:.1f} us")


# K5's block clocks (csrc/block_stack.cu:StackClock, thread 0 of each
# block) and its grid stamps after them
_STACK_CLOCK = (*(f"{p} steps" for p in ("qkv", "proj", "fc1", "fc2")),
                *(f"{p} epilogue" for p in ("qkv", "proj", "fc1", "fc2")),
                "LN2 chunk waits", "LN1 chunk waits", "block 0's LN1",
                "attention", "grid barriers", "the chunks' LN rows")
_STACK_STAMP0 = 4096


def stack_phases(buf):
    cfg = ViTConfig()
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=True)
    stack = prepare_latency_artifact(art, cfg)[0]["stack"]
    g = torch.Generator(device="cuda").manual_seed(1)
    read = _build.library("block_stack").qvt_probe_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    for n, name in ((208, "224 px"), (592, "384 px")):
        x = torch.randn((n, cfg.embed_dim), generator=g,
                        device="cuda").to(torch.bfloat16)
        nv = 197 if n == 208 else 577
        for _ in range(3):
            run_block_stack(stack, x, n_valid=nv)
        torch.cuda.synchronize()
        if read(buf.ctypes.data_as(ctypes.c_void_p)):
            raise RuntimeError("reading the stamps failed")
        k = len(_STACK_PHASES)
        n_st = k * cfg.depth + 2
        t = buf[_STACK_STAMP0:_STACK_STAMP0 + n_st].astype(np.int64)
        ph = np.diff(t[1:]).reshape(cfg.depth, k).mean(0) / 1e3
        print(f"block_stack ({name}, {n} rows): depth {cfg.depth}, stamped "
              f"span {(t[n_st - 1] - t[0]) / 1e3:.1f} us; block 0's LN1 "
              f"{(t[1] - t[0]) / 1e3:.1f} us; per transformer block "
              + ", ".join(f"{nm} {v:.1f} us"
                          for nm, v in zip(_STACK_PHASES, ph))
              + f"; total {ph.sum():.1f} us")
        c = buf[:_STACK_STAMP0].reshape(-1, 16).astype(np.int64)
        c = c[c[:, 0] != 0][:, 2:2 + len(_STACK_CLOCK)] / 1e3 / cfg.depth
        print(f"  thread 0 of each of {len(c)} blocks, a transformer "
              "block, mean / max over the blocks: " + ", ".join(
                  f"{nm} {a:.1f} / {b:.1f} us" for nm, a, b in
                  zip(_STACK_CLOCK, c.mean(0), c.max(0))))


if __name__ == "__main__":
    main()
