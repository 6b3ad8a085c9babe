"""ViT W4A4 integer serving forward (port of
``quantized_vit_tpu/serve/vit_int4.py``).

:func:`vit_int4_forward` runs, per transformer block, the JAX
package's single-device routes. Attention (:func:`uses_chain`, the gate
of vit_int4.py:272): a batch of 4 or more takes
:func:`~..ops.attention.attention_block` (K3, whose proj GEMM is K1); a
batch of 1-3 takes the chain, K1 with the LayerNorm + quant prologue
writing qkv, then :func:`~..ops.attention.attention_qkv` (K6), then K1
with the residual epilogue for proj. MLP (:func:`mlp_route`, the gates of
vit_int4.py:323-404 and fused.py:916-929): K2 (``fused_mlp``); K8
(``fused_mlp_chunked``) for int8 weights too big to stay resident at the
batch's rows (ViT-H/14 at batch 1-2); or, for big-weight MLPs above 576
rows, the two-kernel chain, K1 with the LayerNorm + quant prologue and
the GELU + quant epilogue for fc1, then K1 with the residual epilogue for
fc2. The patch embed and the head are K1, the token stream K4
(:func:`~..ops.patch.patch_finalize`). The JAX package's TPU-only gates
(the mixed-``fmt`` tests, the attention kernel's VMEM fit predicate, the
MLP alignment test) and its TPU tiles (the chain's ``chain_bm`` 544/288,
the resident kernel's pinned 832/416) do not carry over as such; the
VMEM arithmetic and the pins that decide the MLP route do.

:func:`vit_int4_forward_latency` is the batch-1 latency entry: K1 (patch
embed), K4, one launch of K5 (:func:`~..ops.block_stack.vit_block_stack`,
the whole block stack) and K1 (head), from the stacked artifact of
:func:`prepare_latency_artifact`.

Each weight operand carries its own format (packed int4 or int8), so
GETA mixed-precision exports stay on the kernels. The kernels run from a
:class:`KernelPlan` (:func:`prepare_kernels`: each layer's weight in the
kernels' layout and its constants folded, once per artifact).
``use_kernels=False`` runs the plain PyTorch versions instead (the
reference the kernels are held to); CPU tensors take the plain versions
in either case.

Token layout: patches first, cls at row ``n_real - 1``, padded to a
multiple of ``n_align`` (197 -> 208); padded keys are masked.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.vit import ViTConfig
from ..ops.attention import (AttentionPlan, QkvAttentionPlan,
                             attention_block_plain, heads_kernel_limit,
                             plan_attention_block, plan_attention_qkv,
                             qkv_kernel_limit, run_attention_block,
                             run_attention_qkv)
from ..ops.block_stack import (StackPlan, plan_block_stack,
                               run_block_stack, stack_kernel_limit,
                               vit_block_stack_plain)
from ..ops import _build
from ..ops.fused import (BIG_WEIGHT_BM, MatmulPlan, MlpPlan, fold_gelu,
                         fold_ln, fused_mlp_plain, fused_mlp_resident_bm,
                         fused_quant_matmul_plain, mlp_auto_hid_block,
                         mlp_chunked_kernel_limit, plan_matmul, plan_mlp, plan_mlp_chunked, run_matmul,
                         run_mlp, run_mlp_chunked)
from ..ops.patch import patch_finalize, patch_finalize_plain
from ..quant.bitwidth import d_for_bits
from ..quant.lsfq import lsfq_levels, lsfq_top_level
from ..quant.packing import pack_int4


@dataclasses.dataclass
class QLayerArtifact:
    """One quantized layer's serving artifact: weight levels (packed int4
    [K/2, N] or int8 [K, N]), the fused dequant scale ``d_w * d_a``, the
    float bias, the activation quantizer constants ``act`` (d, q_m, t),
    and the static ``fmt``, ``act_pow`` (t != 1) and ``top`` (clip level)."""

    w: torch.Tensor
    scale: torch.Tensor
    bias: Any
    act: Dict[str, torch.Tensor]
    fmt: str
    act_pow: bool = True
    top: int = 127


def _export_layer(layer_params: Dict[str, Any], pack_weights: bool = True):
    """One QuantDense/QuantConv's trained params -> its serving entry
    (vit_int4.py:63-125): the weight's LSFQ levels (a conv HWIO kernel as
    its [H*W*I, O] GEMM form), the fused dequant scale ``d_w * d_a``, the
    bias and the activation quantizer's constants. A layer trained above
    8 bits is requantized to 8 bits (its step widened to
    :func:`~..quant.bitwidth.d_for_bits`, with a warning). ``pack_weights``:
    4-bit levels nibble-packed [K/2, N]; a layer with a weight top level
    above 7 or an odd depth K is stored int8 [K, N] (a pruned fc2 with an
    odd hidden width: a block of int4 fc1 and int8 fc2)."""
    kernel = layer_params["kernel"]
    if kernel.ndim == 4:  # conv HWIO -> [H*W*I, O] gemm form
        h, w, i, o = kernel.shape
        kernel = kernel.reshape(h * w * i, o)
    d_w = layer_params["d_quant_wt"]
    qm_w = layer_params["q_m_wt"]
    t_w = layer_params.get("t_quant_wt", torch.ones_like(d_w))
    w_lv = lsfq_levels(kernel, d_w, qm_w, t_w)
    top_w = int(lsfq_top_level(d_w, qm_w, t_w)[0])
    d_a = layer_params["d_quant_act"]
    qm_a = layer_params["q_m_act"]
    t_a = layer_params.get("t_quant_act", torch.ones_like(d_a))
    top_a = lsfq_top_level(d_a, qm_a, t_a)[0]
    if top_w > 127 or float(top_a) > 127:
        # clipping the levels would corrupt values: requantize properly to
        # 8 bits (the same float tensor, moved by at most d8/2 a value)
        warnings.warn(
            f"layer trained above 8 bits (weight top {top_w}, act top "
            f"{float(top_a):.0f}); requantizing to 8 bits for the INT8 "
            "serving path", stacklevel=2)
        if top_w > 127:
            d_w = torch.broadcast_to(d_for_bits(8.0, qm_w, t_w), d_w.shape)
            w_lv = lsfq_levels(kernel, d_w, qm_w, t_w)
            top_w = int(lsfq_top_level(d_w, qm_w, t_w)[0])
        if float(top_a) > 127:
            d_a = torch.broadcast_to(d_for_bits(8.0, qm_a, t_a), d_a.shape)
            top_a = lsfq_top_level(d_a, qm_a, t_a)[0]
    act = {"d": d_a[0], "q_m": qm_a[0], "t": t_a[0]}
    top = int(min(float(top_a), 127.0))
    act_pow = bool(abs(float(t_a[0]) - 1.0) > 1e-6)
    common = dict(scale=(d_w * d_a)[0], bias=layer_params.get("bias"),
                  act=act, act_pow=act_pow, top=top)
    if pack_weights and top_w <= 7 and w_lv.shape[0] % 2 == 0:
        return QLayerArtifact(
            w=pack_int4(torch.clamp(w_lv, -8, 7).to(torch.int8), axis=0),
            fmt="int4", **common)
    return QLayerArtifact(w=torch.clamp(w_lv, -127, 127).to(torch.int8),
                          fmt="int8", **common)


def export_vit_int4(cfg: ViTConfig, params: Dict[str, Any],
                    pack_weights: bool = True) -> Dict[str, Any]:
    """Trained fake-quant ViT params (a full model or a compressed subnet)
    -> the integer serving artifact (vit_int4.py:128-158), on the params'
    device, for :func:`prepare_kernels`, :func:`prepare_latency_artifact`
    and ``artifact.save_vit_int4_artifact``. ``pack_weights=False``
    stores 4-bit levels unpacked int8."""
    art: Dict[str, Any] = {}
    art["patch_embed"] = _export_layer(params["patch_embed"]["proj"],
                                       pack_weights)
    art["cls_token"] = params["cls_token"]
    art["pos_embed"] = params["pos_embed"]
    art["blocks"] = []
    for i in range(cfg.depth):
        b = params[f"blocks_{i}"]
        art["blocks"].append({
            "norm1": b["norm1"],
            "qkv": _export_layer(b["attn"]["qkv"], pack_weights),
            "proj": _export_layer(b["attn"]["proj"], pack_weights),
            "norm2": b["norm2"],
            "fc1": _export_layer(b["mlp"]["fc1"], pack_weights),
            "fc2": _export_layer(b["mlp"]["fc2"], pack_weights),
        })
    art["norm"] = params["norm"]
    if cfg.representation_size is not None:
        art["pre_logits"] = dict(params["pre_logits"])
    if cfg.num_classes > 0:
        art["head"] = _export_layer(params["head"], pack_weights)
    return art


def _qmatmul(x2d, entry: QLayerArtifact, float_dtype, **kw):
    """Quantized matmul with fused prologue/epilogue (K1's plain version)."""
    kw.setdefault("prologue", "quant")
    if kw["prologue"] is not None:
        kw.setdefault("act_d", entry.act["d"])
        kw.setdefault("act_t", entry.act["t"])
        kw.setdefault("act_top", entry.top)
        kw.setdefault("act_pow", entry.act_pow)
    return fused_quant_matmul_plain(
        x2d, entry.w, kw.pop("scale", entry.scale), kw.pop("bias", entry.bias),
        fmt=entry.fmt, out_dtype=float_dtype, **kw)


def _layernorm(x, p, eps=1e-6):
    """Two-pass LayerNorm of the final norm (vit_int4.py:175-181): a
    different function from the kernels' fast-variance form."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(dt)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _patches_2d(images, cfg: ViTConfig, images_layout: str):
    """images -> [B*P, p*p*C] patch rows (``nhwc`` patchified on the
    device, in the host patchify's order)."""
    b = images.shape[0]
    p = cfg.patch_size
    g = cfg.img_size // p
    kdim = p * p * cfg.in_channels
    if images_layout == "patches":
        return images.reshape(b * g * g, kdim)
    if images_layout == "nhwc":
        xp = images.reshape(b, g, p, g, p * cfg.in_channels)
        return xp.permute(0, 1, 3, 2, 4).reshape(b * g * g, kdim)
    raise ValueError(f"unknown images_layout {images_layout!r}")


def _pos_rows(art, cfg: ViTConfig):
    """(patch positional rows [P, D], cls row [D]) in f32."""
    pos = art["pos_embed"].to(torch.float32).reshape(cfg.num_tokens, -1)
    cls_row = art["cls_token"].to(torch.float32).reshape(-1) + pos[0]
    return pos[1:], cls_row


def _embed_tokens(art, images, cfg: ViTConfig, float_dtype,
                  images_layout: str, n_pad: int):
    """Patch embed + pos embed + cls + pad: images -> [B*n_pad, D] rows
    (plain versions).

    ``patches``: K1 applies the dequant scale and bias. ``nhwc``: K1
    returns the exact integer accumulators (scale 1, no bias) and K4
    applies the scale and bias, as the JAX conv path does."""
    b = images.shape[0]
    pe = art["patch_embed"]
    xp = _patches_2d(images, cfg, images_layout)
    pos_patch, cls_row = _pos_rows(art, cfg)
    if images_layout == "patches":
        acc = _qmatmul(xp, pe, torch.float32, epilogue=None)
        pe_scale = torch.ones((), dtype=torch.float32, device=images.device)
    else:
        acc = _qmatmul(xp, pe, torch.float32, epilogue=None,
                       scale=torch.ones((), dtype=torch.float32,
                                        device=images.device), bias=None)
        pe_scale = pe.scale
        if pe.bias is not None:
            pos_patch = pos_patch + pe.bias
    return patch_finalize_plain(acc.reshape(b, cfg.num_patches, -1),
                                pos_patch, cls_row, pe_scale, n_pad=n_pad,
                                out_dtype=float_dtype)


def _vit_block(x2d, blk, *, b: int, n_pad: int, n_real: int, dim: int,
               hd: int, sm_scale: float, float_dtype, int_attention: bool):
    """One transformer block (plain versions): the attention residual
    branch (K3's) then the MLP residual branch (K2's, which K8 and the
    big-weight chain compute too)."""
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    fc1_e, fc2_e = blk["fc1"], blk["fc2"]
    x2d = attention_block_plain(
        x2d.reshape(b, n_pad, dim),
        qkv_e.w, qkv_e.scale, qkv_e.bias,
        proj_e.w, proj_e.scale, proj_e.bias,
        fmt_proj=proj_e.fmt, n_valid=n_real, out_dtype=float_dtype,
        int_attention=int_attention, **_attention_layer(blk, hd, sm_scale),
    ).reshape(b * n_pad, dim)
    return fused_mlp_plain(
        x2d, fc1_e.w, fc1_e.scale, fc1_e.bias,
        fc2_e.w, fc2_e.scale, fc2_e.bias, out_dtype=float_dtype,
        **_mlp_layer(blk))


def _attention_layer(blk, hd: int, sm_scale: float):
    """K3's layer arguments of one block."""
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    # heads may differ per block in GETA-compressed subnets; the qkv width
    # encodes it (N = 3 * heads_i * hd)
    return dict(
        ln_scale=blk["norm1"]["scale"], ln_bias=blk["norm1"]["bias"],
        heads=qkv_e.w.shape[1] // (3 * hd), sm_scale=sm_scale,
        act_d=qkv_e.act["d"], act_t=qkv_e.act["t"], act_top=qkv_e.top,
        act_pow=qkv_e.act_pow, out_d=proj_e.act["d"],
        out_t=proj_e.act["t"], out_top=proj_e.top,
        out_pow=proj_e.act_pow, fmt=qkv_e.fmt)


def _mlp_layer(blk):
    """K2's (and K8's) layer arguments of one block."""
    fc1_e, fc2_e = blk["fc1"], blk["fc2"]
    return dict(
        ln_scale=blk["norm2"]["scale"], ln_bias=blk["norm2"]["bias"],
        act_d=fc1_e.act["d"], act_t=fc1_e.act["t"], act_top=fc1_e.top,
        act_pow=fc1_e.act_pow, hid_d=fc2_e.act["d"], hid_t=fc2_e.act["t"],
        hid_top=fc2_e.top, hid_pow=fc2_e.act_pow, fmt=fc1_e.fmt,
        fmt2=fc2_e.fmt)


def _quant_layer(entry: QLayerArtifact):
    """K1's layer arguments of a layer with the ``quant`` prologue."""
    return dict(fmt=entry.fmt, prologue="quant", act_d=entry.act["d"],
                act_t=entry.act["t"], act_top=entry.top,
                act_pow=entry.act_pow)


# the smallest batch that takes K3 + K2; smaller batches take the chain
# (the JAX package's gate, vit_int4.py:272, measured on its TPU; this
# card's times for both routes are in PERF.md)
BLOCK_ROUTE_MIN_BATCH = 4


def uses_chain(batch: int) -> bool:
    """True when a forward of ``batch`` images runs the chain (K1 qkv, K6,
    K1 proj) rather than K3 + K1 for its attention branch."""
    return batch < BLOCK_ROUTE_MIN_BATCH


# the MLP routes of :func:`mlp_route`, named by the kernel that runs them
MLP_RESIDENT, MLP_CHUNKED, MLP_CHAIN = ("fused_mlp", "fused_mlp_chunked",
                                        "chain")
# a big-weight MLP over this many rows takes the chain (vit_int4.py:346)
BIG_WEIGHT_CHAIN_ROWS = 576
# the resident TPU kernel's measured M tiles at two int8 geometries
# (vit_int4.py:367-381): a pinned tile keeps the resident kernel, never
# the hidden-chunked one
_PINNED_MLP_BM = {(768, 3072): 832, (1024, 4096): 416}


def mlp_route(m: int, k: int, hid: int, fmt: str, fmt2: Optional[str] = None,
              itemsize: int = 2) -> str:
    """The kernel the JAX package runs for an MLP of ``m`` rows, width
    ``k``, hidden ``hid`` and weight formats ``fmt``/``fmt2`` with a
    residual stream of ``itemsize`` bytes (vit_int4.py:323-404 and
    fused.py:916-929): :data:`MLP_CHAIN` for a big-weight MLP (resident M
    tile under 224 rows) over 576 rows, :data:`MLP_CHUNKED` where
    ``_fused_mlp`` streams int8 weights in hidden chunks, else
    :data:`MLP_RESIDENT`. Mixed formats, which the JAX package sends to the
    chain, stay on K2 (it takes them)."""
    fmt2 = fmt2 or fmt
    big = fused_mlp_resident_bm(k, hid, fmt, itemsize,
                                itemsize) < BIG_WEIGHT_BM
    if big and m > BIG_WEIGHT_CHAIN_ROWS:
        return MLP_CHAIN
    pinned = _PINNED_MLP_BM.get((k, hid))
    if fmt == "int8" and pinned and m % pinned == 0:
        return MLP_RESIDENT
    if fmt == fmt2 and mlp_auto_hid_block(m, k, hid, fmt, itemsize,
                                          itemsize):
        return MLP_CHUNKED
    return MLP_RESIDENT


@dataclasses.dataclass(frozen=True)
class MlpPlans:
    """One block's MLP, prepared for each route of :func:`mlp_route`, all
    on one n-major copy of each weight: K2, K8 (None unless both weights
    are int8), and the chain's two K1 launches (fc1 with the LayerNorm +
    quant prologue and the GELU + quant epilogue; fc2 with the residual
    epilogue)."""

    resident: MlpPlan
    chunked: Optional[MlpPlan]
    fc1: MatmulPlan
    fc2: MatmulPlan
    k: int
    hid: int
    fmt: str
    fmt2: str


def _plan_mlps(blk, w1_t=None, w2_t=None) -> MlpPlans:
    """A block's :class:`MlpPlans`, on ``w1_t`` / ``w2_t`` (the weights
    already in the kernels' layout: the column-FSDP forward's gather
    buffers) or on copies made here."""
    fc1_e, fc2_e = blk["fc1"], blk["fc2"]
    layer = _mlp_layer(blk)
    k, hid = fc2_e.w.shape[1], fc1_e.w.shape[1]
    if w1_t is None:
        w1_t, w2_t = _build.n_major(fc1_e.w), _build.n_major(fc2_e.w)
    args = (fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
            fc2_e.bias)
    return MlpPlans(
        resident=plan_mlp(*args, w1_t=w1_t, w2_t=w2_t, **layer),
        chunked=None if mlp_chunked_kernel_limit(
            k, fc1_e.fmt, fc2_e.fmt) else plan_mlp_chunked(
                *args, w1_t=w1_t, w2_t=w2_t, **layer),
        fc1=plan_matmul(
            fc1_e.w, fc1_e.scale, fc1_e.bias, fmt=fc1_e.fmt,
            prologue="ln_quant", act_d=layer["act_d"], act_t=layer["act_t"],
            act_top=layer["act_top"], act_pow=layer["act_pow"],
            ln_scale=layer["ln_scale"], ln_bias=layer["ln_bias"],
            epilogue="gelu_quant", out_d=layer["hid_d"],
            out_t=layer["hid_t"], out_top=layer["hid_top"],
            out_pow=layer["hid_pow"], w_t=w1_t),
        fc2=plan_matmul(fc2_e.w, fc2_e.scale, fc2_e.bias, fmt=fc2_e.fmt,
                        prologue=None, epilogue="residual", w_t=w2_t),
        k=k, hid=hid, fmt=fc1_e.fmt, fmt2=fc2_e.fmt)


def _run_mlps(plans: MlpPlans, x2d, float_dtype):
    """The MLP residual branch on the route :func:`mlp_route` picks for
    ``x2d``'s rows."""
    route = mlp_route(x2d.shape[0], plans.k, plans.hid, plans.fmt,
                      plans.fmt2, x2d.element_size())
    if route == MLP_CHAIN:
        hlv = run_matmul(plans.fc1, x2d)
        return run_matmul(plans.fc2, hlv, residual=x2d,
                          out_dtype=float_dtype)
    if route == MLP_CHUNKED:  # int8 weights only: K8 has a plan
        return run_mlp_chunked(plans.chunked, x2d, out_dtype=float_dtype)
    return run_mlp(plans.resident, x2d, out_dtype=float_dtype)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """An artifact prepared for the CUDA kernels, once
    (:func:`prepare_kernels`): each K1/K2/K3/K6/K8 call site of the
    forward with its weight copied into the kernels' layout and its
    constants folded, and K4's rows. It holds its own copy of every
    weight, beside the artifact's; a block's qkv weight once, shared by
    K3's plan and the chain's K1 plan, and its fc1 and fc2 weights once,
    shared by the plans of every MLP route (:class:`MlpPlans`)."""

    # per images_layout: the patch embed's K1 plan, then K4's positional
    # rows and scale ("nhwc": K1 returns the exact accumulators, K4
    # applies the dequant scale and the conv bias folded into the rows)
    embed: Dict[str, Tuple[MatmulPlan, torch.Tensor, torch.Tensor]]
    cls_row: torch.Tensor
    blocks: List[Tuple[AttentionPlan, MlpPlans]]
    # per block, the chain's qkv K1 plan (LayerNorm + quant prologue) and
    # its K6 plan; its proj is the AttentionPlan's
    chain: List[Tuple[MatmulPlan, QkvAttentionPlan]]
    head: Optional[MatmulPlan]


# kernel_limits with no batch checks the routes of batches 1 to this; the
# gates of uses_chain and mlp_route reach each of their kernels below it
ROUTE_BATCHES = 64


def kernel_limits(cfg: ViTConfig, n_align: int = 16, latency: bool = False,
                  *, batch: Optional[int] = None, fmt: str = "int4",
                  float_dtype=torch.float32,
                  fsdp_rdma: bool = False) -> List[str]:
    """Why the CUDA kernels cannot serve ``cfg`` with ``fmt`` weights and a
    ``float_dtype`` residual stream (empty if they can): the limits of the
    kernels on the routes a forward of ``batch`` images takes (None: any
    batch), K3 or K6 for attention (no MLP kernel has one: K2, K15 with
    ``fsdp_rdma``, the FSDP forward of ``serve/vit_fsdp.py`` whose
    ``batch`` is a process's share, and K8, which the route gives int8
    weights only); or, with ``latency``, those of K5 for the batch-1
    entry at each block's widths (a compressed subnet's
    ``heads_per_block`` and ``hidden_per_block``), the block named. The
    other kernels take any per-block width (K1 any depth, K2 mixed
    formats, K3 and K6 any head count): their limits depend on head_dim
    alone, which compression keeps."""
    hd = cfg.embed_dim // cfg.num_heads
    if latency:
        lims = []
        for i in range(cfg.depth):
            lim = stack_kernel_limit(cfg.embed_dim, cfg.block_hidden(i), hd,
                                     cfg.block_heads(i) * hd)
            lims.append(lim and f"block {i}: {lim}")
    else:
        lims = []
        for b in (range(1, ROUTE_BATCHES + 1) if batch is None
                  else (batch,)):
            lims.append(qkv_kernel_limit(hd) if uses_chain(b)
                        else heads_kernel_limit(hd))
    return list(dict.fromkeys(lim for lim in lims if lim))


def _raise_limits(limits: List[Optional[str]]) -> None:
    limits = [lim for lim in limits if lim]
    if limits:
        raise ValueError("the CUDA kernels cannot serve this configuration "
                         "(ROADMAP.md, kernel limits): " + "; ".join(limits))


def _sm_scale(cfg: ViTConfig, hd: int) -> float:
    return cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5


def _embed_head_plans(art, cfg: ViTConfig):
    """(embed plans per images_layout, cls row, head plan) of K1/K4."""
    pe = art["patch_embed"]
    patch_embed = plan_matmul(pe.w, pe.scale, pe.bias, **_quant_layer(pe))
    one = torch.ones((), dtype=torch.float32, device=pe.w.device)
    pos_patch, cls_row = _pos_rows(art, cfg)
    pos_acc = pos_patch if pe.bias is None else pos_patch + pe.bias
    embed = {
        "patches": (patch_embed, pos_patch.contiguous(), one),
        "nhwc": (dataclasses.replace(patch_embed, bias=None,
                                     scale=torch.ones_like(patch_embed.scale)),
                 pos_acc.contiguous(), pe.scale),
    }
    he = art.get("head")
    head = (None if he is None
            else plan_matmul(he.w, he.scale, he.bias, **_quant_layer(he)))
    return embed, cls_row.contiguous(), head


def prepare_kernels(art, cfg: ViTConfig) -> KernelPlan:
    """The artifact's kernel plans (its tensors on a CUDA device), for the
    routes of every batch. Raises a ValueError when ``cfg``'s head_dim
    exceeds the attention kernels' bound; the limits that depend on the
    batch and the residual dtype are checked by the forward
    (:func:`kernel_limits`)."""
    hd = art["pos_embed"].shape[-1] // cfg.num_heads
    _raise_limits([heads_kernel_limit(hd)])
    sm_scale = _sm_scale(cfg, hd)
    embed, cls_row, head = _embed_head_plans(art, cfg)
    blocks, chain = [], []
    for blk in art["blocks"]:
        attn, chain_plans = plan_block_attention(blk, hd, sm_scale)
        blocks.append((attn, _plan_mlps(blk)))
        chain.append(chain_plans)
    return KernelPlan(embed=embed, cls_row=cls_row, blocks=blocks,
                      chain=chain, head=head)


def plan_block_attention(blk, hd: int, sm_scale: float, wq_t=None,
                         wp_t=None):
    """A block's attention plans for both routes: K3's
    :class:`~..ops.attention.AttentionPlan` (with its K1 proj) and the
    chain's (K1 qkv, K6) plans, on one n-major qkv weight. ``wq_t`` /
    ``wp_t``: the qkv and proj weights already in the kernels' layout
    (the FSDP forward's gathered buffers), used instead of copies."""
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    layer = _attention_layer(blk, hd, sm_scale)
    attn = plan_attention_block(
        qkv_e.w, qkv_e.scale, qkv_e.bias, proj_e.w, proj_e.scale,
        proj_e.bias, fmt_proj=proj_e.fmt, wq_t=wq_t, wp_t=wp_t, **layer)
    return attn, (
        plan_matmul(qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
                    prologue="ln_quant", act_d=layer["act_d"],
                    act_t=layer["act_t"], act_top=layer["act_top"],
                    act_pow=layer["act_pow"], ln_scale=layer["ln_scale"],
                    ln_bias=layer["ln_bias"], w_t=attn.heads.wq_t),
        plan_attention_qkv(
            qkv_e.w.device, heads=layer["heads"], sm_scale=sm_scale,
            out_d=layer["out_d"], out_t=layer["out_t"],
            out_top=layer["out_top"], out_pow=layer["out_pow"]))


def _embed_kernels(embed, cls_row, xp, b: int, cfg: ViTConfig, dim: int,
                   n_pad: int, float_dtype, images_layout: str):
    """Patch embed (K1) + token stream (K4) on prepared plans."""
    pe_plan, pos_patch, pe_scale = embed[images_layout]
    acc = run_matmul(pe_plan, xp, out_dtype=torch.float32)
    return patch_finalize(acc.reshape(b, cfg.num_patches, dim), pos_patch,
                          cls_row, pe_scale, n_pad=n_pad,
                          out_dtype=float_dtype)


def _logits(art, x2d, b: int, n_pad: int, n_real: int, dim: int,
            head: Optional[MatmulPlan]):
    """cls row -> final LayerNorm -> (pre-logits) -> head (K1 on ``head``
    when given, else its plain version)."""
    x = x2d.reshape(b, n_pad, dim)[:, n_real - 1]  # cls row (last real row)
    x = _layernorm(x, art["norm"]).to(torch.float32)
    if "pre_logits" in art:
        x = torch.tanh(x @ art["pre_logits"]["kernel"]
                       + art["pre_logits"]["bias"])
    if "head" in art:
        x = (run_matmul(head, x, out_dtype=torch.float32) if head is not None
             else _qmatmul(x, art["head"], torch.float32))
    return x


def _chain_attention(chain, attn: AttentionPlan, x2d, *, b: int, n_pad: int,
                     n_real: int, float_dtype, int_attention: bool):
    """The chain's attention branch: K1 (LN + quant prologue) writes qkv in
    the residual dtype, K6 the proj levels, K1 proj + residual."""
    qkv_plan, attn_plan = chain
    qkv = run_matmul(qkv_plan, x2d, out_dtype=float_dtype)
    alv = run_attention_qkv(attn_plan, qkv.reshape(b, n_pad, -1),
                            n_valid=n_real, out_dtype=float_dtype,
                            int_attention=int_attention)
    return run_matmul(attn.proj, alv.reshape(b * n_pad, -1), residual=x2d,
                      out_dtype=float_dtype)


@torch.no_grad()
def vit_int4_forward(art, images, cfg: ViTConfig,
                     float_dtype=torch.float32, int_attention: bool = False,
                     images_layout: str = "nhwc", n_align: int = 16,
                     input_scale: float | None = None,
                     use_kernels: bool = True,
                     plan: Optional[KernelPlan] = None):
    """Quantized ViT forward on integer weights.

    images: [B, H, W, C] (``images_layout='nhwc'``) or host-patchified
    [B, (H/P)*(W/P), P*P*C] (``'patches'``), float or — with
    ``input_scale`` — integer pixels cast and scaled on the device.
    ``float_dtype`` is the residual-stream dtype (bf16 serving, f32 strict
    parity); level math is always f32. Returns f32 logits [B, classes].

    Tensors off the CPU run the CUDA kernels unless ``use_kernels`` is
    False, on the routes :func:`uses_chain` and :func:`mlp_route` pick for
    the batch (a ValueError names the kernel limits they exceed,
    :func:`kernel_limits`); ``plan`` is the artifact's
    :func:`prepare_kernels`, made here when not given (a caller that
    serves many batches keeps it). CPU tensors take the plain versions.
    """
    b = images.shape[0]
    if input_scale is not None:
        images = images.to(torch.float32) * torch.full(
            (), input_scale, dtype=torch.float32, device=images.device)
    n_real = cfg.num_tokens
    n_pad = _round_up(n_real, n_align)
    dim = art["pos_embed"].shape[-1]
    hd = dim // cfg.num_heads
    sm_scale = _sm_scale(cfg, hd)
    xp = _patches_2d(images, cfg, images_layout)
    if use_kernels and images.device.type != "cpu":
        _raise_limits(kernel_limits(cfg, n_align, batch=b,
                                    fmt=art["blocks"][0]["fc1"].fmt,
                                    float_dtype=float_dtype))
        plan = plan or prepare_kernels(art, cfg)
        x2d = _embed_kernels(plan.embed, plan.cls_row, xp, b, cfg, dim,
                             n_pad, float_dtype, images_layout)
        chain = uses_chain(b)
        for (attn, mlp), chain_plans in zip(plan.blocks, plan.chain):
            if chain:
                x2d = _chain_attention(
                    chain_plans, attn, x2d, b=b, n_pad=n_pad, n_real=n_real,
                    float_dtype=float_dtype, int_attention=int_attention)
            else:
                x2d = run_attention_block(
                    attn, x2d.reshape(b, n_pad, dim), n_valid=n_real,
                    out_dtype=float_dtype,
                    int_attention=int_attention).reshape(b * n_pad, dim)
            x2d = _run_mlps(mlp, x2d, float_dtype)
        head = plan.head
    else:
        head = None
        x2d = _embed_tokens(art, images, cfg, float_dtype, images_layout,
                            n_pad)
        for blk in art["blocks"]:
            x2d = _vit_block(x2d, blk, b=b, n_pad=n_pad, n_real=n_real,
                             dim=dim, hd=hd, sm_scale=sm_scale,
                             float_dtype=float_dtype,
                             int_attention=int_attention)
    return _logits(art, x2d, b, n_pad, n_real, dim, head)


# ---------------------------------------------------------------------------
# batch-1 latency entry: the whole block stack in one launch (K5)
# ---------------------------------------------------------------------------


class StackMeta(NamedTuple):
    """Static metadata of the stacked blocks (vit_int4.py:533-545)."""

    fmt: str
    heads: int
    act_top: int
    out_top: int
    mlp_top: int
    hid_top: int
    act_pow: bool
    out_pow: bool
    mlp_pow: bool
    hid_pow: bool


def _blocks_uniform(blocks) -> bool:
    """True when every block shares geometry and static quantizer metadata
    (vit_int4.py:408-419)."""
    def sig(b):
        return tuple(
            (k, b[k].fmt, b[k].act_pow, b[k].top, b[k].bias is not None,
             tuple(b[k].w.shape))
            for k in ("qkv", "proj", "fc1", "fc2"))
    s0 = sig(blocks[0])
    return all(sig(b) == s0 for b in blocks[1:])


def prepare_latency_artifact(art, cfg: ViTConfig):
    """The batch-1 latency artifact, once per artifact (vit_int4.py:548-643):
    the blocks stacked for K5 (:class:`~..ops.block_stack.StackPlan`, the
    weights n-major) with the folds of the per-block plans
    (``fused.fold_ln``: 1/d into LN gamma/beta when the quantizer is
    linear; ``fused.fold_gelu``: 2**-0.5 into fc1's dequant), and on a CUDA
    device the K1/K4 plans of the patch embed and the head.

    Returns (latency artifact, :class:`StackMeta`). Refuses a stack whose
    static metadata differs between blocks, and mixed weight formats
    within a block, as the JAX function does."""
    blocks = art["blocks"]
    if not _blocks_uniform(blocks):
        raise ValueError("per-block static metadata differs; the "
                         "megakernel needs a uniform stack")
    b0 = blocks[0]
    fmt = b0["qkv"].fmt
    if any(b0[k].fmt != fmt for k in ("proj", "fc1", "fc2")):
        raise ValueError("mixed weight formats within a block; the "
                         "megakernel needs one fmt (use the chain path)")
    dev = b0["qkv"].w.device
    if dev.type == "cuda":
        _raise_limits(kernel_limits(cfg, latency=True))
    hd = cfg.embed_dim // cfg.num_heads
    heads = b0["qkv"].w.shape[1] // (3 * hd)
    meta = StackMeta(
        fmt, heads, b0["qkv"].top, b0["proj"].top, b0["fc1"].top,
        b0["fc2"].top, b0["qkv"].act_pow, b0["proj"].act_pow,
        b0["fc1"].act_pow, b0["fc2"].act_pow)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def vec(a, n):
        return (torch.zeros((n,), dtype=torch.float32, device=dev)
                if a is None else torch.broadcast_to(f32(a), (n,)))

    rows: Dict[str, list] = {}
    for blk in blocks:
        qkv_e, proj_e = blk["qkv"], blk["proj"]
        fc1_e, fc2_e = blk["fc1"], blk["fc2"]
        three, hid = qkv_e.w.shape[1], fc1_e.w.shape[1]
        d = proj_e.w.shape[1]
        g1, be1 = fold_ln(blk["norm1"]["scale"], blk["norm1"]["bias"],
                          qkv_e.act["d"], qkv_e.act_pow, dev)
        g2, be2 = fold_ln(blk["norm2"]["scale"], blk["norm2"]["bias"],
                          fc1_e.act["d"], fc1_e.act_pow, dev)
        s1, b1 = vec(fc1_e.scale, hid), vec(fc1_e.bias, hid)
        if not fc2_e.act_pow:  # the folded GELU handoff
            s1, b1 = fold_gelu(s1, b1, dev)
        for k, v in (
                ("wq", qkv_e.w), ("qs", vec(qkv_e.scale, three)),
                ("qb", vec(qkv_e.bias, three)), ("l1g", g1), ("l1b", be1),
                ("wp", proj_e.w), ("ps", vec(proj_e.scale, d)),
                ("pb", vec(proj_e.bias, d)), ("l2g", g2), ("l2b", be2),
                ("w1", fc1_e.w), ("s1", s1), ("b1", b1), ("w2", fc2_e.w),
                ("s2", vec(fc2_e.scale, d)), ("b2", vec(fc2_e.bias, d)),
                ("act_d", f32(qkv_e.act["d"])), ("act_t", f32(qkv_e.act["t"])),
                ("out_d", f32(proj_e.act["d"])),
                ("out_t", f32(proj_e.act["t"])),
                ("mlp_d", f32(fc1_e.act["d"])), ("mlp_t", f32(fc1_e.act["t"])),
                ("hid_d", f32(fc2_e.act["d"])),
                ("hid_t", f32(fc2_e.act["t"]))):
            rows.setdefault(k, []).append(v)
    st = {k: torch.stack(v) for k, v in rows.items()}
    stack = plan_block_stack(
        st["wq"], st["qs"], st["qb"], st["l1g"], st["l1b"], st["wp"],
        st["ps"], st["pb"], st["l2g"], st["l2b"], st["w1"], st["s1"],
        st["b1"], st["w2"], st["s2"], st["b2"], st["act_d"], st["act_t"],
        st["out_d"], st["out_t"], st["mlp_d"], st["mlp_t"], st["hid_d"],
        st["hid_t"], heads=heads, sm_scale=_sm_scale(cfg, hd), fmt=fmt,
        act_pow=meta.act_pow, out_pow=meta.out_pow, mlp_pow=meta.mlp_pow,
        hid_pow=meta.hid_pow, act_top=meta.act_top, out_top=meta.out_top,
        mlp_top=meta.mlp_top, hid_top=meta.hid_top)
    out = {k: v for k, v in art.items() if k != "blocks"}
    out["stack"] = stack
    if dev.type == "cuda":
        out["kernels"] = _embed_head_plans(art, cfg)
    return out, meta


@torch.no_grad()
def vit_int4_forward_latency(art, images, cfg: ViTConfig, meta: StackMeta,
                             float_dtype=torch.bfloat16,
                             images_layout: str = "patches"):
    """Batch-1 latency forward (vit_int4.py:651-701): K1 patch embed, K4,
    ONE launch of K5 over the whole block stack, the final LayerNorm and
    K1 head; the same logits as :func:`vit_int4_forward`.

    art: the latency artifact of :func:`prepare_latency_artifact`;
    images: batch 1 ([1, H, W, C] or the patches layout). The tokens are
    padded to 208 where the JAX entry pads to 224: the key rows (208) and
    the real query rows are the same, so the logits are too. CPU tensors
    take the plain versions."""
    b = images.shape[0]
    if b != 1:
        raise ValueError(f"latency megakernel is batch-1 only, got {b}")
    n_real = cfg.num_tokens
    n_pad = _round_up(n_real, 16)
    dim = art["pos_embed"].shape[-1]
    stack: StackPlan = art["stack"]
    if meta.heads != stack.heads or meta.fmt != ("int4" if stack.int4
                                                 else "int8"):
        raise ValueError(f"StackMeta {meta} does not describe this stack")
    run = dict(n_valid=n_real, out_dtype=float_dtype)
    if images.device.type != "cpu":
        embed, cls_row, head = art["kernels"]
        x2d = _embed_kernels(embed, cls_row,
                             _patches_2d(images, cfg, images_layout), b,
                             cfg, dim, n_pad, float_dtype, images_layout)
        x2d = run_block_stack(stack, x2d, **run)
    else:
        head = None
        x2d = vit_block_stack_plain(
            stack, _embed_tokens(art, images, cfg, float_dtype,
                                 images_layout, n_pad), **run)
    return _logits(art, x2d, b, n_pad, n_real, dim, head)


def random_vit_int4_artifact(cfg: ViTConfig, seed: int = 0,
                             pack_weights: bool = True, device="cuda"):
    """Random serving artifact with realistic scales. Draws from numpy in
    the order of the JAX function (vit_int4.py:704-752), so one seed gives
    the same artifact byte for byte."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)

    def t(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def qlayer(k, n, with_bias=True):
        w = t(rng.integers(-7, 8, (k, n)).astype(np.int8))
        return QLayerArtifact(
            w=pack_int4(w, axis=0) if pack_weights else w,
            scale=f32(1e-3),
            bias=t(rng.standard_normal(n).astype(np.float32) * 1e-2)
            if with_bias else None,
            act={"d": f32(0.05), "q_m": f32(0.35), "t": f32(1.0)},
            fmt="int4" if pack_weights else "int8", act_pow=False, top=7,
        )

    def ln(n):
        return {"scale": torch.ones((n,), dtype=torch.float32, device=dev),
                "bias": torch.zeros((n,), dtype=torch.float32, device=dev)}

    art = {
        "patch_embed": qlayer(cfg.patch_size**2 * cfg.in_channels, d),
        "cls_token": t(
            rng.standard_normal((1, 1, d)).astype(np.float32) * 0.02),
        "pos_embed": t(
            rng.standard_normal((1, cfg.num_tokens, d)).astype(np.float32)
            * 0.02),
        "blocks": [
            {
                "norm1": ln(d),
                "qkv": qlayer(d, 3 * d),
                "proj": qlayer(d, d),
                "norm2": ln(d),
                "fc1": qlayer(d, hidden),
                "fc2": qlayer(hidden, d),
            }
            for _ in range(cfg.depth)
        ],
        "norm": ln(d),
    }
    if cfg.num_classes > 0:
        art["head"] = qlayer(d, cfg.num_classes)
    return art


_QLAYER_FIELDS = ("w", "scale", "bias", "act", "fmt", "act_pow", "top")


def artifact_from_numpy(tree, device="cuda"):
    """The port's artifact from a JAX artifact pytree after
    ``jax.tree.map(np.asarray, art)``: arrays become tensors on ``device``
    with identical bytes; each layer object carrying the QLayerArtifact
    attributes (duck-typed: the port cannot import the JAX class) becomes
    this module's :class:`QLayerArtifact`."""
    dev = resolve_device(device)

    def conv(node):
        if node is None or isinstance(node, (bool, int, float, str)):
            return node
        if all(hasattr(node, f) for f in _QLAYER_FIELDS):
            return QLayerArtifact(
                w=conv(node.w), scale=conv(node.scale), bias=conv(node.bias),
                act=conv(node.act), fmt=str(node.fmt),
                act_pow=bool(node.act_pow), top=int(node.top))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.asarray(node)
        return torch.from_numpy(np.array(arr, order="C")).to(dev)

    return conv(tree)
