"""FSDP serving: weights sharded over the processes of a 'model' axis,
gathered before use (port of ``quantized_vit_tpu/serve/vit_fsdp.py``).

Two forwards:

- :func:`vit_int4_forward_fsdp`, the column half (vit_fsdp.py:60-148,
  :274-342), described at its section below: every block weight split
  along its output columns, K14 gathering each block's four weights one
  block ahead, each process running the single-device block;
- :func:`vit_int4_forward_fsdp_rdma`, the in-kernel gather half
  (vit_fsdp.py:151-407), described here.

Every block's four weights (qkv, proj, fc1, fc2) are split into tp row
shards, one per process of the 'model' axis (:class:`~..parallel.Peers`;
tp = 1: one process, no peers; or one model line of a (dp, tp)
:class:`~..parallel.ProcessMesh`), so a process holds total/tp of the
block weights. The batch is split over the dp x tp processes too; each runs the
single-device pipeline on its own images with the block's whole weights,
gathered just before use:

- block 0's weights by K14 (:func:`~..ops.ring_gather.run_gather_rows`),
  the bootstrap (vit_fsdp.py:182-188, :387);
- every later block's inside the previous block's MLP launch, K15
  (:func:`~..ops.ring_gather.run_mlp_gather`, vit_fsdp.py:237-266): K2's
  cooperative kernel, whose blocks also copy the next block's shards, so
  the MLP's output is K2's bit for bit at any width (ViT-H/14's 1280
  included) and the forward serves every model the single-device one
  does.

The attention half takes the port's single-device route
(:func:`~.vit_int4.uses_chain`: K3 + K1 proj from 4 images a process,
else K1 qkv + K6 + K1 proj); the JAX function's batch >= 8 gate and TPU
fit predicate (vit_fsdp.py:202) are not copied (ROADMAP.md C1.2). The
gathered weights are the originals byte for byte, so the logits equal
:func:`~.vit_int4.vit_int4_forward`'s on the same images.

Layout. The kernels read n-major weights (``ops/_build.py:n_major``). A
process's shard of a weight [R, N] (R = K, or K/2 packed int4) is the
rank-th of tp equal byte ranges of its n-major copy, held in the shape
[R/tp, N] of the JAX package's row shard: the JAX refusals (R divisible
by tp x the sublane tile) and ``check_row_shards`` hold unchanged, and the
gathered [R, N] buffer IS the n-major copy, which the plans read in place
(no transpose per block per forward). Two rotating sets of gather buffers
serve blocks of even and odd index; the plans are made once over them
(:func:`prepare_fsdp_rdma_kernels`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.vit import ViTConfig
from ..ops import _build
from ..ops.attention import (AttentionPlan, QkvAttentionPlan,
                             attention_block_plain, heads_kernel_limit,
                             run_attention_block)
from ..ops.fused import MatmulPlan, MlpPlan, plan_mlp
from ..ops.ring_gather import (GatherPlan, _sublane, fused_mlp_gather_plain,
                               gather_rows_plain, plan_gather_rows,
                               run_gather_rows, run_mlp_gather)
from ..parallel.tp_comm import count_collective
from .vit_int4 import (MlpPlans, _attention_layer, _chain_attention,
                       _embed_head_plans, _embed_kernels, _embed_tokens,
                       _logits, _mlp_layer, _patches_2d, _plan_mlps,
                       _raise_limits, _round_up, _run_mlps, _sm_scale,
                       _vit_block, kernel_limits, plan_block_attention,
                       uses_chain)
from .vit_tp import _qentry_specs, _rep, local_images

_SHARDED = ("qkv", "proj", "fc1", "fc2")
_ALIGN = 256  # byte offset of each weight in a gather buffer set


def prepare_fsdp_rdma_artifact(art: Dict[str, Any], cfg: ViTConfig,
                               tp: int):
    """Validate an artifact for tp-way row sharding + in-kernel gather
    (vit_fsdp.py:151-174): every block weight needs rows % (tp * sublane
    tile) == 0, and the MLP kernel needs the unpacked-int8 format. The
    artifact is returned unchanged."""
    for i, b in enumerate(art["blocks"]):
        for k in _SHARDED:
            e = b[k]
            rows = e.w.shape[0]
            sub = _sublane(e.w.dtype)
            if rows % (tp * sub):
                raise ValueError(
                    f"block {i} {k}: weight rows {rows} not divisible by "
                    f"tp*{sub}={tp * sub} — RDMA row sharding needs "
                    "tile-aligned shard rows")
        if b["fc1"].fmt != "int8" or b["fc2"].fmt != "int8":
            raise ValueError(
                "RDMA-gather mode runs the unpacked-int8 MLP kernel; "
                "export the artifact with pack_weights=False")
    return art


def _shard(w: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """``rank``'s row shard of weight ``w`` [R, N] (module docstring): the
    rank-th of tp equal byte ranges of its n-major copy, as [R/tp, N]."""
    rows = w.shape[0] // tp
    full = _build.n_major(w).reshape(w.shape)
    return full[rank * rows:(rank + 1) * rows].clone()


def shard_fsdp_rdma_artifact(art: Dict[str, Any], rank: int, tp: int):
    """The artifact of process ``rank`` of ``tp`` (the counterpart of
    ``fsdp_rdma_artifact_specs`` + ``shard_fsdp_rdma_artifact``): each
    block's four weights become this process's row shards; everything
    else (embeddings, LayerNorms, scales, biases, head: a few % of the
    bytes) is shared as is. Validates with
    :func:`prepare_fsdp_rdma_artifact` first."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    prepare_fsdp_rdma_artifact(art, None, tp)
    blocks = [{**b, **{k: dataclasses.replace(b[k], w=_shard(b[k].w, rank,
                                                              tp))
                       for k in _SHARDED}} for b in art["blocks"]]
    return {**art, "blocks": blocks, "fsdp_rdma": (rank, tp)}


def _axis(fart, peers) -> Tuple[int, int]:
    rank, tp = (0, 1) if peers is None else (peers.rank, peers.tp)
    if fart.get("fsdp_rdma") != (rank, tp):
        raise ValueError(f"artifact sharded for (rank, tp) = "
                         f"{fart.get('fsdp_rdma')}, run at {(rank, tp)}; "
                         "make it with shard_fsdp_rdma_artifact")
    return rank, tp


def _logical(gathered: torch.Tensor) -> torch.Tensor:
    """The weight [R, N] (a view) of a gathered n-major buffer [R, N]."""
    r, n = gathered.shape
    return gathered.reshape(n, r).t()


def _with_weights(blk, ws):
    return {**blk, **{k: dataclasses.replace(blk[k], w=w)
                      for k, w in zip(_SHARDED, ws)}}


def _attention_plain(x2d, blk, *, b, n_pad, n_real, dim, hd, sm_scale,
                     float_dtype, int_attention):
    """The attention residual branch (plain versions) on whole weights."""
    return attention_block_plain(
        x2d.reshape(b, n_pad, dim), blk["qkv"].w, blk["qkv"].scale,
        blk["qkv"].bias, blk["proj"].w, blk["proj"].scale, blk["proj"].bias,
        fmt_proj=blk["proj"].fmt, n_valid=n_real, out_dtype=float_dtype,
        int_attention=int_attention, **_attention_layer(blk, hd, sm_scale),
    ).reshape(b * n_pad, dim)


def _mlp_args(blk):
    fc1_e, fc2_e = blk["fc1"], blk["fc2"]
    layer = _mlp_layer(blk)
    del layer["fmt2"]
    return (fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
            fc2_e.bias), layer


@dataclasses.dataclass(frozen=True)
class FsdpRdmaPlan:
    """A process's sharded artifact prepared for the kernels, once
    (:func:`prepare_fsdp_rdma_kernels`): the K1/K4 plans of the patch
    embed and the head; K14's bootstrap gather of block 0 into buffer set
    0; per block, its attention plans (K3 + K1 proj, and the chain's K1
    qkv + K6) and K2's MLP plan, all reading the block's weights in its
    buffer set (block i: set i % 2), and the gather of block i + 1's
    shards into the other set (None for the last block). ``sets``: this
    process's two buffer sets, which the peers write into."""

    embed: Dict[str, Tuple[MatmulPlan, torch.Tensor, torch.Tensor]]
    cls_row: torch.Tensor
    head: Optional[MatmulPlan]
    boot: GatherPlan
    blocks: List[Tuple[AttentionPlan, Tuple[MatmulPlan, QkvAttentionPlan],
                       MlpPlan, Optional[GatherPlan]]]
    sets: Tuple[torch.Tensor, torch.Tensor]


def _set_layout(shards, tp):
    """(byte offset, gathered shape, dtype) of each of a block's shards
    (contiguous, gathered along their rows) in a buffer set, and the set's
    bytes."""
    out, off = [], 0
    for s in shards:
        shape = (s.shape[0] * tp, s.shape[1])
        nb = shape[0] * shape[1] * s.element_size()
        out.append((off, shape, s.dtype))
        off += -(-nb // _ALIGN) * _ALIGN
    return out, off


def _set_views(buf, layout):
    return [buf[off:off + shape[0] * shape[1] * torch.empty(
        (), dtype=dt).element_size()].view(dt).reshape(shape)
        for off, shape, dt in layout]


def prepare_fsdp_rdma_kernels(fart, cfg: ViTConfig,
                              peers=None) -> FsdpRdmaPlan:
    """The plans of :class:`FsdpRdmaPlan` for this process's artifact
    (:func:`shard_fsdp_rdma_artifact`, tensors on a CUDA device). At
    tp > 1 every peer calls it (it maps the peers' buffer sets into this
    process). Raises a ValueError naming a kernel limit ``cfg`` exceeds
    regardless of the batch."""
    rank, tp = _axis(fart, peers)
    blocks = fart["blocks"]
    hd = fart["pos_embed"].shape[-1] // cfg.num_heads
    _raise_limits([heads_kernel_limit(hd)])
    sm_scale = _sm_scale(cfg, hd)
    dev = blocks[0]["qkv"].w.device
    _build.require_cuda("fused_mlp_gather", blocks[0]["qkv"].w)
    layouts = [_set_layout([b[k].w for k in _SHARDED], tp) for b in blocks]
    size = max(n for _, n in layouts)
    sets = tuple(torch.empty(size, dtype=torch.uint8, device=dev)
                 for _ in range(2))
    peer_sets = peers.open(list(sets)) if tp > 1 else [list(sets)]

    def gather(i):
        """Block i's shards into set i % 2 of every process."""
        views = [_set_views(ps[i % 2], layouts[i][0]) for ps in peer_sets]
        return plan_gather_rows(
            [blocks[i][k].w for k in _SHARDED], views[rank if tp > 1 else 0],
            peers=peers if tp > 1 else None,
            peer_outs=views if tp > 1 else None)

    embed, cls_row, head = _embed_head_plans(fart, cfg)
    plans = []
    for i, blk in enumerate(blocks):
        w_t = [g.reshape(g.shape[1], g.shape[0])
               for g in _set_views(sets[i % 2], layouts[i][0])]
        cur = _with_weights(blk, [w.t() for w in w_t])
        attn, chain = plan_block_attention(cur, hd, sm_scale, wq_t=w_t[0],
                                           wp_t=w_t[1])
        args, layer = _mlp_args(cur)
        mlp = plan_mlp(*args, w1_t=w_t[2], w2_t=w_t[3], **layer)
        plans.append((attn, chain, mlp,
                      gather(i + 1) if i + 1 < len(blocks) else None))
    return FsdpRdmaPlan(embed=embed, cls_row=cls_row, head=head,
                        boot=gather(0), blocks=plans, sets=sets)


@torch.no_grad()
def vit_int4_forward_fsdp_rdma(fart, images, cfg: ViTConfig, peers=None,
                               float_dtype=torch.bfloat16,
                               images_layout: str = "nhwc",
                               int_attention: bool = False,
                               plan: Optional[FsdpRdmaPlan] = None):
    """FSDP forward with in-kernel weight gathers (vit_fsdp.py:340-407).

    fart: this process's artifact (:func:`shard_fsdp_rdma_artifact`);
    images: the whole batch ([B, H, W, C], or host-patchified with
    ``images_layout='patches'``), the same on every process; B must
    divide over the dp x tp processes (a ValueError otherwise; the
    model line of a (dp, tp) mesh serves the slice of its data
    coordinate). Returns this process's logits [B/(dp tp), classes], f32:
    those of its slice of the images (``vit_tp.local_images``). At tp > 1
    every peer of the line calls it.

    CUDA tensors run the kernels (K1, K4, K14, then per block K3 + K1 or
    K1 + K6 + K1, and K15), from ``plan`` (:func:`prepare_fsdp_rdma_kernels`,
    made here when not given; a caller that serves many batches keeps
    it); CPU tensors the plain versions, gathering over the peers' gloo
    group."""
    rank, tp = _axis(fart, peers)
    images = local_images(images, peers,
                          "batch {b} not divisible by device count {n}")
    b_loc = images.shape[0]
    n_real = cfg.num_tokens
    n_pad = _round_up(n_real, 16)
    dim = fart["pos_embed"].shape[-1]
    hd = dim // cfg.num_heads
    sm_scale = _sm_scale(cfg, hd)
    blocks = fart["blocks"]
    if images.device.type != "cpu":
        _raise_limits(kernel_limits(cfg, 16, batch=b_loc, fmt="int8",
                                    float_dtype=float_dtype,
                                    fsdp_rdma=True))
        plan = plan or prepare_fsdp_rdma_kernels(fart, cfg, peers)
        x2d = _embed_kernels(plan.embed, plan.cls_row,
                             _patches_2d(images, cfg, images_layout), b_loc,
                             cfg, dim, n_pad, float_dtype, images_layout)
        run_gather_rows(plan.boot)
        chain = uses_chain(b_loc)
        for attn, chain_plans, mlp, gather in plan.blocks:
            if chain:
                x2d = _chain_attention(
                    chain_plans, attn, x2d, b=b_loc, n_pad=n_pad,
                    n_real=n_real, float_dtype=float_dtype,
                    int_attention=int_attention)
            else:
                x2d = run_attention_block(
                    attn, x2d.reshape(b_loc, n_pad, dim), n_valid=n_real,
                    out_dtype=float_dtype,
                    int_attention=int_attention).reshape(b_loc * n_pad, dim)
            x2d, _ = run_mlp_gather(mlp, gather, x2d, out_dtype=float_dtype)
        return _logits(fart, x2d, b_loc, n_pad, n_real, dim, plan.head)
    x2d = _embed_tokens(fart, images, cfg, float_dtype, images_layout, n_pad)
    gathered = gather_rows_plain([blocks[0][k].w for k in _SHARDED], peers)
    for i, blk in enumerate(blocks):
        cur = _with_weights(blk, [_logical(g) for g in gathered])
        x2d = _attention_plain(x2d, cur, b=b_loc, n_pad=n_pad,
                               n_real=n_real, dim=dim, hd=hd,
                               sm_scale=sm_scale, float_dtype=float_dtype,
                               int_attention=int_attention)
        args, layer = _mlp_args(cur)
        nxt = ([blocks[i + 1][k].w for k in _SHARDED]
               if i + 1 < len(blocks) else [])
        x2d, gathered = fused_mlp_gather_plain(
            x2d, *args, next_shards=nxt, peers=peers, out_dtype=float_dtype,
            **layer)
    return _logits(fart, x2d, b_loc, n_pad, n_real, dim, None)


# ---------------------------------------------------------------------------
# the column half: weights column-sharded, gathered one block ahead by K14
# ---------------------------------------------------------------------------
#
# Every block weight [R, N] (R = K, or K/2 packed int4) is split along its
# output columns (vit_fsdp.py:60-85): packed int4 pairs contraction rows,
# so column shards gather back to the exact original bytes, int4 or int8,
# with no re-pack. A process's column shard [R, N/tp] is a contiguous
# block of N/tp rows of the weight's n-major copy [N, R]
# (``ops/_build.py:n_major``): it is held as those rows (``w`` is their
# transposed view, the shard's logical [R, N/tp]), K14 gathers the four
# of a block straight into an [N, R] buffer that the plans read in place.
# The batch is split over the processes; each runs the single-device
# block (attention on :func:`~.vit_int4.uses_chain`'s route, the MLP on
# :func:`~.vit_int4.mlp_route`'s) on its own images, with the original
# weights, so the logits equal :func:`~.vit_int4.vit_int4_forward`'s bit
# for bit. Block i + 1's gather is issued before block i's compute, on
# the one stream (the JAX lookahead; overlapping them is later work).


def prepare_fsdp_artifact(art: Dict[str, Any], cfg: ViTConfig, tp: int):
    """Validate an artifact for tp-way column sharding (vit_fsdp.py:60-
    85): every block weight's output width must divide by tp. The
    artifact is returned unchanged."""
    for i, b in enumerate(art["blocks"]):
        for k in _SHARDED:
            n = b[k].w.shape[1]
            if n % tp:
                raise ValueError(
                    f"block {i} {k}: output width {n} not divisible by "
                    f"tp={tp} — FSDP column sharding needs n % tp == 0")
    return art


def fsdp_artifact_specs(art: Dict[str, Any]):
    """The spec tree (vit_fsdp.py:88-110): each block's four weights "col"
    (split along the output columns), everything else (embeddings,
    LayerNorms, scales, biases, head: a few % of the bytes) "rep"."""
    out = {
        "patch_embed": _qentry_specs(art["patch_embed"], "rep"),
        "cls_token": "rep",
        "pos_embed": "rep",
        "norm": _rep(art["norm"]),
        "blocks": [
            {"norm1": _rep(b["norm1"]), "norm2": _rep(b["norm2"]),
             **{k: _qentry_specs(b[k], "col", bias="rep")
                for k in _SHARDED}}
            for b in art["blocks"]],
    }
    if "pre_logits" in art:
        out["pre_logits"] = _rep(art["pre_logits"])
    if "head" in art:
        out["head"] = _qentry_specs(art["head"], "rep")
    return out


def _column_shard(w: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """``rank``'s column shard of ``w`` [R, N] (see the section comment):
    rows [rank * N/tp, (rank + 1) * N/tp) of its n-major copy, returned as
    their [R, N/tp] transposed view."""
    n = w.shape[1] // tp
    return _build.n_major(w)[rank * n:(rank + 1) * n].clone().t()


def shard_fsdp_artifact(art: Dict[str, Any], rank: int, tp: int):
    """The artifact of process ``rank`` of ``tp`` (the counterpart of
    ``fsdp_artifact_specs`` + ``shard_fsdp_artifact``): each block's four
    weights become this process's column shards (:func:`_column_shard`),
    the rest is shared as is. Validates with
    :func:`prepare_fsdp_artifact` first."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    prepare_fsdp_artifact(art, None, tp)
    specs = fsdp_artifact_specs(art)["blocks"]
    blocks = [{**b, **{k: dataclasses.replace(
        b[k], w=_column_shard(b[k].w, rank, tp))
        for k in _SHARDED if s[k].w == "col"}}
        for b, s in zip(art["blocks"], specs)]
    return {**art, "blocks": blocks, "fsdp": (rank, tp)}


def _col_axis(fart, peers) -> Tuple[int, int]:
    rank, tp = (0, 1) if peers is None else (peers.rank, peers.tp)
    if fart.get("fsdp") != (rank, tp):
        raise ValueError(f"artifact sharded for (rank, tp) = "
                         f"{fart.get('fsdp')}, run at {(rank, tp)}; make it "
                         "with shard_fsdp_artifact")
    return rank, tp


def _n_major_shards(blk):
    """A block's four column shards as the contiguous n-major rows K14
    gathers ([N/tp, R] each)."""
    return [blk[k].w.t() for k in _SHARDED]


@dataclasses.dataclass(frozen=True)
class FsdpPlan:
    """A process's column-sharded artifact prepared for the kernels, once
    (:func:`prepare_fsdp_kernels`): the K1/K4 plans of the patch embed and
    the head; per block, K14's gather of its four shards into buffer set
    i % 2 of every process, and the single-device block's plans reading
    the gathered weights there (attention on both routes, the MLP's
    :class:`~.vit_int4.MlpPlans`). ``sets``: this process's two buffer
    sets, which the peers write into."""

    embed: Dict[str, Tuple[MatmulPlan, torch.Tensor, torch.Tensor]]
    cls_row: torch.Tensor
    head: Optional[MatmulPlan]
    gathers: List[GatherPlan]
    blocks: List[Tuple[AttentionPlan, Tuple[MatmulPlan, QkvAttentionPlan],
                       MlpPlans]]
    sets: Tuple[torch.Tensor, torch.Tensor]


def prepare_fsdp_kernels(fart, cfg: ViTConfig, peers=None) -> FsdpPlan:
    """The plans of :class:`FsdpPlan` for this process's artifact
    (:func:`shard_fsdp_artifact`, tensors on a CUDA device). At tp > 1
    every process calls it (it maps the peers' buffer sets into this
    one). Raises a ValueError naming a kernel limit ``cfg`` exceeds
    regardless of the batch, or where K8's plan would need a padded copy
    of a gathered weight (a width off its tiles)."""
    rank, tp = _col_axis(fart, peers)
    blocks = fart["blocks"]
    hd = fart["pos_embed"].shape[-1] // cfg.num_heads
    _raise_limits([heads_kernel_limit(hd)])
    sm_scale = _sm_scale(cfg, hd)
    dev = blocks[0]["qkv"].w.device
    _build.require_cuda("gather_rows", blocks[0]["qkv"].w)
    shards = [_n_major_shards(b) for b in blocks]
    layouts = [_set_layout(s, tp) for s in shards]
    size = max(n for _, n in layouts)
    sets = tuple(torch.empty(size, dtype=torch.uint8, device=dev)
                 for _ in range(2))
    peer_sets = peers.open(list(sets)) if tp > 1 else [list(sets)]
    gathers, plans = [], []
    for i, blk in enumerate(blocks):
        views = [_set_views(ps[i % 2], layouts[i][0]) for ps in peer_sets]
        mine = views[rank if tp > 1 else 0]
        gathers.append(plan_gather_rows(
            shards[i], mine, peers=peers if tp > 1 else None,
            peer_outs=views if tp > 1 else None, sublane_rows=False))
        # the gathered [N, R] buffers are the n-major copies
        cur = _with_weights(blk, [w_t.t() for w_t in mine])
        attn, chain = plan_block_attention(cur, hd, sm_scale, wq_t=mine[0],
                                           wp_t=mine[1])
        mlps = _plan_mlps(cur, w1_t=mine[2], w2_t=mine[3])
        if mlps.chunked is not None and (mlps.chunked.w1_t is not mine[2] or
                                         mlps.chunked.w2_t is not mine[3]):
            raise ValueError(f"block {i}: K8 pads this MLP's widths, so it "
                             "cannot read the gathered weights in place")
        plans.append((attn, chain, mlps))
    embed, cls_row, head = _embed_head_plans(fart, cfg)
    return FsdpPlan(embed=embed, cls_row=cls_row, head=head,
                    gathers=gathers, blocks=plans, sets=sets)


def _gather_block(plan: FsdpPlan, i: int):
    count_collective("all_gather", torch.int8, len(_SHARDED))
    run_gather_rows(plan.gathers[i])


def _gather_block_plain(blk, peers):
    """A block's four weights gathered from their column shards (plain
    version: the n-major rows over gloo), as logical [R, N] views."""
    count_collective("all_gather", torch.int8, len(_SHARDED))
    return _with_weights(blk, [g.t() for g in gather_rows_plain(
        _n_major_shards(blk), peers, sublane_rows=False)])


@torch.no_grad()
def vit_int4_forward_fsdp(fart, images, cfg: ViTConfig, peers=None,
                          float_dtype=torch.bfloat16,
                          images_layout: str = "nhwc",
                          int_attention: bool = False,
                          plan: Optional[FsdpPlan] = None):
    """Weight-gather (FSDP) quantized ViT forward, column half
    (vit_fsdp.py:274-342; the section comment above).

    fart: this process's artifact (:func:`shard_fsdp_artifact`); images:
    the whole batch ([B, H, W, C], or host-patchified with
    ``images_layout='patches'``), the same on every process; B must
    divide over the dp x tp processes (the model line of a (dp, tp) mesh
    serves the slice of its data coordinate). Returns this process's
    logits [B/(dp tp), classes], f32: those of its slice of the images
    (``vit_tp.local_images``), equal to the single-device forward's. At
    tp > 1 every process of the line calls it.

    CUDA tensors run K1 and K4 (embed, head), K14 (a block's four weights
    a launch, one block ahead) and the single-device block's kernels,
    from ``plan`` (:func:`prepare_fsdp_kernels`, made here when not
    given); CPU tensors the plain versions, gathering over the peers'
    gloo group."""
    rank, tp = _col_axis(fart, peers)
    images = local_images(images, peers,
                          "batch {b} not divisible by device count {n}")
    b_loc = images.shape[0]
    n_real = cfg.num_tokens
    n_pad = _round_up(n_real, 16)
    dim = fart["pos_embed"].shape[-1]
    hd = dim // cfg.num_heads
    sm_scale = _sm_scale(cfg, hd)
    blocks = fart["blocks"]
    if images.device.type != "cpu":
        _raise_limits(kernel_limits(cfg, 16, batch=b_loc,
                                    fmt=blocks[0]["fc1"].fmt,
                                    float_dtype=float_dtype))
        plan = plan or prepare_fsdp_kernels(fart, cfg, peers)
        x2d = _embed_kernels(plan.embed, plan.cls_row,
                             _patches_2d(images, cfg, images_layout), b_loc,
                             cfg, dim, n_pad, float_dtype, images_layout)
        chain = uses_chain(b_loc)
        _gather_block(plan, 0)
        for i, (attn, chain_plans, mlps) in enumerate(plan.blocks):
            if i + 1 < len(plan.blocks):  # one block ahead
                _gather_block(plan, i + 1)
            if chain:
                x2d = _chain_attention(
                    chain_plans, attn, x2d, b=b_loc, n_pad=n_pad,
                    n_real=n_real, float_dtype=float_dtype,
                    int_attention=int_attention)
            else:
                x2d = run_attention_block(
                    attn, x2d.reshape(b_loc, n_pad, dim), n_valid=n_real,
                    out_dtype=float_dtype,
                    int_attention=int_attention).reshape(b_loc * n_pad, dim)
            x2d = _run_mlps(mlps, x2d, float_dtype)
        return _logits(fart, x2d, b_loc, n_pad, n_real, dim, plan.head)
    x2d = _embed_tokens(fart, images, cfg, float_dtype, images_layout, n_pad)
    gathered = _gather_block_plain(blocks[0], peers)
    for i in range(len(blocks)):
        cur = gathered
        if i + 1 < len(blocks):
            gathered = _gather_block_plain(blocks[i + 1], peers)
        x2d = _vit_block(x2d, cur, b=b_loc, n_pad=n_pad, n_real=n_real,
                         dim=dim, hd=hd, sm_scale=sm_scale,
                         float_dtype=float_dtype,
                         int_attention=int_attention)
    return _logits(fart, x2d, b_loc, n_pad, n_real, dim, None)
