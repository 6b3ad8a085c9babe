"""Tensor-parallel INT4 ViT serving with hand-placed collectives (port of
``quantized_vit_tpu/serve/vit_tp.py``).

The 'model' axis is the tp processes of a :class:`~..parallel.Peers` (one
card shared, or the cards of one host; ``peers=None`` is tp = 1): the
default group (the mesh (1, tp)), or one model line of a (dp, tp)
:class:`~..parallel.ProcessMesh` (``mesh.peers("model")``), whose data
coordinate says which slice of the batch the line serves. Each of the
dp x tp processes takes B/(dp x tp) images and runs its tp group's
collectives, as the JAX function's ``shard_map`` does. As in the JAX
function:

- the residual stream stays sequence-sharded: each process owns the rows
  of its own images (LayerNorm, quantization and the residual adds run
  tp-way parallel);
- qkv and fc1 are column-parallel, the qkv columns permuted head-major
  (:func:`permute_qkv_entry`) so that a contiguous shard is a valid
  [3, H/tp, hd] block and attention stays local;
- the all-gather into each column matmul carries int8 levels (the
  LayerNorm + quantize runs before it: :func:`_ln_quant`);
- proj and fc2 are row-parallel; their partials go through a
  reduce-scatter back to the sequence shards;
- a block issues exactly 2 all-gathers (int8 [M, D]) and 2
  reduce-scatters ([M, D] in ``comm_dtype``), nothing else
  (``parallel/tp_comm.py`` counts them).

On the card a block runs the levels-only K1 launch
(:func:`~..ops.fused.run_ln_levels`), K14's all-gather, K1 qkv (prologue
None), K6 on the process's H/tp heads with quantized output, K1 proj
partials, the reduce-scatter, then the same pair for fc1 (K1 with the
GELU + quant epilogue) and fc2. Every batch takes this chain, as the JAX
function does (no K3 route). The embedding (K1 + K4) runs on the
process's own images, the head (K1) on its own cls rows after the TP
function's own LayerNorm (f32, not rounded to ``float_dtype`` first).

comm_dtype: f32 reproduces the single-device accumulation closely (the
parity mode); bf16 is the serving default (one more rounding of the
partial sums).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.vit import ViTConfig
from ..ops.attention import (QkvAttentionPlan, attention_qkv_plain,
                             plan_attention_qkv, qkv_kernel_limit,
                             run_attention_qkv)
from ..ops.fused import (LevelsPlan, MatmulPlan, ln_quant_levels_plain,
                         plan_ln_levels, plan_matmul, run_ln_levels,
                         run_matmul)
from ..parallel.distributed import check_mesh
from ..parallel.tp_comm import (AllGather, ReduceScatter, all_gather_plain,
                                plan_all_gather, plan_reduce_scatter,
                                reduce_scatter_plain, run_all_gather,
                                run_reduce_scatter)
from ..quant.packing import pack_int4, unpack_int4
from .vit_int4 import (QLayerArtifact, _embed_head_plans, _embed_kernels,
                       _embed_tokens, _patches_2d, _qmatmul, _raise_limits,
                       _round_up, _sm_scale)

# ---------------------------------------------------------------------------
# artifact preparation: head-major qkv columns + shard placement
# ---------------------------------------------------------------------------


def _qkv_head_perm(heads: int, head_dim: int, tp: int) -> np.ndarray:
    """Column permutation [3*H*hd] -> head-major-by-shard order
    (vit_tp.py:66-81): shard i of the permuted matrix is itself a valid
    [3, H/tp, hd] block for heads [i*H/tp, (i+1)*H/tp)."""
    if heads % tp:
        raise ValueError(f"heads={heads} not divisible by tp={tp}")
    h_loc = heads // tp
    cols = np.arange(3 * heads * head_dim).reshape(3, heads, head_dim)
    return np.transpose(
        cols.reshape(3, tp, h_loc, head_dim), (1, 0, 2, 3)).reshape(-1)


def permute_qkv_entry(e: QLayerArtifact, heads: int, head_dim: int,
                      tp: int) -> QLayerArtifact:
    """A fused-qkv entry with its output columns head-major
    (:func:`_qkv_head_perm`): the columns of w, and of a vector scale and
    the bias. Packing is along K (axis 0), so the same column gather
    serves packed int4 and int8."""
    perm = torch.from_numpy(_qkv_head_perm(heads, head_dim, tp)).to(
        e.w.device)
    scale = e.scale
    if isinstance(scale, torch.Tensor) and scale.ndim == 1:
        scale = scale.index_select(0, perm)
    return dataclasses.replace(
        e, w=e.w.index_select(1, perm), scale=scale,
        bias=None if e.bias is None else e.bias.index_select(0, perm))


def repack_row_parallel_entry(e: QLayerArtifact, tp: int) -> QLayerArtifact:
    """A row-parallel int4 entry re-packed per shard (vit_tp.py:99-125).

    Packed int4 pairs global rows (k, k + K/2) in a byte, so a plain row
    shard of the packed [K/2, N] array would decode to rows [i*K/(2tp),
    ...) and [K/2 + i*K/(2tp), ...), not the contiguous rows [i*K/tp,
    (i+1)*K/tp) that shard i's activations cover: silently wrong logits.
    So: unpack, split K into tp contiguous chunks, pack within each chunk,
    concatenate. int8 entries (and tp = 1) pass through."""
    if tp == 1 or e.fmt != "int4":
        return e
    w_full = unpack_int4(e.w, axis=0)
    k = w_full.shape[0]
    if k % (2 * tp):
        raise ValueError(
            f"row-parallel int4 repack needs K divisible by 2*tp; "
            f"got K={k}, tp={tp}")
    w_new = torch.cat([pack_int4(c, axis=0)
                       for c in torch.split(w_full, k // tp, dim=0)])
    return dataclasses.replace(e, w=w_new)


def prepare_tp_artifact(art: Dict[str, Any], cfg: ViTConfig, tp: int):
    """Single-device serving artifact -> TP-ready artifact
    (vit_tp.py:128-147): the qkv columns permuted head-major for this tp,
    the row-parallel entries (proj, fc2) re-packed per shard when packed
    int4. Everything else unchanged; :func:`shard_tp_artifact` takes a
    process's shards."""
    hd = cfg.embed_dim // cfg.num_heads
    out = dict(art)
    out["blocks"] = []
    for b in art["blocks"]:
        heads = b["qkv"].w.shape[1] // (3 * hd)
        nb = dict(b)
        nb["qkv"] = permute_qkv_entry(b["qkv"], heads, hd, tp)
        nb["proj"] = repack_row_parallel_entry(b["proj"], tp)
        nb["fc2"] = repack_row_parallel_entry(b["fc2"], tp)
        out["blocks"].append(nb)
    return out


# the specs: "col" (split the last axis over the processes), "row" (the
# first axis), "rep" (every process holds it whole); the counterparts of
# P(None, 'model'), P('model', None) and P()
_COL, _ROW, _REP = "col", "row", "rep"


def _qentry_specs(e: QLayerArtifact, kind: str,
                  bias: Optional[str] = None) -> QLayerArtifact:
    """The spec tree of one entry (vit_tp.py:150-162): w by ``kind``, the
    bias by ``bias`` (default: column-sharded with a column weight), the
    rest replicated."""
    bias = bias or (_COL if kind == _COL else _REP)
    return dataclasses.replace(
        e, w=kind, scale=_REP, bias=None if e.bias is None else bias,
        act={k: _REP for k in e.act})


def _rep(tree):
    if isinstance(tree, dict):
        return {k: _rep(v) for k, v in tree.items()}
    return _REP


def tp_artifact_specs(art: Dict[str, Any]):
    """The spec tree of a (TP-prepared) artifact (vit_tp.py:165-192): qkv
    and fc1 column-sharded, proj and fc2 row-sharded, the rest
    replicated."""
    out = {
        "patch_embed": _qentry_specs(art["patch_embed"], _REP),
        "cls_token": _REP,
        "pos_embed": _REP,
        "norm": _rep(art["norm"]),
        "blocks": [
            {
                "norm1": _rep(b["norm1"]),
                "qkv": _qentry_specs(b["qkv"], _COL),
                "proj": _qentry_specs(b["proj"], _ROW),
                "norm2": _rep(b["norm2"]),
                "fc1": _qentry_specs(b["fc1"], _COL),
                "fc2": _qentry_specs(b["fc2"], _ROW),
            }
            for b in art["blocks"]
        ],
    }
    if "pre_logits" in art:
        out["pre_logits"] = _rep(art["pre_logits"])
    if "head" in art:
        out["head"] = _qentry_specs(art["head"], _REP)
    return out


def _take(t, spec: str, rank: int, tp: int, what: str):
    """Process ``rank``'s part of ``t`` under ``spec``."""
    if spec == _REP or t is None:
        return t
    axis = -1 if spec == _COL else 0
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"{what}: {'columns' if spec == _COL else 'rows'} "
                         f"{n} not divisible by tp={tp}")
    s = n // tp
    part = t[..., rank * s:(rank + 1) * s] if spec == _COL else \
        t[rank * s:(rank + 1) * s]
    return part.contiguous()


def _apply(tree, specs, rank, tp, what=""):
    if isinstance(tree, QLayerArtifact):
        return dataclasses.replace(
            tree, w=_take(tree.w, specs.w, rank, tp, what + ".w"),
            scale=_take(tree.scale, specs.scale, rank, tp, what),
            bias=_take(tree.bias, specs.bias, rank, tp, what + ".bias"))
    if isinstance(tree, dict):
        return {k: _apply(v, specs[k], rank, tp, f"{what}.{k}".lstrip("."))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_apply(v, s, rank, tp, f"{what}[{i}]")
                for i, (v, s) in enumerate(zip(tree, specs))]
    return _take(tree, specs, rank, tp, what)


def shard_tp_artifact(art: Dict[str, Any], rank: int, tp: int):
    """Process ``rank``'s entries of a TP-prepared artifact
    (:func:`prepare_tp_artifact`) under :func:`tp_artifact_specs` (the
    counterpart of ``shard_tp_artifact``'s ``device_put``): qkv and fc1
    column shards (their bias by column), proj and fc2 row shards, the rest
    shared as is."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    out = _apply(art, tp_artifact_specs(art), rank, tp)
    out["tp"] = (rank, tp)
    return out


def _layout(peers) -> Tuple[int, int]:
    """(tp, dp) of ``peers`` (None: one process)."""
    return (1, 1) if peers is None else (peers.tp, getattr(peers, "dp", 1))


def local_images(images, peers, message: str):
    """This process's images of the whole batch ``images``: the
    (data_index x tp + rank)-th of dp x tp equal slices (the order of
    ``P(('data', 'model'))``); ``message`` formats the refusal of a batch
    that does not divide, with ``b`` and ``n``. A layout whose dp x tp
    processes are not the group's is refused too (``check_mesh``)."""
    tp, dp = _layout(peers)
    b, n = images.shape[0], dp * tp
    if b % n:
        raise ValueError(message.format(b=b, n=n))
    if n > 1:
        check_mesh(dp, tp)
    b_loc = b // n
    g = 0 if peers is None else (getattr(peers, "data_index", 0) * tp
                                 + peers.rank)
    return images[g * b_loc:(g + 1) * b_loc]


def _axis(tart, peers) -> Tuple[int, int]:
    rank, tp = (0, 1) if peers is None else (peers.rank, peers.tp)
    if tart.get("tp") != (rank, tp):
        raise ValueError(f"artifact sharded for (rank, tp) = "
                         f"{tart.get('tp')}, run at {(rank, tp)}; make it "
                         "with prepare_tp_artifact + shard_tp_artifact")
    return rank, tp


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _ln_quant(x, ln, entry: QLayerArtifact, ln_eps: float = 1e-6):
    """LayerNorm + LSFQ quantize to a layer's int8 input levels
    (vit_tp.py:201-218), plain version: the same folded f32 math as K1's
    ``ln_quant`` prologue, run alone so the levels can be all-gathered."""
    return ln_quant_levels_plain(
        x, ln["scale"], ln["bias"], act_d=entry.act["d"],
        act_t=entry.act["t"], act_top=entry.top, act_pow=entry.act_pow,
        ln_eps=ln_eps)


def _plan_levels(ln, entry: QLayerArtifact, device) -> LevelsPlan:
    return plan_ln_levels(ln["scale"], ln["bias"], act_d=entry.act["d"],
                          act_t=entry.act["t"], act_top=entry.top,
                          act_pow=entry.act_pow, device=device)


def _f32_or_none(v, device):
    return None if v is None else torch.as_tensor(
        v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class TpBlockPlan:
    """One block's kernel plans on a process's shards: the levels launch
    before each all-gather, K1 qkv (prologue None), K6 on the process's
    heads (quantized output for proj), K1 proj (partials, no bias), K1
    fc1 (GELU + quant epilogue), K1 fc2 (partials, no bias), and the
    row-parallel biases added after each reduce-scatter."""

    levels1: LevelsPlan
    qkv: MatmulPlan
    attn: QkvAttentionPlan
    proj: MatmulPlan
    proj_bias: Optional[torch.Tensor]
    levels2: LevelsPlan
    fc1: MatmulPlan
    fc2: MatmulPlan
    fc2_bias: Optional[torch.Tensor]


@dataclasses.dataclass
class TpPlan:
    """A process's TP artifact prepared for the kernels, once
    (:func:`prepare_tp_kernels`): the embed and head plans (K1, K4), the
    block plans, and per (batch, comm dtype) the all-gather and
    reduce-scatter buffers (:meth:`comm`, made at a batch size's first
    forward: a collective step, so every process must run the same batch
    sizes in the same order)."""

    embed: Dict[str, Tuple[MatmulPlan, torch.Tensor, torch.Tensor]]
    cls_row: torch.Tensor
    head: Optional[MatmulPlan]
    blocks: List[TpBlockPlan]
    dim: int
    n_pad: int
    peers: object
    buffers: Dict[tuple, Tuple[AllGather, ReduceScatter]] = \
        dataclasses.field(default_factory=dict)

    def comm(self, batch: int, comm_dtype) -> Tuple[AllGather,
                                                    ReduceScatter]:
        """The collectives' buffers of a forward of ``batch`` images (the
        whole batch, over every data line)."""
        key = (batch, comm_dtype)
        if key not in self.buffers:
            tp, dp = _layout(self.peers)
            m_loc = batch // (dp * tp) * self.n_pad
            dev = self.cls_row.device
            peers = self.peers if tp > 1 else None
            self.buffers[key] = (
                plan_all_gather(m_loc, self.dim, peers, dev),
                plan_reduce_scatter(m_loc, self.dim, comm_dtype, peers, dev))
        return self.buffers[key]


def prepare_tp_kernels(tart, cfg: ViTConfig, peers=None, batches=(),
                       comm_dtype=torch.bfloat16) -> TpPlan:
    """The kernel plans of :class:`TpPlan` for this process's TP artifact
    (:func:`shard_tp_artifact`, tensors on a CUDA device), and the
    collectives' buffers of each of ``batches`` (at tp > 1 a collective
    call: every process makes it with the same batches). Raises a
    ValueError when K6 cannot take ``cfg``'s head_dim."""
    _axis(tart, peers)
    dim = tart["pos_embed"].shape[-1]
    hd = dim // cfg.num_heads
    _raise_limits([qkv_kernel_limit(hd)])
    sm_scale = _sm_scale(cfg, hd)
    dev = tart["blocks"][0]["qkv"].w.device if tart["blocks"] else \
        tart["pos_embed"].device
    embed, cls_row, head = _embed_head_plans(tart, cfg)
    blocks = []
    for blk in tart["blocks"]:
        qkv_e, proj_e = blk["qkv"], blk["proj"]
        fc1_e, fc2_e = blk["fc1"], blk["fc2"]
        blocks.append(TpBlockPlan(
            levels1=_plan_levels(blk["norm1"], qkv_e, dev),
            qkv=plan_matmul(qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
                            prologue=None),
            attn=plan_attention_qkv(
                dev, heads=qkv_e.w.shape[1] // (3 * hd), sm_scale=sm_scale,
                out_d=proj_e.act["d"], out_t=proj_e.act["t"],
                out_top=proj_e.top, out_pow=proj_e.act_pow),
            proj=plan_matmul(proj_e.w, proj_e.scale, None, fmt=proj_e.fmt,
                             prologue=None),
            proj_bias=_f32_or_none(proj_e.bias, dev),
            levels2=_plan_levels(blk["norm2"], fc1_e, dev),
            fc1=plan_matmul(fc1_e.w, fc1_e.scale, fc1_e.bias, fmt=fc1_e.fmt,
                            prologue=None, epilogue="gelu_quant",
                            out_d=fc2_e.act["d"], out_t=fc2_e.act["t"],
                            out_top=fc2_e.top, out_pow=fc2_e.act_pow),
            fc2=plan_matmul(fc2_e.w, fc2_e.scale, None, fmt=fc2_e.fmt,
                            prologue=None),
            fc2_bias=_f32_or_none(fc2_e.bias, dev)))
    plan = TpPlan(embed=embed, cls_row=cls_row, head=head, blocks=blocks,
                  dim=dim, n_pad=_round_up(cfg.num_tokens, 16), peers=peers)
    for b in batches:
        plan.comm(b, comm_dtype)
    return plan


def _residual(x2d, part, bias, float_dtype):
    """x + reduce_scatter(partials) + bias in f32 (vit_tp.py:292-293)."""
    y = x2d.to(torch.float32) + part.to(torch.float32)
    if bias is not None:
        y = y + bias
    return y.to(float_dtype)


def _tp_head(art, x2d, b_loc, n_pad, n_real, dim, head: Optional[MatmulPlan]):
    """The head on this process's own cls rows (vit_tp.py:316-326): the
    TP function's own LayerNorm (two-pass, f32, not rounded to the
    residual dtype first), pre-logits, then K1 (``head``) or its plain
    version."""
    x = x2d.reshape(b_loc, n_pad, dim)[:, n_real - 1].to(torch.float32)
    nrm = art["norm"]
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-6) * nrm["scale"] + nrm["bias"]
    if "pre_logits" in art:
        x = torch.tanh(x @ art["pre_logits"]["kernel"]
                       + art["pre_logits"]["bias"])
    if "head" in art:
        x = (run_matmul(head, x, out_dtype=torch.float32) if head is not None
             else _qmatmul(x, art["head"], torch.float32))
    return x


@torch.no_grad()
def vit_int4_forward_tp(tart, images, cfg: ViTConfig, peers=None,
                        float_dtype=torch.bfloat16,
                        comm_dtype=torch.bfloat16,
                        images_layout: str = "nhwc",
                        plan: Optional[TpPlan] = None):
    """Tensor-parallel quantized ViT forward (module docstring;
    vit_tp.py:221-335).

    tart: this process's TP artifact (:func:`prepare_tp_artifact` then
    :func:`shard_tp_artifact`); images: the whole batch ([B, H, W, C], or
    host-patchified with ``images_layout='patches'``), the same on every
    process; B must divide over the dp x tp processes (a ValueError
    otherwise). Returns this process's logits [B/(dp tp), classes], f32:
    those of its slice of the images (:func:`local_images`). At tp > 1
    every process of the group calls it.

    CUDA tensors run the kernels from ``plan`` (:func:`prepare_tp_kernels`,
    made here when not given; a caller that serves many batches keeps
    it); CPU tensors the plain versions, the collectives over the peers'
    gloo group."""
    rank, tp = _axis(tart, peers)
    b = images.shape[0]
    images = local_images(images, peers,
                          "batch {b} not divisible by dp*tp={n}")
    b_loc = images.shape[0]
    b_grp = b_loc * tp
    n_real = cfg.num_tokens
    n_pad = _round_up(n_real, 16)
    dim = tart["pos_embed"].shape[-1]
    hd = dim // cfg.num_heads
    sm_scale = _sm_scale(cfg, hd)
    if images.device.type != "cpu":
        plan = plan or prepare_tp_kernels(tart, cfg, peers)
        ag, rs = plan.comm(b, comm_dtype)
        x2d = _embed_kernels(plan.embed, plan.cls_row,
                             _patches_2d(images, cfg, images_layout), b_loc,
                             cfg, dim, n_pad, float_dtype, images_layout)
        for bp in plan.blocks:
            # attention: int8 all-gather -> column qkv -> local heads ->
            # row proj partials -> reduce-scatter
            run_ln_levels(bp.levels1, x2d, out=ag.levels)
            lv_all = run_all_gather(ag)
            qkv = run_matmul(bp.qkv, lv_all, out_dtype=float_dtype)
            alv = run_attention_qkv(bp.attn, qkv.reshape(b_grp, n_pad, -1),
                                    n_valid=n_real, out_dtype=float_dtype)
            run_matmul(bp.proj, alv.reshape(b_grp * n_pad, -1),
                       out_dtype=comm_dtype, out=rs.partials)
            x2d = _residual(x2d, run_reduce_scatter(rs), bp.proj_bias,
                            float_dtype)
            # MLP: int8 all-gather -> column fc1 (+GELU+quant) -> row fc2
            run_ln_levels(bp.levels2, x2d, out=ag.levels)
            hlv = run_matmul(bp.fc1, run_all_gather(ag))
            run_matmul(bp.fc2, hlv, out_dtype=comm_dtype, out=rs.partials)
            x2d = _residual(x2d, run_reduce_scatter(rs), bp.fc2_bias,
                            float_dtype)
        return _tp_head(tart, x2d, b_loc, n_pad, n_real, dim, plan.head)
    x2d = _embed_tokens(tart, images, cfg, float_dtype, images_layout, n_pad)
    for blk in tart["blocks"]:
        proj_e, fc2_e = blk["proj"], blk["fc2"]
        heads_loc = blk["qkv"].w.shape[1] // (3 * hd)
        lv_all = all_gather_plain(_ln_quant(x2d, blk["norm1"], blk["qkv"]),
                                  peers)
        qkv = _qmatmul(lv_all, blk["qkv"], float_dtype, prologue=None)
        alv = attention_qkv_plain(
            qkv.reshape(b_grp, n_pad, 3 * heads_loc * hd), heads=heads_loc,
            sm_scale=sm_scale, n_valid=n_real, out_d=proj_e.act["d"],
            out_t=proj_e.act["t"], out_top=proj_e.top,
            out_pow=proj_e.act_pow, out_dtype=float_dtype)
        part = _qmatmul(alv.reshape(b_grp * n_pad, heads_loc * hd), proj_e,
                        torch.float32, prologue=None, bias=None)
        x2d = _residual(x2d, reduce_scatter_plain(part.to(comm_dtype),
                                                  peers), proj_e.bias,
                        float_dtype)
        lv2_all = all_gather_plain(_ln_quant(x2d, blk["norm2"], blk["fc1"]),
                                   peers)
        hlv = _qmatmul(lv2_all, blk["fc1"], float_dtype, prologue=None,
                       epilogue="gelu_quant", out_d=fc2_e.act["d"],
                       out_t=fc2_e.act["t"], out_top=fc2_e.top,
                       out_pow=fc2_e.act_pow)
        part2 = _qmatmul(hlv, fc2_e, torch.float32, prologue=None, bias=None)
        x2d = _residual(x2d, reduce_scatter_plain(part2.to(comm_dtype),
                                                  peers), fc2_e.bias,
                        float_dtype)
    return _tp_head(tart, x2d, b_loc, n_pad, n_real, dim, None)
