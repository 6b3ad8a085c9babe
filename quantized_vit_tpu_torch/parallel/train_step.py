"""The DP x TP quantization-aware training step: the port's counterpart
of ``jit`` over ``shard_params`` (``__graft_entry__.py:dryrun_multichip``:
cross-entropy on one-hot labels, ``optax.adam(1e-3)``).

The ranks of a (dp, tp) :class:`~.partition.ProcessMesh` each hold their
shards of the ViT's params (Megatron's layout, the partition rules):

- qkv and fc1 are column-parallel, their bias column-sharded;
- proj and fc2 are row-parallel, their bias replicated and added after
  the sum;
- everything else is replicated.

The qkv column shard of ``P(None, 'model')`` is not head-aligned (at tp
= 2 rank 0 holds all of q and half of k), so the step computes on a
head-major permutation of the qkv columns (``serve/vit_tp.py:
_qkv_head_perm``): a rank's working shard is a whole [3, H/tp, hd]
block. The state holds the working shards; :func:`logical_shards` and
:func:`gather_state` give back the logical, unpermuted arrays (the
checkpoints and the tests read those).

The model axis: two ``torch.autograd.Function``s carry its traffic.
:class:`_CopyToModel` (identity forward, all-reduce backward) sits on the
input of each column-parallel layer, after that layer's input quantizer,
so the quantizer sees the whole gradient on every rank;
:class:`_ReduceFromModel` (all-reduce forward, identity backward) on the
output of each row-parallel layer, before its bias. The quantizers'
scalars (``d_quant``, ``q_m``, ``t_quant``) are replicated, but their
gradients are sums over what the rank sees: the column weights' shards
and the row layers' head- or hidden-sharded inputs and weights. Those
partial sums are all-reduced over the model axis in one exchange a step.
Every other replicated leaf's gradient is whole on every rank already.

The data axis: each model line takes its slice of the batch
(:func:`~.partition.data_sharding`); the gradients are synced with
:func:`~.collectives.dp_all_reduce_grads` (exact by default, the int8
ring with ``quantized=True``), the loss with an exact mean.

Adam is optax's formula as plain tensor ops (b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias correction), elementwise on the shards.

The all-reduces are sums in rank order: on the CPU over gloo, on the
card over CUDA IPC buffers ordered by fences (``collectives.py``). With
``QuantConfig(fused_vjp=True)`` every nonlinear quantizer's backward is
K7 on the card, on the sharded tensors.

Homogeneous ViTs only (the JAX pipeline's demand too); the step runs the
model deterministically (no dropout), as the JAX step does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.layers import (QuantConfig, _mm_cast, flatten_tree, mm_dot,
                             tree_map, unflatten_tree)
from ..models.vit import ViTConfig, _mixed_einsum, gelu
from ..quant.lsfq import (dge, lsfq_linear, lsfq_nonlinear,
                          lsfq_nonlinear_fused)
from .collectives import _exact_sum, dp_all_reduce_grads
from .partition import (ProcessMesh, data_sharding, gather_leaf,
                        shard_leaf, shard_params, spec_for_path)

_QKV = ("attn/qkv/kernel", "attn/qkv/bias")
# the layers whose quantizer-scalar gradients are partial sums under TP:
# (layer, quantizer suffixes)
_PARTIAL = (("attn/qkv", ("wt",)), ("mlp/fc1", ("wt",)),
            ("attn/proj", ("wt", "act")), ("mlp/fc2", ("wt", "act")))


def check_tp_config(cfg: ViTConfig, tp: int) -> None:
    """Refuses a config the step cannot shard tp ways (ValueError)."""
    if cfg.heads_per_block is not None or cfg.hidden_per_block is not None:
        raise ValueError("the DP x TP step requires homogeneous blocks")
    hidden = cfg.block_hidden(0)
    if cfg.num_heads % tp:
        raise ValueError(f"heads={cfg.num_heads} not divisible by tp={tp}")
    if hidden % tp:
        raise ValueError(f"mlp_hidden={hidden} not divisible by tp={tp}")


# ---------------------------------------------------------------------------
# the model axis's traffic
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, peers) -> torch.Tensor:
    return _exact_sum([x], peers)[0]


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (sum over the model axis) backward."""

    @staticmethod
    def forward(ctx, x, peers):
        ctx.peers = peers
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.peers), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, peers):
        return _all_reduce(x.contiguous(), peers)

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# the forward on a rank's working shards (models/vit.py's ops, in order)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ctx:
    cfg: ViTConfig
    q: QuantConfig
    peers: Any  # the model axis (None at tp = 1)
    clips: Dict[str, torch.Tensor]


def _quant(x, p, suffix: str, c: _Ctx):
    """``models/layers.py:_QuantLayer._quantize`` on a params dict."""
    q = c.q
    d, q_m = p[f"d_quant_{suffix}"], p[f"q_m_{suffix}"]
    clip = q.weight_clip if suffix == "wt" else q.act_clip
    clip_val = c.clips[suffix]
    if q.use_dge:
        return dge(x, d, q_m, clip_val, 0.0, q.dge_bits)
    if q.nonlinear:
        t = p[f"t_quant_{suffix}"]
        if q.fused_vjp:
            return lsfq_nonlinear_fused(x, d, q_m, t, clip[0], clip[1], 0.0)
        return lsfq_nonlinear(x, d, q_m, t, clip, 0.0)
    return lsfq_linear(x, d, q_m, clip_val, 0.0)


def _dense(p, x, c: _Ctx, kind: Optional[str] = None,
           q: Optional[QuantConfig] = None):
    """``QuantDense.forward``; ``kind`` 'col' puts :class:`_CopyToModel` on
    the quantized input, 'row' :class:`_ReduceFromModel` on the product
    (before the bias)."""
    q = c.q if q is None else q
    kernel = p["kernel"]
    if q.enabled:
        kernel = _quant(kernel, p, "wt", c)
        if q.quantize_acts:
            x = _quant(x, p, "act", c)
    if kind == "col" and c.peers is not None:
        x = _CopyToModel.apply(x, c.peers)
    xd, kd, mixed = _mm_cast(q, x, kernel)
    y = mm_dot(xd, kd, mixed)
    if kind == "row" and c.peers is not None:
        y = _ReduceFromModel.apply(y, c.peers)
    if p.get("bias") is not None:
        y = y + p["bias"]
    return y


def _layer_norm(p, x, eps: float = 1e-6):
    x = x.to(torch.float32)
    mean = x.mean(-1, keepdim=True)
    mean2 = (x * x).mean(-1, keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * p["scale"]
    return (x - mean) * mul + p["bias"]


def _patch_embed(p, x, c: _Ctx):
    """``QuantConv``'s patch path (stride = kernel, VALID)."""
    q, ps, dim = c.q, c.cfg.patch_size, c.cfg.embed_dim
    kernel = _quant(p["kernel"], p, "wt", c) if q.enabled else p["kernel"]
    b, h, w, ch = x.shape
    xp = x.reshape(b, h // ps, ps, w // ps, ps, ch).permute(
        0, 1, 3, 2, 4, 5).reshape(b * (h // ps) * (w // ps), ps * ps * ch)
    if q.enabled and q.quantize_acts:
        xp = _quant(xp, p, "act", c)
    xd, kd, mixed = _mm_cast(q, xp, kernel.reshape(ps * ps * ch, dim))
    y = mm_dot(xd, kd, mixed).reshape(b, h // ps, w // ps, dim)
    if p.get("bias") is not None:
        y = y + p["bias"]
    return y.reshape(b, (h // ps) * (w // ps), dim)


def _block(p, x, c: _Ctx, tp: int):
    cfg = c.cfg
    hd = cfg.embed_dim // cfg.num_heads
    h = cfg.num_heads // tp
    scale = cfg.qk_scale if cfg.qk_scale is not None else hd**-0.5
    b, n, _ = x.shape
    y = _layer_norm(p["norm1"], x)
    qkv = _dense(p["attn"]["qkv"], y, c, "col").reshape(
        b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
    att = _mixed_einsum("bhnd,bhmd->bhnm", qkv[0], qkv[1], c.q) * scale
    att = torch.softmax(att, dim=-1)
    out = _mixed_einsum("bhnm,bhmd->bhnd", att, qkv[2], c.q)
    out = out.permute(0, 2, 1, 3).reshape(b, n, h * hd)
    x = x + _dense(p["attn"]["proj"], out, c, "row")
    y = gelu(_dense(p["mlp"]["fc1"], _layer_norm(p["norm2"], x), c, "col"))
    return x + _dense(p["mlp"]["fc2"], y, c, "row")


def tp_forward(params, images, cfg: ViTConfig, peers=None):
    """The ViT forward on a rank's working shards (:func:`init_train_state`)
    at the model axis ``peers`` (None: tp = 1, the whole params): the
    logits of ``images``, the same on every rank of the line."""
    tp = 1 if peers is None else peers.tp
    dev = images.device
    q = cfg.quant_config
    c = _Ctx(cfg=cfg, q=q, peers=peers if tp > 1 else None, clips={
        "wt": torch.tensor(q.weight_clip, device=dev),
        "act": torch.tensor(q.act_clip, device=dev)})
    x = _patch_embed(params["patch_embed"]["proj"], images, c)
    b = x.shape[0]
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    for i in range(cfg.depth):
        x = _block(params[f"blocks_{i}"], x, c, tp)
    x = _layer_norm(params["norm"], x)[:, 0]
    if cfg.representation_size is not None:
        x = torch.tanh(_dense(params["pre_logits"], x, c,
                              q=QuantConfig.off()))
    if cfg.num_classes > 0:
        x = _dense(params["head"], x, c)
    return x


# ---------------------------------------------------------------------------
# the working layout: head-major qkv columns
# ---------------------------------------------------------------------------


def _qkv_perm(cfg: ViTConfig, tp: int, device) -> torch.Tensor:
    from ..serve.vit_tp import _qkv_head_perm

    hd = cfg.embed_dim // cfg.num_heads
    return torch.from_numpy(_qkv_head_perm(cfg.num_heads, hd, tp)).to(device)


def _is_qkv(path: str) -> bool:
    return path.endswith(_QKV)


def working_shards(params, mesh: ProcessMesh, cfg: ViTConfig):
    """This rank's working shards of the whole logical tree ``params``
    (the same on every rank): the qkv columns permuted head-major, then
    the partition rules' shards."""
    tp = mesh.shape["model"]
    check_tp_config(cfg, tp)
    flat = {}
    for k, v in flatten_tree(params).items():
        if _is_qkv(k):
            v = v.index_select(v.ndim - 1, _qkv_perm(cfg, tp, v.device))
        flat[k] = v
    return shard_params(unflatten_tree(flat), mesh)


def logical_shards(tree, mesh: ProcessMesh, cfg: ViTConfig):
    """The partition rules' shards of the logical (unpermuted) arrays of
    a tree of working shards (params, moments or gradients; a collective
    call: the qkv leaves are gathered over the model axis)."""
    tp = mesh.shape["model"]
    out = {}
    for k, v in flatten_tree(tree).items():
        if _is_qkv(k) and tp > 1:
            spec = spec_for_path(k)
            full = gather_leaf(v, spec, mesh)
            inv = torch.argsort(_qkv_perm(cfg, tp, full.device))
            v = shard_leaf(full.index_select(full.ndim - 1, inv), spec, mesh,
                           k)
        out[k] = v
    return unflatten_tree(out)


def working_from_logical(shards, mesh: ProcessMesh, cfg: ViTConfig):
    """Inverse of :func:`logical_shards` (a collective call)."""
    tp = mesh.shape["model"]
    out = {}
    for k, v in flatten_tree(shards).items():
        if _is_qkv(k) and tp > 1:
            spec = spec_for_path(k)
            full = gather_leaf(v, spec, mesh)
            v = shard_leaf(full.index_select(
                full.ndim - 1, _qkv_perm(cfg, tp, full.device)), spec, mesh,
                k)
        out[k] = v
    return unflatten_tree(out)


def gather_state(tree, mesh: ProcessMesh, cfg: ViTConfig):
    """The whole logical arrays of a tree of working shards, on every rank
    (a collective call)."""
    from .partition import gather_params

    return gather_params(logical_shards(tree, mesh, cfg), mesh)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """A rank's working shards (:func:`working_shards`) of the params and
    of Adam's moments, and Adam's step count."""

    params: Dict[str, Any]
    mu: Dict[str, Any]
    nu: Dict[str, Any]
    count: int = 0


def init_train_state(params, mesh: ProcessMesh, cfg: ViTConfig
                     ) -> TrainState:
    """The state of the whole logical tree ``params`` (the same on every
    rank): its working shards and zero moments (``optax.adam``'s init)."""
    mine = working_shards(params, mesh, cfg)
    zeros = tree_map(lambda t: torch.zeros_like(t), mine)
    return TrainState(params=mine, mu=zeros,
                      nu=tree_map(lambda t: torch.zeros_like(t), mine))


def _model_partial_sync(grads: Dict[str, torch.Tensor], peers,
                        depth: int) -> None:
    """All-reduce, over the model axis, the quantizer scalars' gradients
    that are partial sums under TP (one exchange; in place in the flat
    dict ``grads``)."""
    keys = [f"blocks_{i}/{layer}/{nm}_{s}"
            for i in range(depth) for layer, suffixes in _PARTIAL
            for s in suffixes for nm in ("d_quant", "q_m", "t_quant")]
    keys = [k for k in keys if k in grads]
    if not keys:
        return
    for k, v in zip(keys, _exact_sum([grads[k] for k in keys], peers)):
        grads[k] = v


def _one_hot_ce(logits, labels, num_classes: int):
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(
        logits.dtype)
    return -torch.mean(torch.sum(torch.log_softmax(logits, dim=-1) * onehot,
                                 dim=-1))


def loss_and_grads(params, images, labels, cfg: ViTConfig,
                   mesh: ProcessMesh, quantized: bool = False,
                   block: int = 256, sync_data: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(loss, grads) of a rank's working shards ``params`` on the whole
    batch ``images`` [B, H, W, C] / ``labels`` [B] (the same on every
    rank; the rank takes its data line's slice): the mean cross-entropy
    over the batch (synced over the data axis, exact) and the gradients
    of its shards, synced over both axes (the data axis exact, or on the
    int8 ring with ``quantized``; ``sync_data=False`` leaves the data
    axis out: the loss and gradients of the line's own slice). A
    collective call."""
    tp = mesh.shape["model"]
    check_tp_config(cfg, tp)
    images = data_sharding(mesh, images.ndim)(images)
    labels = data_sharding(mesh, 1)(labels)
    leaves = flatten_tree(params)
    live = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    mpeers = mesh.peers("model") if tp > 1 else None
    logits = tp_forward(unflatten_tree(live), images, cfg, mpeers)
    loss = _one_hot_ce(logits, labels, cfg.num_classes)
    got = torch.autograd.grad(loss, list(live.values()))
    grads = dict(zip(live, got))
    if tp > 1:
        _model_partial_sync(grads, mpeers, cfg.depth)
    dpeers = (mesh.peers("data") if mesh.shape["data"] > 1 and sync_data
              else None)
    grads = dp_all_reduce_grads(unflatten_tree(grads), dpeers,
                                quantized=quantized, block=block)
    loss = loss.detach()
    if dpeers is not None:
        loss = _exact_sum([loss.reshape(1)], dpeers)[0][0] / dpeers.tp
    return loss, grads


def adam_update(state: TrainState, grads, lr: float = 1e-3,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> TrainState:
    """``optax.adam(lr)``'s update and ``optax.apply_updates``, leaf by
    leaf as plain tensor ops (f32)."""
    count = state.count + 1
    out = {"params": {}, "mu": {}, "nu": {}}
    p_flat, g_flat = flatten_tree(state.params), flatten_tree(grads)
    m_flat, v_flat = flatten_tree(state.mu), flatten_tree(state.nu)
    for k, p in p_flat.items():
        g = g_flat[k]
        mu = (1 - b1) * g + b1 * m_flat[k]
        nu = (1 - b2) * (g * g) + b2 * v_flat[k]
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        mu_hat = mu / c1.to(mu.device)
        nu_hat = nu / c2.to(nu.device)
        u = mu_hat / (torch.sqrt(nu_hat + 0.0) + eps)
        out["params"][k] = (p + (-lr) * u).detach()
        out["mu"][k], out["nu"][k] = mu, nu
    return TrainState(params=unflatten_tree(out["params"]),
                      mu=unflatten_tree(out["mu"]),
                      nu=unflatten_tree(out["nu"]), count=count)


def train_step(state: TrainState, images, labels, cfg: ViTConfig,
               mesh: ProcessMesh, lr: float = 1e-3, quantized: bool = False,
               block: int = 256):
    """One DP x TP QAT step (module docstring): (new state, loss, synced
    gradients of this rank's working shards). A collective call."""
    loss, grads = loss_and_grads(state.params, images, labels, cfg, mesh,
                                 quantized=quantized, block=block)
    return adam_update(state, grads, lr), loss, grads


def state_from_params(shards, mesh: ProcessMesh, cfg: ViTConfig,
                      count: int = 0) -> TrainState:
    """The state of a rank's logical shards of the params (a sharded
    checkpoint's, which holds the params as the JAX package's does):
    their working shards, zero moments and Adam's step ``count`` (a
    collective call)."""
    mine = working_from_logical(shards, mesh, cfg)
    return TrainState(params=mine,
                      mu=tree_map(lambda t: torch.zeros_like(t), mine),
                      nu=tree_map(lambda t: torch.zeros_like(t), mine),
                      count=int(count))
