"""Pipeline parallelism over transformer blocks, the GPipe schedule (port
of ``quantized_vit_tpu/parallel/pipeline.py``).

The homogeneous ViT blocks are stacked along a leading stage axis
(:func:`stack_block_params`); stage s of the ``pipe`` axis of a
:class:`~.partition.ProcessMesh` holds blocks [s * depth/S, (s + 1) *
depth/S). With S stages and M microbatches the loop runs M + S - 1 steps,
stage s processing microbatch (t - s) at step t (the fill and drain
bubbles run on zeros, as the JAX loop does). Activations pass to the
next stage with one exchange a step (the JAX ``ppermute``): a fenced
exchange of CUDA IPC buffers on the card, a gloo all-gather on the CPU
(``collectives._Wire``); the last stage's outputs then go to every rank.

Patch embedding and the head run replicated outside the pipeline.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..models.layers import flatten_tree, unflatten_tree
from .collectives import wire
from .partition import ProcessMesh


def stack_block_params(params: dict, depth: int, prefix: str = "blocks_"):
    """Stack per-block params ``blocks_0..blocks_{depth-1}`` along a new
    leading axis. Blocks must be homogeneous."""
    flats = [flatten_tree(params[f"{prefix}{i}"]) for i in range(depth)]
    return unflatten_tree({k: torch.stack([f[k] for f in flats])
                           for k in flats[0]})


def unstack_block_params(stacked, depth: int, prefix: str = "blocks_"):
    """Inverse of :func:`stack_block_params`."""
    flat = flatten_tree(stacked)
    return {f"{prefix}{i}": unflatten_tree({k: v[i] for k, v in flat.items()})
            for i in range(depth)}


def gpipe_blocks(stacked_params, x_microbatches: torch.Tensor,
                 block_apply: Callable[[Any, torch.Tensor], torch.Tensor],
                 *, mesh: ProcessMesh, axis: str = "pipe") -> torch.Tensor:
    """Run stacked blocks as a GPipe pipeline over ``mesh``'s ``axis``.

    stacked_params: tree with leading dim ``depth`` (divisible by the
    number of stages; every rank passes the whole stack and keeps its
    stage's blocks). x_microbatches: [n_micro, mb, ...], the same on
    every rank. block_apply(block_params, x) -> x applies ONE block.

    Returns [n_micro, mb, ...] outputs after all ``depth`` blocks, on
    every rank (the last stage's). A collective call over ``axis``."""
    n_stages = mesh.shape[axis]
    flat = flatten_tree(stacked_params)
    depth = next(iter(flat.values())).shape[0]
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by stages {n_stages}")
    idx = mesh.index(axis)
    per = depth // n_stages
    local = [unflatten_tree({k: v[idx * per + i] for k, v in flat.items()})
             for i in range(per)]
    n_micro = x_microbatches.shape[0]
    peers = mesh.peers(axis)

    def chain(h):
        for bp in local:
            h = block_apply(bp, h)
        return h

    buf = torch.zeros_like(x_microbatches[0])
    ys = torch.zeros_like(x_microbatches)
    last = n_micro + n_stages - 2
    for t in range(n_micro + n_stages - 1):
        feed = (x_microbatches[t] if t < n_micro else torch.zeros_like(buf))
        out = chain(feed if idx == 0 else buf)
        j = t - (n_stages - 1)
        if j >= 0 and idx == n_stages - 1:
            ys[j] = out
        if t != last and n_stages > 1:
            # ppermute to the next stage: take the previous stage's output
            buf = wire(peers).exchange([out.contiguous()])[
                (idx - 1) % n_stages][0].clone()
    if n_stages == 1:
        return ys
    # broadcast the last stage's outputs to every rank
    return wire(peers).exchange([ys])[n_stages - 1][0].clone()


def vit_pipeline_forward(model, params: dict, images: torch.Tensor, *,
                         mesh: ProcessMesh, axis: str = "pipe",
                         n_microbatches: int = 2) -> torch.Tensor:
    """Full ViT forward with the block stack pipelined over ``mesh``'s
    ``axis``: embedding (patch conv + cls + pos) and the final norm/head
    run replicated outside the pipeline; the batch is split into
    ``n_microbatches`` along dim 0 (it must divide evenly). ``model``: a
    ``VisionTransformer`` (its config); ``params``: its params tree, the
    same on every rank. Deterministic (no dropout). A collective call."""
    from .train_step import _block, _Ctx, _dense, _layer_norm, _patch_embed
    from ..models.layers import QuantConfig

    cfg = model.cfg
    b = images.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches}")
    if cfg.heads_per_block is not None or cfg.hidden_per_block is not None:
        raise ValueError("pipeline requires homogeneous blocks")
    q = cfg.quant_config
    dev = images.device
    c = _Ctx(cfg=cfg, q=q, peers=None, clips={
        "wt": torch.tensor(q.weight_clip, device=dev),
        "act": torch.tensor(q.act_clip, device=dev)})
    x = _patch_embed(params["patch_embed"]["proj"], images, c)
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    stacked = stack_block_params(params, cfg.depth)
    mb = b // n_microbatches
    y = gpipe_blocks(stacked, x.reshape(n_microbatches, mb, *x.shape[1:]),
                     lambda bp, h: _block(bp, h, c, 1), mesh=mesh, axis=axis)
    x = _layer_norm(params["norm"], y.reshape(b, *x.shape[1:]))[:, 0]
    if cfg.representation_size is not None:
        x = torch.tanh(_dense(params["pre_logits"], x, c,
                              q=QuantConfig.off()))
    if cfg.num_classes > 0:
        x = _dense(params["head"], x, c)
    return x
