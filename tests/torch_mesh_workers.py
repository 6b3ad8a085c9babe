"""Process bodies of the port's multi-device training tests: the (dp, tp)
process layout, the gradient collectives, the DP x TP step, sharded
checkpoints, elastic recovery and the GPipe forward, each run in gloo
processes started by ``quantized_vit_tpu_torch.parallel.run_processes``.

This module imports torch, numpy and the port only (a spawned process
imports it afresh; JAX would add seconds to every start). Inputs and
results are numpy: the JAX references are computed by the test files.
"""

import os

import numpy as np
import torch

from quantized_vit_tpu_torch.models import (QuantConfig, ViTConfig,
                                            flatten_tree, unflatten_tree)
from quantized_vit_tpu_torch.parallel import (
    HealthCheckError, PartitionSpec as P, collective_health_check,
    create_mesh, dp_all_reduce_grads, elastic_restore, gather_params,
    gather_state, gpipe_blocks, init_train_state, initialize_distributed,
    loss_and_grads, quantized_ring_all_reduce, reinitialize_distributed,
    restore_sharded_checkpoint, run_with_elastic_recovery,
    save_sharded_checkpoint, shard_params, stack_block_params,
    vit_pipeline_forward)
from quantized_vit_tpu_torch.parallel.collectives import _ring_leaves
from quantized_vit_tpu_torch.parallel.train_step import adam_update


def _np(tree):
    return {k: v.detach().cpu().numpy() for k, v in
            flatten_tree(tree).items()}


def _torch(flat):
    return unflatten_tree({k: torch.from_numpy(np.array(v))
                           for k, v in flat.items()})


def _regroup(rank, pairs, store_dir, tag):
    """Split the world into the groups of ``pairs`` (lists of old ranks,
    each a new gloo group on its own fresh store); returns this rank's
    (group index, new rank)."""
    for gi, members in enumerate(pairs):
        if rank in members:
            store = os.path.join(store_dir, f"{tag}_{gi}")
            reinitialize_distributed(f"file://{store}", len(members),
                                     members.index(rank))
            return gi, members.index(rank)
    raise ValueError(f"rank {rank} in no group of {pairs}")


# ---------------------------------------------------------------------------
# collectives: n = 8 (the world), 4 and 2 (regrouped subsets)
# ---------------------------------------------------------------------------


def collectives(rank, world, init_method, inputs, store_dir):
    """For n in (8, 4, 2) (the world, then regrouped subsets): the ring of
    each input (``inputs[name]`` = (per-process values [8, ...], block)),
    dp_all_reduce_grads of the tree of all inputs in both modes, and the
    per-leaf and batched rings of that tree at block 64; {n: results} of
    this rank (ranks past n sit out)."""
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device="cpu")
    out = {}
    n = world
    for step, size in enumerate((8, 4, 2)):
        if size != n:
            pairs = [list(range(size))] + [[r] for r in range(size, world)]
            gi, _ = _regroup(rank, pairs, store_dir, f"coll{step}")
            if gi:
                continue
            n = size
        mesh = create_mesh((n,), ("data",), device="cpu")
        peers = mesh.peers("data")
        me = mesh.index("data")
        tree = {k: torch.from_numpy(v[me]) for k, (v, _) in inputs.items()}
        res = {"ring": {k: quantized_ring_all_reduce(tree[k], peers,
                                                     block=b).numpy()
                        for k, (_, b) in inputs.items()}}
        res["exact"] = _np(dp_all_reduce_grads(tree, peers))
        res["exact_sum"] = _np(dp_all_reduce_grads(tree, peers, mean=False))
        res["quant"] = _np(dp_all_reduce_grads(tree, peers, quantized=True,
                                               block=64))
        res["per_leaf"] = {k: quantized_ring_all_reduce(
            v, peers, block=64).numpy() for k, v in tree.items()}
        res["batched"] = dict(zip(tree, (t.numpy() for t in _ring_leaves(
            list(tree.values()), peers, 64))))
        out[n] = res
    return out


# ---------------------------------------------------------------------------
# the DP x TP step at (2, 2), then (1, 2) and (2, 1) on regrouped pairs
# ---------------------------------------------------------------------------


def _tiny_cfg(cfg_kw):
    return ViTConfig(**cfg_kw, quant=QuantConfig(enabled=True))


def _step_result(params, images, labels, cfg, mesh):
    state = init_train_state(params, mesh, cfg)
    loss, grads = loss_and_grads(state.params, images, labels, cfg, mesh)
    new = adam_update(state, grads)
    return {"loss": float(loss), "grads": _np(gather_state(grads, mesh,
                                                            cfg)),
            "params": _np(gather_state(new.params, mesh, cfg))}


def train(rank, world, init_method, cfg_kw, params_np, images, labels,
          store_dir):
    """One step at (2, 2) on the world of 4, then at (1, 2) on ranks 0, 1
    and (2, 1) on ranks 2, 3; each layout's rank-0 result (loss, the
    gathered gradients and Adam-updated params). Plus the refusals."""
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device="cpu")
    cfg = _tiny_cfg(cfg_kw)
    params = _torch(params_np)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    out = {}
    mesh = create_mesh((2, 2), device="cpu")
    r = _step_result(params, x, y, cfg, mesh)
    if rank == 0:
        out[(2, 2)] = r
    errors = []
    for bad in (dict(cfg_kw, num_heads=1, embed_dim=64),
                dict(cfg_kw, mlp_ratio=4.0 + 1 / 64)):
        try:
            init_train_state(params, mesh, _tiny_cfg(bad))
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    gi, _ = _regroup(rank, [[0, 1], [2, 3]], store_dir, "train")
    shape = ((1, 2), (2, 1))[gi]
    mesh = create_mesh(shape, device="cpu")
    r = _step_result(params, x, y, cfg, mesh)
    if mesh.rank == 0:
        out[shape] = r
    return out


# ---------------------------------------------------------------------------
# sharded checkpoints and elastic recovery (world of 4 at (2, 2))
# ---------------------------------------------------------------------------

RULES = [(r"kernel$", P(None, "model")), (r"", P())]


def ckpt(rank, world, init_method, tree_np, store_dir, ckpt_dir):
    """Write the tree sharded at (2, 2); restore it at (2, 2), then on
    regrouped pairs at (1, 2) and (2, 1), and whole (mesh=None); the
    gathered restores and their shard shapes."""
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device="cpu")
    tree = _torch(tree_np)
    mesh = create_mesh((2, 2), device="cpu")
    extra = {"bit_layers": {"blocks_0/attn/qkv": 4.0}, "num_steps": 123}
    path = os.path.join(ckpt_dir, "ckpt_10")
    save_sharded_checkpoint(path, shard_params(tree, mesh), extra, mesh=mesh)
    back, extra2 = restore_sharded_checkpoint(path, mesh=mesh)
    out = {"extra": extra2,
           "shape22": tuple(back["blocks_0"]["attn"]["qkv"]["kernel"].shape),
           (2, 2): _np(gather_params(back, mesh))}
    gi, _ = _regroup(rank, [[0, 1], [2, 3]], store_dir, "ckpt")
    shape = ((1, 2), (2, 1))[gi]
    mesh = create_mesh(shape, device="cpu")
    back, _ = restore_sharded_checkpoint(path, mesh=mesh)
    out[shape] = _np(gather_params(back, mesh))
    out[f"fc1_{shape}"] = tuple(back["blocks_0"]["mlp"]["fc1"]["kernel"]
                                .shape)
    whole, _ = restore_sharded_checkpoint(path, mesh=None, device="cpu")
    out["whole"] = _np(whole)
    return out


def _dense_params(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {
        "kernel": torch.from_numpy(rng.standard_normal((16, 32)).astype(
            np.float32)),
        "bias": torch.from_numpy(rng.standard_normal(32).astype(
            np.float32))}}


def elastic(rank, world, init_method, store_dir, ckpt_dir):
    """tests/parallel/test_elastic.py over processes, on a world of 4 at
    (2, 2): elastic_restore onto the survivors 0-2 (shrunk to (1, 2)),
    the supervisor's recovery with a failure injected at the third
    health check (steps 0, 1 on 4 ranks, then 1, 2, 3 on 2), and the
    max_failures re-raise; each rank's record."""
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device="cpu")
    out = {}
    mesh = create_mesh((2, 2), device="cpu")
    params = _dense_params(0)
    path = os.path.join(ckpt_dir, "ckpt")
    save_sharded_checkpoint(path, shard_params(params, mesh, RULES),
                            {"step": 3}, mesh=mesh, rules=RULES)
    restored, extra, mesh4 = elastic_restore(
        path, [0, 1, 2], model_parallel=2, rules=RULES,
        health_timeout_s=60, init_method=f"file://{store_dir}/er", rank=rank,
        device="cpu")
    if mesh4 is None:
        out["restore"] = None
    else:
        out["restore"] = (extra, dict(mesh4.shape),
                          tuple(restored["dense"]["kernel"].shape),
                          _np(gather_params(restored, mesh4, RULES)))
    # the supervisor: a fresh world of 8 again
    reinitialize_distributed(f"file://{store_dir}/sup", world, rank)
    mesh = create_mesh((2, 2), device="cpu")
    params = _dense_params(1)
    path = os.path.join(ckpt_dir, "ckpt_sup")
    save_sharded_checkpoint(path, shard_params(params, mesh, RULES),
                            {"step": 1}, mesh=mesh, rules=RULES)
    seen = []

    def step_fn(p, m, step):
        seen.append((step, m.size))
        x = torch.ones((8, 16))[m.index("data") * 8 // m.shape["data"]:
                               (m.index("data") + 1) * 8 // m.shape["data"]]
        k = p["dense"]["kernel"]  # this rank's column shard
        cols = slice(m.index("model") * k.shape[1],
                     (m.index("model") + 1) * k.shape[1])
        y = x @ k + p["dense"]["bias"][cols]
        assert bool(torch.all(torch.isfinite(y)))
        return p

    calls = {"n": 0}

    def flaky_health(m):
        calls["n"] += 1
        if calls["n"] == 3:  # the watchdog fires before step 2's work
            raise HealthCheckError("injected: rank lost (watchdog)")
        return collective_health_check(m, timeout_s=60)

    params, mesh, failures = run_with_elastic_recovery(
        step_fn, shard_params(params, mesh, RULES), mesh, path, steps=4,
        health_fn=flaky_health, surviving_ranks_fn=lambda: [0, 1],
        model_parallel=2, rules=RULES, max_failures=1,
        store_dir=store_dir)
    out["supervisor"] = (failures, None if mesh is None else mesh.size,
                         list(seen))
    if mesh is not None:
        out["final"] = _np(gather_params(params, mesh, RULES))

        def always_fail(m):
            raise HealthCheckError("injected")

        try:
            run_with_elastic_recovery(
                step_fn, params, mesh, path, steps=2,
                health_fn=always_fail,
                surviving_ranks_fn=lambda: [0, 1], model_parallel=2,
                rules=RULES, max_failures=0, store_dir=store_dir)
            out["reraised"] = False
        except HealthCheckError:
            out["reraised"] = True
    return out


# ---------------------------------------------------------------------------
# the GPipe forward (world of 4 on the 'pipe' axis)
# ---------------------------------------------------------------------------


def pipeline(rank, world, init_method, cases):
    """Each case on a 'pipe' mesh of the world: ("blocks", name, cfg_kw,
    params, h, n_micro) runs gpipe_blocks over the port's Block; ("vit",
    name, cfg_kw, quant, params, x) vit_pipeline_forward at 2
    microbatches."""
    from quantized_vit_tpu_torch.models import VisionTransformer
    from quantized_vit_tpu_torch.parallel.train_step import _block, _Ctx

    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device="cpu")
    mesh = create_mesh((world,), ("pipe",), device="cpu")
    out = {}
    for kind, name, cfg_kw, *rest in cases:
        if kind == "blocks":
            params_np, h, n_micro = rest
            cfg = ViTConfig(**cfg_kw)
            q = cfg.quant_config
            c = _Ctx(cfg=cfg, q=q, peers=None, clips={
                "wt": torch.tensor(q.weight_clip),
                "act": torch.tensor(q.act_clip)})
            params = _torch(params_np)
            stacked = stack_block_params(params, cfg.depth)
            ht = torch.from_numpy(h)
            got = gpipe_blocks(
                stacked, ht.reshape(n_micro, ht.shape[0] // n_micro,
                                    *ht.shape[1:]),
                lambda bp, z: _block(bp, z, c, 1), mesh=mesh)
            out[name] = got.reshape(ht.shape).numpy()
        else:
            quant, params_np, x = rest
            cfg = ViTConfig(**cfg_kw, quant=QuantConfig(enabled=True)
                            if quant else QuantConfig.off())
            model = VisionTransformer(cfg, device="meta")
            out[name] = vit_pipeline_forward(
                model, _torch(params_np), torch.from_numpy(x), mesh=mesh,
                n_microbatches=2).numpy()
    return out


# ---------------------------------------------------------------------------
# the partition rules on a (2, 4) mesh of a world of 8
# ---------------------------------------------------------------------------


def partition(rank, world, init_method, params_np, art_np, images):
    """shard_params / gather_params of ``params_np`` and shard_vit_artifact
    of the numpy artifact ``art_np`` on (2, 4), this rank's batch slice,
    and the hybrid mesh (dcn (1,), ici (4, 2)) with its health check."""
    from quantized_vit_tpu_torch.parallel import (create_hybrid_mesh,
                                                  data_sharding,
                                                  shard_vit_artifact)
    from quantized_vit_tpu_torch.serve import artifact_from_numpy

    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, device="cpu")
    mesh = create_mesh((2, 4), device="cpu")
    params = _torch(params_np)
    shards = shard_params(params, mesh)
    out = {"coords": dict(mesh.coords),
           "shards": {k: tuple(v.shape) for k, v in
                      flatten_tree(shards).items()},
           "qkv": shards["blocks_0"]["attn"]["qkv"]["kernel"].numpy(),
           "gathered": _np(gather_params(shards, mesh)),
           "batch": data_sharding(mesh, 4)(torch.from_numpy(images)).numpy()}
    art = shard_vit_artifact(artifact_from_numpy(art_np, device="cpu"), mesh)
    blk = art["blocks"][0]
    out["art"] = {k: (blk[k].w.numpy(), None if blk[k].bias is None
                      else blk[k].bias.numpy()) for k in
                  ("qkv", "proj", "fc1", "fc2")}
    hy = create_hybrid_mesh((4, 2), (1,), ("replica", "data", "model"),
                            device="cpu")
    out["hybrid"] = (dict(hy.shape), dict(hy.coords))
    out["health"] = collective_health_check(hy, timeout_s=60).ok
    return out
