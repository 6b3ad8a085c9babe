"""Serving CLI: INT4 artifact + continuous batching load test (port of
``quantized_vit_tpu/cli/serve.py``).

Loads a ViT INT4 artifact, starts the :class:`ContinuousBatcher`, fires
``--requests`` synthetic requests (distinct images from a fixed seed) and
reports throughput, latency and batch occupancy as one JSON line.

Single device (``--mesh-model 0``): an f32 residual stream
(``SERVE_DTYPE``), as the JAX CLI's single-device branch (it calls
``vit_int4_forward`` with its f32 default, quantized_vit_tpu/cli/
serve.py:129-146), so the two CLIs answer alike on one artifact.

Multi-device (``--mesh-model N``, the JAX CLI's mesh (1, N)): N processes
of one 'model' axis (``parallel.Peers``; on one card they share it, with
N cards each takes its own): this process is rank 0 and holds the
batcher; it spawns ranks 1 .. N-1, runs ``collective_health_check`` once
before warm-up, then sends every batch to the workers over gloo, runs
its share and gathers their logits. ``--mesh-mode tp``: tensor parallel
(``serve.vit_int4_forward_tp``: int8 activation all-gathers and
reduce-scatters, 2 + 2 a block); ``--mesh-mode fsdp``: column-sharded
weights gathered a block ahead (``serve.vit_int4_forward_fsdp``), the
compute data parallel. A bf16 residual stream and bf16 reduce-scatters
(``MESH_DTYPE``), as the JAX mesh branch; buckets are multiples of N and
``--max-batch`` is capped at the largest. ``--input-uint8`` is scaled by
1/255 on the device in this branch too (the JAX mesh branch ignores the
flag; ROADMAP.md C1.1).

    python -m quantized_vit_tpu_torch.cli.serve --artifact DIR [--device cuda]
        [--mesh-model N --mesh-mode tp|fsdp]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

SERVE_DTYPE = torch.float32  # the residual stream's dtype
# the mesh branch's residual stream and reduce-scatter dtype
MESH_DTYPE = torch.bfloat16
# a gloo wait of the mesh branch longer than this fails the run
MESH_TIMEOUT_S = 300.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT INT4 serving load test")
    p.add_argument("--artifact", required=True)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--rate", type=float, default=0.0,
                   help="request arrival rate /s (0 = as fast as possible)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--mesh-model", type=int, default=0,
                   help="model-axis size for multi-device serving (0=off): "
                        "N processes, rank 0 this one")
    p.add_argument("--mesh-mode", choices=["tp", "fsdp"], default="tp",
                   help="tp: tensor parallel (int8 activation gathers); "
                        "fsdp: column-sharded weights gathered a block "
                        "ahead, data-parallel compute")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--no-kernels", "--no-pallas", dest="no_kernels",
                   action="store_true",
                   help="plain PyTorch ops instead of the CUDA kernels "
                        "(--no-pallas: the JAX CLI's name of this flag)")
    p.add_argument("--input-uint8", action="store_true",
                   help="serve uint8 pixel inputs; cast and scale by 1/255 "
                        "on the device")
    return p.parse_args(argv)


def build_forward(args):
    """Artifact + flags -> (forward(images) -> logits, cfg, buckets). In
    the mesh branch ``forward`` is a :class:`MeshForward` (close it), and
    ``buckets`` the batch sizes that divide over the processes (else
    None)."""
    if args.mesh_model:
        return _start_mesh(args)
    from ..artifact import load_vit_int4_artifact
    from ..serve import prepare_kernels, vit_int4_forward
    from ..utils.native_prep import patchify_batch, patchify_batch_u8

    art, cfg = load_vit_int4_artifact(args.artifact, device=args.device)
    dev = torch.device(args.device)
    use_kernels = not args.no_kernels
    # the kernels' weight layout and folded constants, made once
    plan = (prepare_kernels(art, cfg) if use_kernels and dev.type != "cpu"
            else None)
    kw = dict(float_dtype=SERVE_DTYPE, images_layout="patches",
              use_kernels=use_kernels, plan=plan)
    # host-side patchify in the batcher's dispatch thread (the host writes
    # these bytes during batch assembly anyway)
    if args.input_uint8:
        def forward(images):
            x = torch.from_numpy(patchify_batch_u8(
                np.asarray(images, np.uint8), cfg.patch_size)).to(dev)
            return vit_int4_forward(art, x, cfg, input_scale=1.0 / 255.0,
                                    **kw)
    else:
        def forward(images):
            x = torch.from_numpy(patchify_batch(
                np.asarray(images, np.float32), cfg.patch_size)).to(dev)
            return vit_int4_forward(art, x, cfg, **kw)
    return forward, cfg, None


def mesh_buckets(n: int, max_batch: int):
    """(buckets, capped max batch) of the mesh branch (quantized_vit_tpu/
    cli/serve.py:95-101, :166-173): n, 2n, 4n, ... up to max(max_batch,
    n), and that cap itself when it divides by n; the max batch is the
    largest bucket, so that no batch fails to divide over the
    processes."""
    cap = max(max_batch, n)
    buckets = [n]
    while buckets[-1] * 2 <= cap:
        buckets.append(buckets[-1] * 2)
    if buckets[-1] < cap and cap % n == 0:
        buckets.append(cap)
    return buckets, buckets[-1]


def _mesh_device(device: str, rank: int, n: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or with n cards card ``rank``,
    else the one card (or the one named) shared."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 1
        dev = torch.device("cuda", rank % count if count >= n else 0)
    return dev


class _MeshMember:
    """One process's share of the mesh branch: its shard of the artifact,
    its kernel plans, and the forward of a whole batch that returns its
    own images' logits."""

    def __init__(self, args, peers):
        from ..artifact import load_vit_int4_artifact
        from ..serve import (prepare_fsdp_kernels, prepare_tp_artifact,
                             prepare_tp_kernels, shard_fsdp_artifact,
                             shard_tp_artifact, vit_int4_forward_fsdp,
                             vit_int4_forward_tp)

        self.peers = peers
        dev = peers.device
        if args.no_kernels and dev.type != "cpu":
            raise SystemExit("--no-kernels: the mesh branch runs the plain "
                             "path on --device cpu only")
        art, cfg = load_vit_int4_artifact(args.artifact, device=dev)
        self.cfg, self.uint8 = cfg, args.input_uint8
        rank, n = peers.rank, peers.tp
        cuda = dev.type == "cuda"
        if args.mesh_mode == "tp":
            part = shard_tp_artifact(prepare_tp_artifact(art, cfg, n), rank,
                                     n)
            plan = prepare_tp_kernels(part, cfg, peers) if cuda else None
            self._fwd = lambda x: vit_int4_forward_tp(
                part, x, cfg, peers, float_dtype=MESH_DTYPE,
                comm_dtype=MESH_DTYPE, images_layout="patches", plan=plan)
        else:
            part = shard_fsdp_artifact(art, rank, n)
            plan = prepare_fsdp_kernels(part, cfg, peers) if cuda else None
            self._fwd = lambda x: vit_int4_forward_fsdp(
                part, x, cfg, peers, float_dtype=MESH_DTYPE,
                images_layout="patches", plan=plan)
        del art

    def step(self, x_host: torch.Tensor) -> torch.Tensor:
        """The batch ``x_host`` (host patches, the same on every process)
        through this process's forward; its logits on the host."""
        x = x_host.to(self.peers.device)
        if self.uint8:  # cast and scale on the device
            x = x.to(torch.float32) * torch.full(
                (), 1.0 / 255.0, dtype=torch.float32, device=x.device)
        return self._fwd(x).to("cpu")

    def patches_shape(self, batch: int):
        cfg = self.cfg
        return (batch, cfg.num_patches,
                cfg.patch_size ** 2 * cfg.in_channels)

    @property
    def dtype(self):
        return torch.uint8 if self.uint8 else torch.float32


def _header(batch: int) -> torch.Tensor:
    """The size of the next batch rank 0 broadcasts (-1: stop)."""
    return torch.tensor([batch], dtype=torch.int64)


def _join_group(args, rank: int, n: int, init_method: str):
    """This process's Peers of the mesh group, checked once."""
    from ..parallel import collective_health_check, initialize_distributed

    peers = initialize_distributed(init_method, n, rank,
                                   device=_mesh_device(args.device, rank, n))
    report = collective_health_check(peers, timeout_s=MESH_TIMEOUT_S)
    return peers, report


def mesh_worker(rank: int, n: int, init_method: str, args):
    """Ranks 1 .. n-1 of the mesh branch: join the group, pass the health
    check, then for each batch rank 0 broadcasts (its size, then its
    patches) run this process's share and send the logits to rank 0,
    until a size of -1. Returns the batches served."""
    import torch.distributed as dist

    peers, _ = _join_group(args, rank, n, init_method)
    served = 0
    member = None
    try:
        member = _MeshMember(args, peers)
        while True:
            head = _header(0)
            dist.broadcast(head, src=0)
            batch = int(head[0])
            if batch < 0:
                break
            x = torch.empty(member.patches_shape(batch), dtype=member.dtype)
            dist.broadcast(x, src=0)
            dist.gather(member.step(x).to(torch.float32), dst=0)
            served += 1
    finally:
        del member  # its plans map the peers' buffers: drop them first
        peers.close()
    return served


def _start_mesh(args):
    """build_forward's mesh branch: spawn ranks 1 .. N-1, join the group
    as rank 0, load and shard the artifact; (MeshForward, cfg, buckets)."""
    import tempfile

    from ..parallel import Workers

    n = args.mesh_model
    if n < 1:
        raise SystemExit(f"--mesh-model {n}: needs N >= 1")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--mesh-model on --device cuda needs a card; "
                         "pass --device cpu for the plain path")
    workers = Workers(mesh_worker, n, tempfile.mkdtemp(prefix="qvt_mesh_"),
                      args=(args,))
    try:
        peers, report = _join_group(args, 0, n, workers.init_method)
        member = _MeshMember(args, peers)
    except BaseException:
        workers.join(timeout_s=30)
        raise
    return (MeshForward(workers, peers, member, report), member.cfg,
            mesh_buckets(n, args.max_batch)[0])


class MeshForward:
    """Rank 0 of the mesh branch: the batcher's ``forward`` (host images
    -> the whole batch's logits, the workers' shares gathered over gloo).
    :meth:`close` stops the workers and leaves the group."""

    def __init__(self, workers, peers, member, report):
        self.workers, self.peers, self.member = workers, peers, member
        self.health = report

    def __call__(self, images):
        import torch.distributed as dist

        from ..utils.native_prep import patchify_batch, patchify_batch_u8

        cfg = self.member.cfg
        if self.member.uint8:
            x = torch.from_numpy(patchify_batch_u8(
                np.asarray(images, np.uint8), cfg.patch_size))
        else:
            x = torch.from_numpy(patchify_batch(
                np.asarray(images, np.float32), cfg.patch_size))
        b = x.shape[0]
        if self.peers.tp > 1:
            dist.broadcast(_header(b), src=0)
            dist.broadcast(x.contiguous(), src=0)
        mine = self.member.step(x).to(torch.float32)
        if self.peers.tp == 1:
            return mine
        parts = [torch.empty_like(mine) for _ in range(self.peers.tp)]
        dist.gather(mine, parts, dst=0)
        return torch.cat(parts)

    def close(self):
        """Stop the workers (a batch size of -1), leave the group; returns
        the batches each worker served."""
        import torch.distributed as dist

        try:
            if self.peers.tp > 1:
                dist.broadcast(_header(-1), src=0)
        finally:
            # the member's plans map the peers' buffers: dropped before
            # the group lets each process free what the others mapped
            self.member = None
            self.peers.close()
        return self.workers.join(timeout_s=MESH_TIMEOUT_S)


def request_images(cfg, n: int, uint8: bool) -> np.ndarray:
    rng = np.random.default_rng(0)
    shape = (n, cfg.img_size, cfg.img_size, cfg.in_channels)
    if uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


def main(argv=None):
    """Runs the load test; prints the summary as one JSON line and returns
    it, with the request ``images`` and their ``answers`` (logits) added."""
    args = parse_args(argv)
    from ..serve import ContinuousBatcher

    forward, cfg, buckets = build_forward(args)
    images = request_images(cfg, args.requests, args.input_uint8)
    max_batch = args.max_batch
    if buckets:
        max_batch = buckets[-1]
        if max_batch != args.max_batch:
            print(f"[serve] capping max_batch {args.max_batch} -> "
                  f"{max_batch} (mesh divisibility)")
    batcher = ContinuousBatcher(forward, max_batch=max_batch,
                                max_delay_ms=args.max_delay_ms,
                                buckets=buckets)
    lat, answers = [], []
    try:
        print("[serve] warming buckets", batcher.buckets)
        batcher.warmup(images[0])
        t0 = time.time()
        with batcher:
            futs = []
            for img in images:
                if args.rate > 0:
                    time.sleep(1.0 / args.rate)
                futs.append((time.monotonic(), batcher.submit(img)))
            for t_sub, f in futs:
                answers.append(f.result(timeout=120))
                lat.append(time.monotonic() - t_sub)
        wall = time.time() - t0
    finally:
        workers = forward.close() if hasattr(forward, "close") else None

    out = {
        "requests": args.requests,
        "device": str(args.device),
        "wall_s": round(wall, 3),
        "throughput_rps": round(args.requests / wall, 2),
        "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
        "batches": batcher.stats["batches"],
        "padded": batcher.stats["padded"],
        "batch_hist": batcher.stats["batch_hist"],
    }
    if args.mesh_model:
        out.update(mesh_model=args.mesh_model, mesh_mode=args.mesh_mode,
                   health_latency_s=forward.health.latency_s,
                   batches_per_worker=workers)
    print(json.dumps(out))
    out["images"] = images
    out["answers"] = np.stack(answers)
    return out


if __name__ == "__main__":
    main()
