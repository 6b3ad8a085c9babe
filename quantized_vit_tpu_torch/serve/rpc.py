"""RPC transport for multi-host serving (port of
``quantized_vit_tpu/serve/rpc.py``).

Data-parallel serving needs no collective between backends; the only
machinery across hosts is request fan-out, which this module provides:

- :class:`RpcServingBackend`: a socket server around a
  :class:`~.batching.ContinuousBatcher`. Requests stream in per
  connection, enter the batcher like local submissions, and each answer is
  written back as its future resolves (out of order, by request id).
- :class:`RpcBackendStub`: the client, with the batcher's interface
  (``submit(image) -> Future``, ``stats``, ``queue_depth()``), so
  :class:`~.batching.MultiHostFrontend` routes across processes as it
  routes across in-process batchers.
- ``python -m quantized_vit_tpu_torch.serve.rpc --artifact DIR | --demo
  tiny [--device cpu]``: a serving worker. It prints
  ``RPC_SERVING_PORT=N`` on one line once it serves.

Wire format (the JAX package's, byte for byte, so either side's stub talks
to either side's server): an 8-byte little-endian length, then a pickled
dict whose arrays are numpy arrays, never torch tensors. Pickle is an
internal-trust transport: anyone who can reach the port can run code
through a crafted pickle. So the server refuses a non-loopback host
unless ``allow_remote=True`` (``--allow-remote``), and a frame is capped
at ``MAX_MSG_BYTES`` so the length field cannot drive huge allocations.
"""

from __future__ import annotations

import argparse
import pickle
import socket
import struct
import sys
import threading
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

_LEN = struct.Struct("<Q")

# the largest frame accepted: room for image batches and replies (a
# batch-256 224^2 f32 tensor is ~154 MB) that still stops a hostile or
# corrupt length header from driving allocations of gigabytes
MAX_MSG_BYTES = 1 << 28  # 256 MiB


def _send_msg(sock: socket.socket, obj, lock: Optional[threading.Lock] = None):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > MAX_MSG_BYTES:
        raise ValueError(
            f"RPC message {len(payload)} bytes exceeds MAX_MSG_BYTES "
            f"{MAX_MSG_BYTES}")
    data = _LEN.pack(len(payload)) + payload
    if lock:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def _recv_msg(sock: socket.socket):
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_MSG_BYTES:
        # drop the connection rather than allocate what the header claims
        raise OSError(
            f"RPC frame header claims {n} bytes (> MAX_MSG_BYTES "
            f"{MAX_MSG_BYTES}); closing connection")
    body = _recv_exact(sock, n)
    return None if body is None else pickle.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class RpcServingBackend:
    """Serve a ContinuousBatcher over a TCP socket (one process)."""

    def __init__(self, batcher, host: str = "127.0.0.1", port: int = 0,
                 allow_remote: bool = False):
        if not allow_remote and host not in ("127.0.0.1", "localhost", "::1"):
            raise ValueError(
                f"refusing to bind non-loopback host {host!r}: the pickle "
                "wire format is internal-trust only (remote code execution "
                "for anyone who can reach the port). Pass "
                "allow_remote=True / --allow-remote to opt in explicitly "
                "on a private network.")
        self.batcher = batcher
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: list = []

    def start(self):
        self.batcher.start()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for c in list(self._conns):
            try:
                c.close()
            except OSError:
                pass
        self.batcher.stop()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until a client asks for shutdown (or ``timeout``)."""
        return self._stop.wait(timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        wlock = threading.Lock()
        try:
            self._serve_conn_loop(conn, wlock)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_conn_loop(self, conn: socket.socket, wlock: threading.Lock):
        while not self._stop.is_set():
            try:
                msg = _recv_msg(conn)
            except OSError:
                return
            if msg is None:
                return
            op = msg.get("op")
            if op == "submit":
                rid = msg["id"]
                fut = self.batcher.submit(np.asarray(msg["image"]))

                def done(f: Future, _rid=rid):
                    try:
                        reply = {"id": _rid, "result": np.asarray(f.result())}
                    except Exception as e:  # noqa: BLE001 (to the client)
                        reply = {"id": _rid, "error": repr(e)}
                    try:
                        _send_msg(conn, reply, wlock)
                    except OSError:
                        pass

                fut.add_done_callback(done)
            elif op == "stats":
                _send_msg(conn, {"id": msg.get("id"),
                                 "stats": self.batcher.stats,
                                 "queue_depth": self.batcher.queue_depth()},
                          wlock)
            elif op == "shutdown":
                _send_msg(conn, {"id": msg.get("id"), "ok": True}, wlock)
                self._stop.set()
                return


# ---------------------------------------------------------------------------
# client stub
# ---------------------------------------------------------------------------


class RpcBackendStub:
    """Client of a serving process with the batcher's interface, for
    :class:`~.batching.MultiHostFrontend`. ``submit()`` returns a Future
    that a reader thread resolves when the server answers;
    ``queue_depth()`` is the local count of requests in flight (the
    router's load signal); ``stats`` asks the remote batcher for its
    counters and waits for them."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.addr = (host, port)
        self._sock = socket.create_connection(self.addr, timeout=timeout)
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._plock = threading.Lock()
        self._next_id = 0
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def start(self):
        return self

    def stop(self):
        """Close this client's connection (the server goes on serving its
        other clients; :meth:`shutdown_server` stops it)."""
        try:
            self._sock.close()
        except OSError:
            pass
        with self._plock:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(RuntimeError("stub stopped"))
            self._pending.clear()

    def shutdown_server(self):
        """Ask the remote worker to stop serving (all clients)."""
        try:
            self._send({"op": "shutdown", "id": self._new_id()})
        except OSError:
            pass
        self.stop()

    def submit(self, image: np.ndarray) -> Future:
        fut: Future = Future()
        rid = self._new_id()
        with self._plock:
            self._pending[rid] = fut
        try:
            self._send({"op": "submit", "id": rid,
                        "image": np.asarray(image)})
        except OSError as e:
            with self._plock:
                self._pending.pop(rid, None)
            fut.set_exception(e)
        return fut

    def queue_depth(self) -> int:
        with self._plock:
            return len(self._pending)

    @property
    def stats(self):
        fut: Future = Future()
        rid = self._new_id()
        with self._plock:
            self._pending[rid] = fut
        self._send({"op": "stats", "id": rid})
        return fut.result(timeout=30)

    def _new_id(self) -> int:
        with self._plock:
            self._next_id += 1
            return self._next_id

    def _send(self, obj):
        _send_msg(self._sock, obj, self._wlock)

    def _read_loop(self):
        while True:
            try:
                msg = _recv_msg(self._sock)
            except OSError:
                msg = None
            if msg is None:
                with self._plock:
                    pending, self._pending = self._pending, {}
                for fut in pending.values():
                    if not fut.done():
                        fut.set_exception(
                            ConnectionError(f"backend {self.addr} closed"))
                return
            rid = msg.get("id")
            with self._plock:
                fut = self._pending.pop(rid, None)
            if fut is None or fut.done():
                continue
            if "error" in msg:
                fut.set_exception(RuntimeError(msg["error"]))
            elif "stats" in msg:
                fut.set_result({"stats": msg["stats"],
                                "queue_depth": msg.get("queue_depth", 0)})
            else:
                fut.set_result(msg["result"])


# ---------------------------------------------------------------------------
# worker entry point
# ---------------------------------------------------------------------------


def build_forward(art, cfg, float_dtype, device="cuda"):
    """``forward(images) -> logits``: NHWC float images patchified on the
    host, then ``vit_int4_forward`` on ``device``. On a card it runs the
    CUDA kernels on plans prepared here, with no plain fallback; on the
    CPU, the plain versions."""
    import torch

    from ..device import resolve_device
    from ..utils.native_prep import patchify_batch
    from .vit_int4 import prepare_kernels, vit_int4_forward

    dev = resolve_device(device)
    plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None

    def forward(images):
        x = torch.from_numpy(patchify_batch(
            np.asarray(images, np.float32), cfg.patch_size)).to(dev)
        return vit_int4_forward(art, x, cfg, float_dtype=float_dtype,
                                images_layout="patches", plan=plan)
    return forward


def load_forward(artifact: str = "", demo: str = "", device="cuda"):
    """(forward, cfg) of a worker: the saved artifact in bf16 (as the JAX
    worker serves it), or the demo model's seed-0 artifact in f32 (the
    JAX worker's tiny ViT)."""
    import torch

    from ..models.vit import ViTConfig
    from .vit_int4 import random_vit_int4_artifact

    if demo:
        cfg = ViTConfig(img_size=32, patch_size=16, embed_dim=64, depth=2,
                        num_heads=2, num_classes=10)
        art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False,
                                       device=device)
        return build_forward(art, cfg, torch.float32, device), cfg
    from ..artifact import load_vit_int4_artifact

    art, cfg = load_vit_int4_artifact(artifact, device=device)
    return build_forward(art, cfg, torch.bfloat16, device), cfg


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="serving worker (RPC backend)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--allow-remote", action="store_true",
                   help="allow binding a non-loopback host (the pickle "
                        "wire format is internal-trust only; see the "
                        "module docstring)")
    p.add_argument("--artifact", default="",
                   help="saved INT4 artifact directory; omit with --demo "
                        "for a synthetic model")
    p.add_argument("--demo", default="", choices=["", "tiny"],
                   help="serve a tiny synthetic ViT (transport testing)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    if not (args.demo or args.artifact):
        p.error("need --artifact or --demo")
    return args


def main(argv=None):
    """Serve until a client asks for shutdown. Every bucket runs once
    before the port is announced, so a kernel that does not build or
    launch ends the worker with its error."""
    from .batching import ContinuousBatcher

    args = parse_args(argv)
    forward, cfg = load_forward(args.artifact, args.demo, args.device)
    batcher = ContinuousBatcher(forward, max_batch=args.max_batch,
                                max_delay_ms=args.max_delay_ms)
    batcher.warmup(np.zeros((cfg.img_size, cfg.img_size, cfg.in_channels),
                            np.float32))
    backend = RpcServingBackend(batcher, host=args.host, port=args.port,
                                allow_remote=args.allow_remote)
    backend.start()
    # the bound port for the parent, one line on stdout
    print(f"RPC_SERVING_PORT={backend.port}", flush=True)
    try:
        backend.wait()
    except KeyboardInterrupt:
        pass
    backend.stop()


if __name__ == "__main__":
    sys.exit(main())
