"""Port parity: the multi-host serving front (``serve/batching.py:
MultiHostFrontend``) and the RPC transport (``serve/rpc.py``) against the
JAX package's.

- The frontend's routing against fake backends: least-loaded first,
  round robin among equals, every backend started and stopped.
- The hardening cases of ``tests/serve/test_rpc_hardening.py`` on the
  port: a non-loopback bind refused without opt-in, a frame header over
  ``MAX_MSG_BYTES`` dropping the connection, an oversized payload refused
  before it is sent.
- The wire in both directions: the port's frames are the JAX package's
  byte for byte; a port stub against a JAX server and a JAX stub against
  a port server, each serving the other package's demo model. The two
  packages' demo forwards agree within ``DEMO_TOL`` (their plain f32
  paths round a few ops apart); every answer that crossed the wire equals
  the serving side's own forward of that image to the bit.
- A real two-process serve: two ``python -m
  quantized_vit_tpu_torch.serve.rpc --demo tiny --device cpu`` workers
  behind one frontend, every answer equal to the port's demo forward of
  its image, both workers used, their stats summed over the wire, and a
  remote shutdown.
"""

import os
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from quantized_vit_tpu.serve import batching as jbatching
from quantized_vit_tpu.serve import rpc as jrpc
from quantized_vit_tpu_torch.serve import MultiHostFrontend
from quantized_vit_tpu_torch.serve import rpc
from quantized_vit_tpu_torch.serve.batching import ContinuousBatcher

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_TOL = 1e-4  # as tests/test_torch_vit_int4.py holds the forwards
SPAWN_TIMEOUT_S = 120


class FakeBackend:
    def __init__(self, depth=0):
        self.depth = depth
        self.started = self.stopped = 0
        self.got = []
        self.stats = {"requests": 0}

    def start(self):
        self.started += 1
        return self

    def stop(self):
        self.stopped += 1

    def queue_depth(self):
        return self.depth

    def submit(self, image):
        self.got.append(image)
        self.stats["requests"] += 1
        f = Future()
        f.set_result(image)
        return f


@pytest.mark.parametrize("depths,want", [
    ((0, 0, 0), [0, 1, 2, 0, 1, 2]),
    ((3, 0, 3), [1] * 6),
    ((2, 1, 1), [1, 2, 1, 2, 1, 2]),
])
def test_frontend_routes_like_jax(depths, want):
    picks = {}
    for name, cls, mk in (("port", MultiHostFrontend, FakeBackend),
                          ("jax", jbatching.MultiHostFrontend, FakeBackend)):
        backends = [mk(d) for d in depths]
        with cls(backends) as fe:
            for i in range(6):
                assert fe.submit(i).result() == i
            picks[name] = [next(j for j, b in enumerate(backends)
                                if i in b.got) for i in range(6)]
            assert fe.stats == {j: {"requests": len(b.got)}
                                for j, b in enumerate(backends)}
        assert all(b.started == b.stopped == 1 for b in backends)
    assert picks["port"] == picks["jax"] == want


def test_frontend_needs_a_backend():
    with pytest.raises(ValueError, match="at least one backend"):
        MultiHostFrontend([])


def test_frontend_follows_live_queue_depths():
    backends = [FakeBackend(), FakeBackend()]
    fe = MultiHostFrontend(backends)
    fe.submit(0)  # a tie: round robin starts at backend 0
    backends[0].depth = 5  # busy: the next ones go to backend 1
    for i in range(1, 4):
        fe.submit(i)
    assert backends[0].got == [0] and backends[1].got == [1, 2, 3]


# -- hardening --------------------------------------------------------------


def _echo_batcher():
    return ContinuousBatcher(
        lambda images: images.sum(axis=(1, 2, 3))[:, None], max_batch=2,
        max_delay_ms=1)


@pytest.mark.parametrize("host", ["0.0.0.0", "10.1.2.3"])
def test_non_loopback_bind_refused_without_opt_in(host):
    with pytest.raises(ValueError, match="allow_remote"):
        rpc.RpcServingBackend(_echo_batcher(), host=host)


@pytest.mark.parametrize("host", ["127.0.0.1", "localhost"])
def test_loopback_binds_fine(host):
    backend = rpc.RpcServingBackend(_echo_batcher(), host=host)
    assert backend.port > 0
    backend.stop()


def test_oversized_frame_header_drops_connection():
    with rpc.RpcServingBackend(_echo_batcher()) as backend:
        sock = socket.create_connection(("127.0.0.1", backend.port),
                                        timeout=10)
        try:
            # an 8 EiB body claimed: the server hangs up without reading
            sock.sendall(struct.pack("<Q", 1 << 63))
            sock.settimeout(10)
            assert sock.recv(1) == b""
        finally:
            sock.close()


def test_send_msg_rejects_oversized_payload():
    class Sink:
        def sendall(self, data):  # pragma: no cover (must not be reached)
            raise AssertionError("oversized payload was sent")

    assert rpc.MAX_MSG_BYTES == jrpc.MAX_MSG_BYTES == 1 << 28
    big = np.zeros(rpc.MAX_MSG_BYTES + 1024, np.uint8)
    with pytest.raises(ValueError, match="MAX_MSG_BYTES"):
        rpc._send_msg(Sink(), {"op": "submit", "image": big})


def test_error_reaches_the_client():
    def bad_forward(images):
        raise ValueError("injected failure")

    batcher = ContinuousBatcher(bad_forward, max_batch=2, max_delay_ms=1)
    with rpc.RpcServingBackend(batcher) as backend:
        stub = rpc.RpcBackendStub("127.0.0.1", backend.port)
        with pytest.raises(RuntimeError, match="injected failure"):
            stub.submit(np.zeros((4, 4, 3), np.float32)).result(timeout=30)
        stub.stop()


def test_stub_serves_concurrent_submitters():
    with rpc.RpcServingBackend(_echo_batcher()) as backend:
        stub = rpc.RpcBackendStub("127.0.0.1", backend.port)
        images = np.random.default_rng(2).standard_normal(
            (24, 4, 4, 3)).astype(np.float32)
        results = [None] * len(images)

        def worker(i):
            results[i] = stub.submit(images[i]).result(timeout=60)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got = np.array([float(r[0]) for r in results])
        np.testing.assert_allclose(got, images.sum(axis=(1, 2, 3)),
                                   rtol=1e-5)
        stub.stop()


# -- the wire ---------------------------------------------------------------


@pytest.mark.parametrize("msg", [
    {"op": "submit", "id": 7,
     "image": np.arange(48, dtype=np.float32).reshape(4, 4, 3)},
    {"id": 3, "result": np.linspace(-1, 1, 10, dtype=np.float32)},
    {"id": 2, "stats": {"requests": 5, "batch_hist": {1: 2, 4: 1}},
     "queue_depth": 0},
    {"op": "shutdown", "id": 9},
])
def test_frames_are_the_jax_packages_bytes(msg):
    frames = []
    for mod in (rpc, jrpc):
        a, b = socket.socketpair()
        with a, b:
            mod._send_msg(a, msg)
            a.shutdown(socket.SHUT_WR)
            frames.append(b"".join(iter(lambda: b.recv(65536), b"")))
            # and each side reads the other's frame
            c, d = socket.socketpair()
            with c, d:
                c.sendall(frames[-1])
                got = (jrpc if mod is rpc else rpc)._recv_msg(d)
        assert set(got) == set(msg)
        for k, v in msg.items():
            assert np.array_equal(got[k], v) if isinstance(
                v, np.ndarray) else got[k] == v
    assert frames[0] == frames[1]
    (n,) = struct.unpack("<Q", frames[0][:8])
    assert n == len(frames[0]) - 8


def _demo_images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def port_demo():
    fwd, cfg = rpc.load_forward(demo="tiny", device="cpu")
    return lambda images: fwd(images).numpy()


@pytest.fixture(scope="module")
def jax_demo():
    fwd = jrpc._demo_forward()
    return lambda images: np.asarray(fwd(images))


def test_demo_forwards_agree(port_demo, jax_demo):
    images = _demo_images(4, 0)
    np.testing.assert_allclose(port_demo(images), jax_demo(images),
                               rtol=DEMO_TOL, atol=DEMO_TOL)


@pytest.mark.parametrize("server", ["jax", "port"])
def test_wire_across_packages(server, port_demo, jax_demo):
    """A port stub against a JAX server, and a JAX stub against a port
    server: answers equal the server's own forward of each image, stats
    come back."""
    images = _demo_images(6, 1)
    if server == "jax":
        fwd, stub_cls = jax_demo, rpc.RpcBackendStub
        batcher = jbatching.ContinuousBatcher(fwd, max_batch=1,
                                              max_delay_ms=1)
        backend = jrpc.RpcServingBackend(batcher)
    else:
        fwd, stub_cls = port_demo, jrpc.RpcBackendStub
        batcher = ContinuousBatcher(fwd, max_batch=1, max_delay_ms=1)
        backend = rpc.RpcServingBackend(batcher)
    with backend:
        stub = stub_cls("127.0.0.1", backend.port)
        futs = [stub.submit(img) for img in images]
        got = np.stack([f.result(timeout=60) for f in futs])
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        want = np.concatenate([fwd(images[i:i + 1]) for i in range(6)])
        assert np.array_equal(got, want)
        np.testing.assert_allclose(got, (jax_demo if server == "port"
                                         else port_demo)(images),
                                   rtol=DEMO_TOL, atol=DEMO_TOL)
        st = stub.stats
        assert st["stats"]["requests"] == 6 and st["queue_depth"] == 0
        stub.stop()


# -- a real two-process serve ----------------------------------------------


def spawn_worker(*flags):
    """A serving worker process; (process, port) once it announces."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "quantized_vit_tpu_torch.serve.rpc", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env, cwd=REPO,
        text=True)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for line in proc.stdout:
        if line.startswith("RPC_SERVING_PORT="):
            return proc, int(line.strip().split("=", 1)[1])
        if time.monotonic() > deadline:
            break
    proc.kill()
    raise RuntimeError(f"worker {flags} died or stayed silent "
                       f"(rc={proc.wait()})")


@pytest.fixture(scope="module")
def workers():
    procs = []
    try:
        for _ in range(2):
            procs.append(spawn_worker("--demo", "tiny", "--device", "cpu",
                                      "--max-delay-ms", "2"))
        yield procs
    finally:
        for p, _ in procs:
            p.terminate()
        for p, _ in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def test_two_process_serve_through_the_frontend(workers, port_demo):
    stubs = [rpc.RpcBackendStub("127.0.0.1", port) for _, port in workers]
    images = _demo_images(24, 3)
    with MultiHostFrontend(stubs) as fe:
        futs = [fe.submit(img) for img in images]
        got = np.stack([f.result(timeout=60) for f in futs])
        want = np.concatenate([port_demo(images[i:i + 1])
                               for i in range(len(images))])
        assert np.array_equal(got, want)
        remote = [s.stats for s in stubs]
        assert sum(r["stats"]["requests"] for r in remote) >= 24
        assert all(r["stats"]["requests"] > 0 for r in remote), remote
    # a remote shutdown ends the worker
    proc, port = workers[0]
    rpc.RpcBackendStub("127.0.0.1", port).shutdown_server()
    assert proc.wait(timeout=30) == 0


def test_worker_refuses_missing_model():
    with pytest.raises(SystemExit):
        rpc.parse_args([])
    assert rpc.parse_args(["--demo", "tiny"]).device == "cuda"
