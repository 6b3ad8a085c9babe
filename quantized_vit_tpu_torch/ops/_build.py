"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface, loaded
with :mod:`ctypes`. The build happens at first use, into
``build/kernels/<hash>/`` at the repository root (listed in
``.gitignore``), keyed on a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.

Every C entry point takes its pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code. Nothing here runs at import time: the CPU tests import every
module and there is no ``nvcc`` there.

The kernels read every weight in one layout, :func:`n_major`; the plans of
``fused.py``, ``attention.py``, ``block_stack.py`` and ``int4_matmul.py``
make that copy once per layer (the FSDP forward gathers its weights in
that layout, ``serve/vit_fsdp.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fused_quant_matmul.cu", "fused_mlp.cu", "attention_block.cu",
           "patch_finalize.cu", "attention_qkv.cu", "block_stack.cu",
           "quant_bwd.cu", "fused_mlp_chunked.cu", "attention_proj.cu",
           "int_matmul.cu", "flash_attention.cu", "ring_gather.cu",
           "fc1_ablation.cu", "attn_ablation.cu")
# -fmad=false: no multiply-add contraction, so every f32 product and sum
# rounds as the plain PyTorch version's separate ops do (a contracted FMA
# moves a value by an ulp and can flip a level at a rounding tie)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
# a source's own flags: attn_ablation.cu's twenty heavily unrolled
# instantiations compile in parallel within the one nvcc (its longest
# build; tools/exp_attn_design.py --builds times it with and without)
SOURCE_FLAGS = {"attn_ablation.cu": ["--split-compile=0"]}
# the phase-stamped variant (csrc/qvt_common.cuh, QVT_PROBE)
PROBE_FLAGS = ["-DQVT_PROBE"]
_flags = list(NVCC_FLAGS)

# launches per kernel, raised by each wrapper where it launches its kernel
LAUNCHES: Dict[str, int] = {"fused_quant_matmul": 0, "fused_mlp": 0,
                            "attention_block": 0, "patch_finalize": 0,
                            "attention_qkv": 0, "block_stack": 0,
                            "quant_bwd": 0, "fused_mlp_chunked": 0,
                            "attention_qkv_proj": 0, "int4_matmul": 0,
                            "int8_matmul": 0, "quant_matmul_fa": 0,
                            "flash_attention": 0, "gather_rows": 0,
                            "fused_mlp_gather": 0, "ln_quant_levels": 0,
                            # the root tools' ablations (ops/ablations.py)
                            "exp_pro": 0, "exp_pro2": 0, "exp_attn": 0,
                            "exp_attn2": 0, "exp_epilogue": 0, "exp_fc1": 0}

# seconds from the start of the last build to each source's library
BUILD_SECONDS: Dict[str, float] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def use_probe_build() -> None:
    """Build and load the phase-stamped kernels from now on (thread 0 of
    each block records ``%globaltimer`` at its phase boundaries; read with
    the library's ``qvt_probe_read``). They build into their own hashed
    directory. For ``tools/phase_probe.py``."""
    global _flags
    with _LOCK:
        _flags = NVCC_FLAGS + PROBE_FLAGS
        _LIBS.clear()


def use_library(stem: str, path) -> None:
    """Load the library at ``path`` in place of ``csrc/<stem>.cu``'s own
    from now on (a probe's variant build, ``tools/exp_attn_design.py
    --stages``)."""
    with _LOCK:
        _LIBS[stem] = ctypes.CDLL(str(path))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(_flags).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> Path:
    """Compile every missing library, one ``nvcc`` per source, in
    parallel. Returns the build directory; raises with the compiler's
    output if any build fails. ``ptxas.log`` there keeps each kernel's
    register and shared-memory report and each source's build seconds
    (also in :data:`BUILD_SECONDS`)."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for src in SOURCES:
        lib = out / (Path(src).stem + ".so")
        if lib.exists():
            continue
        tmp = out / f"{lib.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags, *SOURCE_FLAGS.get(src, ()), "-I",
               str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    texts = {}

    def drain(src, p):  # a thread a compiler: each one's own finish time
        texts[src] = p.communicate()[0]
        BUILD_SECONDS[src] = round(time.perf_counter() - t0, 1)

    threads = [threading.Thread(target=drain, args=(src, p))
               for src, _, _, p in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errors, logs = [], []
    for src, lib, tmp, p in procs:
        text = texts[src]
        logs.append(f"== {src} ({BUILD_SECONDS[src]} s)\n{text}")
        if p.returncode != 0:
            errors.append(f"nvcc failed on {src} (rc {p.returncode}):\n"
                          f"{text[-6000:]}")
        else:
            os.replace(tmp, lib)
    if logs:
        with open(out / "ptxas.log", "a") as f:
            f.write("\n".join(logs))
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<stem>.cu`` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"{stem}.so"))
            _LIBS[stem] = lib
        return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for a missing optional operand)."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.c_longlong

# element-type codes shared with csrc/qvt_common.cuh
DTYPE_CODE = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def dtype_code(dt: torch.dtype) -> int:
    if dt not in DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dt} for a CUDA kernel")
    return DTYPE_CODE[dt]


def n_major(w: torch.Tensor) -> torch.Tensor:
    """A weight [K, N] (or packed int4 [K/2, N]; or a stack [L, K(/2), N])
    as the kernels read it: its last two axes transposed, n-major with k
    contiguous (the tensor-core B operand's layout, so a weight tile fills
    with 16-byte loads). A copy."""
    return w.transpose(-1, -2).contiguous()


def require_cuda(name: str, *tensors) -> None:
    """A kernel wrapper's device check: its tensors lie on one CUDA device
    (a tensor on any other non-CPU device raises instead of reaching the
    plain version)."""
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise ValueError(
                f"{name}: the CUDA kernel needs CUDA tensors, got one on "
                f"{t.device}; CPU tensors take the plain PyTorch version")
