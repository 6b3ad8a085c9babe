"""PyTorch + CUDA port of the ViT W4A4 integer serving path.

The JAX package ``quantized_vit_tpu`` is the reference; this package mirrors
its module layout (``quant/packing.py``, ``artifact/``, ``ops/``,
``serve/``, ``cli/``) so each counterpart is easy to find. It imports
``torch``, numpy and the standard library only.

Every TPU kernel on the serving path has a hand-written Hopper kernel in
``csrc/`` (CUDA C++ for ``sm_90a``, built at first use by
:mod:`quantized_vit_tpu_torch.ops._build`). Each kernel wrapper takes its
plain PyTorch version for CPU tensors only; for a CUDA tensor it launches
the kernel or raises.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
