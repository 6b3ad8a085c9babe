"""K21 on the card: fc1 from int8 levels with each of ``tools/exp_fc1.py``'s
epilogue variants (``csrc/fc1_ablation.cu``, ``ops/ablations.py:
exp_fc1``), at the root tool's shape (M 7168 = 32 images x 224 rows, K
768, N 3072) and seed:

    python3 -m quantized_vit_tpu_torch.tools.exp_fc1 [mode ...] [--device cpu]

Modes: none (the f32 -> int8 cast), round, magic (the 1.5 * 2**23 add),
gelu_erf, gelu_magic, gelu_tanh, gelu_sig, gelu_bf16. On the card
``magic`` computes ``round``'s function and ``gelu_magic`` ``gelu_erf``'s
(the add rounds half to even), by other instructions. The root tool's
``n_stripes`` only scheduled the TPU's work and has no counterpart. For
each mode: the parity against the plain version, the kernel's us per
launch (events and device time), its bound, the plain version's time;
then ``torch._int_mm`` at the same shape (the GEMM alone). Without a card
it raises unless ``--device cpu`` (plain versions, untimed).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ablations as ab
from ._ablation import Mode, Tool, int_mm_yard, main as _main

M, K, N = 7168, 768, 3072
MODES = list(ab.EXP_FC1_MODES)
# through a library transcendental (tanhf, expf): within the levels
# contract on the card, not held bit-exact
LIBRARY_MODES = {"gelu_tanh", "gelu_sig"}


def build(dev, modes=MODES, shape=None) -> Tool:
    m, k, n = shape or (M, K, N)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-7, 8, (m, k)).astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8)).to(dev)
    cuda = dev.type == "cuda"
    out = []
    for mode in modes:
        v = ab.EXP_FC1_MODES[mode]
        call = lambda mode=mode: ab.exp_fc1(x, w, mode)
        plan = ab.plan_fc1(w, v, m) if cuda else None
        out.append(Mode(
            mode, call,
            (lambda p=plan: ab.run_fc1(p, x, "exp_fc1")) if cuda else call,
            lambda v=v: ab.fc1_ablation_plain(x, w, v),
            bytes=m * k + k * n + m * n, ops=2 * m * k * n, kind="int8",
            levels=mode in LIBRARY_MODES))
    return Tool(out, int_mm_yard([(m, k, n)], dev) if cuda else None,
                "_int_mm")


def main(argv=None, shape=None) -> int:
    return _main("exp_fc1", MODES, build, argv, shape)


if __name__ == "__main__":
    sys.exit(main())
