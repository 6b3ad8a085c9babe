"""K18 on the card: ``tools/exp_attn.py``'s attention with its stages
switched off one at a time (``csrc/attn_ablation.cu``,
``ops/ablations.py:exp_attn``), at the root tool's shape (8 images of 224
rows, keys from the first 208, 12 heads of 64, x N(0, 0.01) in bf16) and
seed:

    python3 -m quantized_vit_tpu_torch.tools.exp_attn [mode ...] [--device cpu]

The kernel runs both products on the FP64 tensor cores (mma.sync m16n8k4
.f64), one block a (head, image) with K and V staged once as f64 rows, a
warp's scores and p in its registers. Modes: full, no_mask, no_max,
no_exp, matmuls_only, sum_only, recip (rcp.approx.f32), no_sum; mxu_sum
(the row sums from the P.V MMA as one more n8 column of ones) and
transposed (S^T = K Q^T, reduced over the MMA's other axis) compute full's
function, so ``full`` minus a mode is that stage's cost on this design.
For each mode: the parity against the plain version, the kernel's us per
launch (events and device time), its bound and the FP64 tensor cores'
ceiling, the plain version's time; then bf16
``scaled_dot_product_attention`` at [8, 12, 224, 64], a yardstick an exact
kernel cannot match.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import ablations as ab
from ._ablation import Mode, Tool, main as _main, sdpa_yard

B, N, NK, H, HD = 8, 224, 208, 12, 64
MODES = list(ab.EXP_ATTN_MODES)
# the modes whose p goes through expf or whose sum through rcp.approx:
# within the levels contract on the card, not held bit-exact
EXACT_MODES = {"no_exp", "matmuls_only"}


def build(dev, modes=MODES, shape=None) -> Tool:
    b, n, nk, h, hd = shape or (B, N, NK, H, HD)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, n, 3 * h * hd)) * 0.1).to(
        torch.bfloat16).to(dev)
    kw = dict(heads=h, n_keys=nk)
    cuda = dev.type == "cuda"
    out = []
    for mode in modes:
        call = lambda mode=mode: ab.exp_attn(x, mode, **kw)
        out.append(Mode(
            mode, call, call,
            lambda mode=mode: ab.exp_attn_plain(x, mode, **kw),
            # q at every row, k and v at the first nk; the int8 levels
            bytes=b * (n + 2 * nk) * h * hd * 2 + b * n * h * hd,
            ops=4 * b * h * n * nk * hd, kind="bf16",
            levels=mode not in EXACT_MODES))
    return Tool(out, sdpa_yard(b, h, n, hd, dev) if cuda else None,
                "sdpa_bf16")


def main(argv=None, shape=None) -> int:
    return _main("exp_attn", MODES, build, argv, shape)


if __name__ == "__main__":
    sys.exit(main())
