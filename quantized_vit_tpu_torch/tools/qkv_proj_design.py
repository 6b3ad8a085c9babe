"""K9's layouts on the card: every (query rows R, cluster size G) at its
two timing sites.

K9 (``csrc/attention_proj.cu``) splits the heads of one (image, tile of R
query rows) over a cluster of G blocks; ``ops/attention.py:
qkv_proj_layout`` picks (R, G) from the card's SMs and shared memory. This
tool launches K9 through ``ops/attention.py:_launch_qkv_proj`` (the
wrapper's launch, at a layout other than the picker's) at ViT-H/14 batch 8 and ViT-B/16 batch 32
(random bf16 qkv and residual, int8 ``w_proj``, float attention, t = 1)
at every layout that fits, and prints for each the grid's blocks, the
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``),
the mean of ``REPS`` back-to-back launches (CUDA events) and whether its
output equals the picked layout's bit for bit (it must: each output
column's int32 sum runs in one block whatever the split). Then, for each
site, the picked layout's time with ``int_attention`` on, and the
ceiling of an exact kernel from the H100 SXM data sheet (no
measurement): the attention's operations at the FP64 tensor-core rate
plus the proj's at the int8 rate::

    python3 -m quantized_vit_tpu_torch.tools.qkv_proj_design
"""

from __future__ import annotations

import subprocess

import torch

from ..ops import _build
from ..ops.attention import (QKV_PROJ_MAX_CLUSTER, QKV_PROJ_TILES, SMEM_LIMIT,
                             _card_shape, _launch_qkv_proj,
                             plan_attention_qkv_proj, qkv_proj_clusters,
                             qkv_proj_layout, qkv_proj_smem_bytes)

# (tag, B, N, heads, head_dim, real tokens)
SITES = (("vith_b8", 8, 272, 16, 80, 257), ("vitb_b32", 32, 208, 12, 64, 197))
REPS = 50
# H100 SXM data sheet: FP64 tensor-core FLOP/s, dense int8 operations/s
FP64_TC_PEAK, INT8_PEAK = 67e12, 1979e12


def mean_us(fn):
    """The mean of ``REPS`` back-to-back calls of ``fn`` (CUDA events),
    after three warm-up calls."""
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) * 1e3 / REPS


def site(tag, b, n, heads, hd, nv, g):
    d = heads * hd
    bf16 = torch.bfloat16
    one = torch.ones((), device="cuda")
    qkv = (torch.randn((b, n, 3 * d), generator=g, device="cuda")
           * 0.7).to(bf16)
    res = torch.randn((b, n, d), generator=g, device="cuda").to(bf16)
    w = torch.randint(-7, 8, (d, d), dtype=torch.int8, device="cuda",
                      generator=g)
    plan = plan_attention_qkv_proj(w, 2e-3 * one, None, heads=heads,
                                   sm_scale=hd**-0.5, out_d=0.01 * one,
                                   out_t=one, out_top=31)
    dt = _build.dtype_code(bf16)
    pick = qkv_proj_layout(b, n, heads, hd, 2, *_card_shape(0))

    def launch(rows, cl, int_attention=False):
        return _launch_qkv_proj(plan, qkv, res, rows, cl, n_valid=nv,
                                int_attention=int_attention)

    want = launch(*pick)
    print(f"attention_qkv_proj:{tag} [{b}x{n}, {heads} heads of {hd}], "
          f"picked R {pick[0]} G {pick[1]}")
    for rows in QKV_PROJ_TILES:
        smem = qkv_proj_smem_bytes(rows, hd, d, 2)
        if smem > SMEM_LIMIT:
            continue
        for cl in range(1, QKV_PROJ_MAX_CLUSTER + 1):
            if heads % cl:
                continue
            active = qkv_proj_clusters(0, dt, heads, hd, rows, cl)
            if not active:
                print(f"  R {rows} G {cl}: cannot be scheduled")
                continue
            us = mean_us(lambda: launch(rows, cl))
            out = launch(rows, cl)
            mark = " (picked)" if (rows, cl) == pick else ""
            print(f"  R {rows} G {cl}{mark}: {-(-n // rows) * b * cl} blocks"
                  f" of {smem} B, {active} clusters resident, {us:.1f} us, "
                  f"equal {bool(torch.equal(out, want))}")
    us = mean_us(lambda: launch(*pick, int_attention=True))
    print(f"  R {pick[0]} G {pick[1]} (picked), int_attention: {us:.1f} us")
    nk = -(-nv // 16) * 16
    attn_ops = b * 2 * heads * n * nk * hd * 2
    proj_ops = 2 * b * n * d * d
    print(f"  exact kernel's ceiling (data sheet): attention "
          f"{attn_ops / FP64_TC_PEAK * 1e6:.1f} us + proj "
          f"{proj_ops / INT8_PEAK * 1e6:.1f} us = "
          f"{(attn_ops / FP64_TC_PEAK + proj_ops / INT8_PEAK) * 1e6:.1f} us")


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    for s in SITES:
        site(*s, g)


if __name__ == "__main__":
    main()
