#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: the ViT-B/16 W4A4 serving
paths, ViT-H/14 serving with int8-stored levels, the kernel-level entry
points that the JAX package's bench and tools drive, FSDP serving with
in-kernel weight gathers, tensor-parallel and column-FSDP serving
(processes sharing the card), the ViT-B/16 QAT + GETA training
path, multi-device training (DP x TP, checkpoints, elastic recovery,
GPipe), UltraNet end to end (float, subnet, integer artifact, FPGA
headers), and the other model families (ResNet, MobileNet, the
separate-q/k/v Transformer, the conv autoencoder, LoRA) trained through K7
and compressed, and interop and the automatic grouping (a reference ViT
``.pt`` through the CLIs onto the serving path, the traced-graph grouping
at the families' configurations, a discovered-group QAT run compressed).

Run from the repository root (no arguments; one CUDA card):

    python3 chip_smoke.py

``--phase N`` runs the build and phase N alone, for the phases that need
no earlier phase's output (11, 12 and 13; ``phases_alone``); its record is
printed under its own key beside the (empty) kernel rows.

Phases, in order; any failure exits non-zero:

1. build every CUDA kernel from ``quantized_vit_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel);
2. hold each kernel (K1 ``fused_quant_matmul``, K2 ``fused_mlp``, K3
   ``attention_block``, K4 ``patch_finalize``, K5 ``block_stack``, K6
   ``attention_qkv``, K8 ``fused_mlp_chunked``, K9 ``attention_qkv_proj``,
   K10-K12 ``int4_matmul``, ``int8_matmul``, ``quant_matmul_fa``, K13
   ``flash_attention``, K14 ``gather_rows``, K15 ``fused_mlp_gather``)
   against its plain PyTorch version on the card, at the main paths' ViT-B
   shapes (K13 at its path's ViT-B and ViT-H shapes and a ragged one, in
   bf16, f32 and mixed q/v dtypes, then at 592 tokens, head_dim 128 and 20
   and wherever else its nine (query tile, head bound) instantiations
   need; K14 on a ViT-B block's weights as
   int8, packed int4 and bf16 bytes, on ViT-H/14's as int8, and on int8
   shards and outputs at byte offsets (pairs off 16-byte alignment, a
   zero-byte job); K15 at the batch's
   rows and ragged
   ones and at ViT-H/14's width at 8704, 544 and 1000 rows, all at tp =
   1 here and at tp = 2 and 4 in phase 3c),
   at ViT-H/14's (K8 at 272 and 544 rows, K2 there with int8, packed
   int4 and mixed weights, K3, K6 and K9 at head_dim 80; K3 also with an
   f32 residual stream at batch 4), K1 at every site of the forwards
   (the chain's qkv and proj at batch 1-3 in bf16 and f32, the head at
   one row, ViT-H/14's patch embed at K = 588 on its padded plan and on
   a shared copy read byte by byte, its chain qkv at batch 2, fc1 and
   fc2 at batch 32) and launched at set work splits at 416, 544 and 6656
   rows (whole tiles only, every tile split 2 to 10 ways, 64 and 128
   tiles), K2 launched at set work splits at
   ViT-B's batch 1, 2 and 32 rows (both tiles of each GEMM, fc2's tiles
   whole and split), K3 and K6 launched at
   set query tiles at every (query rows, qkv dtype, head bound)
   instantiation (ragged last tiles, masked keys; K6's three output
   modes, K3's int8 and packed int4 weights and both quantizers;
   ``int_attention``), K6 at 592 tokens in f32 (a 384-px ViT-B/16), K9
   at bench.py's preamble shapes and, launched at set
   layouts, at every
   (query rows, qkv dtype, head bound) instantiation with cluster sizes 1
   to 8 (ragged last tiles, odd head counts, columns split unevenly
   against the proj's 256-column pass), K10-K12 at
   tools/profile_kernels.py's four ViT-B layer shapes (and with float16
   out), and at small ragged
   shapes, for packed int4 and int8 weights, the linear (t = 1) and pow
   (t != 1) quantizers, both residual dtypes and ``int_attention`` on and
   off, under the parity contract: int8 levels within 1 level at <= 0.5%
   of positions, the MLP block's output (K2, K8) within 1e-5, attention
   outputs (K3's and K9's branch, K6's float output) within 0.1
   everywhere and differing at <= 1% of positions, the rest (K5's
   residual stream included) exact;
   each row says whether it is bit-exact;
3. the forwards (random artifact from seed 0, host-patchified input, bf16
   residual stream), each with the launch counters set to 0 just before
   and read just after, logits against the plain path: ViT-B/16 at batch
   32 (K3 + K2 route) for both weight storages, the chain at batch 1, 2
   and 3 (K1 + K6 + K1, then K2, or K8 at batch 3 where the JAX routing
   streams int8 weights), ``int_attention`` on both routes (batch 4 and
   2), the batch-1 latency entry (one K5 launch; at 224 px, and for the
   384-px ViT-B/16 at depth 2 in bf16, logits equal to the plain path's)
   and a 384-px ViT-B/16
   at depth 2 on the chain at batch 1 with an f32 residual stream (K6 on
   592 tokens, K8) and on the K3 route at batch 4 in bf16 (K3 on 592
   tokens), and ViT-H/14 at depth 2 on the K3 route at batch 4 with an
   f32 residual stream and, with packed int4, on the chain at batch 1 and
   2 (K2 at K = 1280; the logits of these and of the K3 routes required
   equal to the plain path's); then ViT-H/14 at
   full width and depth 32 (int8-stored levels) at batch 1 and 2 (K1 +
   K6 + K1 + K8 per block) and 32 (K3 + K1 proj + the K1 fc1/fc2 chain);
3b. the kernel-level paths at full width, each with the launch counters
   checked: bench.py's parity preamble (K9), tools/exp_vith.py's ViT-H/14
   attention branch at batch 8 (K1 qkv + K9 against K3's branch),
   tools/profile_kernels.py's GEMMs (K10-K12 at ViT-B's layer shapes) and
   the LSFQ pipeline of tests/ops/test_int4_matmul.py at fc1's width
   (K10 and K12 against the fake-quant float product, within 1e-4), and
   K13 on the q/k/v of block 0 of the seed-0 artifacts (ViT-B/16 batch
   32, ViT-H/14 batch 1 and 8; float and int8 outputs);
3c. FSDP serving (serve/vit_fsdp.py) on the batch-32 forward's artifact
   and images, and on ViT-H/14's (batch 32): at tp = 1 in this process
   (ViT-H/14 at full depth), at tp = 2 as two spawned processes sharing
   the card (gloo, CUDA IPC, interprocess events; ViT-H/14 at depth 8),
   each run's launches checked (1 K14, 12 K15, 12 K3, 14 K1, 1 K4; 32
   K15, 32 K3, 34 K1 at ViT-H/14 full depth) and its logits bit-equal
   to ``vit_int4_forward``'s; the spawned groups (tp = 2 and 4) also
   hold K14 and K15 (at both widths) against the full weights and
   ``fused_mlp_plain``, each process under a deadline;
3d. the root tools' six timing ablations (K16-K21, ``ops/ablations.py``:
   K1's fc1 with prologue and epilogue variants, K6's attention with its
   stages switched off and with J images a block), each tool's modes
   through its wrapper at the root tool's shapes and seed with the
   launch counters checked (one launch a mode), every mode against its
   plain version (bit-exact, or within 1 level at <= 0.5% of positions
   where a library transcendental or rcp.approx enters), each timed
   (events; the device time of each tool's reported mode), its plain
   version and the tool's yardstick (``torch._int_mm`` at the GEMM's
   shape, bf16 ``scaled_dot_product_attention``), each tool's count of
   bit-exact modes logged; then K18's ten modes at ``EXP_ATTN_EDGES``
   (bf16 K/V rows past 208 keys, narrow heads, ragged tiles) and K19 at
   ``EXP_ATTN2_EDGES`` (keys past its 224-key ring, ragged chunks and
   tiles, heads of 8 and 40, one key, no key, no mask, scores past the
   clamp, a qkv off 16-byte alignment) and K17 (and one K16 row) at
   ``EXP_PRO2_EDGES`` (M off the token panel and under one, N off 8,
   K 80 and 1280, a depth that one window of the 64-token panel holds
   and one past that window, random g and b with clipped levels, the
   bias and folded modes), each bit-exact,
   each family's bit-exact rows logged;
4. the serving CLI's forward behind a batcher: single requests and pairs
   (buckets 1 and 2, the chain through K6), then the CLI's own burst of 64
   requests at max batch 8 on the artifact saved by the port's writer;
   every answer equal to a direct forward of the same images;
5. timings with CUDA events (warm-up, then the median of 20 runs, 200
   under 1 ms): each kernel at its main-path shapes (ViT-B's, K2 also at
   batch 2 and 1 and K8 beside it on the same int8 weights at batch 32,
   2 and 1, and ViT-H/14's: K8 at batch 1 and 2, K2 with packed int4 at
   batch 1 and 2, K1's embed, chain qkv and fc1/fc2
   chain, K3 at batch 32, K6 at batch 1 and 2; K9 at ViT-H's batch 8 and
   ViT-B's 32, K10-K12 at ViT-B's layer shapes; K6 also with
   ``int_attention`` at ViT-B's batch 2 and 32), its plain version,
   ``torch._int_mm`` on its GEMM shapes and
   ``scaled_dot_product_attention`` on K6's, K9's and K13's shapes
   (at K2's, K3's, K6's, K8's and K13's sites with the host's time a call
   and the device time of both, and K3's and K6's FP64 tensor-core
   ceiling;
   yardsticks the port never calls; beside K9 also K6 + K1 and K3's
   branch, beside K12 K1 with its quant prologue, beside K15 K2 on the
   same plan, at ViT-B/16's and ViT-H/14's batch 32), ``torch.cat``
   beside K14, K15's overlap sweep
   (tools/exp_rdma_overlap.py's question: K2 alone, then K15 gathering
   4-31 MB), the FSDP forwards at tp = 1 against ``vit_int4_forward``,
   both routes' attention branch at batch 2, 3, 4, 8, 16 and 32, the
   forwards, and a plain bf16 PyTorch ViT forward of the same
   architecture (ViT-B/16 at batch 32, 1 and 2; ViT-H/14 at 1, 2, 32);
6. training: ViT-B/16 at full width, batch 32, seeded synthetic NHWC
   images, ``QuantConfig(enabled=True, fused_vjp=True)`` at 32 bits, GETA
   with ``cli/train.py``'s defaults over a 13-step schedule (warmup,
   range projection with a bit ramp-down, two pruning periods, fix) driven
   by ``TrainLoop.train_one_epoch``, with the launch counters set to 0
   just before and read just after: every loss finite, K7
   (``quant_bwd``) launched 100 times per step, the target group sparsity
   reached, the bit layout frozen; then ``evaluate`` on held-out arrays, a
   checkpoint round trip, and one step with K7 against the same step with
   the plain chain (losses equal, every gradient but the quantizer
   scalars' bit-identical, those within K7's contract); K7's parity cases
   run in phase 2 (grad_x bit-exact, each sum within 1e-5 of its
   summands' L1 mass). Timings: K7's device time over the training run
   (torch.profiler's CUDA trace of the run), K7 and its plain version on
   the inputs of every quantizer site of one training step (CUDA events,
   and the kernels' own device time from torch.profiler), the whole step
   with K7 and with the plain chain in turns, a profile of each, and a
   plain PyTorch ViT-B/16 training step (f32 and bf16 autocast,
   ``torch.optim.Adam``) as the yardstick;
7. train -> compress -> export -> serve: the trained params through
   ``OTO.construct_subnet`` (per-block head counts and hidden widths),
   ``export_vit_int4``, the artifact writer and reader, then the forward
   on the batch-32 route and the chain at batch 1 and 3, each MLP on the
   route its own width takes, and the batch-1 latency entry's refusal
   of the non-uniform stack; a uniform subnet (``random_set_zero_groups``
   at one sparsity on the run's initial params, packed int4) through
   all three routes; launches checked and logits against the plain
   path's, as the other forwards'; widths, MACs and BOPs before and
   after, and the forward times;
8. the pruning-only optimizers, the inference CLIs and the RPC serving
   front, at ViT-B/16 width: HESSO (``OTO.hesso``) on the QAT ViT
   (``fused_vjp``: K7 in every nonlinear quantizer's backward) at batch
   32, driven by ``TrainLoop`` through warmup and two pruning periods
   (every loss finite, K7's launches per step, the target sparsity, the
   pruned rows exactly zero), its subnet through ``export_vit_int4`` on
   the batch-32 route (launches, logits equal to the plain path's), ms
   per step and K7's device time per step; HESSO-CRIC in a hand loop
   that passes the loss (two cycles, the reset bit for bit, the final
   redundant set at its target size); a class-per-subfolder tree of
   seeded PNGs through ``cli.eval`` (phase 6's params and phase 7's
   subnet, from checkpoints written here) equal to a direct
   ``evaluate``, ``cli.predict`` equal to a direct forward's softmax, a
   non-RGB file refused; and ``MultiHostFrontend`` over an in-process
   batcher and an ``RpcBackendStub`` of a worker process serving phase
   4's artifact on the card, 64 requests, both backends used, every
   answer equal to a direct forward of its image, req/s and p50/p99;
9. multi-device serving on the seed-0 packed-int4 ViT-B/16 at batch 32,
   the 'model' axis's processes sharing the card (tp = 1 in this process,
   2 and 4 spawned; gloo, CUDA IPC, interprocess events): the collective
   health check, the tensor-parallel forward (the levels-only K1 launch,
   K14's int8 all-gather, K1 qkv, K6 on a process's heads, K1 proj, the
   reduce-scatter, the same for fc1 / fc2) in f32/f32 and bf16/bf16, no
   further from the single-device f32 forward than 1.5x the bf16
   single-device forward's, and the column-sharded FSDP forward (K14
   gathering each block's column shards one block ahead), bit-equal to
   the single-device forward; each run's launches, collectives and fences
   checked, each forward timed in turns with the single-device one and
   traced once; the levels launch against its plain version and K1's own
   level scratch, byte for byte; the serve CLI's ``--mesh-model 2`` in
   tp and fsdp mode (``--input-uint8``) against direct forwards;
10. multi-device training at ViT-B/16 width (QAT, K7 on every nonlinear
   quantizer's backward, seed 0, batch 32), four processes sharing the
   card: the DP x TP step at (1, 1) here and (2, 2), (1, 2), (2, 1)
   spawned, each layout's first-step loss and gathered gradients against
   the single-process step, its step time, fences, K7 launches and peak
   memory; the int8 gradient ring at dp = 2 against the exact sum; a
   sharded checkpoint written at (2, 2) and restored at (1, 2) and
   (2, 1); an elastic run that loses two processes to an injected
   failure and resumes on (1, 2), bit-equal to an uninterrupted (1, 2)
   run from the checkpoint; GPipe at 2 stages against the single-process
   float forward; TP and column-FSDP serving with a data axis of 2 at
   (2, 1) and (2, 2) against the (1, tp) forwards;
11. UltraNet (``models/ultranet.py``; no CUDA kernel of its own: its
   convs are cuDNN's, the integer ones exact in f64) at 160 x 320, full
   width, seed 0 with BN statistics drawn from numpy: each block on the
   CPU's input activation at batch 4 (eval and train: BN outputs within
   ULTRA_BN_TOL, levels equal off ties, the updated running statistics),
   the whole net in f64 against the CPU's (eval outputs, train outputs,
   running statistics and the gradients of sum(p^2)), then GETA's random
   zeroing at 0.4, ``construct_subnet`` (MACs fall, the subnet's forward
   runs), the integer artifact exported, saved, loaded and run at batch
   32 (raw predictions bit-equal to the CPU's on the same tables, boxes
   within 1e-6 relative), the FPGA headers and the reference npz
   byte-identical to the CPU's from the same tables, the native packer
   (g++ at its first use) against its numpy path; timed at batch 32:
   the integer forward, the float eval forward, the train step (train
   forward and backward), the subnet's forward, and plain bf16 cuDNN
   convs of the same architecture without quantizers (a yardstick).
12. the other model families (``models/{resnet,mobilenet,transformer,
   autoencoder,lora}.py``; their only kernel is K7, at every quantized
   layer's two quantizers), f32 with TF32 off: ResNet-20 and MobileNet on
   32 x 32 x 3 at batch 128, the BERT-base encoder at 128 tokens and
   batch 32 with a ragged mask, the U-Net autoencoder at 64 x 64 and batch
   32, each: three GETA QAT steps with K7 (its launches a step counted,
   one step traced with torch.profiler: two a quantized layer), one step
   against the plain chain (as phase 6: losses equal, gradients
   bit-identical, the quantizers' within 1e-5 of their summands' L1
   mass), the card against the CPU at batch 4 with the
   quantizers at 8 bits (each quantized layer on the CPU's input: levels
   equal off ties, the product within FAMILY_CPU_TOL; the whole net in
   f64), GETA's random zeroing at 0.4 and ``construct_subnet`` (the
   subnet's forward equal to the zeroed model's in f64, its MACs lower),
   and the eval forward and train step timed (the eval forward and a
   GETA step traced once); the Llama-style block (BERT-base
   widths, 4 kv heads, RoPE, SwiGLU, causal, depth 2) compressed the same
   way; LoRA at 768 -> 3072 on 4096 rows and a 30522 x 768 embedding (the
   merge lossless, HESSO zeroing lora_b's columns with the base's, timed);
   ``model_to_quantize_model`` on ResNet-20 at 32 bits.
13. interop and the automatic grouping (``interop/``, ``graph/tracer.py``,
   ``graph/autogroups.py``, ``compress/auto.py``; no kernel of their own):
   the ViT-B/16 QAT tree (LSFQ at INTEROP_BITS, seed 0) written as a
   reference ``.pt`` and read back by ``load_params_any`` (bit-equal),
   exported by ``cli.export vit`` (the artifact byte-equal to the source
   tree's) and served at BATCH on the block route (K1, K4, K3 + K1 + K2 a
   block; launches counted; logits bit-equal to the source artifact's),
   int4-packed as the CLI writes it and int8-stored; ``cli.export torch``
   into the reference-shaped torch ViT, its f32 logits at
   INTEROP_TORCH_BATCH against the port's float forward and the CPU's run
   (TF32 off); the ONNX export's contract; discovery equal to the
   declarative builders on ResNet-20, MobileNet and UltraNet (at
   ULTRA_HW), ``validate_node_groups`` and conservative discovery on
   ViT-B/16 (make_fx's host ms and node counts recorded); LSFQ ResNet-20
   with discovered groups: FAMILY_STEPS GETA steps through K7, then
   ``construct_subnet_auto`` bit-equal to ``construct_subnet_resnet``, the
   compressed forward within FAMILY_SUBNET_TOL of the sparse one in f64.

It prints ``{"kernels": [...]}``, then the card's name and power limit as
``nvidia-smi`` reports them, then ``{"ok": true, "device": {...}}`` as the
last line, and writes the full record to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build")
BATCH = 32
ITERS = 20
SHORT_ITERS = 200  # timed runs of anything under 1 ms
# the main path's configuration; a CPU rehearsal (tests) shrinks these
DEV = "cuda"
CFG_KW: dict = {}
# a 384-px ViT-B/16 (577 tokens, 592 padded), depth cut to 2: on the
# chain at batch 1 with an f32 residual stream (the first K6 refused it)
# and on the K3 route at batch 4 in bf16 (the first K3 refused it)
B384_KW: dict = dict(img_size=384, depth=2)
# the ViT-H/14 serving phase: the published widths (Dosovitskiy et al.
# 2021, Table 1: D 1280, 16 heads, MLP 5120, patch 14 at 224 px) at full
# depth, int8-stored levels; a rehearsal shrinks these too
VIT_H_KW: dict = dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16,
                      num_classes=1000)
VIT_H_BATCHES = (1, 2, 32)
# the kernel-level paths of bench.py and the JAX package's tools: the ViT-H
# attention branch at tools/exp_vith.py's batch 8, and the GEMMs at
# tools/profile_kernels.py's M = 8 images of ViT-B/16's padded tokens
VIT_H_BRANCH_BATCH = 8
PROFILE_BATCH = 8
# K10-K12's launch counters
INT_MM_KERNELS = ("int4_matmul", "int8_matmul", "quant_matmul_fa")
# K13's kernel path: q/k/v of block 0 at ViT-B/16 batch 32 (BATCH) and
# ViT-H/14 batch 1 and 8
K13_VIT_H_BATCHES = (1, 8)
# the FSDP phase (serve/vit_fsdp.py): its forward at tp = 1 in this
# process and at FSDP_TP in spawned processes sharing the card; the
# gathers' parity rows at each of GATHER_TPS (tp > 1 spawned); K15 at
# ragged row counts beside the batch's; the overlap sweep's dummy shards
# (tools/exp_rdma_overlap.py:97-121)
FSDP_TP = 2
GATHER_TPS = (1, 2, 4)
K15_RAGGED_M = (96, 1000)
OVERLAP_MB = (4, 8, 16, 31)
FSDP_TP_ITERS = 5
# the spawned ViT-H/14 FSDP forward's depth (tp = 1 runs all 32 blocks)
VIT_H_FSDP_TP_DEPTH = 8
SPAWN_TIMEOUT_S = 300
ART_DIR = os.path.join(ROOT, "build", "smoke_artifact")  # serve phase

# H100 data-sheet peaks (dense): int8 TOP/s, bf16 FLOP/s, HBM bytes/s,
# FP64 tensor-core FLOP/s (the ceiling of an exact attention kernel on the
# f64 MMA: K6's timing sites)
PEAKS = {
    "SXM": (1979e12, 989e12, 3.35e12, 67e12),
    "PCIe": (1513e12, 756e12, 2.0e12, 51e12),
    "NVL": (1671e12, 835e12, 3.9e12, 60e12),
}
# f32 FLOP/s outside the tensor cores (data sheet): K7's operations
F32_PEAKS = {"SXM": 67e12, "PCIe": 51e12, "NVL": 60e12}
# the training phase's schedule: warmup (step 1), range projection (2-11,
# one bit ramp-down at step 4), two pruning periods (boundaries at steps 6
# and 9, commits at 7 and 10), fix (12-13); the cli/train.py defaults
TRAIN_STEPS = 13
GETA_KW = dict(lr=1e-4, lr_quant=1e-3, variant="adam", weight_decay=0.0,
               target_group_sparsity=0.5, group_divisible=1,
               start_projection_step=1, projection_steps=4,
               projection_periods=2, start_pruning_step=5, pruning_steps=6,
               pruning_periods=2, bit_reduction=4.0, min_bit_wt=4.0,
               max_bit_wt=32.0, min_bit_act=4.0, max_bit_act=32.0)
TRAIN_CKPT = os.path.join(ROOT, "build", "smoke_train_ckpt")
# phase 8: HESSO's schedule (warmup steps 1-4, two pruning periods of 4
# steps: boundaries at 5 and 9, commits at 7 and 11), HESSO-CRIC's (a
# basic step, two sampling cycles of 3 steps from step 2, the final set at
# step 8, then 3 hybrid steps), the image tree, the RPC burst. Both
# optimizers step the quantizers' d with the weights' rate, unclamped
# (Adam moves a leaf by about lr a step): 1e-5 keeps an 8-bit d (~1e-3 at
# ViT-B's init) within a few percent over the run
HESSO_STEPS = 12
HESSO_KW = dict(lr=1e-5, variant="adam", target_group_sparsity=0.5,
                start_pruning_step=4, pruning_steps=8, pruning_periods=2)
CRIC_STEPS = 12
CRIC_KW = dict(lr=1e-5, variant="adam", target_group_sparsity=0.5,
               start_cric_step=2, proj_per_node_group=False,
               sampling_steps=3, max_cycle_period=3, hybrid_training_steps=3,
               tolerance=-1)
FOLDER_DIR = os.path.join(ROOT, "build", "smoke_folder")
FOLDER_CLASSES, FOLDER_PER_CLASS = 4, 16
RPC_REQUESTS = 64
RPC_PORT_TIMEOUT_S = 240
# phase 11: UltraNet at its export input (artifact/ultranet.py
# UltraNetExportConfig.input_shape, the reference's torch_export.py:150),
# full width; the checks against the CPU run at ULTRA_CHECK_BATCH; GETA's
# random zeroing at ULTRA_SPARSITY for the subnet
ULTRA_HW = (160, 320)
ULTRA_BATCH = 32
ULTRA_CHECK_BATCH = 4
ULTRA_SPARSITY = 0.4
# card against CPU: a BN output (f32, the convs' sums in their own orders)
# within these of the CPU's on the same layer input, eval / train; a level
# may differ by one where the value lies within ULTRA_TIE levels of a
# half-level; the f64 run end to end within ULTRA_F64_TOL relative
ULTRA_BN_TOL = (1e-4, 1e-3)
ULTRA_TIE = 1e-3
ULTRA_F64_TOL = 1e-9
# phase 12: the other model families at the repo's configurations' full
# widths: ResNet-20 (He et al. 2016 §4.2) and MobileNet on CIFAR's 32 x 32
# x 3, the BERT-base encoder (Devlin et al. 2019) at 128 tokens with a
# ragged mask, the U-Net autoencoder at 64 x 64, LoRA at BERT-base's MLP
# and vocabulary; FAMILY_STEPS GETA QAT steps each (warmup, then a pruning
# window from step 2; the quantizers from 32 bits); the checks against the
# CPU at FAMILY_CHECK_BATCH; the random zeroing at FAMILY_SPARSITY
CIFAR_HW, CIFAR_BATCH = 32, 128
BERT_SEQ, BERT_BATCH = 128, 32
AE_HW, AE_BATCH = 64, 32
LORA_DIMS = (768, 3072, 30522)  # LoraDense in -> out; the embedding's vocab
LORA_ROWS, LORA_RANK = 4096, 8
# a rehearsal shrinks these configurations
RESNET_KW: dict = {}
BERT_KW: dict = {}
FAMILY_STEPS = 3
FAMILY_CHECK_BATCH = 4
FAMILY_SPARSITY = 0.4
FAMILY_GETA_KW = dict(lr=1e-5, lr_quant=1e-3, variant="adam",
                      target_group_sparsity=0.4, start_projection_step=1,
                      projection_steps=1, projection_periods=1,
                      start_pruning_step=1, pruning_steps=2,
                      pruning_periods=1, max_bit_wt=32.0, max_bit_act=32.0,
                      min_bit_wt=4.0, min_bit_act=4.0)
# a layer's product on the CPU's quantized operands, card against CPU,
# relative to its largest magnitude (ULTRA_BN_TOL's eval bound); levels
# within FAMILY_TIE of a half-level may differ by one; the f64 run end to
# end within FAMILY_F64_TOL; a subnet's forward within FAMILY_SUBNET_TOL of
# the zeroed model's (relative, floor 1; in f64, where only the summation
# order differs: in f32 cuBLAS and cuDNN pick other algorithms for the
# sliced shapes: 1e-5-5e-5 apart at ResNet-20 and BERT-base on an H100)
FAMILY_CPU_TOL = 1e-4
FAMILY_TIE = 1e-3
FAMILY_F64_TOL = 1e-9
FAMILY_SUBNET_TOL = 1e-5
# phase 13: the ViT-B/16 QAT tree's quantizers at INTEROP_BITS; the
# reference-shaped torch module against the port's float forward at
# INTEROP_TORCH_BATCH within INTEROP_TOL (rtol and atol); the compressed
# ResNet-20's eval forward within FAMILY_SUBNET_TOL of the sparse one
INTEROP_BITS = 4.0
INTEROP_TORCH_BATCH = 8
INTEROP_TOL = 1e-4
INTEROP_DIR = os.path.join(ROOT, "build", "smoke_interop")


def log(*a):
    print(*a, flush=True)


class Failed(Exception):
    pass


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="drive the port on one GPU")
    ap.add_argument("--phase", type=int, choices=sorted(phases_alone()),
                    default=None, help="run the build and this phase alone")
    only = ap.parse_args(argv).phase
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import quantized_vit_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    record = {"device": torch.cuda.get_device_name(0)}
    try:
        run(record, only)
    except Failed as e:
        log(f"FAILED: {e}")
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1, default=str)
        return 1
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    line = {"kernels": record.get("kernels", [])}
    if only is not None:
        key = phases_alone()[only][0]
        line[key] = record[key]
    print(json.dumps(line, default=str))
    print(record["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------


def phases_alone():
    """{phase: (its record's key, its function)} of the phases that need
    no earlier phase's output."""
    return {11: ("ultranet", ultranet_phase),
            12: ("families", families_phase),
            13: ("interop", interop_autogroups_phase)}


def run(record, only=None):
    """Every phase in order; ``only``: the build and that phase of
    ``phases_alone``."""
    from quantized_vit_tpu_torch.ops import _build

    dev = torch.device(DEV)
    peaks = next((v for k, v in PEAKS.items() if k in record["device"]),
                 PEAKS["SXM"])
    record["peaks"] = {"int8_ops": peaks[0], "bf16_flops": peaks[1],
                       "bytes_per_s": peaks[2], "fp64_tc_flops": peaks[3]}
    if dev.type != "cuda":  # CPU rehearsal: plain versions only
        record["nvidia_smi"] = "cpu rehearsal, no card"
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        record["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
        log("card:", record["nvidia_smi"])
        t0 = time.time()
        try:
            bdir = _build.build_all()
        except Exception as e:  # a kernel that does not build fails the run
            raise Failed(f"build: {e}")
        record["build_s"] = round(time.time() - t0, 1)
        record["build_source_s"] = dict(_build.BUILD_SECONDS)
        log(f"[build] {record['build_s']} s -> {bdir}")
        ptx = bdir / "ptxas.log"
        record["ptxas"] = [ln.strip() for ln in (
            ptx.read_text().splitlines() if ptx.exists() else [])
            if "registers" in ln or "spill" in ln]
        for ln in record["ptxas"]:
            if "registers" in ln:
                log("  ptxas:", ln)

    if only is not None:
        phases_alone()[only][1](dev, record)
        return
    parity = Parity(dev)
    parity.run_all(main_cfg())
    record["parity"] = parity.rows
    if parity.failures:
        raise Failed("kernel parity: " + "; ".join(parity.failures[:8]))

    fwd = forward_phase(dev, record)
    fwd["vit_h"] = vit_h_phase(dev, record)
    fwd["paths"] = kernel_paths_phase(dev, record, fwd)
    fwd["fsdp"] = fsdp_phase(dev, record, parity, fwd)
    ablations = ablations_phase(dev, record, parity)
    serve_phase(dev, record, fwd)
    timing_phase(dev, record, fwd, peaks)
    record["kernels"] += ablation_kernel_rows(record, ablations)
    # phase 7's yardsticks: the seed-0 ViT-B/16 artifacts
    arts = {k: fwd[k] for k in ("art", "art_packed", "cfg", "x")}
    del fwd
    trained = train_phase(dev, record, peaks)
    subnet_phase(dev, record, trained, arts)
    hesso_phase(dev, record)
    cli_rpc_phase(dev, record, trained)
    mesh_phase(dev, record, parity, arts, peaks)
    train_mesh_phase(dev, record, arts)
    ultranet_phase(dev, record)
    families_phase(dev, record)
    interop_autogroups_phase(dev, record)


def main_cfg():
    from quantized_vit_tpu_torch.models import ViTConfig

    return ViTConfig(**CFG_KW)  # ViT-B/16 unless a rehearsal shrinks it


def vit_h_cfg():
    from quantized_vit_tpu_torch.models import ViTConfig

    return ViTConfig(**VIT_H_KW)  # ViT-H/14 unless a rehearsal shrinks it


def vit_h_shapes(cfg):
    """(patches, D, real tokens, padded tokens, hidden, heads) of the
    ViT-H/14 phase."""
    n_pad = -(-cfg.num_tokens // 16) * 16
    return (cfg.num_patches, cfg.embed_dim, cfg.num_tokens, n_pad,
            int(cfg.embed_dim * cfg.mlp_ratio), cfg.num_heads)


def profile_shapes(cfg):
    """(layer, M, K, N) of tools/profile_kernels.py's GEMMs: ViT-B/16's
    qkv, proj, fc1 and fc2 at M = PROFILE_BATCH x the padded tokens."""
    _, _, d, _, n_pad, _, hid, _, _ = shapes(cfg)
    m = PROFILE_BATCH * n_pad
    return [("qkv", m, d, 3 * d), ("proj", m, d, d), ("fc1", m, d, hid),
            ("fc2", m, hid, d)]


def shapes(cfg):
    """(batch, patches, D, real tokens, padded tokens, patch K, hidden,
    classes, heads) of the main path."""
    n_pad = -(-cfg.num_tokens // 16) * 16
    return (BATCH, cfg.num_patches, cfg.embed_dim, cfg.num_tokens, n_pad,
            cfg.patch_size**2 * cfg.in_channels,
            int(cfg.embed_dim * cfg.mlp_ratio), cfg.num_classes,
            cfg.num_heads)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def level_diff(got, want):
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return float(d.max()) if d.numel() else 0.0, float((d > 0).float().mean())


def float_diff(got, want):
    d = (got.float() - want.float()).abs()
    return float(d.max()) if d.numel() else 0.0, float((d > 0).float().mean())


def raw_bytes(t):
    """A tensor's bytes (the gathers copy them opaquely)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def parity_row(kernel, case, kind, got, want):
    """One parity row under the contract of ``kind``: ``levels`` (within
    1 level at <= 0.5% of positions), ``mlp`` (within 1e-5),
    ``attention`` (within 0.1, differing at <= 1% of positions), else
    exact; every value finite."""
    if kind == "levels":
        mx, frac = level_diff(got, want)
        ok = mx <= 1 and frac <= 0.005
    elif kind == "mlp":
        mx, frac = float_diff(got, want)
        ok = mx <= 1e-5
    elif kind == "attention":
        mx, frac = float_diff(got, want)
        ok = mx <= 0.1 and frac <= 0.01
    else:  # exact
        mx, frac = float_diff(got, want)
        ok = (mx == 0.0 and got.shape == want.shape
              and got.dtype == want.dtype)
    if not torch.isfinite(got.float()).all():
        ok = False
    return {"kernel": kernel, "case": case, "check": kind,
            "max_abs_err": mx, "share_differ": frac, "bit_exact": mx == 0.0,
            "ok": ok}


class Parity:
    """Kernel-vs-plain cases; each row: kernel, case, max diff, share of
    positions that differ, pass."""

    def __init__(self, dev):
        self.dev = dev
        self.rows = []
        self.failures = []

    def check(self, kernel, case, kind, got, want):
        row = parity_row(kernel, case, kind, got, want)
        self.add(row)
        return row["max_abs_err"], row["share_differ"]

    def add(self, row):
        self.rows.append(row)
        if not row["ok"]:
            self.failures.append(f"{row['kernel']} {row['case']}: max "
                                 f"{row['max_abs_err']} share "
                                 f"{row['share_differ']}")

    # -- data -------------------------------------------------------------

    def t(self, a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.dev, dtype=dtype) if dtype else t.to(self.dev)

    def weight(self, rng, k, n, fmt):
        from quantized_vit_tpu_torch.quant import pack_int4

        w = torch.from_numpy(rng.integers(-7, 8, (k, n)).astype(np.int8))
        return (pack_int4(w, axis=0) if fmt == "int4" else w).to(self.dev)

    def scal(self, v):
        return torch.tensor(v, dtype=torch.float32, device=self.dev)

    # -- K1 ---------------------------------------------------------------

    def k1(self, case, m, k, n, fmt, pow_, prologue, epilogue, seed,
           stream=None, layout=None, byte_wise=False):
        """K1 on seeded inputs against fused_quant_matmul_plain, through
        the wrapper (a plan per call); ``stream`` (bf16 or f32): x of the
        LayerNorm prologue, the residual and a float output in that dtype
        (else bf16 x and residual, f32 out unless residual); ``layout``
        (a dict of ``MatmulLayout`` fields): K1 launched at that work
        split (``_launch_matmul``) instead of the picker's; ``byte_wise``:
        on a plan that shares an n-major copy of the weight (``w_t``), as
        a block's plans do, which the kernel reads byte by byte where its
        depth is off the 16-byte path (the wrapper's own copy is padded
        there). A CPU rehearsal takes the wrapper, its plain version."""
        from quantized_vit_tpu_torch.ops import (_build, fused_quant_matmul,
                                                 fused_quant_matmul_plain,
                                                 plan_matmul, run_matmul)
        from quantized_vit_tpu_torch.ops.fused import (COPY_PROLOGUE,
                                                       _launch_matmul,
                                                       matmul_layout)

        rng = np.random.default_rng(seed)
        f32, bf16 = torch.float32, torch.bfloat16
        if prologue is None:
            x = self.t(rng.integers(-7, 8, (m, k)).astype(np.int8))
        elif prologue == "ln_quant":
            x = self.t(rng.standard_normal((m, k)) * 0.5, stream or bf16)
        else:
            x = self.t(rng.standard_normal((m, k)), f32)
        w = self.weight(rng, k, n, fmt)
        scale = self.t(rng.random(n) * 0.01 + 1e-3, f32)
        bias = self.t(rng.standard_normal(n) * 0.1, f32)
        out_dtype = stream or (bf16 if epilogue == "residual" else f32)
        layer = dict(fmt=fmt, prologue=prologue, epilogue=epilogue)
        if prologue is not None:
            layer.update(act_d=self.scal(0.05),
                         act_t=self.scal(1.08 if pow_ else 1.0),
                         act_top=127 if prologue == "ln_quant" else 7,
                         act_pow=pow_ and prologue != "gelu_quant")
        if prologue == "ln_quant":
            layer.update(
                ln_scale=self.t(rng.standard_normal(k) * 0.1 + 1, f32),
                ln_bias=self.t(rng.standard_normal(k) * 0.01, f32))
        run = dict(out_dtype=out_dtype)
        if epilogue == "residual":
            run["residual"] = self.t(rng.standard_normal((m, n)),
                                     stream or bf16)
        if epilogue in ("quant", "gelu_quant"):
            layer.update(out_d=self.scal(0.5), out_t=self.scal(
                0.93 if pow_ else 1.0), out_top=31, out_pow=pow_)
        want = fused_quant_matmul_plain(x, w, scale, bias, **layer, **run)
        if self.dev.type != "cuda" or (layout is None and not byte_wise):
            got = fused_quant_matmul(x, w, scale, bias, **layer, **run)
        elif layout is None:
            got = run_matmul(plan_matmul(w, scale, bias, w_t=_build.n_major(w),
                                         **layer), x, **run)
        else:
            pro = prologue
            if pro is None and (k % 16 or x.data_ptr() % 16):
                pro = COPY_PROLOGUE
            lay = dataclasses.replace(
                matmul_layout(m, k, n, pro, x.element_size()), **layout)
            got = _launch_matmul(plan_matmul(w, scale, bias, **layer), x,
                                 lay, **run)
        kind = ("levels" if epilogue in ("quant", "gelu_quant") else "exact")
        return self.check("fused_quant_matmul", case, kind, got, want)

    def run_k1_sites(self, cfg):
        """K1 at every site of the forwards beyond the batch-32 ones of
        run_all: the chain's qkv (LayerNorm prologue, bf16 and f32
        streams) and proj (residual) at batch 1, 2 and 3, the head at one
        row; ViT-H/14's patch embed (K = 588: the padded plan, int8 and
        packed int4, and the unpadded byte-wise one), chain qkv at batch
        2, fc1 (LayerNorm -> GELU-quant) and fc2 (residual) at batch 32;
        then K1 launched at set work splits at 416, 544 and 6656 rows:
        whole tiles only, every tile split 2 to 8 ways, some whole and
        the rest split 3 to 10 ways, 64 and 128 tiles, every epilogue."""
        b, p, d, _, n_pad, kp, _, ncls, _ = shapes(cfg)
        seed = 600
        for bk in CHAIN_BATCHES:
            m = bk * n_pad
            for stream in (torch.bfloat16, torch.float32):
                for fmt in ("int4", "int8"):
                    seed += 1
                    tag = f"{fmt},{str(stream)[6:]}"
                    self.k1(f"chain_qkv[{m}x{d}x{3 * d}]({tag})", m, d,
                            3 * d, fmt, seed % 3 == 0, "ln_quant", None,
                            seed, stream)
                    self.k1(f"chain_proj[{m}x{d}x{d}]({tag})", m, d, d,
                            fmt, False, None, "residual", seed, stream)
        for fmt in ("int4", "int8"):
            for pow_ in (False, True):
                seed += 1
                self.k1(f"head[1x{d}x{ncls}]({fmt},"
                        f"{'pow' if pow_ else 'lin'})", 1, d, ncls, fmt,
                        pow_, "quant", None, seed)
        vh = vit_h_cfg()
        vp, vd, _, vn_pad, vhid, _ = vit_h_shapes(vh)
        vkp = vh.patch_size**2 * vh.in_channels
        vb = max(VIT_H_BATCHES)
        for fmt in ("int8", "int4"):
            seed += 1
            self.k1(f"vit_h_patch_embed[{vb * vp}x{vkp}x{vd}]({fmt},"
                    "padded)", vb * vp, vkp, vd, fmt, False, "quant", None,
                    seed)
        seed += 1
        self.k1(f"vit_h_patch_embed[{vb * vp}x{vkp}x{vd}](int8,byte-wise)",
                vb * vp, vkp, vd, "int8", False, "quant", None, seed,
                byte_wise=True)
        seed += 1
        self.k1(f"vit_h_chain_qkv[{2 * vn_pad}x{vd}x{3 * vd}](int8)",
                2 * vn_pad, vd, 3 * vd, "int8", False, "ln_quant", None,
                seed, torch.bfloat16)
        mh = vb * vn_pad
        for pow_ in (False, True):
            seed += 1
            tag = "pow" if pow_ else "lin"
            self.k1(f"vit_h_fc1[{mh}x{vd}x{vhid}](int8,{tag})", mh, vd,
                    vhid, "int8", pow_, "ln_quant", "gelu_quant", seed)
            self.k1(f"vit_h_fc2[{mh}x{vhid}x{vd}](int8,{tag})", mh, vhid,
                    vd, "int8", pow_, None, "residual", seed + 50)
        # set work splits: (rows, K, N, prologue, epilogue, (tile, tiles
        # whole, splits) ...); tiles whole past the count are all of them
        m2, mb = 2 * n_pad, b * n_pad
        for m, k, n, pro, epi, lays in (
                (m2, d, 3 * d, "ln_quant", None,
                 ((64, 10**6, 1), (64, 0, 2), (128, 0, 6))),
                (m2, d, d, None, "residual", ((128, 10**6, 1),
                                              (64, 10, 3))),
                (mb, d, d, None, "residual",
                 ((64, 10**6, 1), (128, 0, 2), (128, 264, 6))),
                (mb, d, d, "quant", None, ((64, 100, 4),)),
                (2 * vn_pad, vhid, vd, None, "residual",
                 ((64, 0, 8), (128, 20, 5))),
                (2 * vn_pad, vd, vhid, "ln_quant", "gelu_quant",
                 ((64, 40, 7), (128, 0, 3))),
                (2 * vn_pad, vd, 3 * vd, "ln_quant", "quant",
                 ((128, 10**6, 1), (64, 5, 10)))):
            for tile, full, s in lays:
                seed += 1
                tiles = -(-m // tile) * -(-n // tile)
                full = min(full, tiles)
                fmt = "int8" if seed % 2 else "int4"
                self.k1(f"layout[{m}x{k}x{n},{pro}->{epi}](t{tile},"
                        f"whole{full},S{s},{fmt})", m, k, n, fmt,
                        seed % 3 == 0, pro, epi, seed,
                        layout=dict(tile=tile, full=full, splits=s))

    # -- K2 ---------------------------------------------------------------

    def k2(self, case, m, k, hid, fmt, fmt2, pow_, seed,
           stream=torch.bfloat16, kernel="fused_mlp", bias=True,
           layout=None):
        """K2 (or, with ``kernel="fused_mlp_chunked"``, K8 on int8
        weights) launched on its own plan, against fused_mlp_plain; with
        ``layout`` (a dict of ``MlpLayout`` fields, or for K8 of
        ``ChunkedLayout`` fields), launched at that work split
        (``_launch_mlp``, ``_launch_mlp_chunked``) instead of the
        picker's."""
        from quantized_vit_tpu_torch.ops import (fused_mlp_plain, plan_mlp,
                                                 plan_mlp_chunked, run_mlp,
                                                 run_mlp_chunked)
        from quantized_vit_tpu_torch.ops.fused import (_launch_mlp,
                                                       _launch_mlp_chunked,
                                                       chunked_layout,
                                                       mlp_layout)

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        x = self.t(rng.standard_normal((m, k)) * 0.5, stream)
        w1 = self.weight(rng, k, hid, fmt)
        w2 = self.weight(rng, hid, k, fmt2)
        s1, b1 = self.scal(1e-3), self.t(rng.standard_normal(hid) * 0.01, f32)
        s2, b2 = self.scal(1e-3), self.t(rng.standard_normal(k) * 0.01, f32)
        if not bias:
            b1 = b2 = None
        kw = dict(ln_scale=self.t(rng.standard_normal(k) * 0.1 + 1, f32),
                  ln_bias=self.t(rng.standard_normal(k) * 0.01, f32),
                  act_d=self.scal(0.05), act_t=self.scal(
                      1.08 if pow_ else 1.0), act_top=127, act_pow=pow_,
                  hid_d=self.scal(0.05), hid_t=self.scal(
                      0.93 if pow_ else 1.0), hid_top=127, hid_pow=pow_,
                  fmt=fmt, fmt2=fmt2)
        want = fused_mlp_plain(x, w1, s1, b1, w2, s2, b2, out_dtype=stream,
                               **kw)
        if self.dev.type != "cuda":  # CPU rehearsal: the plain version
            got = fused_mlp_plain(x, w1, s1, b1, w2, s2, b2,
                                  out_dtype=stream, **kw)
        elif layout is not None and kernel == "fused_mlp_chunked":
            lay = dataclasses.replace(
                chunked_layout(m, k, hid, x.element_size()), **layout)
            got = _launch_mlp_chunked(
                plan_mlp_chunked(w1, s1, b1, w2, s2, b2, **kw), x, lay,
                out_dtype=stream)
        elif layout is not None:
            lay = dataclasses.replace(mlp_layout(m, k, hid), **layout)
            got = _launch_mlp(plan_mlp(w1, s1, b1, w2, s2, b2, **kw), x, lay,
                              out_dtype=stream)
        elif kernel == "fused_mlp":
            got = run_mlp(plan_mlp(w1, s1, b1, w2, s2, b2, **kw), x,
                          out_dtype=stream)
        else:
            got = run_mlp_chunked(plan_mlp_chunked(w1, s1, b1, w2, s2, b2,
                                                   **kw), x, out_dtype=stream)
        return self.check(kernel, case, "mlp", got, want)

    # -- K3 ---------------------------------------------------------------

    def k3(self, case, b, n, d, heads, n_valid, fmt, fmt_proj, pow_, seed,
           stream=torch.bfloat16, int_attn=False, rows=None):
        """K3's levels and its branch with the K1 proj against their
        plain versions; with ``rows``, the levels alone, launched at that
        query tile (``_launch_attention_heads``) instead of the picker's
        (a CPU rehearsal takes the wrapper, its plain version)."""
        from quantized_vit_tpu_torch.ops import (attention_block,
                                                 attention_block_plain,
                                                 attention_heads,
                                                 attention_heads_plain)
        from quantized_vit_tpu_torch.ops.attention import (
            _launch_attention_heads, plan_attention_heads)

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        hd = d // heads
        x = self.t(rng.standard_normal((b, n, d)) * 0.2, stream)
        wq = self.weight(rng, d, 3 * d, fmt)
        wp = self.weight(rng, d, d, fmt_proj)
        qs, qb = self.scal(1e-3), self.t(rng.standard_normal(3 * d) * 0.01,
                                         f32)
        ps, pb = self.scal(2e-3), self.t(rng.standard_normal(d) * 0.01, f32)
        kw = dict(ln_scale=self.t(rng.standard_normal(d) * 0.1 + 1, f32),
                  ln_bias=self.t(rng.standard_normal(d) * 0.01, f32),
                  heads=heads, sm_scale=hd**-0.5, n_valid=n_valid,
                  act_d=self.scal(0.05), act_t=self.scal(
                      1.08 if pow_ else 1.0), act_top=127, act_pow=pow_,
                  out_d=self.scal(0.06), out_t=self.scal(
                      0.93 if pow_ else 1.0), out_top=31, out_pow=pow_,
                  out_dtype=stream, int_attention=int_attn)
        want = attention_heads_plain(x, wq, qs, qb, fmt=fmt, **kw)
        if rows is not None:
            run = {k: kw.pop(k) for k in ("n_valid", "out_dtype",
                                          "int_attention")}
            got = (_launch_attention_heads(
                plan_attention_heads(wq, qs, qb, fmt=fmt, **kw), x, rows,
                **run) if self.dev.type == "cuda"
                else attention_heads(x, wq, qs, qb, fmt=fmt, **kw, **run))
            return self.check("attention_block", case, "levels", got, want)
        self.check("attention_block", case + ":levels", "levels",
                   attention_heads(x, wq, qs, qb, fmt=fmt, **kw), want)
        got = attention_block(x, wq, qs, qb, wp, ps, pb, fmt=fmt,
                              fmt_proj=fmt_proj, **kw)
        want = attention_block_plain(x, wq, qs, qb, wp, ps, pb, fmt=fmt,
                                     fmt_proj=fmt_proj, **kw)
        return self.check("attention_block", case, "attention", got, want)

    def run_heads_tiles(self):
        """K3 at every (query rows R, qkv dtype, head bound) instantiation,
        launched at set tiles: 200 tokens at head_dim 64 and 280 at 80 (a
        ragged last tile at every R), masked keys (n_valid < nk < n), each
        instantiation with float attention and ``int_attention``, the
        linear and pow quantizers and int8 and packed int4 weights in
        turn."""
        i = 0
        for rows in (64, 32, 16):
            for dt in (torch.bfloat16, torch.float32):
                for hd, n, nv in ((64, 200, 190), (80, 280, 257)):
                    for ia in (False, True):
                        i += 1
                        fmt = ("int8", "int4")[i % 2]
                        pow_ = i % 3 == 0
                        self.k3(f"tile[R{rows}](2x{n}x{2 * hd},h2)"
                                f"({str(dt)[6:]},{fmt},"
                                f"{'pow' if pow_ else 'lin'},"
                                f"{'int' if ia else 'f'}_attn)", 2, n,
                                2 * hd, 2, nv, fmt, fmt, pow_, 800 + i, dt,
                                int_attn=ia, rows=rows)

    # -- K6 ---------------------------------------------------------------

    def k6(self, case, b, n, heads, hd, n_valid, dtype, quant, int_attn,
           seed, rows=None):
        """quant: None (float out), "lin" (t = 1) or "pow" (t != 1).
        ``rows``: launched at that query tile (``_launch_attention_qkv``)
        instead of the picker's; a CPU rehearsal takes the wrapper (its
        plain version)."""
        from quantized_vit_tpu_torch.ops import (attention_qkv,
                                                 attention_qkv_plain)
        from quantized_vit_tpu_torch.ops.attention import (
            _launch_attention_qkv, plan_attention_qkv)

        rng = np.random.default_rng(seed)
        qkv = self.t(rng.standard_normal((b, n, 3 * heads * hd)) * 0.7,
                     dtype)
        quant_kw = {}
        if quant:
            quant_kw = dict(out_d=self.scal(0.01), out_t=self.scal(
                0.93 if quant == "pow" else 1.0), out_top=31,
                out_pow=quant == "pow")
        run = dict(n_valid=n_valid, out_dtype=dtype, int_attention=int_attn)
        if rows is None or self.dev.type != "cuda":
            got = attention_qkv(qkv, heads=heads, sm_scale=hd**-0.5,
                                **quant_kw, **run)
        else:
            got = _launch_attention_qkv(plan_attention_qkv(
                qkv.device, heads=heads, sm_scale=hd**-0.5, **quant_kw), qkv,
                rows, **run)
        want = attention_qkv_plain(qkv, heads=heads, sm_scale=hd**-0.5,
                                   **quant_kw, **run)
        return self.check("attention_qkv", case,
                          "levels" if quant else "attention", got, want)

    def run_qkv_attn_tiles(self):
        """K6 at every (query rows R, qkv dtype, head bound) instantiation,
        launched at set tiles: 200 tokens at head_dim 64 and 270 at 80
        (a ragged last tile at every R), masked keys (n_valid < nk < n),
        each instantiation with float attention and ``int_attention``,
        the three output modes in turn; then 592 tokens at head_dim 64 in
        f32 (a 384-px ViT-B/16 at batch 1, which the first K6 refused)
        through the wrapper."""
        bf16, f32 = torch.bfloat16, torch.float32
        modes = (None, "lin", "pow")
        i = 0
        for rows in (64, 32, 16):
            for dt in (bf16, f32):
                for hd, n, nv in ((64, 200, 190), (80, 270, 257)):
                    for ia in (False, True):
                        quant = modes[i % 3]
                        i += 1
                        self.k6(f"tile[R{rows}](2x{n},h2x{hd})"
                                f"({str(dt)[6:]},{quant or 'float'},"
                                f"{'int' if ia else 'f'}_attn)", 2, n, 2, hd,
                                nv, dt, quant, ia, 700 + i, rows=rows)
        for quant in modes:
            for ia in (False, True):
                i += 1
                self.k6(f"vit_b384[1x592,h12x64](float32,{quant or 'float'},"
                        f"{'int' if ia else 'f'}_attn)", 1, 592, 12, 64, 577,
                        f32, quant, ia, 700 + i)

    # -- K5 ---------------------------------------------------------------

    def stack_operands(self, rng, depth, d, heads, hid, fmt, pow_):
        """Stacked, folded K5 operands at artifact-like scales (weights
        [L, K(/2), N]) and the static keywords."""
        from quantized_vit_tpu_torch.quant import pack_int4

        f32 = torch.float32

        def w(k, n):
            lv = torch.from_numpy(
                rng.integers(-7, 8, (depth, k, n)).astype(np.int8))
            return (pack_int4(lv, axis=1) if fmt == "int4" else lv).to(
                self.dev)

        def rows(n, scale, base=0.0):
            return self.t(rng.standard_normal((depth, n)) * scale + base,
                          f32)

        def scal(v):
            return torch.full((depth,), v, dtype=f32, device=self.dev)

        t_a, t_h = (1.08, 0.93) if pow_ else (1.0, 1.0)
        # LayerNorm gamma carries 1/d = 20 under the linear quantizer
        g_sc, g_base = (0.1, 1.0) if pow_ else (2.0, 20.0)
        ops = (w(d, 3 * d), rows(3 * d, 2e-4, 1e-3), rows(3 * d, 1e-2),
               rows(d, g_sc, g_base), rows(d, 0.2), w(d, d),
               rows(d, 2e-4, 1e-3), rows(d, 1e-2), rows(d, g_sc, g_base),
               rows(d, 0.2), w(d, hid), rows(hid, 2e-4, 7e-4),
               rows(hid, 1e-2), w(hid, d), rows(d, 2e-4, 1e-3),
               rows(d, 1e-2), scal(0.05), scal(t_a), scal(0.05),
               scal(t_h), scal(0.05), scal(t_a), scal(0.05), scal(t_h))
        kw = dict(heads=heads, sm_scale=(d // heads)**-0.5, fmt=fmt,
                  act_pow=pow_, out_pow=pow_, mlp_pow=pow_, hid_pow=pow_,
                  act_top=7, out_top=7, mlp_top=7, hid_top=7)
        return ops, kw

    def k5(self, case, j, n, n_valid, d, heads, hid, depth, fmt, dtype,
           pow_, seed, layout=None):
        """K5 against its plain version, bit for bit; ``layout``: a dict
        of StackLayout fields launched in place of the picker's (none on
        the CPU)."""
        import dataclasses

        from quantized_vit_tpu_torch.ops import (plan_block_stack,
                                                 vit_block_stack,
                                                 vit_block_stack_plain)
        from quantized_vit_tpu_torch.ops import block_stack as B

        rng = np.random.default_rng(seed)
        ops, kw = self.stack_operands(rng, depth, d, heads, hid, fmt, pow_)
        x = self.t(rng.standard_normal((j * n, d)) * 0.5, dtype)
        run = dict(n_valid=n_valid, out_dtype=dtype, j_imgs=j)
        plan = plan_block_stack(*ops, **kw)
        if layout is not None and x.device.type == "cuda":
            lay = dataclasses.replace(B.stack_layout_for(plan, x, j),
                                      **layout)
            got = B._launch_block_stack(
                plan, x, lay, n_valid=n_valid,
                nk=B._n_keys(n, n_valid, dtype.itemsize))
        else:
            got = vit_block_stack(x, *ops, **kw, **run)
        want = vit_block_stack_plain(plan, x, **run)
        return self.check("block_stack", case, "exact", got, want)

    def k5_images(self, case, n, n_valid, d, heads, hid, depth, fmt, seed):
        """j_imgs = 2 equals two j_imgs = 1 calls of the kernel, exactly."""
        from quantized_vit_tpu_torch.ops import vit_block_stack

        rng = np.random.default_rng(seed)
        ops, kw = self.stack_operands(rng, depth, d, heads, hid, fmt, False)
        x = self.t(rng.standard_normal((2 * n, d)) * 0.5, torch.bfloat16)
        two = vit_block_stack(x, *ops, **kw, n_valid=n_valid, j_imgs=2)
        one = torch.cat([vit_block_stack(x[i * n:(i + 1) * n], *ops, **kw,
                                         n_valid=n_valid)
                         for i in range(2)])
        return self.check("block_stack", case, "exact", two, one)

    # -- K4 ---------------------------------------------------------------

    def k4(self, case, b, p, d, n_pad, out_dtype, seed):
        from quantized_vit_tpu_torch.ops import (patch_finalize,
                                                 patch_finalize_plain)

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        acc = self.t(rng.standard_normal((b, p, d)) * 300, f32)
        pos = self.t(rng.standard_normal((p, d)) * 0.02, f32)
        cls = self.t(rng.standard_normal(d) * 0.02, f32)
        sc = self.scal(1e-3)
        got = patch_finalize(acc, pos, cls, sc, n_pad=n_pad,
                             out_dtype=out_dtype)
        want = patch_finalize_plain(acc, pos, cls, sc, n_pad=n_pad,
                                    out_dtype=out_dtype)
        return self.check("patch_finalize", case, "exact", got, want)

    def run_small_batch_kernels(self, cfg):
        """K3 with int_attention, K6 and K5 at the small-batch routes'
        shapes (ViT-B: batch 2-3 for K6, batch 1 at full depth for K5)
        and at small ragged ones."""
        _, _, d, n_real, n_pad, _, hid, _, heads = shapes(cfg)
        hd = d // heads
        b = BATCH
        bf16, f32 = torch.bfloat16, torch.float32
        for fmt in ("int4", "int8"):
            self.k3(f"main[{b}x{n_pad}x{d},h{heads}]({fmt},int_attn)", b,
                    n_pad, d, heads, n_real, fmt, fmt, False, 11,
                    int_attn=True)
            for pow_ in (False, True):
                self.k3(f"small[3x40x96,h3]({fmt},{'pow' if pow_ else 'lin'}"
                        ",int_attn)", 3, 40, 96, 3, 29, fmt, fmt, pow_, 12,
                        int_attn=True)
        self.k3("small[3x40x96,h3](f32,int_attn)", 3, 40, 96, 3, 29, "int8",
                "int8", False, 13, f32, int_attn=True)
        seed = 100
        for bk in (2, 3):
            for dt in (bf16, f32):
                for quant in (None, "lin", "pow"):
                    for int_attn in (False, True):
                        seed += 1
                        self.k6(f"main[{bk}x{n_pad},h{heads}x{hd}]"
                                f"({str(dt)[6:]},{quant or 'float'},"
                                f"{'int' if int_attn else 'f'}_attn)", bk,
                                n_pad, heads, hd, n_real, dt, quant,
                                int_attn, seed)
        for quant in (None, "lin", "pow"):
            for int_attn in (False, True):
                seed += 1
                tag = f"{quant or 'float'},{'int' if int_attn else 'f'}_attn"
                self.k6(f"small[3x40,h3x32]({tag})", 3, 40, 3, 32, 29, bf16,
                        quant, int_attn, seed)
                self.k6(f"small[1x37,h2x24](f32,{tag})", 1, 37, 2, 24, 29,
                        f32, quant, int_attn, seed)
        for fmt in ("int4", "int8"):
            for dt in (bf16, f32):
                seed += 1
                self.k5(f"main[1x{n_pad}x{d},h{heads},L{cfg.depth}]"
                        f"({fmt},{str(dt)[6:]})", 1, n_pad, n_real, d, heads,
                        hid, cfg.depth, fmt, dt, False, seed)
        self.k5(f"main[1x{n_pad}x{d},h{heads},L{cfg.depth}](int4,pow)", 1,
                n_pad, n_real, d, heads, hid, cfg.depth, "int4", bf16, True,
                seed + 1)
        for fmt in ("int4", "int8"):
            self.k5(f"small[2x32x96,h3,L2]({fmt},j2)", 2, 32, 29, 96, 3, 160,
                    2, fmt, bf16, False, 120)
            self.k5_images(f"small[2x32x96,h3,L2]({fmt},j2=j1+j1)", 32, 29,
                           96, 3, 160, 2, fmt, 121)
        self.k5("small[1x40x64,h2,L3](int4,pow)", 1, 40, 37, 64, 2, 128, 3,
                "int4", bf16, True, 122)
        self.k5("small[1x40x64,h2,L3](int8,f32)", 1, 40, 37, 64, 2, 128, 3,
                "int8", f32, False, 123)
        self.run_stack_kernels(cfg)

    def run_stack_kernels(self, cfg):
        """K5 (its redesign on the TMA + wgmma ring and K6's tile) past its
        first design's limits, each bit-exact: the 384-px ViT-B/16 (592
        rows, bf16, depth 2; the first K5 refused its key rows), ViT-H/14's
        width (D 1280, 16 heads of 80, hidden 5120, 272 rows, depth 2),
        ViT-B/16 at two images (j_imgs = 2 also equal to two single
        calls), small shapes at 3 and 4 images, both quantizers, both
        weight formats and residual dtypes; then launched at set work
        splits (the other attention tile, fewer and more token groups)."""
        from quantized_vit_tpu_torch.models import ViTConfig

        bf16, f32 = torch.bfloat16, torch.float32
        _, _, d, n_real, n_pad, _, hid, _, heads = shapes(cfg)
        _, _, d384, nr384, n384, _, hid384, _, h384 = shapes(ViTConfig(
            **dict(CFG_KW, **B384_KW)))
        vh = vit_h_cfg()
        _, dh, nrh, nph, hidh, _ = vit_h_shapes(vh)
        seed = 1600
        for fmt, dt, pow_ in (("int4", bf16, False), ("int8", bf16, True),
                              ("int4", f32, True)):
            seed += 1
            tag = f"{fmt},{str(dt)[6:]},{'pow' if pow_ else 'lin'}"
            self.k5(f"384px[1x{n384}x{d384},h{h384},L2]({tag})", 1, n384,
                    nr384, d384, h384, hid384, 2, fmt, dt, pow_, seed)
            self.k5(f"vith[1x{nph}x{dh},h{vh.num_heads}x"
                    f"{dh // vh.num_heads},L2]({tag})", 1, nph, nrh, dh,
                    vh.num_heads, hidh, 2, fmt, dt, pow_, seed + 50)
        self.k5(f"main[2x{n_pad}x{d},h{heads},L2](int4,j2)", 2, n_pad,
                n_real, d, heads, hid, 2, "int4", bf16, False, 1660)
        self.k5_images(f"main[2x{n_pad}x{d},h{heads},L2](int4,j2=j1+j1)",
                       n_pad, n_real, d, heads, hid, 2, "int4", 1661)
        for j in (3, 4):
            for fmt, dt in (("int4", f32), ("int8", bf16)):
                self.k5(f"small[{j}x40x96,h3,L2]({fmt},{str(dt)[6:]},j{j})",
                        j, 40, 33, 96, 3, 160, 2, fmt, dt, j == 4,
                        1662 + j)
        # set work splits at ViT-B batch 1 and at the 384-px rows: the
        # other attention tile; one token group a phase; twice the
        # picker's groups
        for m, nr in ((n_pad, n_real), (n384, nr384)):
            for name, lay in self.stack_layouts(m, d, heads, hid):
                seed += 1
                self.k5(f"layout[1x{m}x{d},L2]({name})", 1, m, nr, d, heads,
                        hid, 2, "int4" if seed % 2 else "int8", bf16,
                        seed % 3 == 0, seed, layout=lay)

    @staticmethod
    def stack_layouts(m, d, heads, hid):
        """(name, StackLayout fields) of K5's work splits beside the
        picker's at m rows of widths d and hid: the other attention tile,
        the fewest token chunks, twice the picker's."""
        from quantized_vit_tpu_torch.ops import block_stack as B
        from quantized_vit_tpu_torch.tools.stack_design import scaled

        base = B.stack_layout(m, d, d, hid, True, 2, 1, heads, d // heads)
        out = [("att" + str(48 - base.att_rows),
                dict(att_rows=48 - base.att_rows))]
        for name, factor in (("groups 1", 0), ("groups x2", 2)):
            lay = scaled(base, factor)
            out.append((name, dict(nc=lay.nc, nw=lay.nw, g=lay.g,
                                   stages=lay.stages)))
        return out

    # -- K9 ---------------------------------------------------------------

    def k9(self, case, b, n, heads, hd, d, n_valid, dtype, fmt, quant,
           int_attn, seed, bias=True, x_scale=0.7, out_d=0.01, out_top=31,
           scale=2e-3, layout=None):
        """K9 (attention + proj) against its plain version (K6's plain
        levels, then K1's plain residual epilogue); quant "lin" (t = 1) or
        "pow" (t != 1). ``layout`` (query rows, cluster size): launched at
        that layout (``_launch_qkv_proj``) instead of the picker's; a CPU
        rehearsal takes the wrapper (its plain version)."""
        from quantized_vit_tpu_torch.ops import (attention_qkv_proj,
                                                 attention_qkv_proj_plain)
        from quantized_vit_tpu_torch.ops.attention import (
            _launch_qkv_proj, plan_attention_qkv_proj)

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        qkv = self.t(rng.standard_normal((b, n, 3 * heads * hd)) * x_scale,
                     dtype)
        w = self.weight(rng, heads * hd, d, fmt)
        res = self.t(rng.standard_normal((b, n, d)) * 0.5, dtype)
        pb = self.t(rng.standard_normal(d) * 0.01, f32) if bias else None
        kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=n_valid,
                  out_d=self.scal(out_d), out_t=self.scal(
                      0.93 if quant == "pow" else 1.0), out_top=out_top,
                  out_pow=quant == "pow", fmt=fmt, out_dtype=dtype,
                  int_attention=int_attn)
        if layout is None or self.dev.type != "cuda":
            got = attention_qkv_proj(qkv, w, self.scal(scale), pb, res, **kw)
        else:
            run = {k: kw.pop(k) for k in ("n_valid", "out_dtype",
                                          "int_attention")}
            got = _launch_qkv_proj(plan_attention_qkv_proj(
                w, self.scal(scale), pb, **kw), qkv, res, *layout, **run)
            kw.update(run)
        want = attention_qkv_proj_plain(qkv, w, self.scal(scale), pb, res,
                                        **kw)
        return self.check("attention_qkv_proj", case, "attention", got, want)

    def run_qkv_proj_layouts(self):
        """K9 at every (query rows R, qkv dtype, head bound) instantiation,
        each at cluster sizes G the picker can reach (1 to 8): ViT-H/14
        widths at 272 tokens (ragged last 32-row tile: 8 x 32 + 16) with G
        8, 4, 2 and 1, so the 1280 columns split 160 (packed int4), 320 and
        640 a block against the 256-column pass; ViT-B/16 widths at 208
        tokens (6 x 32 + 16) with G 3, 6, 1 and 2; odd head counts (3 heads
        with G 3 and 1, 5 heads of 80 with G 5); masked keys and
        ``int_attention`` on some rows."""
        bf16, f32 = torch.bfloat16, torch.float32
        seed = 600
        for dt, cases in ((bf16, ((32, 8, 3), (16, 4, 6), (32, 2, 1))),
                          (f32, ((32, 8, 3), (16, 4, 6), (16, 1, 2)))):
            dn = str(dt)[6:]
            for rows, gh, gb in cases:
                seed += 1
                fmt = "int4" if gh == 8 else "int8"
                ia = dt == f32 and rows == 32
                self.k9(f"layout[R{rows},G{gh}](2x272,h16x80,{fmt},{dn}"
                        f"{',int_attn' if ia else ''})", 2, 272, 16, 80,
                        1280, 257, dt, fmt, "lin" if rows == 32 else "pow",
                        ia, seed, layout=(rows, gh))
                self.k9(f"layout[R{rows},G{gb}](2x208,h12x64,int4,{dn}"
                        f"{',int_attn' if rows == 16 else ''})", 2, 208, 12,
                        64, 768, 197, dt, "int4", "lin", rows == 16,
                        seed + 50, layout=(rows, gb))
        for rows, g, dt in ((16, 3, bf16), (32, 1, f32), (32, 3, f32)):
            seed += 1
            self.k9(f"layout[R{rows},G{g}](3x40,h3x32,int8,{str(dt)[6:]})",
                    3, 40, 3, 32, 96, 29, dt, "int8", "pow", g == 1, seed,
                    layout=(rows, g))
        self.k9("layout[R32,G5](2x100,h5x80,int4,bf16)", 2, 100, 5, 80, 400,
                90, bf16, "int4", "lin", False, 690, layout=(32, 5))

    def run_qkv_proj_kernels(self, cfg):
        """K9 at bench.py's parity-preamble shapes (bench.py:165-185), at
        ViT-B/16's batch 32 and ViT-H/14's batch 8 (tools/exp_vith.py's B;
        272 padded tokens, as the port's forward pads them), and at small
        ragged shapes (an odd head count, masked keys, heads off the
        16-byte paths): int8 and packed int4 weights, t = 1 and t != 1,
        ``int_attention`` off and on, with and without bias, bf16 and
        f32."""
        bf16, f32 = torch.bfloat16, torch.float32
        for i, fmt in enumerate(("int8", "int4")):
            self.k9(f"bench[2x64x384,h2](bf16,{fmt})", 2, 64, 2, 64, 256, 50,
                    bf16, fmt, "lin", False, 500 + i, x_scale=0.1,
                    out_d=0.05, out_top=7, scale=1e-3)
        b, _, d, n_real, n_pad, _, _, _, heads = shapes(cfg)
        hd = d // heads
        tag = f"vit_b[{b}x{n_pad},h{heads}x{hd}]"
        seed = 510
        for fmt in ("int8", "int4"):
            for quant in ("lin", "pow"):
                seed += 1
                self.k9(f"{tag}({fmt},{quant},bf16)", b, n_pad, heads, hd, d,
                        n_real, bf16, fmt, quant, False, seed)
            self.k9(f"{tag}({fmt},lin,bf16,int_attn)", b, n_pad, heads, hd,
                    d, n_real, bf16, fmt, "lin", True, seed + 10)
        self.k9(f"{tag}(int8,lin,f32,no bias)", b, n_pad, heads, hd, d,
                n_real, f32, "int8", "lin", False, 530, bias=False)
        _, d, n_real, n_pad, _, heads = vit_h_shapes(vit_h_cfg())
        hd = d // heads
        bh = VIT_H_BRANCH_BATCH
        tag = f"vit_h[{bh}x{n_pad},h{heads}x{hd}]"
        for i, (fmt, quant, dt, ia, bias) in enumerate((
                ("int8", "lin", bf16, False, True),
                ("int4", "lin", bf16, False, True),
                ("int8", "pow", bf16, False, False),
                ("int8", "lin", bf16, True, True),
                ("int8", "lin", f32, False, True),
                ("int4", "pow", f32, True, False))):
            opts = (",int_attn" if ia else "") + ("" if bias else ",no bias")
            self.k9(f"{tag}({fmt},{quant},{str(dt)[6:]}{opts})", bh, n_pad,
                    heads, hd, d, n_real, dt, fmt, quant, ia, 540 + i,
                    bias=bias)
        seed = 560
        for quant in ("lin", "pow"):
            for ia in (False, True):
                seed += 1
                t = f"{quant},{'int' if ia else 'f'}_attn"
                self.k9(f"small[3x40,h3x32,D96](int4,bf16,{t})", 3, 40, 3, 32,
                        96, 29, bf16, "int4", quant, ia, seed)
                self.k9(f"small[1x37,h2x24,D72](int8,f32,{t})", 1, 37, 2, 24,
                        72, 29, f32, "int8", quant, ia, seed + 10,
                        bias=not ia)
                self.k9(f"small[2x40,h3x24,D72](int4,bf16,{t})", 2, 40, 3, 24,
                        72, 40, bf16, "int4", quant, ia, seed + 20)

    # -- K10-K12 ----------------------------------------------------------

    def int_mm(self, kernel, case, m, k, n, seed, *, fmt="int4",
               x_dtype=None, act_pow=False, out_dtype=torch.float32,
               requant_top=None, bias=True, scalar=False, layout=None,
               x_offset=0):
        """One of the integer GEMMs (``int4_matmul``, ``int8_matmul``,
        ``quant_matmul_fa``) against its plain version: float outputs
        exact, requantized levels under the levels contract. Inputs as
        tools/profile_kernels.py makes them (levels in [-7, 7], a float x
        at 0.1 with d 0.05 and top 7); int8_matmul's levels span int8.
        ``layout``: a function of the picker's layout giving the one to
        launch at (``_launch_int_matmul``; a CPU rehearsal takes the
        plain version); ``x_offset``: int8 levels ``x_offset`` bytes past
        a 16-byte boundary (the kernel copies them in phase 1)."""
        from quantized_vit_tpu_torch.ops import (int4_matmul,
                                                 int4_matmul_plain,
                                                 int8_matmul,
                                                 int8_matmul_plain,
                                                 quant_matmul_fa,
                                                 quant_matmul_fa_plain)
        from quantized_vit_tpu_torch.quant import pack_int4

        rng = np.random.default_rng(seed)
        f32 = torch.float32
        lo = -127 if kernel == "int8_matmul" else -7
        if kernel == "quant_matmul_fa":
            x = self.t(rng.standard_normal((m, k)) * 0.1, x_dtype)
        else:
            x = self.t(rng.integers(lo, -lo + 1, (m, k)).astype(np.int8))
            if x_offset:
                buf = torch.zeros((m * k + 16,), dtype=torch.int8,
                                  device=self.dev)
                x = buf[x_offset:x_offset + m * k].view(m, k).copy_(x)
        w = self.t(rng.integers(lo, -lo + 1, (k, n)).astype(np.int8))
        if fmt == "int4":
            w = pack_int4(w, axis=0)
        sc = (self.scal(1e-3) if scalar else
              self.t(rng.random(n) * 0.01 + 1e-3, f32))
        if requant_top is not None:
            sc = sc * 2.0
        b = self.t(rng.standard_normal(n) * 0.01, f32) if bias else None
        q = (self.scal(0.05), self.scal(1.08 if act_pow else 1.0),
             torch.full((), 7, dtype=torch.int32, device=self.dev))
        if kernel == "int4_matmul":
            kw = dict(out_dtype=out_dtype, requant_top=requant_top)
            got = int4_matmul(x, w, sc, b, **kw)
            want = int4_matmul_plain(x, w, sc, b, **kw)
        elif kernel == "int8_matmul":
            got = int8_matmul(x, w, sc, b, out_dtype=out_dtype)
            want = int8_matmul_plain(x, w, sc, b, out_dtype=out_dtype)
        else:
            kw = dict(fmt=fmt, act_pow=act_pow, out_dtype=out_dtype)
            got = quant_matmul_fa(x, w, sc, b, *q, **kw)
            want = quant_matmul_fa_plain(x, w, sc, b, *q, **kw)
        if layout is not None and self.dev.type == "cuda":
            got = self.int_mm_at(kernel, layout, x, w, sc, b, q, fmt,
                                 act_pow, out_dtype, requant_top)
        return self.check(kernel, case, "levels" if requant_top else "exact",
                          got, want)

    @staticmethod
    def int_mm_at(kernel, layout, x, w, sc, b, q, fmt, act_pow, out_dtype,
                  requant_top):
        """The integer GEMM at ``layout(picked layout)``."""
        from quantized_vit_tpu_torch.ops.fused import _card_sms
        from quantized_vit_tpu_torch.ops.int4_matmul import (
            _launch_int_matmul, int_matmul_layout, plan_int_matmul)

        fa = {} if kernel != "quant_matmul_fa" else dict(
            act_d=q[0], act_t=q[1], act_top=q[2], act_pow=act_pow)
        plan = plan_int_matmul(w, sc, b, fmt=fmt, **fa)
        out_size = 1 if requant_top is not None else (
            2 if out_dtype == torch.bfloat16 else 4)
        pick = int_matmul_layout(x.shape[0], plan.k, plan.n, plan.int4,
                                 x.element_size(), x.data_ptr() % 16 == 0,
                                 out_size, _card_sms(x.device.index))
        return _launch_int_matmul(plan, x, layout(pick),
                                  out_dtype=out_dtype,
                                  requant_top=requant_top)

    def run_int_matmul_kernels(self, cfg):
        """K10-K12 at tools/profile_kernels.py's four ViT-B/16 layer shapes
        (qkv, proj, fc1, fc2) at M = 8 images x the padded tokens (1664):
        int4_matmul with f32 out and with the requant epilogue,
        int8_matmul with f32 and bf16 out, quant_matmul_fa for int4 and
        int8 weights, act_pow off and on, bf16 x to bf16 out (the tool's
        case) and f32 to f32; then tests/ops/test_int4_matmul.py's ragged
        shapes and a scalar scale without bias."""
        bf16, f32 = torch.bfloat16, torch.float32
        seed = 600
        for label, m, k, n in profile_shapes(cfg):
            tag = f"profile_{label}[{m}x{k}x{n}]"
            seed += 10
            self.int_mm("int4_matmul", tag + "(f32)", m, k, n, seed)
            self.int_mm("int4_matmul", tag + "(requant 7)", m, k, n,
                        seed + 1, requant_top=7)
            for i, dt in enumerate((f32, bf16)):
                self.int_mm("int8_matmul", tag + f"({str(dt)[6:]})", m, k, n,
                            seed + 2 + i, fmt="int8", out_dtype=dt)
            for fmt in ("int4", "int8"):
                for pw in (False, True):
                    for dt in (bf16, f32):
                        self.int_mm("quant_matmul_fa",
                                    tag + f"({fmt},{'pow' if pw else 'lin'},"
                                    f"{str(dt)[6:]})", m, k, n, seed + 4,
                                    fmt=fmt, x_dtype=dt, act_pow=pw,
                                    out_dtype=dt)
        for m, k, n in ((8, 64, 128), (197, 768, 768), (100, 250, 130)):
            self.int_mm("int4_matmul", f"small[{m}x{k}x{n}]", m, k, n, 650)
            self.int_mm("int4_matmul", f"small[{m}x{k}x{n}](requant 7)", m,
                        k, n, 651, requant_top=7)
        for m, k, n in ((64, 128, 128), (197, 768, 256), (33, 40, 24)):
            self.int_mm("int8_matmul", f"small[{m}x{k}x{n}]", m, k, n, 652,
                        fmt="int8", bias=m % 2 == 1)
        self.int_mm("int4_matmul", "small[32x128x64](scalar scale, no bias)",
                    32, 128, 64, 653, scalar=True, bias=False)
        for m, k, n in ((24, 64, 48), (7, 40, 20), (50, 250, 130)):
            for fmt in ("int4", "int8"):
                self.int_mm("quant_matmul_fa", f"small[{m}x{k}x{n}]({fmt})",
                            m, k, n, 654, fmt=fmt, x_dtype=f32, act_pow=True,
                            scalar=fmt == "int8", bias=fmt == "int4")
        # float16 out, which the kernel writes as f32 and the wrapper
        # casts (as the JAX wrappers cast)
        f16 = torch.float16
        for label, m, k, n in profile_shapes(cfg)[:1]:
            tag = f"profile_{label}[{m}x{k}x{n}](float16)"
            self.int_mm("int4_matmul", tag, m, k, n, 655, out_dtype=f16)
            self.int_mm("int8_matmul", tag, m, k, n, 656, fmt="int8",
                        out_dtype=f16)
            self.int_mm("quant_matmul_fa", tag, m, k, n, 657, x_dtype=f32,
                        act_pow=True, out_dtype=f16)
        for m, k, n in ((33, 40, 24), (100, 250, 130)):
            self.int_mm("int4_matmul", f"small[{m}x{k}x{n}](float16)", m, k,
                        n, 658, out_dtype=f16)
            self.int_mm("int8_matmul", f"small[{m}x{k}x{n}](float16)", m, k,
                        n, 659, fmt="int8", out_dtype=f16)
        self.run_int_matmul_layouts(cfg)

    def run_int_matmul_layouts(self, cfg):
        """The redesigned kernel's rows: each front end at every work
        split the picker can choose (each token tile whole; the depth
        split 2 and 3 ways, every tile and the tiles after whole waves of
        the card's SMs; the picked layout) at qkv, proj and fc2 (24 steps
        of depth); ragged shapes (50 x 96 x 72,
        K = 40 and 200, off the 16-byte TMA rows, N not a multiple of 4 or
        128, M below a token tile); int8 levels off a 16-byte boundary
        (copied in phase 1); a scalar scale without bias for each front
        end; requant, bf16, f16 and f32 out; act_pow on and off; f32 and
        bf16 x."""
        from quantized_vit_tpu_torch.ops.fused import _card_sms
        from quantized_vit_tpu_torch.ops.int4_matmul import (
            INT_MM_NW, int_matmul_variant)

        bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
        fronts = (("int4_matmul", dict(fmt="int4")),
                  ("int8_matmul", dict(fmt="int8")),
                  ("quant_matmul_fa", dict(fmt="int4", x_dtype=bf16,
                                           out_dtype=bf16)),
                  ("quant_matmul_fa", dict(fmt="int8", x_dtype=f32,
                                           act_pow=True)))

        def lays(int4):
            out = [("picked", lambda p: p)]
            for nw in INT_MM_NW:
                out.append((f"nw{nw} whole",
                            lambda p, nw=nw: int_matmul_variant(p, nw)))
            for s in (2, 3):
                out.append((f"split {s}", lambda p, s=s: int_matmul_variant(
                    p, p.nw, s, 0)))
                out.append((f"split {s} after waves",
                            lambda p, s=s: int_matmul_variant(
                                p, p.nw, s, p.tiles // _card_sms(0)
                                * _card_sms(0))))
            return out

        seed = 700
        for label, m, k, n in profile_shapes(cfg):
            if label == "fc1":
                continue
            for kernel, kw in fronts:
                int4 = kw["fmt"] == "int4"
                for name, fn in lays(int4):
                    seed += 1
                    self.int_mm(kernel, f"layout_{label}[{m}x{k}x{n}]"
                                f"({kw['fmt']},{name})", m, k, n, seed,
                                layout=fn, **kw)
        # ragged shapes, each front end, with and without the 16-byte TMA
        # rows; a scalar scale without bias
        for m, k, n in ((50, 96, 72), (197, 768, 768), (50, 40, 130),
                        (300, 200, 257), (7, 768, 2304)):
            for kernel, kw in fronts:
                seed += 1
                self.int_mm(kernel, f"ragged[{m}x{k}x{n}]({kw['fmt']})", m,
                            k, n, seed, **kw)
            self.int_mm("int8_matmul", f"ragged[{m}x{k}x{n}](scalar, no "
                        "bias)", m, k, n, seed, fmt="int8", scalar=True,
                        bias=False)
            self.int_mm("quant_matmul_fa", f"ragged[{m}x{k}x{n}](scalar, "
                        "no bias, f16)", m, k, n, seed, fmt="int4",
                        x_dtype=f32, scalar=True, bias=False, out_dtype=f16)
            self.int_mm("int4_matmul", f"ragged[{m}x{k}x{n}](requant 7)", m,
                        k, n, seed, requant_top=7)
        for m, k, n in ((1664, 768, 768), (197, 768, 768)):
            for kernel in ("int4_matmul", "int8_matmul"):
                seed += 1
                self.int_mm(kernel, f"offset[{m}x{k}x{n}](x 1 byte off)", m,
                            k, n, seed, fmt="int4" if kernel == "int4_matmul"
                            else "int8", x_offset=1)
        for label, m, k, n in profile_shapes(cfg):
            seed += 1
            self.int_mm("int4_matmul", f"profile_{label}[{m}x{k}x{n}]"
                        "(bf16)", m, k, n, seed, out_dtype=bf16)

    # -- K7 ---------------------------------------------------------------

    def k7(self, case, x, g, d, q_m, t, q_s=0.0, clip=(-2.0, 2.0)):
        """K7 against its plain version: grad_x bit-exact, each of the
        three sums within 1e-5 of the L1 mass of its summands."""
        from quantized_vit_tpu_torch.ops.quant_vjp import (
            lsfq_nonlinear_bwd_fused, lsfq_nonlinear_bwd_plain,
            nonlinear_bwd_terms)

        kw = dict(clip_lo=clip[0], clip_hi=clip[1], q_s=q_s)
        d, q_m, t = (torch.full((1,), float(v), device=self.dev)
                     for v in (d, q_m, t))
        got = lsfq_nonlinear_bwd_fused(x, g, d, q_m, t, **kw)
        want = lsfq_nonlinear_bwd_plain(x, g, d, q_m, t, **kw)
        l1 = [float(v.abs().sum(dtype=torch.float64))
              for v in nonlinear_bwd_terms(x, g, d, q_m, t, **kw)[1:]]
        gx_max, gx_share = float_diff(got[0], want[0])
        errs = [abs(float(a) - float(b)) for a, b in zip(got[1:], want[1:])]
        finite = bool(torch.isfinite(got[0]).all()) and all(
            np.isfinite(float(v)) for v in got[1:])
        ok = (gx_max == 0.0 and finite
              and all(e <= 1e-5 * m for e, m in zip(errs, l1)))
        self.rows.append({
            "kernel": "quant_bwd", "case": case, "check": "k7",
            "max_abs_err": max([gx_max] + errs), "share_differ": gx_share,
            "bit_exact": gx_max == 0.0 and max(errs) == 0.0, "ok": ok,
            "sum_err_over_l1": max(e / m if m else e
                                   for e, m in zip(errs, l1)),
            "grad_x_exact": gx_max == 0.0})
        if not ok:
            self.failures.append(f"quant_bwd {case}: grad_x max {gx_max}, "
                                 f"sum errors {errs} vs L1 {l1}")

    def run_quant_bwd(self, cfg):
        """K7 at every distinct site shape of the training step (weights
        near 4-bit scales, activations near 8-bit, t != 1, and t = 1 at
        two of them), an edge-mask tile with values at q_s, at q_m and at
        +-clip, a q_m <= q_s overlap, ragged element counts (not divisible
        by 4), a non-contiguous g and an unaligned x."""
        gen = torch.Generator(device=self.dev).manual_seed(70)
        dev = self.dev

        def randn(shape, scale):
            return torch.randn(shape, generator=gen, device=dev) * scale

        seen = set()
        for site, shape, _ in k7_sites(cfg):
            if shape in seen:
                continue
            seen.add(shape)
            weight = site.endswith("_wt")
            x = randn(shape, 0.02 if weight else 1.2)
            g = randn(shape, 1e-3)
            q_m = float(x.abs().max()) * 0.9 if weight else 1.1
            d = q_m / 7 if weight else 0.07
            tag = f"main[{'x'.join(map(str, shape))}]({site})"
            self.k7(tag + "(t!=1)", x, g, d, q_m, 0.94 if weight else 1.06)
            if site in ("qkv_act", "fc1_wt"):
                self.k7(tag + "(t=1)", x, g, d, q_m, 1.0)
        base = torch.tensor([0.0, 1e-8, 0.5, 1.0, 1.5, 2.0, 2.5, -0.5, -1.0,
                             -2.0, -3.0, 0.99, 1.01, -1e-8, 0.0, 0.0],
                            device=dev)
        x = base.repeat(8, 8)  # [8, 128]: q_s = 0, q_m = 1, clip = +-2
        for t in (1.0, 1.06):
            self.k7(f"small[8x128](edges,t={t})", x, torch.cos(x * 3.0),
                    0.05, 1.0, t)
        x = randn((64, 96), 0.6)
        for t in (1.0, 1.06):
            self.k7(f"small[64x96](q_m<=q_s,t={t})", x, randn((64, 96), 1.0),
                    0.02, 0.3, t, q_s=0.5)
        for shape in ((7, 13), (3, 5, 7), (1,), (5, 1001)):
            x = randn(shape, 1.2)
            self.k7(f"small[{'x'.join(map(str, shape))}](ragged)", x,
                    randn(shape, 1.0), 0.07, 1.1, 1.06)
        x = randn((64, 96), 1.2)
        self.k7("small[64x96](g non-contiguous)", x,
                randn((96, 64), 1.0).t(), 0.07, 1.1, 1.06)
        buf = randn((1 + 40 * 100,), 1.2)
        self.k7("small[40x100](x unaligned)", buf[1:].reshape(40, 100),
                randn((40, 100), 1.0), 0.07, 1.1, 0.97)

    def run_mlp_kernels(self, cfg):
        """K2 at ViT-H/14's widths (K 1280, H 5120; batch 1 and 2: 272
        and 544 rows) with int8, packed int4 and mixed int8/int4 weights,
        which its first design refused; then at the ViT-B rows of batch
        1, 2 and 32 (208, 416, 6656) at set work splits: both tiles of
        each GEMM (ragged last row tiles at 208 and 416), fc2's tiles all
        split, some whole and the rest split 2-5 ways, the LayerNorm
        groups of 8 to 256 threads."""
        vh = vit_h_cfg()
        _, d, _, n_pad, hid, _ = vit_h_shapes(vh)
        seed = 500
        for b in (1, 2):
            for f1, f2 in (("int8", "int8"), ("int4", "int4"),
                           ("int8", "int4")):
                seed += 1
                self.k2(f"vit_h[{b * n_pad}x{d}x{hid}]({f1}/{f2})",
                        b * n_pad, d, hid, f1, f2, seed % 2 == 0, seed)
        bb, _, bd, _, bn_pad, _, bhid, _, _ = shapes(cfg)
        # (LN threads, fc1 tile, fc2 tile, fc2 tiles whole, splits)
        for m, lays in ((bn_pad, ((256, 64, 64, 0, 5), (256, 128, 128, 0, 3),
                                  (8, 64, 64, 10, 2))),
                        (2 * bn_pad, ((128, 64, 64, 0, 3),
                                      (32, 128, 128, 4, 4))),
                        (bb * bn_pad, ((8, 128, 128, 264, 5),
                                       (16, 64, 64, 1000, 2)))):
            for t, t1, t2, full, s in lays:
                seed += 1
                tiles2 = -(-m // t2) * -(-bd // t2)
                full = min(full, tiles2)
                self.k2(f"layout[{m}x{bd}x{bhid}](ln{t},t{t1}/{t2},"
                        f"whole{full},S{s})", m, bd, bhid,
                        "int8" if seed % 2 else "int4",
                        "int8" if seed % 2 else "int4", seed % 3 == 0, seed,
                        layout=dict(ln_threads=t, tile1=t1, tile2=t2,
                                    full2=full, splits=s))

    def run_vit_h_kernels(self):
        """K8 against its plain version at ViT-H/14's MLP shapes (batch 1
        and 2: 272 and 544 rows, K 1280, H 5120), at ViT-B's batch-3 chain
        shape (the JAX routing streams int8 weights there too) and at small
        ragged ones (off the 16-byte paths, one row tile, many), for the
        linear and pow quantizers, both residual dtypes, with and without
        bias; K3 and K6 at head_dim 80 (ViT-H's 272 tokens and a ragged
        40; K3 also in f32 at batch 4), int_attention on and off."""
        vh = vit_h_cfg()
        _, d, n_real, n_pad, hid, heads = vit_h_shapes(vh)
        hd = d // heads
        bf16, f32 = torch.bfloat16, torch.float32
        k8 = dict(kernel="fused_mlp_chunked")
        seed = 300
        for b in (1, 2):
            for pow_ in (False, True):
                for stream in (bf16, f32):
                    seed += 1
                    tag = (f"{'pow' if pow_ else 'lin'},"
                           f"{str(stream)[6:]}")
                    self.k2(f"main[{b * n_pad}x{d}x{hid}]({tag})",
                            b * n_pad, d, hid, "int8", "int8", pow_, seed,
                            stream, **k8)
            self.k2(f"main[{b * n_pad}x{d}x{hid}](lin,bf16,no bias)",
                    b * n_pad, d, hid, "int8", "int8", False, seed + 50,
                    bf16, bias=False, **k8)
        _, _, bd, _, bn_pad, _, bhid, _, _ = shapes(main_cfg())
        self.k2(f"vit_b_chain_b3[{3 * bn_pad}x{bd}x{bhid}](lin,bf16)",
                3 * bn_pad, bd, bhid, "int8", "int8", False, 360, bf16, **k8)
        for i, (m, k, h) in enumerate(((45, 96, 160), (96, 128, 512),
                                       (50, 72, 40), (1, 64, 96))):
            for pow_ in (False, True):
                self.k2(f"small[{m}x{k}x{h}]({'pow' if pow_ else 'lin'})",
                        m, k, h, "int8", "int8", pow_, 370 + 2 * i + pow_,
                        f32 if pow_ else bf16, bias=not pow_, **k8)
        for int_attn in (False, True):
            tag = "int_attn" if int_attn else "f_attn"
            self.k3(f"vit_h[2x{n_pad}x{d},h{heads}](int8,{tag})", 2, n_pad,
                    d, heads, n_real, "int8", "int8", False, 380 + int_attn,
                    int_attn=int_attn)
            self.k3(f"small[3x40x{2 * hd},h2](int8,pow,{tag})", 3, 40,
                    2 * hd, 2, 29, "int8", "int8", True, 382 + int_attn,
                    int_attn=int_attn)
            self.k3(f"small[3x40x{2 * hd},h2](f32,{tag})", 3, 40, 2 * hd, 2,
                    29, "int4", "int4", False, 384 + int_attn, f32,
                    int_attn=int_attn)
            # an f32 residual stream at batch 4, which the first K3 refused
            self.k3(f"vit_h[4x{n_pad}x{d},h{heads}](int8,f32,{tag})", 4,
                    n_pad, d, heads, n_real, "int8", "int8", False,
                    386 + int_attn, f32, int_attn=int_attn)
        seed = 400
        for b in (1, 2):
            for dt in (bf16, f32):
                for quant in (None, "lin", "pow"):
                    for int_attn in (False, True):
                        seed += 1
                        self.k6(f"vit_h[{b}x{n_pad},h{heads}x{hd}]"
                                f"({str(dt)[6:]},{quant or 'float'},"
                                f"{'int' if int_attn else 'f'}_attn)", b,
                                n_pad, heads, hd, n_real, dt, quant,
                                int_attn, seed)
        for quant in (None, "lin", "pow"):
            for int_attn in (False, True):
                seed += 1
                self.k6(f"small[3x40,h2x{hd}]({quant or 'float'},"
                        f"{'int' if int_attn else 'f'}_attn)", 3, 40, 2, hd,
                        29, bf16, quant, int_attn, seed)

    # -- K13 --------------------------------------------------------------

    def k13(self, case, b, h, n, hd, n_valid, dts, quant, seed):
        """K13 on seeded q/k/v [b, h, n, hd] (``dts``: q/k dtype, v
        dtype) against its plain version; ``quant``: None (float out in
        v's dtype), "lin" (t = 1) or "pow" (t != 1) int8 levels."""
        from quantized_vit_tpu_torch.ops import (flash_attention,
                                                 flash_attention_plain)
        from quantized_vit_tpu_torch.ops.attention import (_card_shape,
                                                           flash_tile_rows)

        g = torch.Generator(device=self.dev).manual_seed(seed)
        q, k, v = (torch.randn((b, h, n, hd), generator=g,
                               device=self.dev).to(dt)
                   for dt in (dts[0], dts[0], dts[1]))
        kw = dict(sm_scale=hd**-0.5, n_valid=n_valid, out_dtype=dts[1])
        if quant:
            kw.update(out_d=self.scal(0.02), out_t=self.scal(
                0.93 if quant == "pow" else 1.0), out_top=31,
                out_pow=quant == "pow")
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        self.check("flash_attention", case,
                   "levels" if quant else "attention", got, want)
        self.rows[-1]["qt"] = flash_tile_rows(
            b, h, n, hd, *(_card_shape(q.device.index) if q.is_cuda else ()))

    # -- K14, K15 at tp = 1 (tp > 1: fsdp_phase's spawned processes) ------

    def k15(self, case, m, cfg, seed, pow_=False, stream=torch.bfloat16):
        """K15 (tp = 1) with the four int8 weight shards of ``cfg``'s
        block to gather: the MLP against fused_mlp_plain, each gathered
        weight against its shard, byte for byte."""
        rows = mlp_gather_case(self.dev, None, cfg, m, seed, pow_, stream)
        for row in rows:
            self.add(dict(row, case=case + row["case"]))

    def run_chunked_kernels(self, cfg):
        """K8 (its redesign on TMA and wgmma) at the rest of its route's
        sites and past its first design's limits, bit-exact or not: the
        384-px ViT-B/16 chain at batch 1 with an f32 residual stream (592
        rows), ViT-B/16's batch-32 rows (6656, the site timed beside K2),
        ragged rows at ViT-H/14's widths (1, 45, 300), K = 1536 (H 6144)
        at 272 and 544 rows, each with the linear and the pow quantizer
        and both residual dtypes; then launched at set work splits (each
        phase's token chunk and wgmma N 32-256, rings of 3 to 16 stages)
        at ViT-H/14's batch 1 and 2 and at small ragged shapes."""
        from quantized_vit_tpu_torch.ops import fused as F

        from quantized_vit_tpu_torch.models import ViTConfig

        bf16, f32 = torch.bfloat16, torch.float32
        k8 = dict(kernel="fused_mlp_chunked")
        bb, _, bd, _, bn_pad, _, bhid, _, _ = shapes(cfg)
        _, _, _, _, bn384, _, _, _, _ = shapes(ViTConfig(**dict(
            CFG_KW, **B384_KW)))
        vh = vit_h_cfg()
        _, d, _, n_pad, hid, _ = vit_h_shapes(vh)
        wide = 6 * d // 5  # 1536 at ViT-H/14's 1280
        seed = 900
        sites = [(f"chain384_b1[{bn384}x{bd}x{bhid}]", bn384, bd, bhid),
                 (f"vit_b_b{bb}[{bb * bn_pad}x{bd}x{bhid}]", bb * bn_pad,
                  bd, bhid),
                 *[(f"vit_h_ragged[{m}x{d}x{hid}]", m, d, hid)
                   for m in (1, 45, n_pad + 28)],
                 *[(f"wide[{b * n_pad}x{wide}x{4 * wide}]", b * n_pad, wide,
                    4 * wide) for b in (1, 2)]]
        for case, m, k, h in sites:
            for pow_, stream in ((False, bf16), (True, f32), (False, f32),
                                 (True, bf16)):
                seed += 1
                if m == bb * bn_pad and stream == f32 and not pow_:
                    continue
                self.k2(f"{case}({'pow' if pow_ else 'lin'},"
                        f"{str(stream)[6:]})", m, k, h, "int8", "int8", pow_,
                        seed, stream, **k8)

        def split(m, phase, g):
            chunks = 2 if F.CHUNKED_WR[phase - 1] == F.CHUNKED_ROWS else 1
            g = max(g, -(-m // (chunks * F.CHUNKED_NW[-1])))  # <= 256 rows
            nc = -(-(-(-m // (chunks * g))) // 8) * 8
            return {f"nc{phase}": nc,
                    f"nw{phase}": next(v for v in F.CHUNKED_NW if v >= nc),
                    f"g{phase}": -(-m // (chunks * nc))}

        # (rows, K, H, fc1's token groups, fc2's)
        for m, k, h, g1, g2 in ((n_pad, d, hid, 1, 1),
                                (n_pad, d, hid, 2, 3),
                                (n_pad, d, hid, 6, 12),
                                (2 * n_pad, d, hid, 4, 2),
                                (2 * n_pad, d, hid, 12, 5),
                                (45, 96, 160, 1, 1), (50, 72, 40, 3, 2),
                                (1, 64, 96, 1, 1)):
            lay = dict(split(m, 1, g1), **split(m, 2, g2))
            stage = max(F._chunked_stage(F.CHUNKED_WR[0], lay["nw1"]),
                        F._chunked_stage(F.CHUNKED_WR[1], lay["nw2"]))
            for stages in sorted({3, F.chunked_stages(stage)}):
                seed += 1
                pow_ = seed % 2 == 0
                self.k2(f"layout[{m}x{k}x{h}](fc1 {lay['nc1']}/{lay['nw1']}"
                        f"x{lay['g1']},fc2 {lay['nc2']}/{lay['nw2']}x"
                        f"{lay['g2']},st{stages})", m, k, h, "int8", "int8",
                        pow_, seed, f32 if pow_ else bf16,
                        layout=dict(lay, stages=stages), **k8)

    def run_flash_kernels(self, cfg):
        """K13 at K13's path shapes (ViT-B/16 batch 32: 208 tokens, 197
        real; ViT-H/14 batch 1 and 8: 272, 257, head_dim 80) in bf16, f32
        and mixed q/v dtypes, float and int8 outputs, t = 1 and t != 1,
        and at a ragged 50 tokens (37 real); then at a 384-px ViT-B/16's
        592 tokens, ViT-B/16 batch 2, ViT-H/14 batch 2 and batch 1 in f32,
        head_dim 80 and 128 at the tiles those leave out, and a head_dim of
        20 (rows off the 16-byte grid: the element-by-element staging), so
        every (tile, head bound) instantiation runs. Each row records its
        tile."""
        b, _, d, n_real, n_pad, _, _, _, heads = shapes(cfg)
        vh = vit_h_cfg()
        _, dh, nh_real, nh_pad, _, hh = vit_h_shapes(vh)
        bf16, f32 = torch.bfloat16, torch.float32
        seed = 800
        for tag, bb, h, n, hd, nv in (
                (f"vit_b[{b}x{heads}x{n_pad}x{d // heads}]", b, heads, n_pad,
                 d // heads, n_real),
                *((f"vit_h[{bk}x{hh}x{nh_pad}x{dh // hh}]", bk, hh, nh_pad,
                   dh // hh, nh_real) for bk in K13_VIT_H_BATCHES)):
            for quant in (None, "lin", "pow"):
                seed += 1
                self.k13(f"{tag}(bf16,{quant or 'float'})", bb, h, n, hd, nv,
                         (bf16, bf16), quant, seed)
        vb = (b, heads, n_pad, d // heads, n_real)
        for dts in ((f32, f32), (f32, bf16), (bf16, f32)):
            for quant in (None, "lin"):
                seed += 1
                dt = f"{str(dts[0])[6:]}/{str(dts[1])[6:]}"
                self.k13(f"vit_b[{b}x{heads}x{n_pad}x{d // heads}]({dt},"
                         f"{quant or 'float'})", *vb, dts, quant, seed)
        for dts in ((bf16, bf16), (f32, f32), (f32, bf16)):
            for quant in (None, "lin", "pow"):
                seed += 1
                dt = f"{str(dts[0])[6:]}/{str(dts[1])[6:]}"
                self.k13(f"ragged[3x2x50x72]({dt},{quant or 'float'})", 3, 2,
                         50, 72, 37, dts, quant, seed)
        # the ViT-B/16 widths at 384 px (577 tokens padded to 592) and at
        # batch 2; ViT-H/14 at batch 2, and at batch 1 in f32
        n384 = (384 // cfg.patch_size)**2 + 1
        n384_pad = -(-n384 // 16) * 16
        for quant in (None, "lin"):
            self.k13(f"vit_b384[{b}x{heads}x{n384_pad}x{d // heads}]"
                     f"(bf16,{quant or 'float'})", b, heads, n384_pad,
                     d // heads, n384, (bf16, bf16), quant, 830 + bool(quant))
        self.k13(f"vit_b[2x{heads}x{n_pad}x{d // heads}](bf16,float)", 2,
                 heads, n_pad, d // heads, n_real, (bf16, bf16), None, 832)
        self.k13(f"vit_h[2x{hh}x{nh_pad}x{dh // hh}](bf16,float)", 2, hh,
                 nh_pad, dh // hh, nh_real, (bf16, bf16), None, 833)
        for i, (dts, quant) in enumerate((((f32, f32), None),
                                          ((f32, bf16), "lin"))):
            dt = f"{str(dts[0])[6:]}/{str(dts[1])[6:]}"
            self.k13(f"vit_h[1x{hh}x{nh_pad}x{dh // hh}]({dt},"
                     f"{quant or 'float'})", 1, hh, nh_pad, dh // hh,
                     nh_real, dts, quant, 834 + i)
        # the tiles the path shapes leave out (64 rows at head bound 80 and
        # 128, 16 at 64 and 128), head_dim 128 at ragged tokens, and a
        # head_dim of 20 (rows off the 16-byte grid)
        seed = 840
        for shape, cases in (
                ((4, 16, 144, 80, 140), (((bf16, bf16), None),
                                         ((f32, f32), "lin"))),
                ((4, 8, 197, 128, 190), (((bf16, bf16), None),
                                         ((bf16, bf16), "pow"),
                                         ((f32, f32), None))),
                ((32, 16, 40, 128, 37), (((bf16, bf16), None),
                                         ((f32, f32), "lin"))),
                ((1, 2, 40, 128, 33), (((bf16, bf16), None),)),
                ((2, 3, 45, 20, 41), (((bf16, bf16), None),
                                      ((f32, bf16), "lin"),
                                      ((bf16, f32), "pow")))):
            for dts, quant in cases:
                seed += 1
                dt = f"{str(dts[0])[6:]}/{str(dts[1])[6:]}"
                self.k13(f"ragged[{'x'.join(map(str, shape[:4]))}]({dt},"
                         f"{quant or 'float'})", *shape, dts, quant, seed)

    def run_gather_kernels(self, cfg):
        """K14 on ViT-B's four block weights (int8, packed int4 and bf16
        bytes) and K15 at tp = 1: at ViT-B/16's width at the batch's rows
        and ragged ones, and at ViT-H/14's (the first K15 refused it) at
        batch 32's and 2's rows and a ragged count."""
        b, _, d, _, n_pad, *_ = shapes(cfg)
        for kcfg, kind in gather_kinds(cfg, vit_h_cfg()):
            for row in gather_case(self.dev, None, kcfg, kind, 900):
                self.add(row)
        m = b * n_pad
        self.k15(f"main[{m}x{d}]", m, cfg, 910)
        for i, mr in enumerate(K15_RAGGED_M):
            self.k15(f"ragged[{mr}x{d}]", mr, cfg, 911 + i)
        self.k15(f"ragged[{K15_RAGGED_M[0]}x{d}](pow,f32)", K15_RAGGED_M[0],
                 cfg, 915, pow_=True, stream=torch.float32)
        cfg_h = vit_h_cfg()
        n_h, d_h = vit_h_shapes(cfg_h)[3], cfg_h.embed_dim
        m_h = [bk * n_h for bk in (max(VIT_H_BATCHES), 2)]
        for i, mh in enumerate(m_h + [K15_RAGGED_M[1]]):
            self.k15(f"vith[{mh}x{d_h}]", mh, cfg_h, 916 + i)

    def run_all(self, cfg):
        t0 = time.time()
        seed = 0
        b, p, d, n_real, n_pad, kp, hid, ncls, heads = shapes(cfg)
        m = b * n_pad
        for fmt in ("int4", "int8"):
            for pow_ in (False, True):
                tag = f"{fmt},{'pow' if pow_ else 'lin'}"
                seed += 1
                self.k1(f"patch_embed[{b * p}x{kp}x{d}]({tag})", b * p, kp,
                        d, fmt, pow_, "quant", None, seed)
                self.k1(f"head[{b}x{d}x{ncls}]({tag})", b, d, ncls, fmt,
                        pow_, "quant", None, seed)
                self.k2(f"main[{m}x{d}x{hid}]({tag})", m, d, hid, fmt, fmt,
                        pow_, seed)
                self.k3(f"main[{b}x{n_pad}x{d},h{heads}]({tag})", b, n_pad,
                        d, heads, n_real, fmt, fmt, pow_, seed)
            self.k1(f"attn_proj[{m}x{d}x{d}]({fmt})", m, d, d, fmt, False,
                    None, "residual", seed)
        self.k4(f"main[{b}x{p}x{d}->{n_pad}](bf16)", b, p, d, n_pad,
                torch.bfloat16, 1)
        self.k4(f"main[{b}x{p}x{d}->{n_pad}](f32)", b, p, d, n_pad,
                torch.float32, 2)
        # small ragged shapes: every prologue x epilogue of K1, mixed
        # weight formats for K2/K3
        for fmt in ("int4", "int8"):
            for pow_ in (False, True):
                tag = f"{fmt},{'pow' if pow_ else 'lin'}"
                for pro in (None, "quant", "ln_quant", "gelu_quant"):
                    for epi in (None, "residual", "quant", "gelu_quant"):
                        seed += 1
                        self.k1(f"small[50x96x72,{pro}->{epi}]({tag})", 50,
                                96, 72, fmt, pow_, pro, epi, seed)
                self.k2(f"small[45x96x160]({tag})", 45, 96, 160, fmt, fmt,
                        pow_, seed)
                self.k3(f"small[3x40x96,h3]({tag})", 3, 40, 96, 3, 29, fmt,
                        fmt, pow_, seed)
        # shapes off the 16-byte paths (K, H, D not multiples of 16 / 32):
        # the kernels' byte-wise fallbacks (K1's own plan pads such a
        # weight; on a shared copy it reads it byte by byte)
        for fmt in ("int4", "int8"):
            for pro, epi in ((None, "residual"), ("ln_quant", "gelu_quant"),
                             ("quant", None)):
                seed += 1
                self.k1(f"small[50x40x72,{pro}->{epi}]({fmt})", 50, 40, 72,
                        fmt, False, pro, epi, seed)
                self.k1(f"small[50x40x72,{pro}->{epi}]({fmt},byte-wise)",
                        50, 40, 72, fmt, False, pro, epi, seed,
                        byte_wise=True)
            self.k2(f"small[45x72x40]({fmt})", 45, 72, 40, fmt, fmt, False,
                    seed)
            self.k3(f"small[3x40x72,h3]({fmt})", 3, 40, 72, 3, 29, fmt, fmt,
                    False, seed)
        self.k2("small[45x96x160](int8/int4)", 45, 96, 160, "int8", "int4",
                False, 7)
        self.k3("small[3x40x96,h3](int8/int4)", 3, 40, 96, 3, 29, "int8",
                "int4", False, 7)
        # the f32 residual stream (vit_int4_forward's default float_dtype)
        for fmt in ("int4", "int8"):
            self.k2(f"small[45x96x160](f32,{fmt})", 45, 96, 160, fmt, fmt,
                    False, 8, torch.float32)
            self.k3(f"small[3x40x96,h3](f32,{fmt})", 3, 40, 96, 3, 29, fmt,
                    fmt, False, 8, torch.float32)
        self.k4("small[3x4x72->16]", 3, 4, 72, 16, torch.bfloat16, 3)
        self.run_k1_sites(cfg)
        self.run_small_batch_kernels(cfg)
        self.run_mlp_kernels(cfg)
        self.run_vit_h_kernels()
        self.run_chunked_kernels(cfg)
        self.run_heads_tiles()
        self.run_qkv_attn_tiles()
        self.run_qkv_proj_kernels(cfg)
        self.run_qkv_proj_layouts()
        self.run_int_matmul_kernels(cfg)
        self.run_flash_kernels(cfg)
        self.run_gather_kernels(cfg)
        self.run_quant_bwd(cfg)
        sync()
        n_ok = sum(r["ok"] for r in self.rows)
        n_exact = sum(r["bit_exact"] for r in self.rows)
        log(f"[parity] {n_ok}/{len(self.rows)} cases pass, {n_exact} "
            f"bit-exact ({time.time() - t0:.1f} s)")
        for r in self.rows:
            if not r["ok"] or "small" not in r["case"]:
                log(f"  {'ok ' if r['ok'] else 'BAD'} {r['kernel']:18s} "
                    f"{r['case']:44s} max {r['max_abs_err']:.3g} "
                    f"share {r['share_differ']:.2e}")


def k7_sites(cfg):
    """(site, shape, launches per training step) of every nonlinear
    quantizer of the ViT training step at BATCH: K7 runs once for each
    weight quantizer and once for each activation quantizer."""
    b, p, d, n_real, _, kp, hid, ncls, _ = shapes(cfg)
    ps, rows, depth = cfg.patch_size, b * n_real, cfg.depth
    return [("patch_act", (b * p, kp), 1),
            ("patch_wt", (ps, ps, cfg.in_channels, d), 1),
            ("qkv_act", (rows, d), depth), ("qkv_wt", (d, 3 * d), depth),
            ("proj_act", (rows, d), depth), ("proj_wt", (d, d), depth),
            ("fc1_act", (rows, d), depth), ("fc1_wt", (d, hid), depth),
            ("fc2_act", (rows, hid), depth), ("fc2_wt", (hid, d), depth),
            ("head_act", (b, d), 1), ("head_wt", (d, ncls), 1)]


# ---------------------------------------------------------------------------
# phase 3: the main path, one batch-32 forward
# ---------------------------------------------------------------------------

def expected_launches(depth, route="block", mlp="fused_mlp"):
    """Launches of one forward. ``block`` (batch >= 4): K1 for the patch
    embed, each block's proj and the head, K3 once per block, K4 once.
    ``chain`` (batch 1-3): K1 also for each block's qkv, K6 in place of
    K3. The MLP once per block: ``fused_mlp`` (K2), ``fused_mlp_chunked``
    (K8), or ``chain``, two K1 launches (fc1, fc2). ``latency``: K1 twice,
    K4 and K5 once. ``fsdp``: the FSDP forward (a process's batch >= 4),
    the block route with K15 for the MLP and one K14 (block 0's
    gather)."""
    from quantized_vit_tpu_torch.ops import _build

    # every counter (the tools' ablations' too) at 0 but K4's
    none = dict(dict.fromkeys(_build.LAUNCHES, 0), patch_finalize=1)
    if route == "latency":
        return dict(none, fused_quant_matmul=2, block_stack=1)
    if route == "fsdp":
        return dict(none, fused_quant_matmul=2 + depth,
                    attention_block=depth, gather_rows=1,
                    fused_mlp_gather=depth)
    out = dict(none, fused_quant_matmul=2 + depth * (2 if route == "chain"
                                                     else 1))
    out["attention_qkv" if route == "chain" else "attention_block"] = depth
    if mlp == "chain":
        out["fused_quant_matmul"] += 2 * depth
    else:
        out[mlp] = depth
    return out


# Logit tolerance vs the plain path: every kernel repeats its plain
# version's f32 arithmetic (sums in f64), so the logits should agree to the
# last bit; a rare level flip at a rounding tie in an early block moves a
# logit by about scale*top*|w| ~ 1e-3*7*7 ~ 0.05 at most.
LOGIT_TOL = 0.05
CHAIN_BATCHES = (1, 2, 3)
# the batches at which both attention routes' branches are timed
ROUTE_BATCHES = (2, 3, 4, 8, 16, 32)
# the MLP kernel of the ViT-B chain forwards (int8-stored levels, bf16):
# the JAX routing (fused.py:916-929) streams the weights in hidden chunks
# at batch 3, whose 624 rows leave the resident TPU kernel a 128-row tile
CHAIN_MLP = {1: "fused_mlp", 2: "fused_mlp", 3: "fused_mlp_chunked"}
# ViT-H/14's MLP per batch (int8, bf16): K8 at 272 and 544 rows, the K1
# chain above 576 (vit_int4.py:323-356)
VIT_H_MLP = {1: "fused_mlp_chunked", 2: "fused_mlp_chunked"}


def check_forward(record, dev, tag, fn, plain, want_launches, batch, cfg):
    """One forward through the kernels with the launch counters set to 0
    just before and read just after; logits against ``plain``."""
    from quantized_vit_tpu_torch.ops import _build

    _build.reset_launches()
    logits = fn()
    sync()
    launches = dict(_build.LAUNCHES)
    ref = plain()
    sync()
    d = (logits - ref).abs()
    rec = {"forward": tag, "batch": batch, "launches": launches,
           "logits_shape": list(logits.shape),
           "max_abs_diff": float(d.max()),
           "share_differ": float((d > 0).float().mean()),
           "logits_equal": bool(torch.equal(logits, ref)),
           "argmax_agree": float((logits.argmax(1) == ref.argmax(1))
                                 .float().mean()),
           "logit_absmax": float(ref.abs().max())}
    record.setdefault("forward", []).append(rec)
    log(f"[forward {tag} b{batch}] launches {launches} max|dlogit| "
        f"{rec['max_abs_diff']:.3g} equal {rec['logits_equal']} "
        f"|logit|max {rec['logit_absmax']:.3g}")
    if dev.type == "cuda" and launches != want_launches:
        raise Failed(f"forward {tag} b{batch} launches {launches} != "
                     f"{want_launches}")
    if (tuple(logits.shape) != (batch, cfg.num_classes)
            or not torch.isfinite(logits).all()):
        raise Failed(f"forward {tag} logits {tuple(logits.shape)} not "
                     "finite or wrong shape")
    if rec["max_abs_diff"] > LOGIT_TOL:
        raise Failed(f"forward {tag} logits differ from the plain path by "
                     f"{rec['max_abs_diff']} > {LOGIT_TOL}")
    return launches


def forward_phase(dev, record):
    """The batch-32 forward (K3 + K2 route) for both weight storages, the
    chain forward at batch 1-3, ``int_attention`` on both routes, and the
    batch-1 latency forward (K5)."""
    from quantized_vit_tpu_torch.serve import (prepare_kernels,
                                               prepare_latency_artifact,
                                               random_vit_int4_artifact,
                                               vit_int4_forward,
                                               vit_int4_forward_latency)
    from quantized_vit_tpu_torch.utils import patchify_batch

    cfg = main_cfg()
    rng = np.random.default_rng(0)
    images = rng.standard_normal(
        (BATCH, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
    out = {"cfg": cfg, "x": x, "launches": {}}
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    for pack in (False, True):
        art = random_vit_int4_artifact(cfg, seed=0, pack_weights=pack,
                                       device=dev)
        # the weights' kernel layout and folded constants, once per
        # artifact (as the serve CLI does at load); no kernel launches
        t0 = time.perf_counter()
        plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
        sync()
        plan_ms = (time.perf_counter() - t0) * 1e3
        tag = "int4-packed" if pack else "int8-stored"
        launches = check_forward(
            record, dev, tag,
            lambda: vit_int4_forward(art, x, cfg, plan=plan, **kw),
            lambda: vit_int4_forward(art, x, cfg, use_kernels=False, **kw),
            expected_launches(cfg.depth), BATCH, cfg)
        record["forward"][-1]["prepare_kernels_host_ms"] = plan_ms
        if pack:
            out["art_packed"] = art
            continue
        out.update(art=art, plan=plan)
        out["launches"]["block"] = launches
        # the chain route (the JAX gate: batch < 4), same artifact
        for b in CHAIN_BATCHES:
            xb = x[:b]
            launches = check_forward(
                record, dev, f"chain,{tag}",
                lambda: vit_int4_forward(art, xb, cfg, plan=plan, **kw),
                lambda: vit_int4_forward(art, xb, cfg, use_kernels=False,
                                         **kw),
                expected_launches(cfg.depth, "chain", CHAIN_MLP[b]), b, cfg)
            out["launches"][f"chain_b{b}"] = launches
        # int_attention (the variant bench.py times) on both routes
        for b, route in ((4, "block"), (2, "chain")):
            xb = x[:b]
            check_forward(
                record, dev, f"{route},int_attn,{tag}",
                lambda: vit_int4_forward(art, xb, cfg, plan=plan,
                                         int_attention=True, **kw),
                lambda: vit_int4_forward(art, xb, cfg, use_kernels=False,
                                         int_attention=True, **kw),
                expected_launches(cfg.depth, route), b, cfg)
    # the batch-1 latency entry on the packed artifact (the JAX package's
    # latency format); the JAX bench demands its logits equal the chain's
    art = out["art_packed"]
    t0 = time.perf_counter()
    lat, meta = prepare_latency_artifact(art, cfg)
    sync()
    lat_ms = (time.perf_counter() - t0) * 1e3
    x1 = x[:1]
    out["launches"]["latency"] = check_forward(
        record, dev, "latency,int4-packed",
        lambda: vit_int4_forward_latency(lat, x1, cfg, meta, **kw),
        lambda: vit_int4_forward(art, x1, cfg, use_kernels=False, **kw),
        expected_launches(cfg.depth, "latency"), 1, cfg)
    record["forward"][-1]["prepare_latency_host_ms"] = lat_ms
    if not record["forward"][-1]["logits_equal"]:
        raise Failed("forward latency: logits differ from the plain path's")
    out.update(lat=lat, meta=meta)
    b384 = dict(CFG_KW, **B384_KW)
    out["launches"]["latency384"] = latency_forward(dev, record, b384, "384")
    out["launches"]["chain384_b1"] = limit_forward(dev, record, b384, "384",
                                                   1, torch.float32)
    out["launches"]["block384_b4"] = limit_forward(dev, record, b384, "384",
                                                   4, torch.bfloat16)
    out["launches"]["block_vith14_f32_b4"] = limit_forward(
        dev, record, dict(VIT_H_KW, depth=2), "_vith14", 4, torch.float32)
    # ViT-H/14 with packed int4 at batch 1-2: K2 at K = 1280
    for bk in (1, 2):
        out["launches"][f"chain_vith14_int4_b{bk}"] = limit_forward(
            dev, record, dict(VIT_H_KW, depth=2), "_vith14", bk,
            torch.bfloat16, pack=True)
    return out


def latency_forward(dev, record, cfg_kw, name):
    """The batch-1 latency entry (one K5 launch) of a configuration the
    first K5 refused, in bf16 with packed int4 weights from seed 0: the
    384-px ViT-B/16 (592 key rows), launches checked, logits equal to the
    plain path's."""
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.serve import (prepare_latency_artifact,
                                               random_vit_int4_artifact,
                                               vit_int4_forward,
                                               vit_int4_forward_latency)
    from quantized_vit_tpu_torch.utils import patchify_batch

    cfg = ViTConfig(**cfg_kw)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=True,
                                   device=dev)
    lat, meta = prepare_latency_artifact(art, cfg)
    images = np.random.default_rng(7).standard_normal(
        (1, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    tag = f"latency{name},bf16,int4-packed"
    launches = check_forward(
        record, dev, tag,
        lambda: vit_int4_forward_latency(lat, x, cfg, meta, **kw),
        lambda: vit_int4_forward(art, x, cfg, use_kernels=False, **kw),
        expected_launches(cfg.depth, "latency"), 1, cfg)
    if not record["forward"][-1]["logits_equal"]:
        raise Failed(f"forward {tag}: logits differ from the plain path's")
    return launches


def limit_forward(dev, record, cfg_kw, name, batch, float_dtype,
                  pack=False):
    """The forward of a configuration a first kernel refused (int8-stored
    levels from seed 0, or packed int4 with ``pack``), launches checked,
    logits against the plain path: the 384-px ViT-B/16 (``B384_KW`` over
    the main configuration) at batch 1 in f32 on the chain (K6 on 592
    tokens at head_dim 64) and at batch 4 in bf16 on the K3 route (592
    tokens); ViT-H/14 at depth 2 in f32 at batch 4 on the K3 route (272
    tokens x head_dim 80 in f32), and with packed int4 at batch 1 and 2
    in bf16 on the chain (K2 at K 1280). On the K3 route and with packed
    int4 the logits must equal the plain path's."""
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.serve import (prepare_kernels,
                                               random_vit_int4_artifact,
                                               uses_chain, vit_int4_forward)
    from quantized_vit_tpu_torch.serve.vit_int4 import mlp_route
    from quantized_vit_tpu_torch.utils import patchify_batch

    cfg = ViTConfig(**cfg_kw)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=pack,
                                   device=dev)
    plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
    images = np.random.default_rng(6).standard_normal(
        (batch, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
    kw = dict(float_dtype=float_dtype, images_layout="patches")
    n_pad = -(-cfg.num_tokens // 16) * 16
    mlp = mlp_route(batch * n_pad, cfg.embed_dim,
                    int(cfg.embed_dim * cfg.mlp_ratio),
                    "int4" if pack else "int8",
                    itemsize=float_dtype.itemsize)
    route = "chain" if uses_chain(batch) else "block"
    dt = "f32" if float_dtype == torch.float32 else "bf16"
    tag = f"{route}{name},{dt},{'int4-packed' if pack else 'int8-stored'}"
    launches = check_forward(
        record, dev, tag,
        lambda: vit_int4_forward(art, x, cfg, plan=plan, **kw),
        lambda: vit_int4_forward(art, x, cfg, use_kernels=False, **kw),
        expected_launches(cfg.depth, route, mlp), batch, cfg)
    if ((route == "block" or pack)
            and not record["forward"][-1]["logits_equal"]):
        raise Failed(f"forward {tag} b{batch}: logits differ from the "
                     "plain path's")
    return launches


def vit_h_phase(dev, record):
    """ViT-H/14 at full width and depth (int8-stored levels from seed 0,
    host-patchified input, bf16 residual stream) through the forward at
    batch 1, 2 and 32, each with the launch counters set to 0 just before
    and read just after, logits against the plain path: batch 1 and 2 run
    K1 qkv + K6 + K1 proj + K8 per block, batch 32 K3 + K1 proj + the
    K1 fc1/fc2 chain."""
    from quantized_vit_tpu_torch.serve import (prepare_kernels,
                                               random_vit_int4_artifact,
                                               vit_int4_forward)

    cfg = vit_h_cfg()
    t0 = time.perf_counter()
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False,
                                   device=dev)
    sync()
    art_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
    sync()
    plan_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(5)
    kp = cfg.patch_size**2 * cfg.in_channels
    x = torch.from_numpy(rng.standard_normal(
        (max(VIT_H_BATCHES), cfg.num_patches, kp)).astype(np.float32)).to(dev)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    out = {"cfg": cfg, "art": art, "plan": plan, "x": x, "launches": {}}
    for b in VIT_H_BATCHES:
        xb = x[:b]
        route = "chain" if b < 4 else "block"
        out["launches"][f"vith_b{b}"] = check_forward(
            record, dev, "vit_h14,int8-stored",
            lambda: vit_int4_forward(art, xb, cfg, plan=plan, **kw),
            lambda: vit_int4_forward(art, xb, cfg, use_kernels=False, **kw),
            expected_launches(cfg.depth, route, VIT_H_MLP.get(b, "chain")),
            b, cfg)
    record["vit_h"] = {"config": dict(VIT_H_KW), "artifact_s": art_s,
                       "prepare_kernels_host_ms": plan_ms}
    log(f"[vit_h] artifact {art_s:.1f} s, prepare_kernels {plan_ms:.1f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 3b: the kernel-level paths of bench.py and the JAX package's tools
# ---------------------------------------------------------------------------


def run_path(dev, tag, fn, want):
    """``fn()`` with the launch counters set to 0 just before and read just
    after; on the card the launches must be ``want`` (kernel: count).
    Returns the result and every counter."""
    from quantized_vit_tpu_torch.ops import _build

    _build.reset_launches()
    out = fn()
    sync()
    launches = dict(_build.LAUNCHES)
    got = {k: v for k, v in launches.items() if v}
    log(f"[path {tag}] launches {got}")
    if dev.type == "cuda" and got != want:
        raise Failed(f"path {tag}: launches {got} != {want}")
    return out, launches


def path_check(rec, tag, got, want, tol=None, levels=False):
    """``got`` against ``want`` into ``rec[tag]``: the attention contract
    (within 0.1, differing at <= 1% of positions), with ``levels`` the
    levels contract (within 1 level at <= 0.5% of positions) or, with
    ``tol``, allclose at rtol = atol = tol; raises Failed otherwise."""
    mx, share = float_diff(got, want)
    if levels:
        ok = mx <= 1 and share <= 0.005
    elif tol is None:
        ok = mx <= 0.1 and share <= 0.01
    else:
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
    ok = ok and tuple(got.shape) == tuple(want.shape) and bool(
        torch.isfinite(got.float()).all())
    rec[tag] = {"max_abs_diff": mx, "share_differ": share,
                "bit_equal": mx == 0.0, "ok": ok}
    log(f"  {tag}: max {mx:.3g} share {share:.2e} equal {mx == 0.0} ok {ok}")
    if not ok:
        raise Failed(f"{tag}: max {mx}, share {share}")


def kernel_paths_phase(dev, record, fwd):
    """The kernel-level entry points as bench.py and the JAX package's
    tools drive them, at full width, each path with the launch counters
    set to 0 just before and read just after:

    - bench.py's parity preamble (bench.py:165-185): K9 on qkv
      [2, 64, 384] against its plain pair;
    - tools/exp_vith.py: the ViT-H/14 attention branch at batch 8 on block
      0 of the seed-0 artifact and seeded input, K1 qkv (LayerNorm + quant
      prologue, bf16 out) then K9, against K3's branch (its heads launch
      and its K1 proj) on the same x: one function of the same weights,
      so within the attention contract;
    - tools/profile_kernels.py: at ViT-B/16's four layer shapes,
      quant_matmul_fa (int4, bf16 x and out, t = 1), int4_matmul (f32
      out) and int8_matmul on the same levels with int8 weights, each
      exact against its plain version;
    - tests/ops/test_int4_matmul.py:89-120 at ViT-B/16's fc1 (768 ->
      3072) on M = 1664 seeded rows: 4-bit LSFQ levels through
      int4_matmul, the float x through quant_matmul_fa, both within 1e-4
      of the fake-quant float product;
    - K13 (``flash_attention``, which nothing in the JAX package calls) on
      the q/k/v of block 0 of the seed-0 artifacts (:func:`block0_qkv`),
      ViT-B/16 at batch 32 and ViT-H/14 at batch 1 and 8, the bf16 output
      (attention contract) and the proj's int8 levels (levels contract)
      against its plain version.
    """
    from quantized_vit_tpu_torch.ops import (attention_block,
                                             attention_qkv_proj,
                                             attention_qkv_proj_plain,
                                             flash_attention,
                                             flash_attention_plain,
                                             fused_quant_matmul, int4_matmul,
                                             int4_matmul_plain, int8_matmul,
                                             int8_matmul_plain,
                                             quant_matmul_fa,
                                             quant_matmul_fa_plain)
    from quantized_vit_tpu_torch.quant import (init_quant_params,
                                               lsfq_levels, lsfq_nonlinear,
                                               lsfq_top_level, pack_int4)
    from quantized_vit_tpu_torch.serve.vit_int4 import _attention_layer

    bf16, f32 = torch.bfloat16, torch.float32
    rec, launches = {}, {}

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x.to(dtype) if dtype else x

    def scal(v):
        return torch.full((), v, dtype=f32, device=dev)

    # bench.py's parity preamble
    rng = np.random.default_rng(7)
    qkv = t(rng.standard_normal((2, 64, 3 * 128)) * 0.1, bf16)
    wp = t(rng.integers(-7, 8, (128, 256)).astype(np.int8))
    bp = t(rng.standard_normal(256) * 0.01, f32)
    resp = t(rng.standard_normal((2, 64, 256)) * 0.1, bf16)
    akw = dict(heads=2, sm_scale=0.125, n_valid=50, out_d=scal(0.05),
               out_t=scal(1.0), out_top=7, fmt="int8")
    got, launches["bench_preamble"] = run_path(
        dev, "bench_preamble",
        lambda: attention_qkv_proj(qkv, wp, scal(1e-3), bp, resp, **akw),
        {"attention_qkv_proj": 1})
    path_check(rec, "bench_preamble", got, attention_qkv_proj_plain(
        qkv, wp, scal(1e-3), bp, resp, **akw))

    # tools/exp_vith.py: the ViT-H/14 attention branch at batch 8
    vh = fwd["vit_h"]
    _, d, n_real, n_pad, _, heads = vit_h_shapes(vh["cfg"])
    hd = d // heads
    bh = VIT_H_BRANCH_BATCH
    blk = vh["art"]["blocks"][0]
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    layer = _attention_layer(blk, hd, hd**-0.5)
    x = t(np.random.default_rng(9).standard_normal((bh * n_pad, d)) * 0.5,
          bf16)
    x3 = x.reshape(bh, n_pad, d)
    proj_q = {k: layer[k] for k in ("heads", "sm_scale", "out_d", "out_t",
                                    "out_top", "out_pow")}

    def k1_k9():
        q = fused_quant_matmul(
            x, qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
            prologue="ln_quant", act_d=layer["act_d"], act_t=layer["act_t"],
            act_top=layer["act_top"], act_pow=layer["act_pow"],
            ln_scale=layer["ln_scale"], ln_bias=layer["ln_bias"],
            out_dtype=bf16)
        return attention_qkv_proj(
            q.reshape(bh, n_pad, -1), proj_e.w, proj_e.scale, proj_e.bias,
            x3, n_valid=n_real, fmt=proj_e.fmt, out_dtype=bf16, **proj_q)

    tag = f"vith_branch_b{bh}"
    k9_out, launches[tag] = run_path(
        dev, tag + " K1+K9", k1_k9,
        {"fused_quant_matmul": 1, "attention_qkv_proj": 1})
    k3_out, launches[tag + "_k3"] = run_path(
        dev, tag + " K3 branch",
        lambda: attention_block(
            x3, qkv_e.w, qkv_e.scale, qkv_e.bias, proj_e.w, proj_e.scale,
            proj_e.bias, fmt_proj=proj_e.fmt, n_valid=n_real,
            out_dtype=bf16, **layer),
        {"attention_block": 1, "fused_quant_matmul": 1})
    path_check(rec, tag + " K1+K9 vs K3 branch", k9_out, k3_out)

    # tools/profile_kernels.py's GEMMs at ViT-B/16's layer shapes
    rng = np.random.default_rng(0)
    gemm = []
    for label, m, k, n in profile_shapes(main_cfg()):
        w_lv = t(rng.integers(-7, 8, (k, n)).astype(np.int8))
        gemm.append((label, t(rng.standard_normal((m, k)) * 0.1, bf16),
                     t(rng.integers(-7, 8, (m, k)).astype(np.int8)), w_lv,
                     pack_int4(w_lv, axis=0),
                     t(rng.standard_normal(n) * 0.01, f32)))
    fa_q = (scal(0.05), scal(1.0),
            torch.full((), 7, dtype=torch.int32, device=dev))
    sc = scal(1e-3)

    def profile():
        return [(quant_matmul_fa(xf, wp4, sc, b, *fa_q, fmt="int4",
                                 act_pow=False, out_dtype=bf16),
                 int4_matmul(xl, wp4, sc, b, out_dtype=f32),
                 int8_matmul(xl, w8, sc, b, out_dtype=f32))
                for _, xf, xl, w8, wp4, b in gemm]

    outs, launches["profile_kernels"] = run_path(
        dev, "profile_kernels", profile,
        {k: len(gemm) for k in ("quant_matmul_fa", "int4_matmul",
                                "int8_matmul")})
    for (label, xf, xl, w8, wp4, b), (fa, i4, i8) in zip(gemm, outs):
        path_check(rec, f"profile_{label} quant_matmul_fa", fa,
                   quant_matmul_fa_plain(xf, wp4, sc, b, *fa_q, fmt="int4",
                                         act_pow=False, out_dtype=bf16), 0.0)
        path_check(rec, f"profile_{label} int4_matmul", i4,
                   int4_matmul_plain(xl, wp4, sc, b), 0.0)
        path_check(rec, f"profile_{label} int8_matmul", i8,
                   int8_matmul_plain(xl, w8, sc, b), 0.0)
    del gemm, outs

    # the LSFQ pipeline at fc1's width
    _, m, k, n = profile_shapes(main_cfg())[2]
    rng = np.random.default_rng(8)
    xa = t(rng.standard_normal((m, k)) * 0.5, f32)
    wa = t(rng.standard_normal((k, n)) * 0.05, f32)
    d_w, qm_w, t_w = init_quant_params(wa, num_bits=4, nonlinear=True)
    d_a, qm_a, t_a = init_quant_params(xa, num_bits=4, nonlinear=True)
    clip = torch.tensor([-2.0, 2.0], device=dev)
    float_out = (lsfq_nonlinear(xa, d_a, qm_a, t_a, clip)
                 @ lsfq_nonlinear(wa, d_w, qm_w, t_w, clip))
    w_packed = pack_int4(lsfq_levels(wa, d_w, qm_w, t_w).to(torch.int8))
    x_lv = lsfq_levels(xa, d_a, qm_a, t_a).to(torch.int8)
    scale = (d_w * d_a)[0]
    top = lsfq_top_level(d_a, qm_a, t_a)[0]
    (i4, fa), launches["lsfq_fc1"] = run_path(
        dev, "lsfq_fc1",
        lambda: (int4_matmul(x_lv, w_packed, scale),
                 quant_matmul_fa(xa, w_packed, scale, None, d_a[0], t_a[0],
                                 top, act_pow=True)),
        {"int4_matmul": 1, "quant_matmul_fa": 1})
    path_check(rec, f"lsfq_fc1[{m}x{k}x{n}] int4_matmul", i4, float_out,
               1e-4)
    path_check(rec, f"lsfq_fc1[{m}x{k}x{n}] quant_matmul_fa", fa,
               float_out, 1e-4)

    # K13's kernel path (nothing in the JAX package calls it): q/k/v of
    # block 0 of the seed-0 artifacts, ViT-B/16 at batch 32 and ViT-H/14
    # at batch 1 and 8, the float output and the proj's int8 levels
    k13 = {}
    for tag, cfg_, art, plan, b, seed in (
            (f"k13_vitb_b{BATCH}", fwd["cfg"], fwd["art"], fwd["plan"], BATCH,
             0),
            *((f"k13_vith_b{bk}", vh["cfg"], vh["art"], vh["plan"], bk, 5)
              for bk in K13_VIT_H_BATCHES)):
        q, k, v, kw = block0_qkv(dev, cfg_, art, plan, b, seed)
        k13[tag] = (q, k, v, kw)
        proj_e = art["blocks"][0]["proj"]
        for quant in (False, True):
            qkw = dict(kw, out_d=proj_e.act["d"], out_t=proj_e.act["t"],
                       out_top=proj_e.top, out_pow=proj_e.act_pow) \
                if quant else kw
            ptag = tag + (":int8" if quant else "")
            got, launches[ptag] = run_path(
                dev, ptag, lambda qkw=qkw: flash_attention(q, k, v, **qkw),
                {"flash_attention": 1})
            path_check(rec, f"{ptag} [{'x'.join(map(str, q.shape))}]", got,
                       flash_attention_plain(q, k, v, **qkw),
                       levels=quant)
    record["paths"] = {"checks": rec, "launches": launches}
    return {"launches": launches, "k13": k13}


def block0_qkv(dev, cfg, art, plan, b, seed):
    """q, k, v [b, H, N, hd] (bf16) of block 0 on ``b`` seeded
    host-patchified images: the embedded tokens (K1 + K4) through K1 with
    the LayerNorm + quant prologue (the chain's qkv launch), split and
    permuted; with K13's keywords (scale, n_valid, bf16 out)."""
    from quantized_vit_tpu_torch.ops import run_matmul
    from quantized_vit_tpu_torch.serve.vit_int4 import (_embed_kernels,
                                                        _embed_tokens,
                                                        _qmatmul)

    n_real = cfg.num_tokens
    n_pad = -(-n_real // 16) * 16
    d, heads = cfg.embed_dim, cfg.num_heads
    hd = d // heads
    kp = cfg.patch_size**2 * cfg.in_channels
    xp = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, cfg.num_patches, kp)).astype(np.float32)).to(dev)
    bf16 = torch.bfloat16
    blk = art["blocks"][0]
    if plan is not None:
        x2d = _embed_kernels(plan.embed, plan.cls_row,
                             xp.reshape(b * cfg.num_patches, kp), b, cfg, d,
                             n_pad, bf16, "patches")
        qkv = run_matmul(plan.chain[0][0], x2d, out_dtype=bf16)
    else:
        x2d = _embed_tokens(art, xp, cfg, bf16, "patches", n_pad)
        qkv = _qmatmul(x2d, blk["qkv"], bf16, prologue="ln_quant",
                       ln_scale=blk["norm1"]["scale"],
                       ln_bias=blk["norm1"]["bias"])
    q, k, v = qkv.reshape(b, n_pad, 3, heads, hd).permute(
        2, 0, 3, 1, 4).contiguous()
    return q, k, v, dict(sm_scale=hd**-0.5, n_valid=n_real, out_dtype=bf16)


# ---------------------------------------------------------------------------
# phase 3c: FSDP serving, the forward with in-kernel weight gathers
# ---------------------------------------------------------------------------


def vit_b_block_weights(cfg, kind, seed, dev):
    """One block's four weights as the FSDP forward gathers them (qkv
    [D, 3D], proj [D, D], fc1 [D, hid], fc2 [hid, D]): int8 levels,
    packed int4 bytes ([K/2, N]) or bf16 values (the int8 shapes)."""
    d, hid = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    shp = [(d, 3 * d), (d, d), (d, hid), (hid, d)]
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(dev, torch.bfloat16) for s in shp]
    if kind == "int4":
        shp = [(k // 2, n) for k, n in shp]
    return [torch.from_numpy(rng.integers(-128, 128, s).astype(np.int8))
            .to(dev) for s in shp]


def _rows_of(t, rank, tp):
    r = t.shape[0] // tp
    return t[rank * r:(rank + 1) * r].contiguous()


_BLOCK_NAMES = ("qkv", "proj", "fc1", "fc2")


def gather_kinds(cfg, cfg_h):
    """K14's parity cases, (width config, kind): ViT-B/16's block weights
    as int8, packed int4 and bf16 bytes, ViT-H/14's as int8, and the
    unaligned shards."""
    return [(cfg, k) for k in ("int8", "int4", "bf16")] + [
        (cfg_h, "int8"), (cfg, "odd")]


# K14's unaligned case: (rows, cols) of int8 shards a process holds, each
# a view at a byte offset into its buffer (a zero-byte job among them),
# and the outputs' offsets: congruent with the source modulo 16 or not
# (the kernel's byte-by-byte path for both)
ODD_SHARDS = ((32, 77), (64, 13), (0, 40))
ODD_SRC_OFF = (3, 9, 0)
ODD_OUT_OFF = (3, 0, 5)


def _at_offset(t, off):
    """``t``'s bytes in a fresh buffer at byte offset ``off`` (a
    contiguous view whose address is ``off`` past 16-byte alignment)."""
    nb = t.numel() * t.element_size()
    buf = torch.zeros(nb + off + 16, dtype=torch.uint8, device=t.device)
    v = buf[off:off + nb].view(t.dtype).view(t.shape)
    v.copy_(t)
    return v


def gather_case(dev, peers, cfg, kind, seed):
    """K14 (``gather_rows``) of this process's row shards, each result
    against the full weight, the shards concatenated in rank order, byte
    for byte: one block's four weights at ``cfg``'s width
    (:func:`vit_b_block_weights`) as int8, packed int4 or bf16 bytes
    (``kind``), or ``kind="odd"``: int8 shards at byte offsets gathered
    into outputs at byte offsets (:data:`ODD_SHARDS`; the plan and launch
    entry points, which take the outputs)."""
    from quantized_vit_tpu_torch.ops import (gather_rows, plan_gather_rows,
                                             run_gather_rows)

    rank, tp = (0, 1) if peers is None else (peers.rank, peers.tp)
    if kind == "odd":
        rng = np.random.default_rng(seed)
        full = [torch.from_numpy(rng.integers(-128, 128, (r * tp, c))
                                 .astype(np.int8)).to(dev)
                for r, c in ODD_SHARDS]
        shards = [_at_offset(_rows_of(f, rank, tp), o)
                  for f, o in zip(full, ODD_SRC_OFF)]
        outs = [_at_offset(torch.zeros_like(f), o)
                for f, o in zip(full, ODD_OUT_OFF)]
        if dev.type == "cuda":
            got = run_gather_rows(plan_gather_rows(shards, outs, peers))
        else:
            got = gather_rows(shards, peers=peers)
        names = [f"odd{j}" for j in range(len(full))]
    else:
        full = vit_b_block_weights(cfg, kind, seed, dev)
        got = gather_rows([_rows_of(f, rank, tp) for f in full], peers=peers)
        names = _BLOCK_NAMES
    return [parity_row(
        "gather_rows", f"block.{nm}[{'x'.join(map(str, f.shape))}]({kind},"
        f"d{cfg.embed_dim},tp={tp},rank={rank})", "exact", raw_bytes(g),
        raw_bytes(f)) for nm, g, f in zip(names, got, full)]


def mlp_gather_case(dev, peers, cfg, m, seed, pow_=False,
                    stream=torch.bfloat16):
    """K15 (``fused_mlp_gather``) on ``m`` seeded rows of ``cfg``'s width
    with this process's shards of one block's int8 weights: the MLP
    against ``fused_mlp_plain``, each gathered weight against the full
    one, byte for byte. Rows' cases start with "(tp=..)"."""
    from quantized_vit_tpu_torch.ops import fused_mlp_gather, fused_mlp_plain

    rank, tp = (0, 1) if peers is None else (peers.rank, peers.tp)
    d, hid = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    rng = np.random.default_rng(seed)
    f32 = torch.float32

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x.to(dt) if dt else x

    def scal(v):
        return torch.full((), v, dtype=f32, device=dev)

    x = t(rng.standard_normal((m, d)) * 0.5, stream)
    w1 = t(rng.integers(-7, 8, (d, hid)).astype(np.int8))
    w2 = t(rng.integers(-7, 8, (hid, d)).astype(np.int8))
    args = (x, w1, scal(1e-3), t(rng.standard_normal(hid) * 0.01, f32), w2,
            scal(1e-3), t(rng.standard_normal(d) * 0.01, f32))
    kw = dict(ln_scale=t(rng.standard_normal(d) * 0.1 + 1, f32),
              ln_bias=t(rng.standard_normal(d) * 0.01, f32),
              act_d=scal(0.05), act_t=scal(1.08 if pow_ else 1.0),
              act_top=127, act_pow=pow_, hid_d=scal(0.05),
              hid_t=scal(0.93 if pow_ else 1.0), hid_top=127, hid_pow=pow_,
              fmt="int8", out_dtype=stream)
    full = vit_b_block_weights(cfg, "int8", seed + 1, dev)
    y, gath = fused_mlp_gather(
        *args, next_shards=[_rows_of(f, rank, tp) for f in full],
        peers=peers, **kw)
    tag = f"(tp={tp},rank={rank})"
    return [parity_row("fused_mlp_gather", tag, "mlp", y,
                       fused_mlp_plain(*args, **kw))] + [
        parity_row("fused_mlp_gather", f"{tag}:gather.{nm}", "exact",
                   raw_bytes(g), raw_bytes(f))
        for nm, g, f in zip(_BLOCK_NAMES, gath, full)]


def fsdp_rank(peers, cfg, x_np, iters):
    """This process's FSDP forward of ``x_np`` (host-patchified, the whole
    batch) on its shard of the seed-0 int8-stored artifact (bf16
    residual stream): the logits, the launches of one forward (counters
    set to 0 just before, read just after), and the host time of
    ``iters`` forwards, each started after a host barrier and ended by a
    synchronize."""
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import (prepare_fsdp_rdma_kernels,
                                               random_vit_int4_artifact,
                                               shard_fsdp_rdma_artifact,
                                               vit_int4_forward_fsdp_rdma)

    dev = peers.device
    cuda = dev.type == "cuda"
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=False,
                                   device=dev)
    fart = shard_fsdp_rdma_artifact(art, peers.rank, peers.tp)
    del art
    x = torch.from_numpy(x_np).to(dev)
    plan = prepare_fsdp_rdma_kernels(fart, cfg, peers) if cuda else None

    def fwd():
        return vit_int4_forward_fsdp_rdma(
            fart, x, cfg, peers, float_dtype=torch.bfloat16,
            images_layout="patches", plan=plan)

    def done():
        if cuda:
            torch.cuda.synchronize(dev)

    peers.barrier()
    _build.reset_launches()
    logits = fwd()
    done()
    launches = dict(_build.LAUNCHES)
    ms = []
    for _ in range(iters):
        peers.barrier()
        t0 = time.perf_counter()
        fwd()
        done()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"logits": logits.float().cpu().numpy(), "launches": launches,
            "ms": ms, "shard_bytes": sum(
                b[k].w.numel() * b[k].w.element_size()
                for b in fart["blocks"] for k in _BLOCK_NAMES)}


def spawned_worker(rank, tp, init_method, dev, cfg_kw, cases):
    """One of tp processes sharing the card (``run_processes``): the gloo
    group, then each case, in order on every process: ("gather", kind,
    seed, cfg_kw), ("mlp_gather", name, m, seed, cfg_kw) (None: the main
    config) or ("fsdp", key, x, iters, cfg_kw). Returns the parity rows
    and each FSDP forward's result under its key."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    peers = initialize_distributed(init_method, tp, rank, device=dev)
    cfg = ViTConfig(**cfg_kw)
    out = {"rows": []}
    try:
        for case in cases:
            if case[0] == "gather":
                kind, seed, gkw = case[1:]
                out["rows"] += gather_case(peers.device, peers,
                                           ViTConfig(**gkw), kind, seed)
            elif case[0] == "mlp_gather":
                name, m, seed, ckw = case[1:]
                ccfg = cfg if ckw is None else ViTConfig(**ckw)
                out["rows"] += [dict(r, case=name + r["case"]) for r in
                                mlp_gather_case(peers.device, peers, ccfg,
                                                m, seed)]
            else:
                key, x_np, iters, fcfg = case[1:]
                out[key] = fsdp_rank(peers, ViTConfig(**fcfg), x_np, iters)
    finally:
        peers.close()
    return out


def fsdp_phase(dev, record, parity, fwd):
    """The FSDP forward of serve/vit_fsdp.py on the main path's artifact
    (seed 0, int8-stored levels, bf16 residual stream) and batch, and on
    ViT-H/14's (vit_h_phase's, full depth, batch 32), each run with the
    launch counters set to 0 just before and read just after, logits
    against ``vit_int4_forward`` on the same artifact and images, bit for
    bit: at tp = 1 in this process (K1, K4, K14 once, then per block K3 +
    K1 proj and K15), and at FSDP_TP as spawned processes sharing the
    card (ViT-H/14 at depth VIT_H_FSDP_TP_DEPTH), the batch split over
    them. The same spawned groups (every tp of GATHER_TPS above 1) hold
    K14 and K15 against the full weights and ``fused_mlp_plain``, K15 at
    ViT-B/16's and ViT-H/14's widths; their rows join phase 2's."""
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.parallel import run_processes
    from quantized_vit_tpu_torch.serve import (prepare_fsdp_rdma_kernels,
                                               prepare_kernels,
                                               random_vit_int4_artifact,
                                               shard_fsdp_rdma_artifact,
                                               vit_int4_forward,
                                               vit_int4_forward_fsdp_rdma)

    cuda = dev.type == "cuda"
    cfg, art, x = fwd["cfg"], fwd["art"], fwd["x"]
    _, _, d, _, n_pad, _, _, _, _ = shapes(cfg)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    ref = vit_int4_forward(art, x, cfg, plan=fwd["plan"], **kw)
    sync()
    t0 = time.perf_counter()
    fart = shard_fsdp_rdma_artifact(art, 0, 1)
    fplan = prepare_fsdp_rdma_kernels(fart, cfg) if cuda else None
    sync()
    rec = {"prepare_host_ms": (time.perf_counter() - t0) * 1e3}
    want = expected_launches(cfg.depth, "fsdp")
    launches = {"fsdp_tp1": check_forward(
        record, dev, "fsdp_rdma,tp=1,int8-stored",
        lambda: vit_int4_forward_fsdp_rdma(fart, x, cfg, plan=fplan, **kw),
        lambda: ref, want, BATCH, cfg)}
    if not record["forward"][-1]["logits_equal"]:
        raise Failed("FSDP forward at tp=1: logits differ from "
                     "vit_int4_forward's")
    # ViT-H/14 at tp = 1 on vit_h_phase's artifact: K15 at K = 1280 (the
    # first K15 refused it), logits against the single-device forward's
    # (K3 + K1 proj + the K1 fc1/fc2 chain: the same bits as K2's)
    vh = fwd["vit_h"]
    cfg_h, xh = vh["cfg"], vh["x"]
    ref_h = vit_int4_forward(vh["art"], xh, cfg_h, plan=vh["plan"], **kw)
    sync()
    t0 = time.perf_counter()
    fart_h = shard_fsdp_rdma_artifact(vh["art"], 0, 1)
    fplan_h = prepare_fsdp_rdma_kernels(fart_h, cfg_h) if cuda else None
    sync()
    rec["vith_prepare_host_ms"] = (time.perf_counter() - t0) * 1e3
    launches["fsdp_vith_tp1"] = check_forward(
        record, dev, "fsdp_rdma_vith14,tp=1,int8-stored",
        lambda: vit_int4_forward_fsdp_rdma(fart_h, xh, cfg_h, plan=fplan_h,
                                           **kw),
        lambda: ref_h, expected_launches(cfg_h.depth, "fsdp"),
        xh.shape[0], cfg_h)
    if not record["forward"][-1]["logits_equal"]:
        raise Failed("ViT-H/14 FSDP forward at tp=1: logits differ from "
                     "vit_int4_forward's")
    # the depth-cut ViT-H/14 of the spawned forward, and its reference
    hkw = dict(VIT_H_KW, depth=min(VIT_H_KW["depth"], VIT_H_FSDP_TP_DEPTH))
    cfg_hc = ViTConfig(**hkw)
    art_hc = random_vit_int4_artifact(cfg_hc, seed=0, pack_weights=False,
                                      device=dev)
    ref_hc = vit_int4_forward(
        art_hc, xh, cfg_hc,
        plan=prepare_kernels(art_hc, cfg_hc) if cuda else None, **kw)
    del art_hc
    forwards = {"fsdp": (ref, want, CFG_KW, x),
                "fsdp_vith": (ref_hc, expected_launches(cfg_hc.depth,
                                                        "fsdp"), hkw, xh)}
    rows = []
    for tp in sorted(set(GATHER_TPS + (FSDP_TP,)) - {1}):
        cases = [("gather", k, 900, dataclasses.asdict(c))
                 for c, k in gather_kinds(cfg, cfg_h)]
        # K15 at a process's rows of the batch-32 forwards
        m, m_h = BATCH // tp * n_pad, xh.shape[0] // tp * vit_h_shapes(
            cfg_h)[3]
        cases += [("mlp_gather", f"main[{m}x{d}]", m, 910, None),
                  ("mlp_gather", f"vith[{m_h}x{cfg_h.embed_dim}]", m_h, 916,
                   dict(VIT_H_KW))]
        if tp == FSDP_TP:
            cases += [("mlp_gather", f"ragged[{mr}x{d}]", mr, 911 + i, None)
                      for i, mr in enumerate(K15_RAGGED_M)]
            cases += [("fsdp", key, xf.cpu().numpy(), FSDP_TP_ITERS,
                       dict(fkw)) for key, (_, _, fkw, xf) in
                      forwards.items()]
        t0 = time.time()
        try:
            res = run_processes(spawned_worker, tp,
                                os.path.join(OUT_DIR, "dist"),
                                args=(DEV, dict(CFG_KW), cases),
                                timeout_s=SPAWN_TIMEOUT_S)
        except RuntimeError as e:
            raise Failed(f"spawned processes at tp={tp}: {e}")
        rec[f"spawn_tp{tp}_s"] = round(time.time() - t0, 1)
        for r in res:
            rows += r["rows"]
        if tp != FSDP_TP:
            continue
        for key, (ref_k, want_k, _, _) in forwards.items():
            fs = [r[key] for r in res]
            got = torch.from_numpy(np.concatenate([f["logits"]
                                                   for f in fs]))
            equal = bool(torch.equal(got, ref_k.float().cpu()))
            tag = f"{key[5:] + '_' if key != 'fsdp' else ''}tp{tp}"
            rec[tag] = {
                "logits_equal": equal,
                "max_abs_diff": float((got - ref_k.float().cpu()).abs()
                                      .max()),
                "launches_per_rank": [f["launches"] for f in fs],
                "shard_bytes_per_rank": [f["shard_bytes"] for f in fs],
                # host time, barrier to synchronize: two time-sliced
                # contexts on one card, not a scaling number
                "wall_ms_per_rank": [statistics.median(f["ms"])
                                     for f in fs]}
            launches[f"{key}_tp{tp}"] = fs[0]["launches"]
            used = [{k: v for k, v in f["launches"].items() if v}
                    for f in fs]
            log(f"[{key} tp={tp}] logits equal {equal}, launches {used}"
                f", wall {rec[tag]['wall_ms_per_rank']} ms "
                f"({rec[f'spawn_tp{tp}_s']} s spawned)")
            if not equal:
                raise Failed(f"{key} forward at tp={tp}: logits differ from "
                             f"vit_int4_forward's by {rec[tag]}")
            if cuda and any(f["launches"] != want_k for f in fs):
                raise Failed(f"{key} forward at tp={tp}: launches "
                             f"{[f['launches'] for f in fs]} != {want_k}")
    rec["vith_tp_depth"] = cfg_hc.depth
    for row in rows:
        parity.add(row)
    bad = [r for r in rows if not r["ok"]]
    log(f"[fsdp] {len(rows) - len(bad)}/{len(rows)} spawned parity rows "
        f"pass, {sum(r['bit_exact'] for r in rows)} bit-exact")
    if bad:
        raise Failed("spawned parity: " + "; ".join(
            f"{r['kernel']} {r['case']}: max {r['max_abs_err']}"
            for r in bad[:8]))
    record["fsdp"] = rec
    return {"launches": launches, "fart": fart, "plan": fplan,
            "fart_h": fart_h, "plan_h": fplan_h}


# ---------------------------------------------------------------------------
# phase 3d: the root tools' timing ablations (K16-K21)
# ---------------------------------------------------------------------------

# tool: (its source, the TPU kernel it replaces, the mode its row in the
# kernels line reports)
ABLATIONS = {
    "exp_pro": ("fc1_ablation.cu", "tools/exp_pro.py:99", "ln_quant"),
    "exp_pro2": ("fc1_ablation.cu", "tools/exp_pro2.py:146", "folded"),
    "exp_attn": ("attn_ablation.cu", "tools/exp_attn.py:111", "full"),
    "exp_attn2": ("attn_ablation.cu", "tools/exp_attn2.py:64", "1"),
    "exp_epilogue": ("fc1_ablation.cu", "tools/exp_epilogue.py:103",
                     "gelu10"),
    "exp_fc1": ("fc1_ablation.cu", "tools/exp_fc1.py:106", "gelu_erf"),
}
# a tool's shape when not the root tool's (a CPU rehearsal cuts them)
ABLATION_SHAPES: dict = {}
# K18 (exp_attn) beyond the tool's shape, on the card: (images, queries,
# keys, heads, head_dim, x's scale): bf16 K/V rows past 208 keys, heads of
# 8-40, ragged query tiles, one key, scores of a wider range
EXP_ATTN_EDGES = ((2, 256, 256, 3, 64, 0.1), (2, 300, 216, 2, 64, 0.1),
                  (1, 250, 250, 2, 64, 1.0), (3, 37, 37, 2, 8, 0.1),
                  (2, 100, 90, 3, 40, 0.1), (2, 224, 208, 2, 64, 1.0),
                  (2, 17, 1, 1, 16, 0.1))
# K19 (exp_attn2) beyond the tool's shape, on the card: (images, tokens,
# n_valid, heads, head_dim, x's scale, J, qkv's offset in elements into
# its storage): keys past the ring's 224 (the keys streamed again a round
# of tiles), a key count off the 8-key chunk and ragged query tiles, heads
# of 8 and 40, one key, no key at all (no TMA map encoded), no mask,
# scores past the clamp at 100 (p up to 2^100: f64 sums no longer exact,
# the levels contract), a qkv that is not 16-byte aligned (the wrapper's
# copy)
EXP_ATTN2_EDGES = ((2, 300, 290, 2, 64, 0.1, 1, 0),
                   (2, 250, 233, 3, 64, 0.1, 2, 0),
                   (4, 37, 37, 2, 8, 0.1, 4, 0),
                   (2, 100, 90, 3, 40, 0.1, 1, 0),
                   (2, 17, 1, 1, 16, 0.1, 2, 0), (2, 20, 0, 1, 8, 0.1, 1, 0),
                   (2, 64, 64, 2, 64, 0.1, 1, 0),
                   (2, 224, 197, 2, 64, 8.0, 1, 0),
                   (4, 520, 515, 2, 64, 0.1, 4, 0),
                   (2, 224, 197, 3, 64, 0.1, 2, 1))


# K17 (exp_pro2) and K16 (exp_pro) beyond the tools' shape, on the card:
# (tool, mode, M, K, N, x's scale, random g and b): M off the 112-token
# panel (1000) and under one (17), N = 1540 (a multiple of 4, not of 8),
# K = 80 (under one 128-level step) and 1280 (ViT-H/14's width), K = 3072
# (a panel held a window of steps at a time), g ~ N(0, 16) and b ~ N(0, 4)
# (levels clipped and not), the bias and folded modes, K16's quant
EXP_PRO2_EDGES = (("exp_pro2", "lean", 1000, 768, 3072, 2.0, False),
                  ("exp_pro2", "lean", 17, 768, 3072, 2.0, False),
                  ("exp_pro2", "bias", 1000, 768, 1540, 2.0, True),
                  ("exp_pro2", "vscale", 300, 80, 3072, 1.0, True),
                  ("exp_pro2", "folded", 1040, 1280, 5120, 1.0, True),
                  ("exp_pro2", "bias", 2000, 768, 3072, 1.0, True),
                  ("exp_pro2", "folded", 1000, 1280, 1540, 1.0, True),
                  ("exp_pro2", "lean", 300, 3072, 768, 1.0, True),
                  ("exp_pro2", "bias", 500, 2048, 1540, 1.0, True),
                  ("exp_pro", "quant", 1000, 768, 1540, 4.0, False),
                  ("exp_pro", "ln_quant", 17, 80, 64, 1.0, True))


def ablations_phase(dev, record, parity):
    """Phase 3d: every mode of the six ablation tools
    (``quantized_vit_tpu_torch/tools/exp_*.py``) at the root tools'
    shapes and seeds. A tool's path is its modes' wrappers, one call
    each, with the launch counters set to 0 just before and read just
    after (one launch a mode); then each mode's kernel against its plain
    version (a parity row), then the tool's own timings
    (``tools/_ablation.py``: the launch by events and by device time, the
    plain version, the bound) and its yardstick; on the card, K18 at
    :data:`EXP_ATTN_EDGES` (:func:`exp_attn_edges`), K19 at
    :data:`EXP_ATTN2_EDGES` (:func:`exp_attn2_edges`) and K17 and K16 at
    :data:`EXP_PRO2_EDGES` (:func:`exp_pro2_edges`).
    """
    import importlib

    from quantized_vit_tpu_torch.tools import _ablation

    t0 = time.time()
    out = {}
    for tool in ABLATIONS:
        mod = importlib.import_module(f"quantized_vit_tpu_torch.tools.{tool}")
        t = mod.build(dev, mod.MODES, ABLATION_SHAPES.get(tool))
        _, launches = run_path(dev, f"ablations_{tool}",
                               lambda: [m.call() for m in t.modes],
                               {tool: len(t.modes)})
        modes = {}
        for m in t.modes:
            r = _ablation.check(m)
            parity.add({"kernel": tool, "case": m.mode,
                        "check": r["contract"],
                        "max_abs_err": float(r["max_abs_err"]),
                        "share_differ": r["share_differ"],
                        "bit_exact": r["bit_exact"], "ok": r["ok"]})
            modes[m.mode] = dict(r, **_ablation.measure(m))
        y = _ablation.measure_yard(t) or {}
        exact = sum(v["bit_exact"] for v in modes.values())
        out[tool] = {"launches": launches[tool], "modes": modes,
                     "bit_exact_modes": exact,
                     "yardstick": t.yard_name,
                     "yardstick_us": y.get("us"),
                     "yardstick_device_us": y.get("device_us")}
        log(f"[ablations {tool}] " + "; ".join(
            f"{k} {v['us']:.1f} us (max {v['max_abs_err']})"
            for k, v in modes.items()) + f"; {t.yard_name} "
            + ("n/a" if not y else f"{y['us']:.1f} us")
            + f"; {exact} of {len(modes)} modes bit-exact")
    if dev.type == "cuda":
        out["exp_attn_edges"] = exp_attn_edges(dev, parity)
        out["exp_attn2_edges"] = exp_attn2_edges(dev, parity)
        out["exp_pro2_edges"] = exp_pro2_edges(dev, parity)
    bad = [f for f in parity.failures if f.split(" ")[0] in ABLATIONS]
    if bad:
        raise Failed("ablation parity: " + "; ".join(bad[:8]))
    out["phase_s"] = round(time.time() - t0, 1)
    record["ablations"] = out
    log(f"[ablations] phase {out['phase_s']} s")
    return out


def exp_attn_edges(dev, parity):
    """K18 at :data:`EXP_ATTN_EDGES`, every mode against exp_attn_plain
    on seeded x (the tool's levels contract), a parity row each; returns
    (rows, bit-exact rows). Launched outside any path's count."""
    from quantized_vit_tpu_torch.ops import ablations as ab
    from quantized_vit_tpu_torch.tools import _ablation

    rows = exact = 0
    for b, nq, nk, h, hd, scale in EXP_ATTN_EDGES:
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (b, nq, 3 * h * hd)) * scale).to(torch.bfloat16).to(dev)
        kw = dict(heads=h, n_keys=nk)
        rows_dt = "f64" if nk <= ab.ATTN_F64_KEYS else "bf16"
        for mode in ab.EXP_ATTN_MODES:
            call = lambda mode=mode: ab.exp_attn(x, mode, **kw)
            r = _ablation.check(_ablation.Mode(
                mode, call, call,
                lambda mode=mode: ab.exp_attn_plain(x, mode, **kw),
                bytes=0, ops=0, kind="bf16", levels=True))
            parity.add({"kernel": "exp_attn",
                        "case": f"{mode} b{b} n{nq} keys{nk} h{h}x{hd} "
                                f"x{scale} ({rows_dt} rows)",
                        "check": r["contract"],
                        "max_abs_err": float(r["max_abs_err"]),
                        "share_differ": r["share_differ"],
                        "bit_exact": r["bit_exact"], "ok": r["ok"]})
            rows += 1
            exact += r["bit_exact"]
    log(f"[ablations exp_attn edges] {exact} of {rows} bit-exact")
    return {"rows": rows, "bit_exact": exact}


def exp_attn2_edges(dev, parity):
    """K19 at :data:`EXP_ATTN2_EDGES`, each row's J against
    exp_attn2_plain on seeded qkv (the tool's levels contract), a parity
    row each; returns (rows, bit-exact rows). Launched outside any path's
    count."""
    from quantized_vit_tpu_torch.ops import ablations as ab
    from quantized_vit_tpu_torch.tools import _ablation

    rows = exact = 0
    for b, n, nv, h, hd, scale, j, off in EXP_ATTN2_EDGES:
        shape = (b, n, 3 * h * hd)
        src = torch.from_numpy(np.random.default_rng(1).standard_normal(
            shape) * scale).to(torch.bfloat16).to(dev)
        x = torch.empty(src.numel() + off, dtype=torch.bfloat16,
                        device=dev)[off:].view(shape)
        x.copy_(src)
        kw = dict(heads=h, n_valid=nv)
        call = lambda: ab.exp_attn2(x, 0.05, j_imgs=j, **kw)
        r = _ablation.check(_ablation.Mode(
            str(j), call, call, lambda: ab.exp_attn2_plain(x, 0.05, **kw),
            bytes=0, ops=0, kind="bf16", levels=True))
        parity.add({"kernel": "exp_attn2",
                    "case": f"J {j} b{b} n{n} valid{nv} h{h}x{hd} x{scale}"
                            f" offset {off}",
                    "check": r["contract"],
                    "max_abs_err": float(r["max_abs_err"]),
                    "share_differ": r["share_differ"],
                    "bit_exact": r["bit_exact"], "ok": r["ok"]})
        rows += 1
        exact += r["bit_exact"]
    log(f"[ablations exp_attn2 edges] {exact} of {rows} bit-exact")
    return {"rows": rows, "bit_exact": exact}


def exp_pro2_edges(dev, parity):
    """K17 and K16 at :data:`EXP_PRO2_EDGES`, each row's mode through its
    wrapper against fc1_ablation_plain on seeded inputs (bit-exact), a
    parity row each; returns (rows, bit-exact rows). Launched outside any
    path's count."""
    from quantized_vit_tpu_torch.ops import ablations as ab
    from quantized_vit_tpu_torch.tools import _ablation

    rows = exact = 0
    for tool, mode, m, k, n, scale, rand_gb in EXP_PRO2_EDGES:
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal((m, k)) * scale).to(
            torch.bfloat16).to(dev)
        w = torch.from_numpy(rng.integers(-16, 17, (k, n)).astype(
            np.int8)).to(dev)
        if rand_gb:
            g = rng.standard_normal(k) * 4.0
            b = rng.standard_normal(k) * 2.0
        else:
            g, b = np.full(k, 20.0), np.zeros(k)
        g, b = (torch.from_numpy(v.astype(np.float32)).to(dev)
                for v in (g, b))
        sc = torch.from_numpy((rng.uniform(0.5, 1.5, n) * 1e-3).astype(
            np.float32)).to(dev)
        bias = torch.from_numpy((rng.standard_normal(n) * 0.5).astype(
            np.float32)).to(dev)
        if tool == "exp_pro2":
            v = ab.EXP_PRO2_MODES[mode]
            call = lambda: ab.exp_pro2(x, w, g, b, mode, scale=sc, bias=bias)
            plain = lambda: ab.fc1_ablation_plain(
                x, w, v, ln_g=g, ln_b=b, scale=sc if v.vscale else ab.SCALE,
                bias=bias if v.bias else None)
        else:
            v = ab.EXP_PRO_MODES[mode]
            call = lambda: ab.exp_pro(x, w, g, b, mode)
            plain = lambda: ab.fc1_ablation_plain(x, w, v, ln_g=g, ln_b=b)
        r = _ablation.check(_ablation.Mode(mode, call, call, plain, bytes=0,
                                           ops=0, kind="int8"))
        parity.add({"kernel": tool,
                    "case": f"{mode} M{m} K{k} N{n} x{scale}"
                            f"{' random g, b' if rand_gb else ''}",
                    "check": r["contract"],
                    "max_abs_err": float(r["max_abs_err"]),
                    "share_differ": r["share_differ"],
                    "bit_exact": r["bit_exact"], "ok": r["ok"]})
        rows += 1
        exact += r["bit_exact"]
    log(f"[ablations exp_pro2 edges] {exact} of {rows} bit-exact")
    return {"rows": rows, "bit_exact": exact}


def ablation_kernel_rows(record, abl):
    """K16-K21's rows of the kernels line: each tool's reported mode (its
    time, plain time, bound, yardstick), its path's launches, the largest
    parity error over its modes, and every mode's time beside it."""
    rows = []
    for tool, (src, rep, shown) in ABLATIONS.items():
        r = abl[tool]
        m = r["modes"][shown]
        rows.append({
            "name": tool, "route": "cuda",
            "source": f"quantized_vit_tpu_torch/csrc/{src}",
            "replaces": rep, "launches": r["launches"],
            "path": f"ablations_{tool}", "mode": shown,
            "max_abs_err": max(v["max_abs_err"] for v in r["modes"].values()),
            "bit_exact": all(v["bit_exact"] for v in r["modes"].values()),
            "ms": m["us"] / 1e3, "device_ms": (
                None if m.get("device_us") is None
                else m["device_us"] / 1e3),
            "plain_ms": m["plain_us"] / 1e3, "bound_ms": m["bound_us"] / 1e3,
            "bound_by": m["bound_by"],
            "library_ms": (None if r["yardstick_us"] is None
                           else r["yardstick_us"] / 1e3),
            "library": r["yardstick"],
            "library_device_ms": (None if r["yardstick_device_us"] is None
                                  else r["yardstick_device_us"] / 1e3),
            "us_per_mode": {k: v["us"] for k, v in r["modes"].items()},
        })
    return rows


# ---------------------------------------------------------------------------
# phase 4: the serving CLI
# ---------------------------------------------------------------------------


def serve_phase(dev, record, fwd):
    """The serve CLI's forward behind a batcher: first a few requests one
    at a time and in pairs (buckets 1 and 2, the chain with K6), then the
    CLI's own burst of 64 requests at max batch 8. Every answer equals a
    direct forward of the same images."""
    from quantized_vit_tpu_torch.artifact import (load_vit_int4_artifact,
                                                  save_vit_int4_artifact)
    from quantized_vit_tpu_torch.cli import serve
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import (ContinuousBatcher,
                                               vit_int4_forward)
    from quantized_vit_tpu_torch.utils import patchify_batch

    art_dir = ART_DIR
    save_vit_int4_artifact(art_dir, fwd["art"], fwd["cfg"])
    art, cfg = load_vit_int4_artifact(art_dir, device=dev)

    def direct(images):
        x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
        return vit_int4_forward(art, x, cfg, float_dtype=serve.SERVE_DTYPE,
                                images_layout="patches").cpu().numpy()

    # small flushes: three single requests, then two pairs
    forward, _, _ = serve.build_forward(serve.parse_args(
        ["--artifact", art_dir, "--device", str(dev)]))
    imgs = serve.request_images(cfg, 7, False)
    batcher = ContinuousBatcher(forward, max_batch=8, max_delay_ms=5.0)
    batcher.warmup(imgs[0])
    _build.reset_launches()
    small_equal = True
    with batcher:
        for i in range(3):
            got = batcher.submit(imgs[i]).result(timeout=120)
            small_equal &= bool(np.array_equal(got, direct(imgs[i:i + 1])[0]))
        for i in (3, 5):
            futs = [batcher.submit(imgs[i]), batcher.submit(imgs[i + 1])]
            got = np.stack([f.result(timeout=120) for f in futs])
            small_equal &= bool(np.array_equal(got, direct(imgs[i:i + 2])))
    small = {"batch_hist": dict(batcher.stats["batch_hist"]),
             "launches": dict(_build.LAUNCHES),
             "answers_equal_direct": small_equal}
    log(f"[serve small flushes] buckets {small['batch_hist']} launches "
        f"{small['launches']} equal {small_equal}")

    t0 = time.time()
    res = serve.main(["--artifact", art_dir, "--requests", "64",
                      "--max-batch", "8", "--device", str(dev)])
    got = np.concatenate([direct(res["images"][i:i + 8])
                          for i in range(0, len(res["images"]), 8)])
    equal = bool(np.array_equal(res["answers"], got))
    summary = {k: v for k, v in res.items() if k not in ("images", "answers")}
    summary["answers_equal_direct"] = equal
    summary["max_abs_diff"] = float(np.abs(res["answers"] - got).max())
    summary["phase_s"] = round(time.time() - t0, 1)
    summary["small_flushes"] = small
    record["serve"] = summary
    log(f"[serve] {summary}")
    if not equal or summary["batches"] < 64 // 8:
        raise Failed(f"serve answers differ from direct forwards: {summary}")
    if not small_equal or not {1, 2} <= set(small["batch_hist"]):
        raise Failed(f"small flushes: {small}")
    if dev.type == "cuda" and small["launches"]["attention_qkv"] == 0:
        raise Failed("buckets 1 and 2 did not run attention_qkv (K6)")


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters=ITERS, warmup=3):
    """Median ms of ``iters`` timed runs (CUDA events), after warm-up; at
    least ``SHORT_ITERS`` runs when one run takes under 1 ms
    (``quantized_vit_tpu_torch/tools/_ablation.py:events_us``, which
    the ablation tools time with too)."""
    from quantized_vit_tpu_torch.tools._ablation import events_us

    if DEV != "cuda":  # CPU rehearsal: host clock, never a device number
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    return events_us(fn, iters, warmup, SHORT_ITERS) / 1e3


def int_mm_ms(shapes):
    """``torch._int_mm`` on the kernel's GEMM shapes, as one timed call
    sequence (a yardstick; the port never calls it). None if this card's
    PyTorch refuses a shape."""
    from quantized_vit_tpu_torch.tools._ablation import int_mm_yard

    try:
        return cuda_ms(int_mm_yard(shapes, DEV))
    except RuntimeError as e:
        log(f"  _int_mm yardstick unavailable: {e}")
        return None


def timing_phase(dev, record, fwd, peaks):
    from quantized_vit_tpu_torch.ops import (attention_heads,
                                             attention_heads_plain,
                                             attention_qkv,
                                             attention_qkv_plain,
                                             fused_mlp, fused_mlp_plain,
                                             fused_quant_matmul,
                                             fused_quant_matmul_plain,
                                             patch_finalize,
                                             patch_finalize_plain,
                                             run_attention_block,
                                             run_attention_heads,
                                             run_attention_qkv,
                                             run_block_stack, run_matmul,
                                             run_mlp, run_mlp_chunked,
                                             vit_block_stack_plain)
    from quantized_vit_tpu_torch.serve import (vit_int4_forward,
                                               vit_int4_forward_fsdp_rdma,
                                               vit_int4_forward_latency)
    from quantized_vit_tpu_torch.serve.vit_int4 import _chain_attention

    int8_peak, bf16_peak, bw, fp64_peak = peaks
    cfg, art, x = fwd["cfg"], fwd["art"], fwd["x"]
    b, p, d, n_real, n_pad, kp, hid, ncls, heads = shapes(cfg)
    hd = d // heads
    m = b * n_pad
    nk = -(-n_real // 16) * 16  # key rows of the bf16 attention
    blk = art["blocks"][0]
    qkv_e, proj_e, fc1_e, fc2_e = (blk[k] for k in ("qkv", "proj", "fc1",
                                                    "fc2"))
    bf16 = torch.bfloat16

    def bound(bytes_, int8_ops=0.0, bf16_ops=0.0):
        t_ops = int8_ops / int8_peak + bf16_ops / bf16_peak
        t_mem = bytes_ / bw
        return max(t_ops, t_mem) * 1e3, ("bytes" if t_mem >= t_ops
                                         else "operations")

    g = torch.Generator(device=DEV).manual_seed(0)
    xs = torch.randn((m, d), generator=g, device=DEV).to(bf16)
    x3 = xs.reshape(b, n_pad, d)
    xpatch = x.reshape(b * p, kp)
    xhead = torch.randn((b, d), generator=g, device=DEV)
    alv = torch.randint(-7, 8, (m, d), dtype=torch.int8, device=DEV,
                        generator=g)
    acc = torch.randn((b, p, d), generator=g, device=DEV) * 300
    pos = torch.randn((p, d), generator=g, device=DEV) * 0.02
    cls = torch.randn((d,), generator=g, device=DEV) * 0.02
    one = torch.ones((), device=DEV)
    # K6's input: the chain's qkv tensor at batch 2 (and batch 32)
    qkv2 = (torch.randn((2, n_pad, 3 * d), generator=g, device=DEV)
            * 0.7).to(bf16)
    qkv32 = (torch.randn((b, n_pad, 3 * d), generator=g, device=DEV)
             * 0.7).to(bf16)
    qkv1 = qkv2[:1]  # the chain at batch 1
    pe = art["patch_embed"]

    def q(e):
        return dict(act_d=e.act["d"], act_t=e.act["t"], act_top=e.top,
                    act_pow=e.act_pow)

    he = art["head"]
    mlp_kw = dict(ln_scale=blk["norm2"]["scale"], ln_bias=blk["norm2"]["bias"],
                  act_d=fc1_e.act["d"], act_t=fc1_e.act["t"],
                  act_top=fc1_e.top, act_pow=fc1_e.act_pow,
                  hid_d=fc2_e.act["d"], hid_t=fc2_e.act["t"],
                  hid_top=fc2_e.top, hid_pow=fc2_e.act_pow, fmt=fc1_e.fmt,
                  fmt2=fc2_e.fmt, out_dtype=bf16)
    attn_kw = dict(ln_scale=blk["norm1"]["scale"],
                   ln_bias=blk["norm1"]["bias"], heads=heads,
                   sm_scale=hd**-0.5, n_valid=n_real, act_d=qkv_e.act["d"],
                   act_t=qkv_e.act["t"], act_top=qkv_e.top,
                   act_pow=qkv_e.act_pow, out_d=proj_e.act["d"],
                   out_t=proj_e.act["t"], out_top=proj_e.top,
                   out_pow=proj_e.act_pow, fmt=qkv_e.fmt, out_dtype=bf16)
    qkv_kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=n_real,
                  out_d=proj_e.act["d"], out_t=proj_e.act["t"],
                  out_top=proj_e.top, out_pow=proj_e.act_pow, out_dtype=bf16)
    lat, meta = fwd["lat"], fwd["meta"]
    stack = lat["stack"]
    x1 = xs[:n_pad]
    x2 = xs[:2 * n_pad]  # the chain at batch 2
    # each site: (kernel call as the main path makes it, plain version).
    # On the card the kernel call is the launch on the forward's prepared
    # plan (run_*); the CPU rehearsal has no plan and calls the wrapper.
    plain = {
        "patch_embed": lambda: fused_quant_matmul_plain(
            xpatch, pe.w, pe.scale, pe.bias, fmt=pe.fmt, prologue="quant",
            out_dtype=torch.float32, **q(pe)),
        "attn_proj": lambda: fused_quant_matmul_plain(
            alv, proj_e.w, proj_e.scale, proj_e.bias, fmt=proj_e.fmt,
            prologue=None, epilogue="residual", residual=xs, out_dtype=bf16),
        "head": lambda: fused_quant_matmul_plain(
            xhead, he.w, he.scale, he.bias, fmt=he.fmt, prologue="quant",
            out_dtype=torch.float32, **q(he)),
        "mlp": lambda: fused_mlp_plain(
            xs, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
            fc2_e.bias, **mlp_kw),
        "heads": lambda: attention_heads_plain(
            x3, qkv_e.w, qkv_e.scale, qkv_e.bias, **attn_kw),
        "embed": lambda: patch_finalize_plain(acc, pos, cls, one, n_pad=n_pad,
                                              out_dtype=bf16),
        "qkv_attn_b2": lambda: attention_qkv_plain(qkv2, **qkv_kw),
        "qkv_attn_b1": lambda: attention_qkv_plain(qkv1, **qkv_kw),
        "qkv_attn_b32": lambda: attention_qkv_plain(qkv32, **qkv_kw),
        "qkv_attn_int_b2": lambda: attention_qkv_plain(
            qkv2, int_attention=True, **qkv_kw),
        "qkv_attn_int_b32": lambda: attention_qkv_plain(
            qkv32, int_attention=True, **qkv_kw),
        "stack_b1": lambda: vit_block_stack_plain(stack, x1, n_valid=n_real,
                                                  out_dtype=bf16),
        "chain_qkv_b2": lambda: fused_quant_matmul_plain(
            x2, qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
            prologue="ln_quant", ln_scale=blk["norm1"]["scale"],
            ln_bias=blk["norm1"]["bias"], out_dtype=bf16, **q(qkv_e)),
        "mlp_b2": lambda: fused_mlp_plain(
            x2, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
            fc2_e.bias, **mlp_kw),
    }
    # K2 at the chain's batch 1, K8 on the same int8 weights at batch 32,
    # 2 and 1 (the same function: the plain version is K2's)
    plain["mlp_b1"] = lambda: fused_mlp_plain(
        x1, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
        fc2_e.bias, **mlp_kw)
    x3r = xs[:3 * n_pad]  # the chain at batch 3, where K8 runs
    plain["mlp_b3"] = lambda: fused_mlp_plain(
        x3r, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
        fc2_e.bias, **mlp_kw)
    # the 384-px ViT-B/16 chain at batch 1: 592 rows, f32 residual stream
    nr384 = (384 // cfg.patch_size)**2 + 1
    n384 = -(-nr384 // 16) * 16
    x384 = torch.randn((n384, d), generator=g, device=DEV)
    # K5 on the 384-px latency entry's rows (the stack has no token count)
    x384b = x384.to(bf16)
    plain["stack_b1_384"] = lambda: vit_block_stack_plain(
        stack, x384b, n_valid=nr384, out_dtype=bf16)
    plain["mlp_384_f32"] = lambda: fused_mlp_plain(
        x384, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
        fc2_e.bias, **dict(mlp_kw, out_dtype=torch.float32))
    for bk, site in ((b, "mlp"), (2, "mlp_b2"), (1, "mlp_b1"), (3, "mlp_b3"),
                     ("384_f32", "mlp_384_f32")):
        plain[f"mlp_k8_b{bk}"] = plain[site]
    plan = fwd["plan"]
    if plan is not None:
        attn_p, mlp_p = plan.blocks[0][0], plan.blocks[0][1].resident
        k6_p = plan.chain[0][1]
        kern = {
            "patch_embed": lambda: run_matmul(
                plan.embed["patches"][0], xpatch, out_dtype=torch.float32),
            "attn_proj": lambda: run_matmul(attn_p.proj, alv, residual=xs,
                                            out_dtype=bf16),
            "head": lambda: run_matmul(plan.head, xhead,
                                       out_dtype=torch.float32),
            "mlp": lambda: run_mlp(mlp_p, xs, out_dtype=bf16),
            "heads": lambda: run_attention_heads(attn_p.heads, x3,
                                                 n_valid=n_real,
                                                 out_dtype=bf16),
            "qkv_attn_b2": lambda: run_attention_qkv(
                k6_p, qkv2, n_valid=n_real, out_dtype=bf16),
            "qkv_attn_b1": lambda: run_attention_qkv(
                k6_p, qkv1, n_valid=n_real, out_dtype=bf16),
            "qkv_attn_b32": lambda: run_attention_qkv(
                k6_p, qkv32, n_valid=n_real, out_dtype=bf16),
            "qkv_attn_int_b2": lambda: run_attention_qkv(
                k6_p, qkv2, n_valid=n_real, out_dtype=bf16,
                int_attention=True),
            "qkv_attn_int_b32": lambda: run_attention_qkv(
                k6_p, qkv32, n_valid=n_real, out_dtype=bf16,
                int_attention=True),
            "stack_b1": lambda: run_block_stack(stack, x1, n_valid=n_real,
                                                out_dtype=bf16),
            "stack_b1_384": lambda: run_block_stack(
                stack, x384b, n_valid=nr384, out_dtype=bf16),
            "chain_qkv_b2": lambda: run_matmul(plan.chain[0][0], x2,
                                               out_dtype=bf16),
            "mlp_b2": lambda: run_mlp(mlp_p, x2, out_dtype=bf16),
            "mlp_b1": lambda: run_mlp(mlp_p, x1, out_dtype=bf16),
        }
        k8_p = plan.blocks[0][1].chunked
        for bk, xm in ((b, xs), (2, x2), (1, x1), (3, x3r)):
            kern[f"mlp_k8_b{bk}"] = (
                lambda xm=xm: run_mlp_chunked(k8_p, xm, out_dtype=bf16))
        kern["mlp_b3"] = lambda: run_mlp(mlp_p, x3r, out_dtype=bf16)
        kern["mlp_k8_b384_f32"] = lambda: run_mlp_chunked(
            k8_p, x384, out_dtype=torch.float32)
        kern["mlp_384_f32"] = lambda: run_mlp(mlp_p, x384,
                                              out_dtype=torch.float32)
    else:
        kern = {
            "patch_embed": lambda: fused_quant_matmul(
                xpatch, pe.w, pe.scale, pe.bias, fmt=pe.fmt,
                prologue="quant", out_dtype=torch.float32, **q(pe)),
            "attn_proj": lambda: fused_quant_matmul(
                alv, proj_e.w, proj_e.scale, proj_e.bias, fmt=proj_e.fmt,
                prologue=None, epilogue="residual", residual=xs,
                out_dtype=bf16),
            "head": lambda: fused_quant_matmul(
                xhead, he.w, he.scale, he.bias, fmt=he.fmt, prologue="quant",
                out_dtype=torch.float32, **q(he)),
            "mlp": lambda: fused_mlp(
                xs, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
                fc2_e.bias, **mlp_kw),
            "heads": lambda: attention_heads(
                x3, qkv_e.w, qkv_e.scale, qkv_e.bias, **attn_kw),
            "qkv_attn_b2": lambda: attention_qkv(qkv2, **qkv_kw),
            "qkv_attn_b1": lambda: attention_qkv(qkv1, **qkv_kw),
            "qkv_attn_b32": lambda: attention_qkv(qkv32, **qkv_kw),
            "qkv_attn_int_b2": lambda: attention_qkv(
                qkv2, int_attention=True, **qkv_kw),
            "qkv_attn_int_b32": lambda: attention_qkv(
                qkv32, int_attention=True, **qkv_kw),
            "stack_b1": plain["stack_b1"],
            "stack_b1_384": plain["stack_b1_384"],
            "chain_qkv_b2": lambda: fused_quant_matmul(
                x2, qkv_e.w, qkv_e.scale, qkv_e.bias, fmt=qkv_e.fmt,
                prologue="ln_quant", ln_scale=blk["norm1"]["scale"],
                ln_bias=blk["norm1"]["bias"], out_dtype=bf16, **q(qkv_e)),
            "mlp_b2": lambda: fused_mlp(
                x2, fc1_e.w, fc1_e.scale, fc1_e.bias, fc2_e.w, fc2_e.scale,
                fc2_e.bias, **mlp_kw),
        }
        for site in ("mlp_b1", f"mlp_k8_b{b}", "mlp_k8_b2", "mlp_k8_b1",
                     "mlp_b3", "mlp_k8_b3", "mlp_384_f32",
                     "mlp_k8_b384_f32"):
            kern[site] = plain[site]
    kern["embed"] = lambda: patch_finalize(acc, pos, cls, one, n_pad=n_pad,
                                           out_dtype=bf16)
    # K1 at the chain's other sites (batch 1-3) and the head at one row
    # (not on the batch-32 forward: 0 launches there)
    k1_sites = {"head_b1": (dict(x=xhead[:1], w=he, prologue="quant",
                                 layer=q(he), out_dtype=torch.float32),
                            plan.head if plan is not None else None)}
    for bk in CHAIN_BATCHES:
        mk = bk * n_pad
        if bk != 2:
            k1_sites[f"chain_qkv_b{bk}"] = (dict(
                x=xs[:mk], w=qkv_e, prologue="ln_quant", layer=dict(
                    q(qkv_e), ln_scale=blk["norm1"]["scale"],
                    ln_bias=blk["norm1"]["bias"]), out_dtype=bf16),
                plan.chain[0][0] if plan is not None else None)
        k1_sites[f"chain_proj_b{bk}"] = (dict(
            x=alv[:mk], w=proj_e, prologue=None, layer=dict(
                epilogue="residual", residual=xs[:mk]), out_dtype=bf16),
            attn_p.proj if plan is not None else None)
    for site, (c, k1_plan) in k1_sites.items():
        layer = dict(c["layer"])
        res = layer.pop("residual", None)

        def plain_k1(c=c, layer=layer, res=res):
            return fused_quant_matmul_plain(
                c["x"], c["w"].w, c["w"].scale, c["w"].bias, fmt=c["w"].fmt,
                prologue=c["prologue"], residual=res,
                out_dtype=c["out_dtype"], **layer)

        plain[site] = plain_k1
        kern[site] = plain_k1 if k1_plan is None else (
            lambda c=c, p=k1_plan, res=res: run_matmul(
                p, c["x"], residual=res, out_dtype=c["out_dtype"]))

    def sdpa(bk):
        return sdpa_call(bk, heads, n_pad, nk, hd, g)

    w1b = 1 if pe.fmt == "int8" else 0.5
    wpk = 0.5 if meta.fmt == "int4" else 1
    w_blk = d * 3 * d + d * d + 2 * d * hid  # levels of one block's weights
    attn_ops = 2 * heads * n_pad * nk * hd * 2  # one image's QK^T and PV
    sites = [
        # kernel, site, launches/forward, bound, GEMMs, library call
        ("fused_quant_matmul", "patch_embed", 1,
         bound(b * p * kp * 4 + kp * d * w1b + b * p * d * 4,
               2 * b * p * kp * d), [(b * p, kp, d)], None),
        ("fused_quant_matmul", "attn_proj", cfg.depth,
         bound(m * d + d * d * w1b + 2 * m * d * 2, 2 * m * d * d),
         [(m, d, d)], None),
        ("fused_quant_matmul", "head", 1,
         bound(b * d * 4 + d * ncls * w1b + b * ncls * 4, 2 * b * d * ncls),
         [(b, d, ncls)], None),
        ("fused_mlp", "mlp", cfg.depth,
         bound(2 * m * d * 2 + 2 * d * hid * w1b, 4 * m * d * hid),
         [(m, d, hid), (m, hid, d)], None),
        ("attention_block", "heads", cfg.depth,
         bound(m * d * 2 + 3 * d * d * w1b + m * d, 2 * m * d * 3 * d,
               b * attn_ops), [(m, d, 3 * d)], None),
        ("patch_finalize", "embed", 1,
         bound(b * p * d * 4 + p * d * 4 + d * 4 + m * d * 2), [], None),
        # K6 on the chain forward at batch 2 (12 launches), and at batch 32
        ("attention_qkv", "qkv_attn_b2", cfg.depth,
         bound(2 * n_pad * 3 * d * 2 + 2 * n_pad * d, 0, 2 * attn_ops), [],
         sdpa(2)),
        ("attention_qkv", "qkv_attn_b32", 0,
         bound(b * n_pad * 3 * d * 2 + b * n_pad * d, 0, b * attn_ops), [],
         sdpa(b)),
        # K6 on the chain at batch 1: with the chain's K1 and K2 sites at
        # batch 1, the yardstick of K5's time a block
        ("attention_qkv", "qkv_attn_b1", 0,
         bound(n_pad * 3 * d * 2 + n_pad * d, 0, attn_ops), [], sdpa(1)),
        # K6 with int_attention (the variant bench.py times) at batch 2 and
        # 32: no library call computes it
        ("attention_qkv", "qkv_attn_int_b2", 0,
         bound(2 * n_pad * 3 * d * 2 + 2 * n_pad * d, 0, 2 * attn_ops), [],
         None),
        ("attention_qkv", "qkv_attn_int_b32", 0,
         bound(b * n_pad * 3 * d * 2 + b * n_pad * d, 0, b * attn_ops), [],
         None),
        # the chain's K1 qkv and K2 at batch 2 (not on the batch-32
        # forward: 0 launches there), to split the chain's time
        ("fused_quant_matmul", "chain_qkv_b2", 0,
         bound(2 * n_pad * d * 2 + 3 * d * d * w1b + 2 * n_pad * 3 * d * 2,
               2 * 2 * n_pad * d * 3 * d), [(2 * n_pad, d, 3 * d)], None),
        ("fused_mlp", "mlp_b2", 0,
         bound(2 * 2 * n_pad * d * 2 + 2 * d * hid * w1b,
               4 * 2 * n_pad * d * hid),
         [(2 * n_pad, d, hid), (2 * n_pad, hid, d)], None),
        *[("fused_quant_matmul", f"chain_qkv_b{bk}", 0,
           bound(bk * n_pad * d * 2 + 3 * d * d * w1b
                 + bk * n_pad * 3 * d * 2, 2 * bk * n_pad * d * 3 * d),
           [(bk * n_pad, d, 3 * d)], None) for bk in CHAIN_BATCHES
          if bk != 2],
        *[("fused_quant_matmul", f"chain_proj_b{bk}", 0,
           bound(bk * n_pad * d + d * d * w1b + 2 * bk * n_pad * d * 2,
                 2 * bk * n_pad * d * d), [(bk * n_pad, d, d)], None)
          for bk in CHAIN_BATCHES],
        ("fused_quant_matmul", "head_b1", 0,
         bound(d * 4 + d * ncls * w1b + ncls * 4, 2 * d * ncls),
         [(1, d, ncls)], None),
        ("fused_mlp", "mlp_b1", 0,
         bound(2 * n_pad * d * 2 + 2 * d * hid * w1b, 4 * n_pad * d * hid),
         [(n_pad, d, hid), (n_pad, hid, d)], None),
        # K8 on the same int8 weights at batch 32, 2, 1 and 3 (ViT-B's
        # chain at batch 3 runs it: 0 launches here), K2 at batch 3
        *[("fused_mlp_chunked", f"mlp_k8_b{bk}", 0,
           bound(2 * bk * n_pad * d * 2 + 2 * d * hid,
                 4 * bk * n_pad * d * hid),
           [(bk * n_pad, d, hid), (bk * n_pad, hid, d)], None)
          for bk in (b, 2, 1, 3)],
        ("fused_mlp", "mlp_b3", 0,
         bound(2 * 3 * n_pad * d * 2 + 2 * d * hid, 4 * 3 * n_pad * d * hid),
         [(3 * n_pad, d, hid), (3 * n_pad, hid, d)], None),
        # the 384-px chain at batch 1 (f32 residual stream): K8, K2 beside
        *[(kn, site, 0, bound(2 * n384 * d * 4 + 2 * d * hid,
                              4 * n384 * d * hid),
           [(n384, d, hid), (n384, hid, d)], None)
          for kn, site in (("fused_mlp_chunked", "mlp_k8_b384_f32"),
                           ("fused_mlp", "mlp_384_f32"))],
        # K5 on the latency forward: one launch, all the depth; and on the
        # 384-px entry's 592 rows (its forward: phase 3's latency384)
        ("block_stack", "stack_b1", 1,
         bound(cfg.depth * w_blk * wpk + 2 * n_pad * d * 2,
               cfg.depth * 2 * n_pad * w_blk, cfg.depth * attn_ops), [],
         None),
        ("block_stack", "stack_b1_384", 0,
         bound(cfg.depth * w_blk * wpk + 2 * n384 * d * 2,
               cfg.depth * 2 * n384 * w_blk,
               cfg.depth * 2 * heads * n384 * (-(-nr384 // 16) * 16)
               * hd * 2), [], None),
    ]
    # K6's and K3's sites: the FLOP of the attention's two products (exact
    # only on the f64 MMA), over the FP64 tensor cores' rate, as the
    # attention's ceiling
    fp64_flop = {f"qkv_attn{v}_b{bk}": bk * attn_ops for bk in (2, b)
                 for v in ("", "_int")}
    fp64_flop["heads"] = b * attn_ops
    sites += vit_h_sites(fwd["vit_h"], kern, plain, bound, fp64_flop)
    sites += path_sites(fwd, kern, plain, bound)
    sites += fsdp_sites(fwd, kern, plain, bound, xs)
    per_site = []
    for name, site, nl, (bms, by), gemms, lib, *extra in sites:
        ms = cuda_ms(kern[site])
        pms = cuda_ms(plain[site], iters=5, warmup=1)
        ims = int_mm_ms(gemms) if gemms else None
        lms = cuda_ms(lib) if lib is not None else None
        # yardsticks the port never calls beside the kernel: K1 with the
        # quant prologue at K12's shapes, K6 + K1 and K3's branch at K9's
        yard = {k: cuda_ms(fn) * 1e3 for k, fn in (extra[0] if extra
                                                    else {}).items()}
        # and their device time beside the K10-K12 sites' (the kernels
        # run for less than their wrappers' host time a call)
        yard_dev = ({k: kernel_device_us(fn) for k, fn in extra[0].items()}
                    if extra and name in INT_MM_KERNELS else {})
        per_site.append({"kernel": name, "site": site, "launches": nl,
                         "us": ms * 1e3, "plain_us": pms * 1e3,
                         "bound_us": bms * 1e3, "bound_by": by,
                         "int_mm_us": None if ims is None else ims * 1e3,
                         "library_us": None if lms is None else lms * 1e3,
                         "yardsticks_us": yard,
                         "yardsticks_device_us": yard_dev})
        if name in ("flash_attention", "attention_qkv", "attention_block",
                    "fused_mlp", "fused_mlp_chunked", "fused_quant_matmul",
                    "block_stack", "patch_finalize", *INT_MM_KERNELS):
            # how much of the time is the host's, the kernel's and SDPA's
            split = host_split(kern[site], ms * 1e3)
            per_site[-1].update(split)
            splits = [(name, split)]
            if lib is not None:
                lsplit = host_split(lib, lms * 1e3)
                per_site[-1]["library_split"] = lsplit
                splits.append(("library", lsplit))
            for who, sp in splits:
                dv, share = sp["device_us"], sp["card_share"]
                log(f"[time] {who:18s} {site:12s} host {sp['host_us']:.1f} "
                    f"us a call; on the card "
                    f"{'n/a' if dv is None else f'{dv:.1f}'} us, "
                    f"{'n/a' if share is None else f'{share:.3f}'} of the "
                    "time")
        if site in fp64_flop:
            per_site[-1]["fp64_ceiling_us"] = (fp64_flop[site] / fp64_peak
                                               * 1e6)
            log(f"[time] {name:18s} {site:12s} FP64 MMA ceiling "
                f"{per_site[-1]['fp64_ceiling_us']:.1f} us")
        log(f"[time] {name:18s} {site:12s} {ms * 1e3:9.1f} us  plain "
            f"{pms * 1e3:9.1f}  bound {bms * 1e3:7.1f} ({by})  _int_mm "
            f"{'n/a' if ims is None else f'{ims * 1e3:.1f}'}  library "
            f"{'n/a' if lms is None else f'{lms * 1e3:.1f}'}"
            + "".join(f"  {k} {v:.1f}" for k, v in yard.items())
            + "".join(f"  {k} on the card "
                      f"{'n/a' if v is None else f'{v:.1f}'}"
                      for k, v in yard_dev.items()))
    record["per_site"] = per_site

    # the attention branch of both routes at batch 2-32: K3 (alone and
    # with its K1 proj) against K1 qkv + K6 + K1 proj, on the same plans
    # (the data for BLOCK_ROUTE_MIN_BATCH, serve/vit_int4.py)
    if plan is not None:
        routes = {}
        for bk in ROUTE_BATCHES:
            xb = xs[:bk * n_pad]
            x3b = xb.reshape(bk, n_pad, d)
            r = routes[f"b{bk}"] = {
                "k3_ms": cuda_ms(lambda: run_attention_heads(
                    attn_p.heads, x3b, n_valid=n_real, out_dtype=bf16)),
                "block_ms": cuda_ms(lambda: run_attention_block(
                    attn_p, x3b, n_valid=n_real, out_dtype=bf16)),
                "chain_ms": cuda_ms(lambda: _chain_attention(
                    plan.chain[0], attn_p, xb, b=bk, n_pad=n_pad,
                    n_real=n_real, float_dtype=bf16, int_attention=False))}
            log(f"[time] attention branch b{bk}: K3 {r['k3_ms'] * 1e3:.1f}"
                f" us, K3+K1 {r['block_ms'] * 1e3:.1f} us, K1+K6+K1 "
                f"{r['chain_ms'] * 1e3:.1f} us")
        record["attention_routes"] = routes

    kw = dict(float_dtype=bf16, images_layout="patches")
    ms_fwd = cuda_ms(lambda: vit_int4_forward(art, x, cfg, plan=plan, **kw))
    ms_bf16 = cuda_ms(bf16_vit_forward(cfg, x))
    small = {"latency_b1_ms": cuda_ms(lambda: vit_int4_forward_latency(
        lat, x[:1], cfg, meta, **kw))}
    for bk in CHAIN_BATCHES:
        small[f"chain_b{bk}_ms"] = cuda_ms(lambda: vit_int4_forward(
            art, x[:bk], cfg, plan=plan, **kw))
    for bk in (1, 2):
        small[f"bf16_torch_b{bk}_ms"] = cuda_ms(bf16_vit_forward(cfg,
                                                                 x[:bk]))
    record["forward_timing"] = {
        "batch": b, "ms_per_batch": ms_fwd, "img_per_s": b / ms_fwd * 1e3,
        "bf16_torch_ms_per_batch": ms_bf16,
        "bf16_torch_img_per_s": b / ms_bf16 * 1e3,
        "ratio_vs_bf16": ms_bf16 / ms_fwd,
        "kernel_ms_sum": sum(s["us"] * s["launches"] for s in per_site
                             if s["kernel"] in ("fused_quant_matmul",
                                                "fused_mlp",
                                                "attention_block",
                                                "patch_finalize")) / 1e3,
        **small}
    log(f"[time] forward b{b} bf16: {ms_fwd:.3f} ms/batch "
        f"({b / ms_fwd * 1e3:.1f} img/s); plain bf16 torch ViT-B/16 "
        f"{ms_bf16:.3f} ms ({b / ms_bf16 * 1e3:.1f} img/s); ratio "
        f"{ms_bf16 / ms_fwd:.3f}")
    log("[time] small batches (ms): " + ", ".join(
        f"{k[:-3]} {v:.3f}" for k, v in small.items()))
    vh = fwd["vit_h"]
    vh_t = {}
    for bk in VIT_H_BATCHES:
        vh_t[f"b{bk}_ms"] = cuda_ms(lambda: vit_int4_forward(
            vh["art"], vh["x"][:bk], vh["cfg"], plan=vh["plan"], **kw))
        vh_t[f"bf16_torch_b{bk}_ms"] = cuda_ms(bf16_vit_forward(
            vh["cfg"], vh["x"][:bk]))
        vh_t[f"ratio_vs_bf16_b{bk}"] = (vh_t[f"bf16_torch_b{bk}_ms"]
                                        / vh_t[f"b{bk}_ms"])
    record["vit_h"]["forward_timing"] = vh_t
    log("[time] ViT-H/14 forwards (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in vh_t.items()))

    # the FSDP forward at tp = 1 against vit_int4_forward on this card;
    # tp = 2's host wall time is fsdp_phase's (two contexts time-sliced)
    fs = fwd["fsdp"]
    ms_fsdp = cuda_ms(lambda: vit_int4_forward_fsdp_rdma(
        fs["fart"], x, cfg, plan=fs["plan"], **kw))
    bh = vh["x"].shape[0]
    ms_fsdp_h = cuda_ms(lambda: vit_int4_forward_fsdp_rdma(
        fs["fart_h"], vh["x"], vh["cfg"], plan=fs["plan_h"], **kw))
    record["fsdp"]["forward_timing"] = {
        "tp1_ms": ms_fsdp, "vit_int4_forward_ms": ms_fwd,
        "ratio_vs_single_device": ms_fwd / ms_fsdp,
        f"vith_tp1_b{bh}_ms": ms_fsdp_h,
        f"vith_vit_int4_forward_b{bh}_ms": vh_t[f"b{bh}_ms"],
        "vith_ratio_vs_single_device": vh_t[f"b{bh}_ms"] / ms_fsdp_h}
    log(f"[time] FSDP forward tp=1 b{b}: {ms_fsdp:.3f} ms (single-device "
        f"forward {ms_fwd:.3f} ms); ViT-H/14 b{bh}: {ms_fsdp_h:.3f} ms "
        f"(single-device {vh_t[f'b{bh}_ms']:.3f} ms)")
    record["overlap"] = overlap_sweep(cfg)

    rel = {"fused_quant_matmul": (
               "quantized_vit_tpu_torch/csrc/fused_quant_matmul.cu",
               "quantized_vit_tpu/ops/fused.py:556", "block"),
           "fused_mlp": ("quantized_vit_tpu_torch/csrc/fused_mlp.cu",
                         "quantized_vit_tpu/ops/fused.py:977", "block"),
           "attention_block": (
               "quantized_vit_tpu_torch/csrc/attention_block.cu",
               "quantized_vit_tpu/ops/attention.py:667", "block"),
           "patch_finalize": (
               "quantized_vit_tpu_torch/csrc/patch_finalize.cu",
               "quantized_vit_tpu/ops/patch.py:52", "block"),
           "attention_qkv": (
               "quantized_vit_tpu_torch/csrc/attention_qkv.cu",
               "quantized_vit_tpu/ops/attention.py:859", "chain_b2"),
           "block_stack": (
               "quantized_vit_tpu_torch/csrc/block_stack.cu",
               "quantized_vit_tpu/ops/block_stack.py:341", "latency"),
           "fused_mlp_chunked": (
               "quantized_vit_tpu_torch/csrc/fused_mlp_chunked.cu",
               "quantized_vit_tpu/ops/fused.py:1065", "vith_b1"),
           "attention_qkv_proj": (
               "quantized_vit_tpu_torch/csrc/attention_proj.cu",
               "quantized_vit_tpu/ops/attention.py:770",
               f"vith_branch_b{VIT_H_BRANCH_BATCH}"),
           "int4_matmul": ("quantized_vit_tpu_torch/csrc/int_matmul.cu",
                           "quantized_vit_tpu/ops/int4_matmul.py:193",
                           "profile_kernels"),
           "int8_matmul": ("quantized_vit_tpu_torch/csrc/int_matmul.cu",
                           "quantized_vit_tpu/ops/int4_matmul.py:273",
                           "profile_kernels"),
           "quant_matmul_fa": ("quantized_vit_tpu_torch/csrc/int_matmul.cu",
                               "quantized_vit_tpu/ops/int4_matmul.py:480",
                               "profile_kernels"),
           "flash_attention": (
               "quantized_vit_tpu_torch/csrc/flash_attention.cu",
               "quantized_vit_tpu/ops/attention.py:119",
               f"k13_vitb_b{BATCH}"),
           "gather_rows": ("quantized_vit_tpu_torch/csrc/ring_gather.cu",
                           "quantized_vit_tpu/ops/ring_gather.py:154",
                           "fsdp_tp1"),
           "fused_mlp_gather": (
               "quantized_vit_tpu_torch/csrc/fused_mlp.cu",
               "quantized_vit_tpu/ops/ring_gather.py:314", "fsdp_tp1")}
    launches = dict(fwd["launches"], **fwd["vit_h"]["launches"],
                    **fwd["paths"]["launches"], **fwd["fsdp"]["launches"])
    kernels = []
    for name, (src, rep, path) in rel.items():
        ss = [s for s in per_site if s["kernel"] == name]
        errs = [r for r in record["parity"]
                if r["kernel"] == name and "small" not in r["case"]]
        tot = lambda key: sum(s[key] * s["launches"] for s in ss
                              if s["launches"]) / 1e3
        # the sites on the kernel's own forward (launches > 0)
        im = [s["int_mm_us"] for s in ss if s["launches"]]
        lib = [s["library_us"] for s in ss if s["launches"]]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            # counted on the path that runs the kernel: the batch-32
            # forward, the chain forward at batch 2, the latency forward,
            # ViT-H/14's forward at batch 1, the kernel paths of phase 3b
            "launches": launches[path][name], "path": path,
            "max_abs_err": max(r["max_abs_err"] for r in errs),
            "share_differ": max(r["share_differ"] for r in errs),
            "bit_exact": all(r["bit_exact"] for r in errs),
            # per forward: the kernel's launches at their main-path shapes
            "ms": tot("us"), "plain_ms": tot("plain_us"),
            "bound_ms": tot("bound_us"),
            "bound_by": max(ss, key=lambda s: s["bound_us"] * s["launches"])
            ["bound_by"],
            "library_ms": (None if not lib or any(v is None for v in lib)
                           else tot("library_us")),
            "int_mm_ms": (None if not im or any(v is None for v in im)
                          else tot("int_mm_us")),
            "us_per_launch": {s["site"]: s["us"] for s in ss},
            "bound_us_per_launch": {s["site"]: s["bound_us"] for s in ss},
        })
    record["kernels"] = kernels


def k9_site_calls(blk, plan, qkv, x3, hd, n_real):
    """(K9, its plain version, K6 + K1, K3's branch) on block ``blk``'s
    layers, as calls on ``qkv`` [B, N, 3D] and the residual ``x3``; on the
    card each kernel launches on a plan (K6, K3 and the proj K1 on the
    forward's ``plan``), in a CPU rehearsal the wrappers take their plain
    versions."""
    from quantized_vit_tpu_torch.ops import (
        attention_block, attention_qkv, attention_qkv_proj,
        attention_qkv_proj_plain, fused_quant_matmul,
        plan_attention_qkv_proj, run_attention_block, run_attention_qkv,
        run_attention_qkv_proj, run_matmul)
    from quantized_vit_tpu_torch.serve.vit_int4 import _attention_layer

    bf16 = torch.bfloat16
    qkv_e, proj_e = blk["qkv"], blk["proj"]
    layer = _attention_layer(blk, hd, hd**-0.5)
    q = {k: layer[k] for k in ("heads", "sm_scale", "out_d", "out_t",
                               "out_top", "out_pow")}
    kq = dict(n_valid=n_real, out_dtype=bf16)
    proj = (proj_e.w, proj_e.scale, proj_e.bias)
    m = x3.shape[0] * x3.shape[1]
    x2 = x3.reshape(m, -1)

    def plain():
        return attention_qkv_proj_plain(qkv, *proj, x3, fmt=proj_e.fmt, **q,
                                        **kq)

    if plan is None:
        def k9():
            return attention_qkv_proj(qkv, *proj, x3, fmt=proj_e.fmt, **q,
                                      **kq)

        def k6_k1():
            alv = attention_qkv(qkv, **q, **kq)
            return fused_quant_matmul(alv.reshape(m, -1), *proj,
                                      fmt=proj_e.fmt, prologue=None,
                                      epilogue="residual", residual=x2,
                                      out_dtype=bf16)

        def k3():
            return attention_block(x3, qkv_e.w, qkv_e.scale, qkv_e.bias,
                                   *proj, fmt_proj=proj_e.fmt, **layer, **kq)

        return k9, plain, k6_k1, k3
    attn_p, k6_p = plan.blocks[0][0], plan.chain[0][1]
    k9_p = plan_attention_qkv_proj(*proj, fmt=proj_e.fmt, **q)

    def k6_k1():
        alv = run_attention_qkv(k6_p, qkv, **kq)
        return run_matmul(attn_p.proj, alv.reshape(m, -1), residual=x2,
                          out_dtype=bf16)

    return (lambda: run_attention_qkv_proj(k9_p, qkv, x3, **kq), plain,
            k6_k1, lambda: run_attention_block(attn_p, x3, **kq))


def path_sites(fwd, kern, plain, bound):
    """The timing sites of phase 3b's kernels, added to ``kern``/``plain``:
    K9 at ViT-H/14's batch 8 (its launch on the exp_vith path) and
    ViT-B/16's batch 32, with SDPA + ``torch._int_mm`` on the proj as the
    library yardstick and, beside it, K6 + K1 (the function's plain
    structure on kernels) and K3's branch; K10-K12 at profile_kernels'
    four shapes (one launch each on that path), ``torch._int_mm`` as the
    library call and, for K12, K1 with the quant prologue (1/d, not the
    division) as a yardstick."""
    from quantized_vit_tpu_torch.ops import (fused_quant_matmul,
                                             int4_matmul_plain,
                                             int8_matmul_plain,
                                             plan_int_matmul, plan_matmul,
                                             quant_matmul_fa_plain,
                                             run_int_matmul, run_matmul)
    from quantized_vit_tpu_torch.quant import pack_int4

    bf16 = torch.bfloat16
    g = torch.Generator(device=DEV).manual_seed(11)
    sites = []
    vh = fwd["vit_h"]
    vb = shapes(fwd["cfg"])
    for site, art, plan, b, d, n_real, n_pad, heads, nl in (
            (f"k9_vith_b{VIT_H_BRANCH_BATCH}", vh["art"], vh["plan"],
             VIT_H_BRANCH_BATCH, *vit_h_shapes(vh["cfg"])[1:4],
             vit_h_shapes(vh["cfg"])[5], 1),
            (f"k9_vitb_b{BATCH}", fwd["art"], fwd["plan"], BATCH, vb[2],
             vb[3], vb[4], vb[8], 0)):
        hd = d // heads
        nk = -(-n_real // 16) * 16
        m = b * n_pad
        qkv = (torch.randn((b, n_pad, 3 * d), generator=g, device=DEV)
               * 0.7).to(bf16)
        x3 = torch.randn((b, n_pad, d), generator=g, device=DEV).to(bf16)
        kern[site], plain[site], k6_k1, k3 = k9_site_calls(
            art["blocks"][0], plan, qkv, x3, hd, n_real)
        proj_e = art["blocks"][0]["proj"]
        alv = torch.randint(-7, 8, (m, d), dtype=torch.int8, device=DEV,
                            generator=g)
        wt = torch.randint(-7, 8, (d, d), dtype=torch.int8, device=DEV,
                           generator=g).t()
        attn = sdpa_call(b, heads, n_pad, nk, hd, g)

        def lib(attn=attn, alv=alv, wt=wt):
            attn()
            return torch._int_mm(alv, wt)

        wb = d * d * (0.5 if proj_e.fmt == "int4" else 1)
        attn_ops = b * 2 * heads * n_pad * nk * hd * 2
        sites.append((
            "attention_qkv_proj", site, nl,
            bound(m * 3 * d * 2 + 2 * m * d * 2 + wb + 8 * d, 2 * m * d * d,
                  attn_ops), [], lib, {"k6_k1": k6_k1, "k3_branch": k3}))
    sc = torch.full((), 1e-3, device=DEV)
    fa_q = dict(act_d=torch.full((), 0.05, device=DEV),
                act_t=torch.full((), 1.0, device=DEV), act_top=7,
                act_pow=False)
    for label, m, k, n in profile_shapes(fwd["cfg"]):
        xf = (torch.randn((m, k), generator=g, device=DEV) * 0.1).to(bf16)
        xl = torch.randint(-7, 8, (m, k), dtype=torch.int8, device=DEV,
                           generator=g)
        w8 = torch.randint(-7, 8, (k, n), dtype=torch.int8, device=DEV,
                           generator=g)
        w4 = pack_int4(w8, axis=0)
        bias = torch.randn((n,), generator=g, device=DEV) * 0.01
        fa_args = (fa_q["act_d"], fa_q["act_t"], fa_q["act_top"])
        plain.update({
            f"int4_{label}": lambda xl=xl, w4=w4, bias=bias:
                int4_matmul_plain(xl, w4, sc, bias),
            f"int8_{label}": lambda xl=xl, w8=w8, bias=bias:
                int8_matmul_plain(xl, w8, sc, bias),
            f"fa_{label}": lambda xf=xf, w4=w4, bias=bias:
                quant_matmul_fa_plain(xf, w4, sc, bias, *fa_args, fmt="int4",
                                      act_pow=False, out_dtype=bf16)})
        if DEV != "cuda":  # CPU rehearsal: the plain versions
            for kk in ("int4", "int8", "fa"):
                kern[f"{kk}_{label}"] = plain[f"{kk}_{label}"]
            k1 = (lambda xf=xf, w4=w4, bias=bias: fused_quant_matmul(
                xf, w4, sc, bias, fmt="int4", prologue="quant",
                out_dtype=bf16, **fa_q))
        else:
            p4 = plan_int_matmul(w4, sc, bias, fmt="int4")
            p8 = plan_int_matmul(w8, sc, bias, fmt="int8")
            pfa = plan_int_matmul(w4, sc, bias, fmt="int4", **fa_q)
            p1 = plan_matmul(w4, sc, bias, fmt="int4", prologue="quant",
                             **fa_q)
            kern.update({
                f"int4_{label}": lambda p4=p4, xl=xl: run_int_matmul(p4, xl),
                f"int8_{label}": lambda p8=p8, xl=xl: run_int_matmul(p8, xl),
                f"fa_{label}": lambda pfa=pfa, xf=xf: run_int_matmul(
                    pfa, xf, out_dtype=bf16)})
            k1 = (lambda p1=p1, xf=xf: run_matmul(p1, xf, out_dtype=bf16))
        ops = 2 * m * k * n
        mm = (lambda xl=xl, w8t=w8.t().contiguous().t():
              torch._int_mm(xl, w8t))
        sites += [
            ("int4_matmul", f"int4_{label}", 1,
             bound(m * k + k * n / 2 + m * n * 4 + 8 * n, ops), [], mm),
            ("int8_matmul", f"int8_{label}", 1,
             bound(m * k + k * n + m * n * 4 + 8 * n, ops), [], mm),
            ("quant_matmul_fa", f"fa_{label}", 1,
             bound(m * k * 2 + k * n / 2 + m * n * 2 + 8 * n, ops), [], mm,
             {"k1_quant": k1})]
    return sites


def fsdp_sites(fwd, kern, plain, bound, xs):
    """The timing sites of K13, K14 and K15, added to ``kern``/``plain``:
    K13 on its path's q/k/v (ViT-B/16 batch 32: the launch of its path;
    ViT-H/14 batch 1 and 8) with ``scaled_dot_product_attention`` on the
    same q/k/v as the library call (no mask: the padded keys count); K14
    on block 0's gather of the FSDP forward at tp = 1 (one launch a
    forward), ``torch.cat`` of the shards as the library call; K15 on
    block 0's MLP + gather of block 1 at the batch's rows (12 launches a
    forward), and at ViT-H/14's (its FSDP forward's 32 launches counted
    on their own path), with K2 on the same plan as a yardstick (no
    PyTorch call computes it)."""
    import torch.nn.functional as F

    from quantized_vit_tpu_torch.ops import (flash_attention,
                                             flash_attention_plain,
                                             fused_mlp_gather_plain,
                                             gather_rows_plain,
                                             run_gather_rows, run_mlp,
                                             run_mlp_gather)
    from quantized_vit_tpu_torch.serve.vit_fsdp import (_SHARDED, _logical,
                                                        _mlp_args,
                                                        _with_weights)

    sites = []
    for site, (q, k, v, kw) in fwd["paths"]["k13"].items():
        kern[site] = lambda q=q, k=k, v=v, kw=kw: flash_attention(q, k, v,
                                                                  **kw)
        plain[site] = lambda q=q, k=k, v=v, kw=kw: flash_attention_plain(
            q, k, v, **kw)
        b, h, n, hd = q.shape
        nbytes = 4 * q.numel() * q.element_size()
        sites.append((
            "flash_attention", site, int(site == f"k13_vitb_b{BATCH}"),
            bound(nbytes, 0, 2 * b * h * n * n * hd * 2), [],
            lambda q=q, k=k, v=v, kw=kw: F.scaled_dot_product_attention(
                q, k, v, scale=kw["sm_scale"])))
    fs = fwd["fsdp"]
    vh = fwd["vit_h"]
    xh = (torch.randn((vh["x"].shape[0] * vit_h_shapes(vh["cfg"])[3],
                       vh["cfg"].embed_dim), device=DEV,
                      generator=torch.Generator(DEV).manual_seed(3))
          * 0.5).to(torch.bfloat16)
    kg = []
    for tag, fart, plan, x, nl in (("", fs["fart"], fs["plan"], xs,
                                    fwd["cfg"].depth),
                                   ("_vith", fs["fart_h"], fs["plan_h"], xh,
                                    0)):
        blk0, blk1 = fart["blocks"][0], fart["blocks"][1]
        shards0 = [blk0[k].w for k in _SHARDED]
        shards1 = [blk1[k].w for k in _SHARDED]
        moved = sum(s.numel() * s.element_size() for s in shards1)
        full0 = _with_weights(blk0, [_logical(s) for s in shards0])
        args, layer = _mlp_args(full0)
        plain["mlp_gather" + tag] = (
            lambda x=x, args=args, shards1=shards1, layer=layer:
            fused_mlp_gather_plain(x, *args, next_shards=shards1,
                                   out_dtype=torch.bfloat16, **layer))
        yard = {}
        if plan is not None:
            _, _, mlp0, gather1 = plan.blocks[0]
            kern["mlp_gather" + tag] = (
                lambda mlp0=mlp0, gather1=gather1, x=x: run_mlp_gather(
                    mlp0, gather1, x, out_dtype=torch.bfloat16))
            yard["k2_same_plan"] = (lambda mlp0=mlp0, x=x: run_mlp(
                mlp0, x, out_dtype=torch.bfloat16))
        else:
            kern["mlp_gather" + tag] = plain["mlp_gather" + tag]
        m, d = x.shape
        hid = args[0].shape[1]
        kg.append(("fused_mlp_gather", "mlp_gather" + tag, nl,
                   bound(2 * m * d * 2 + 2 * d * hid + 2 * moved,
                         4 * m * d * hid),
                   [(m, d, hid), (m, hid, d)], None, yard))
        if not tag:
            plain["gather_b0"] = lambda shards0=shards0: gather_rows_plain(
                shards0)
            kern["gather_b0"] = (plain["gather_b0"] if plan is None else
                                 lambda plan=plan: run_gather_rows(
                                     plan.boot))
            kg.append(("gather_rows", "gather_b0", 1,
                       bound(2 * sum(s.numel() * s.element_size()
                                     for s in shards0)), [],
                       lambda shards0=shards0: [torch.cat([s])
                                                for s in shards0]))
    # K14's site first, as the kernels line lists them
    return sites + kg[1:2] + kg[:1] + kg[2:]


def overlap_sweep(cfg):
    """tools/exp_rdma_overlap.py's single-chip question (:80-134) on this
    card at tp = 1: K2 alone at M = BATCH x the padded tokens (the
    script's 32 x 208, D 768, hidden 3072, int8, t = 1, top 7), then K15
    on the same plan gathering 4, 8, 16 and 31 MB of dummy int8 shards,
    and K14 alone on the same shards. A flat K15 time means the copy
    hides under the MLP. (Its AOT leg, a TPU v5e topology compile, has no
    counterpart on this card.)"""
    from quantized_vit_tpu_torch.ops import (fused_mlp_gather_plain,
                                             fused_mlp_plain, plan_gather_rows,
                                             plan_mlp, run_gather_rows,
                                             run_mlp, run_mlp_gather)

    _, _, d, _, n_pad, _, hid, _, _ = shapes(cfg)
    m = BATCH * n_pad
    rng = np.random.default_rng(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
        return x.to(dt) if dt else x

    def scal(v):
        return torch.full((), v, dtype=f32, device=DEV)

    x = t(rng.standard_normal((m, d)) * 0.2, bf16)
    w1 = t(rng.integers(-7, 8, (d, hid)).astype(np.int8))
    w2 = t(rng.integers(-7, 8, (hid, d)).astype(np.int8))
    args = (w1, scal(1e-3), t(rng.standard_normal(hid) * 0.01, f32), w2,
            scal(1e-3), t(rng.standard_normal(d) * 0.01, f32))
    kw = dict(ln_scale=torch.ones((d,), device=DEV),
              ln_bias=torch.zeros((d,), device=DEV), act_d=scal(0.05),
              act_t=scal(1.0), act_top=7, act_pow=False, hid_d=scal(0.05),
              hid_t=scal(1.0), hid_top=7, hid_pow=False, fmt="int8")
    cuda = DEV == "cuda"
    plan = plan_mlp(*args, **kw) if cuda else None
    out = {"m": m, "k": d, "hid": hid,
           "k2_us": 1e3 * cuda_ms(
               (lambda: run_mlp(plan, x)) if cuda else
               (lambda: fused_mlp_plain(x, *args, **kw))), "sweep": {}}
    for mb in OVERLAP_MB:
        rows = (mb * 2**20) // d
        rows -= rows % 32
        dummy = torch.randint(-7, 8, (rows, d), dtype=torch.int8, device=DEV)
        if cuda:
            gp = plan_gather_rows([dummy])
            k15 = cuda_ms(lambda: run_mlp_gather(plan, gp, x))
            k14 = cuda_ms(lambda: run_gather_rows(gp))
            del gp
        else:
            k15 = cuda_ms(lambda: fused_mlp_gather_plain(
                x, *args, next_shards=[dummy], **kw))
            k14 = None
        out["sweep"][f"{mb}MB"] = {
            "k15_us": k15 * 1e3, "k15_minus_k2_us": k15 * 1e3 - out["k2_us"],
            "k14_alone_us": None if k14 is None else k14 * 1e3,
            "bytes": rows * d}
        del dummy
    log(f"[time] overlap sweep (M {m}): K2 {out['k2_us']:.1f} us; " +
        ", ".join(f"K15 + {k} {v['k15_us']:.1f} us (K14 alone "
                  f"{v['k14_alone_us'] or 0:.1f})"
                  for k, v in out["sweep"].items()))
    return out


def sdpa_call(b, heads, nq, nk, hd, g):
    """scaled_dot_product_attention on q [b, heads, nq, hd] and k = v
    [b, heads, nk, hd] in bf16: a yardstick (no exp2 clamp, no quantizing
    epilogue) the port never calls."""
    import torch.nn.functional as F

    qq = torch.randn((b, heads, nq, hd), generator=g, device=DEV).to(
        torch.bfloat16)
    kk = torch.randn((b, heads, nk, hd), generator=g, device=DEV).to(
        torch.bfloat16)
    return lambda: F.scaled_dot_product_attention(qq, kk, kk)


def vit_h_sites(vh, kern, plain, bound, fp64_flop):
    """The ViT-H/14 phase's timing sites, added to ``kern``/``plain``: K8
    per launch at batch 1 (32 launches a forward) and 2; K1's patch embed
    (K = 588), chain qkv and fc1/fc2 chain at batch 32; K3 at batch 32 and
    K6 at batch 1 and 2 (head_dim 80; the attention FLOP of K3's and K6's
    sites into ``fp64_flop``). Only
    K8's batch-1 site counts launches: the ViT-B forward's per-forward
    totals stay ViT-B's."""
    from quantized_vit_tpu_torch.ops import (attention_heads_plain,
                                             attention_qkv_plain,
                                             fused_mlp_plain,
                                             fused_quant_matmul_plain,
                                             run_attention_heads,
                                             run_attention_qkv, run_matmul,
                                             run_mlp, run_mlp_chunked)
    from quantized_vit_tpu_torch.ops.fused import plan_mlp, plan_mlp_chunked
    from quantized_vit_tpu_torch.quant import pack_int4
    from quantized_vit_tpu_torch.serve.vit_int4 import (_attention_layer,
                                                        _mlp_layer)

    cfg, art, plan = vh["cfg"], vh["art"], vh["plan"]
    p, d, n_real, n_pad, hid, heads = vit_h_shapes(cfg)
    hd = d // heads
    kp = cfg.patch_size**2 * cfg.in_channels
    bb = max(VIT_H_BATCHES)
    mb = bb * n_pad
    bf16 = torch.bfloat16
    blk = art["blocks"][0]
    g = torch.Generator(device=DEV).manual_seed(3)
    xs = torch.randn((mb, d), generator=g, device=DEV).to(bf16)
    hlv = torch.randint(-7, 8, (mb, hid), dtype=torch.int8, device=DEV,
                        generator=g)
    qkvs = {b: (torch.randn((b, n_pad, 3 * d), generator=g, device=DEV)
                * 0.7).to(bf16) for b in (1, 2)}
    xpatch = vh["x"][:bb].reshape(bb * p, kp)
    mlp_kw = dict(_mlp_layer(blk), out_dtype=bf16)
    attn_kw = dict(_attention_layer(blk, hd, hd**-0.5), n_valid=n_real,
                   out_dtype=bf16)
    qkv_kw = dict(heads=heads, sm_scale=hd**-0.5, n_valid=n_real,
                  out_d=blk["proj"].act["d"], out_t=blk["proj"].act["t"],
                  out_top=blk["proj"].top, out_pow=blk["proj"].act_pow,
                  out_dtype=bf16)
    e = {k: blk[k] for k in ("qkv", "proj", "fc1", "fc2")}
    # the attention's levels, the chain proj's input
    alv = torch.randint(-7, 8, (2 * n_pad, d), dtype=torch.int8,
                        device=DEV, generator=g)
    pe = art["patch_embed"]

    def q(le):
        return dict(act_d=le.act["d"], act_t=le.act["t"], act_top=le.top,
                    act_pow=le.act_pow)

    def mlp_plain(m):
        return lambda: fused_mlp_plain(
            xs[:m], e["fc1"].w, e["fc1"].scale, e["fc1"].bias, e["fc2"].w,
            e["fc2"].scale, e["fc2"].bias, **mlp_kw)

    # K2 on block 0's weights packed to int4 (the packed artifact's
    # format), which its first design refused at K = 1280
    w4 = [pack_int4(e[k].w, axis=0) for k in ("fc1", "fc2")]
    mlp4_kw = dict(mlp_kw, fmt="int4", fmt2="int4")
    for bk in (1, 2):
        plain[f"vith_mlp_int4_b{bk}"] = (
            lambda m=bk * n_pad: fused_mlp_plain(
                xs[:m], w4[0], e["fc1"].scale, e["fc1"].bias, w4[1],
                e["fc2"].scale, e["fc2"].bias, **mlp4_kw))

    # K8 past its first design's width limit (K = 1536 at ViT-H/14's),
    # random int8 levels, beside K2 on the same weights
    wide = 6 * d // 5
    gw = np.random.default_rng(11)
    wkw = dict(mlp_kw, fmt="int8", fmt2="int8")
    ww = [torch.from_numpy(gw.integers(-7, 8, shp).astype(np.int8)).to(DEV)
          for shp in ((wide, 4 * wide), (4 * wide, wide))]
    wsb = [torch.full((), 1e-3, device=DEV), None]
    wln = dict(ln_scale=torch.ones(wide, device=DEV),
               ln_bias=torch.zeros(wide, device=DEV))
    xw = torch.randn((bb * n_pad, wide), generator=g, device=DEV).to(bf16)
    wkw.update(wln)
    for bk in (1, 2):
        plain[f"vith_wide_mlp_b{bk}"] = (
            lambda m=bk * n_pad: fused_mlp_plain(
                xw[:m], ww[0], wsb[0], wsb[1], ww[1], wsb[0], wsb[1], **wkw))
        plain[f"vith_wide_mlp_k2_b{bk}"] = plain[f"vith_wide_mlp_b{bk}"]
        plain[f"vith_mlp_k2_b{bk}"] = mlp_plain(bk * n_pad)
    plain.update({
        "vith_mlp_b1": mlp_plain(n_pad), "vith_mlp_b2": mlp_plain(2 * n_pad),
        "vith_patch_embed_b32": lambda: fused_quant_matmul_plain(
            xpatch, pe.w, pe.scale, pe.bias, fmt=pe.fmt, prologue="quant",
            out_dtype=torch.float32, **q(pe)),
        **{f"vith_chain_qkv_b{bk}": (
            lambda m=bk * n_pad: fused_quant_matmul_plain(
                xs[:m], e["qkv"].w, e["qkv"].scale, e["qkv"].bias,
                fmt="int8", prologue="ln_quant",
                ln_scale=blk["norm1"]["scale"],
                ln_bias=blk["norm1"]["bias"], out_dtype=bf16,
                **q(e["qkv"]))) for bk in (1, 2)},
        **{f"vith_chain_proj_b{bk}": (
            lambda m=bk * n_pad: fused_quant_matmul_plain(
                alv[:m], e["proj"].w, e["proj"].scale, e["proj"].bias,
                fmt="int8", prologue=None, epilogue="residual",
                residual=xs[:m], out_dtype=bf16)) for bk in (1, 2)},
        "vith_fc1_b32": lambda: fused_quant_matmul_plain(
            xs, e["fc1"].w, e["fc1"].scale, e["fc1"].bias, fmt="int8",
            prologue="ln_quant", ln_scale=blk["norm2"]["scale"],
            ln_bias=blk["norm2"]["bias"], epilogue="gelu_quant",
            out_d=e["fc2"].act["d"], out_t=e["fc2"].act["t"],
            out_top=e["fc2"].top, out_pow=e["fc2"].act_pow, **q(e["fc1"])),
        "vith_fc2_b32": lambda: fused_quant_matmul_plain(
            hlv, e["fc2"].w, e["fc2"].scale, e["fc2"].bias, fmt="int8",
            prologue=None, epilogue="residual", residual=xs, out_dtype=bf16),
        "vith_heads_b32": lambda: attention_heads_plain(
            xs.reshape(bb, n_pad, d), e["qkv"].w, e["qkv"].scale,
            e["qkv"].bias, **attn_kw),
        "vith_qkv_attn_b1": lambda: attention_qkv_plain(qkvs[1], **qkv_kw),
        "vith_qkv_attn_b2": lambda: attention_qkv_plain(qkvs[2], **qkv_kw),
    })
    if plan is None:  # CPU rehearsal: the plain versions
        kern.update({k: plain[k] for k in plain if k.startswith("vith_")})
    else:
        attn_p, mlps = plan.blocks[0]
        p4 = plan_mlp(w4[0], e["fc1"].scale, e["fc1"].bias, w4[1],
                      e["fc2"].scale, e["fc2"].bias,
                      **{k: v for k, v in mlp4_kw.items()
                         if k != "out_dtype"})
        pkw = {k: v for k, v in wkw.items() if k != "out_dtype"}
        pw8 = plan_mlp_chunked(ww[0], wsb[0], wsb[1], ww[1], wsb[0], wsb[1],
                               **pkw)
        pw2 = plan_mlp(ww[0], wsb[0], wsb[1], ww[1], wsb[0], wsb[1], **pkw)
        for bk in (1, 2):
            kern[f"vith_mlp_int4_b{bk}"] = (
                lambda m=bk * n_pad: run_mlp(p4, xs[:m], out_dtype=bf16))
            kern[f"vith_mlp_k2_b{bk}"] = (
                lambda m=bk * n_pad: run_mlp(mlps.resident, xs[:m],
                                             out_dtype=bf16))
            kern[f"vith_wide_mlp_b{bk}"] = (
                lambda m=bk * n_pad: run_mlp_chunked(pw8, xw[:m],
                                                     out_dtype=bf16))
            kern[f"vith_wide_mlp_k2_b{bk}"] = (
                lambda m=bk * n_pad: run_mlp(pw2, xw[:m], out_dtype=bf16))
        kern.update({
            "vith_mlp_b1": lambda: run_mlp_chunked(mlps.chunked, xs[:n_pad],
                                                   out_dtype=bf16),
            "vith_mlp_b2": lambda: run_mlp_chunked(
                mlps.chunked, xs[:2 * n_pad], out_dtype=bf16),
            "vith_patch_embed_b32": lambda: run_matmul(
                plan.embed["patches"][0], xpatch, out_dtype=torch.float32),
            **{f"vith_chain_qkv_b{bk}": (
                lambda m=bk * n_pad: run_matmul(plan.chain[0][0], xs[:m],
                                                out_dtype=bf16))
               for bk in (1, 2)},
            **{f"vith_chain_proj_b{bk}": (
                lambda m=bk * n_pad: run_matmul(
                    attn_p.proj, alv[:m], residual=xs[:m], out_dtype=bf16))
               for bk in (1, 2)},
            "vith_fc1_b32": lambda: run_matmul(mlps.fc1, xs),
            "vith_fc2_b32": lambda: run_matmul(mlps.fc2, hlv, residual=xs,
                                               out_dtype=bf16),
            "vith_heads_b32": lambda: run_attention_heads(
                attn_p.heads, xs.reshape(bb, n_pad, d), n_valid=n_real,
                out_dtype=bf16),
            "vith_qkv_attn_b1": lambda: run_attention_qkv(
                plan.chain[0][1], qkvs[1], n_valid=n_real, out_dtype=bf16),
            "vith_qkv_attn_b2": lambda: run_attention_qkv(
                plan.chain[0][1], qkvs[2], n_valid=n_real, out_dtype=bf16),
        })
    nk = -(-n_real // 16) * 16
    attn_ops = 2 * heads * n_pad * nk * hd * 2  # one image's QK^T and PV
    fp64_flop.update({f"vith_qkv_attn_b{bk}": bk * attn_ops
                      for bk in (1, 2)})
    fp64_flop["vith_heads_b32"] = bb * attn_ops

    def mlp_bound(m, wbytes=1):
        return bound(2 * m * d * 2 + 2 * d * hid * wbytes, 4 * m * d * hid)

    return [
        ("fused_mlp", "vith_mlp_int4_b1", 0, mlp_bound(n_pad, 0.5),
         [(n_pad, d, hid), (n_pad, hid, d)], None),
        ("fused_mlp", "vith_mlp_int4_b2", 0, mlp_bound(2 * n_pad, 0.5),
         [(2 * n_pad, d, hid), (2 * n_pad, hid, d)], None),
        ("fused_mlp_chunked", "vith_mlp_b1", cfg.depth, mlp_bound(n_pad),
         [(n_pad, d, hid), (n_pad, hid, d)], None),
        ("fused_mlp_chunked", "vith_mlp_b2", 0, mlp_bound(2 * n_pad),
         [(2 * n_pad, d, hid), (2 * n_pad, hid, d)], None),
        # K2 on the same int8 plan (the same function), K8's yardstick
        *[("fused_mlp", f"vith_mlp_k2_b{bk}", 0, mlp_bound(bk * n_pad),
           [(bk * n_pad, d, hid), (bk * n_pad, hid, d)], None)
          for bk in (1, 2)],
        # K = 1536 (H 6144): K8 past its first design's width, K2 beside
        *[(kn, f"vith_wide_mlp{sfx}_b{bk}", 0, bound(
            2 * bk * n_pad * wide * 2 + 2 * wide * 4 * wide,
            4 * bk * n_pad * wide * 4 * wide),
           [(bk * n_pad, wide, 4 * wide), (bk * n_pad, 4 * wide, wide)],
           None) for bk in (1, 2)
          for kn, sfx in (("fused_mlp_chunked", ""), ("fused_mlp", "_k2"))],
        ("fused_quant_matmul", "vith_patch_embed_b32", 0,
         bound(bb * p * kp * 4 + kp * d + bb * p * d * 4,
               2 * bb * p * kp * d), [(bb * p, kp, d)], None),
        *[("fused_quant_matmul", f"vith_chain_qkv_b{bk}", 0,
           bound(bk * n_pad * d * 2 + 3 * d * d + bk * n_pad * 3 * d * 2,
                 2 * bk * n_pad * d * 3 * d), [(bk * n_pad, d, 3 * d)],
           None) for bk in (1, 2)],
        *[("fused_quant_matmul", f"vith_chain_proj_b{bk}", 0,
           bound(bk * n_pad * d + d * d + 2 * bk * n_pad * d * 2,
                 2 * bk * n_pad * d * d), [(bk * n_pad, d, d)], None)
          for bk in (1, 2)],
        ("fused_quant_matmul", "vith_fc1_b32", 0,
         bound(mb * d * 2 + d * hid + mb * hid, 2 * mb * d * hid),
         [(mb, d, hid)], None),
        ("fused_quant_matmul", "vith_fc2_b32", 0,
         bound(mb * hid + hid * d + 2 * mb * d * 2, 2 * mb * hid * d),
         [(mb, hid, d)], None),
        ("attention_block", "vith_heads_b32", 0,
         bound(mb * d * 2 + 3 * d * d + mb * d, 2 * mb * d * 3 * d,
               bb * attn_ops), [(mb, d, 3 * d)], None),
        ("attention_qkv", "vith_qkv_attn_b1", 0,
         bound(n_pad * 3 * d * 2 + n_pad * d, 0, attn_ops), [],
         sdpa_call(1, heads, n_pad, nk, hd, g)),
        ("attention_qkv", "vith_qkv_attn_b2", 0,
         bound(2 * n_pad * 3 * d * 2 + 2 * n_pad * d, 0, 2 * attn_ops), [],
         sdpa_call(2, heads, n_pad, nk, hd, g)),
    ]


# ---------------------------------------------------------------------------
# phase 6: QAT + GETA training, full width
# ---------------------------------------------------------------------------


class StepProbe:
    """The optimizer as the training loop sees it: per step, the K7
    launches of the step's backward (read when the loop clips the
    gradients), GETA.step's host time (until it returns) and its time to
    the end of its device work, and the schedule's state after the step."""

    def __init__(self, opt):
        self.opt = opt
        self.rows = []
        self._seen = 0
        self._gc_ms = 0.0
        self._gc_t0 = 0.0

    def gc_callback(self, phase, info):
        """Python's garbage collections, timed (a share of GETA.step's
        host time)."""
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self._gc_ms += (time.perf_counter() - self._gc_t0) * 1e3

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def _active(self):
        return any(st["active_redundant"] for st in self.opt.state.values())

    def clip_grads(self, grads):
        from quantized_vit_tpu_torch.ops import _build

        n = _build.LAUNCHES["quant_bwd"]
        self.rows.append({"k7_launches": n - self._seen})
        self._seen = n
        return self.opt.clip_grads(grads)

    def step(self, params, grads):
        active = self._active()
        self._gc_ms = 0.0
        t0 = time.perf_counter()
        out = self.opt.step(params, grads)
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        o = self.opt
        self.rows[-1].update(
            step=o.num_steps, geta_host_ms=(t1 - t0) * 1e3,
            geta_ms=(t2 - t0) * 1e3, gc_ms=self._gc_ms,
            max_bit_wt=o.max_bit_wt,
            pruning_period=o.curr_pruning_period,
            prune_mode=active or self._active(),
            n_pruned=len(o.pruned_group_idxes),
            bits_frozen=bool(o.bit_layers))
        return out


def phase_of(n):
    g = GETA_KW
    if n <= g["start_projection_step"]:
        return "warmup"
    if n > g["start_pruning_step"] + g["pruning_steps"]:
        return "fix"
    return "range"


def train_phase(dev, record, peaks):
    """ViT-B/16 QAT (fused_vjp: K7 for every nonlinear quantizer's
    backward) with GETA at batch BATCH, driven by TrainLoop through
    warmup, range projection, two pruning periods and fix; then evaluate,
    a checkpoint round trip, the plain chain against K7 on one step, and
    the timings."""
    import dataclasses

    from quantized_vit_tpu_torch.graph import OTO
    from quantized_vit_tpu_torch.models import (QuantConfig,
                                                VisionTransformer, apply,
                                                flatten_tree,
                                                init_quant_params_tree,
                                                tree_map)
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.opt import (GETA, load_checkpoint,
                                             save_checkpoint)
    from quantized_vit_tpu_torch.utils import (ArrayDataset, DataLoader,
                                               TrainLoop, evaluate)

    t_phase = time.time()
    base = main_cfg()
    cfg = dataclasses.replace(
        base, quant=QuantConfig(enabled=True, fused_vjp=True))
    model = VisionTransformer(cfg, seed=0, device=dev)
    # the quantizer scalars at 32 bits, as cli/train.py initialises them
    params = init_quant_params_tree(
        tree_map(lambda p: p.detach().clone(), model.param_tree()),
        init_bits=32.0)
    init_params = tree_map(lambda p: p.clone(), params)
    rng = np.random.default_rng(0)
    hw = (cfg.img_size, cfg.img_size, cfg.in_channels)
    images = rng.standard_normal((TRAIN_STEPS * BATCH, *hw),
                                 dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, TRAIN_STEPS * BATCH)
    held_x = rng.standard_normal((2 * BATCH - 3, *hw), dtype=np.float32)
    held_y = rng.integers(0, cfg.num_classes, 2 * BATCH - 3)

    oto = OTO(model, params)
    oto.mark_unprunable_by_param_names(["patch_embed", "pos_embed",
                                        "cls_token", "head"])
    opt = oto.geta(**GETA_KW)
    probe = StepProbe(opt)
    gen = torch.Generator(device=dev).manual_seed(0)

    def train_apply(p, x, g):
        return apply(model, p, x, deterministic=False, generator=g)

    loop = TrainLoop(apply_fn=train_apply, optimizer=probe,
                     num_classes=cfg.num_classes, device=dev)
    loader = DataLoader(ArrayDataset(images, labels), BATCH, shuffle=True,
                        seed=0)
    gc.callbacks.append(probe.gc_callback)
    _build.reset_launches()
    try:
        # under a CUDA trace: K7's device time over the launches counted
        (params, tm), kern = traced(
            lambda: loop.train_one_epoch(params, loader, 0, gen))
    finally:
        gc.callbacks.remove(probe.gc_callback)
    launches = dict(_build.LAUNCHES)
    steps = tm["steps"]
    ev = evaluate(lambda p, x: apply(model, p, x), params,
                  DataLoader(ArrayDataset(held_x, held_y), BATCH,
                             pad_last=True), device=dev)
    metrics = opt.compute_metrics(params)
    bits_now = opt.bitwidth_dict(params)
    out = {"steps": steps, "losses": tm["step_losses"],
           "seconds": tm["seconds"], "per_step": probe.rows,
           "phases": [phase_of(r["step"]) for r in probe.rows],
           "launches": launches, "eval": ev,
           "group_sparsity": metrics["group_sparsity"],
           "num_zero_groups": metrics["num_zero_groups"],
           "target_redundant_groups": opt.target_num_redundant_groups,
           "bit_layers_frozen": opt.bit_layers == bits_now,
           "bit_layers": opt.bit_layers, "k7_trace": k7_in_trace(kern)}
    del kern
    record["train"] = out
    log(f"[train] {steps} steps, losses {[round(v, 4) for v in out['losses']]}"
        f", {tm['seconds']:.1f} s; phases {out['phases']}")
    for r in probe.rows:
        log(f"  step {r['step']:2d} K7 {r['k7_launches']:3d} GETA host "
            f"{r['geta_host_ms']:.1f} ms (gc {r['gc_ms']:.1f}) total "
            f"{r['geta_ms']:.1f} ms "
            f"max_bit {r['max_bit_wt']} period {r['pruning_period']} prune "
            f"{r['prune_mode']} pruned {r['n_pruned']}")
    log(f"[train] K7 in the run's trace: {out['k7_trace']}")
    log(f"[train] sparsity {metrics['group_sparsity']:.4f} "
        f"({metrics['num_zero_groups']} of {opt.total_num_groups} groups, "
        f"target {opt.target_num_redundant_groups}); eval {ev}")
    per_step = sum(n for _, _, n in k7_sites(cfg))
    if steps != TRAIN_STEPS or not all(np.isfinite(out["losses"])):
        raise Failed(f"training: {steps} steps, losses {out['losses']}")
    if not all(np.isfinite([ev["loss"], ev["top1"], ev["top5"]])):
        raise Failed(f"evaluate: {ev}")
    if dev.type == "cuda" and (
            any(r["k7_launches"] != per_step for r in probe.rows)
            or launches["quant_bwd"] != per_step * steps):
        raise Failed(f"K7 launches per step "
                     f"{[r['k7_launches'] for r in probe.rows]} != "
                     f"{per_step}")
    if metrics["num_zero_groups"] != opt.target_num_redundant_groups:
        raise Failed(f"group sparsity: {metrics['num_zero_groups']} zero "
                     f"groups, target {opt.target_num_redundant_groups}")
    ramps = [r["max_bit_wt"] for r in probe.rows]
    if (set(out["phases"]) != {"warmup", "range", "fix"}
            or min(ramps) >= GETA_KW["max_bit_wt"]
            or probe.rows[-1]["pruning_period"] < 2
            or sum(r["prune_mode"] for r in probe.rows) < 2
            or not opt.bit_layers or not out["bit_layers_frozen"]):
        raise Failed(f"schedule not walked: {probe.rows}")

    # checkpoint round trip
    path = os.path.join(TRAIN_CKPT, f"ckpt_{opt.num_steps}")
    save_checkpoint(path, params, opt.state_dict(), {"steps": steps})
    params2, state2, extra2 = load_checkpoint(path, device=dev)
    opt2 = GETA(oto.node_groups, params2, opt.cfg)
    opt2.load_state_dict(state2)
    flat, flat2 = flatten_tree(params), flatten_tree(params2)
    m1, m12 = flatten_tree(opt.m1), flatten_tree(opt2.m1)
    ckpt_ok = (set(flat) == set(flat2)
               and all(torch.equal(flat[k], flat2[k]) for k in flat)
               and all(torch.equal(m1[k], m12[k]) for k in m1)
               and opt2.num_steps == opt.num_steps
               and opt2.bit_layers == opt.bit_layers
               and opt2.pruned_group_idxes == opt.pruned_group_idxes
               and extra2 == {"steps": steps})
    out["checkpoint_roundtrip"] = ckpt_ok
    log(f"[train] checkpoint round trip {ckpt_ok}")
    if not ckpt_ok:
        raise Failed("checkpoint round trip")
    del params2, opt2, state2, flat2, m12

    # the plain chain against K7 on one step: same params, batch and card
    x0 = torch.from_numpy(images[:BATCH]).to(dev)
    y0 = torch.from_numpy(labels[:BATCH]).to(dev)
    model_plain = VisionTransformer(dataclasses.replace(
        base, quant=QuantConfig(enabled=True, fused_vjp=False)), device=dev)
    loop_plain = TrainLoop(
        apply_fn=lambda p, x, g: apply(model_plain, p, x,
                                       deterministic=False, generator=g),
        optimizer=opt, num_classes=cfg.num_classes, device=dev)
    out["plain_vs_k7"], sites = compare_plain_step(loop, loop_plain, params,
                                                   x0, y0)
    if not out["plain_vs_k7"]["ok"]:
        raise Failed(f"plain chain vs K7 step: {out['plain_vs_k7']}")

    train_timing(dev, record, peaks, cfg, loop, loop_plain, opt, params,
                 x0, y0, steps, sites)
    out["phase_s"] = round(time.time() - t_phase, 1)
    log(f"[train] phase {out['phase_s']} s")
    return {"oto": oto, "params": params, "init": init_params,
            "images": images[:BATCH]}


def compare_plain_step(loop, loop_plain, params, x, y):
    """One step's loss and gradients with K7 and with the plain chain:
    the losses equal, every gradient but the quantizer scalars'
    bit-identical, each d/q_m/t gradient within 1e-5 of the L1 mass of its
    summands (recorded from the plain chain's terms). Returns the result
    and the step's quantizer sites: the inputs of each backward, (path,
    (x, g, d, q_m, t), keywords), for the timings."""
    from quantized_vit_tpu_torch.models import flatten_tree
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.ops import quant_vjp

    ptr_path = {v.data_ptr(): k for k, v in flatten_tree(params).items()
                if k.rsplit("/", 1)[-1].startswith("d_quant")}
    masses = {}
    sites = []
    plain = quant_vjp.lsfq_nonlinear_bwd_plain

    def recording(x_, g_, d_, q_m_, t_, **kw):
        terms = quant_vjp.nonlinear_bwd_terms(x_, g_, d_, q_m_, t_, **kw)
        path = ptr_path[d_.data_ptr()]
        masses[path] = [float(v.abs().sum(dtype=torch.float64))
                        for v in terms[1:]]
        sites.append((path, (x_, g_, d_, q_m_, t_), kw))
        return plain(x_, g_, d_, q_m_, t_, **kw)

    before = _build.LAUNCHES["quant_bwd"]
    loss_f, _, grads_f = loop.loss_and_grads(params, x, y)
    sync()
    k7_launches = _build.LAUNCHES["quant_bwd"] - before
    quant_vjp.lsfq_nonlinear_bwd_plain = recording
    try:
        loss_p, _, grads_p = loop_plain.loss_and_grads(params, x, y)
        sync()
    finally:
        quant_vjp.lsfq_nonlinear_bwd_plain = plain
    gf, gp = flatten_tree(grads_f), flatten_tree(grads_p)
    exact = scalar_exact = 0
    differ, worst = [], 0.0
    for k in gf:
        layer, _, leaf = k.rpartition("/")
        if leaf.startswith(("d_quant", "q_m", "t_quant")):
            suffix = leaf.rsplit("_", 1)[-1]
            which = ("d_quant", "q_m", "t_quant").index(
                leaf[:-len(suffix) - 1])
            mass = masses[f"{layer}/d_quant_{suffix}"][which]
            err = float((gf[k] - gp[k]).abs().max())
            scalar_exact += err == 0.0
            worst = max(worst, err / mass if mass else err)
            if err > 1e-5 * mass:
                differ.append(k)
        elif torch.equal(gf[k], gp[k]):
            exact += 1
        else:
            differ.append(k)
    n_scalar = sum(1 for k in gf if k.rsplit("/", 1)[-1].startswith(
        ("d_quant", "q_m", "t_quant")))
    res = {"loss_equal": bool(torch.equal(loss_f, loss_p)),
           "loss": float(loss_f), "grads_bit_identical": exact,
           "grads_other": len(gf) - n_scalar,
           "quant_scalar_grads": n_scalar,
           "quant_scalar_grads_exact": scalar_exact,
           "quant_scalar_max_err_over_l1": worst,
           "k7_launches": k7_launches, "failing": differ[:10]}
    res["ok"] = (res["loss_equal"] and not differ
                 and len(masses) == n_scalar // 3)
    log(f"[train] plain chain vs K7 step: {res}")
    return res, sites


def time_k7_sites(record, peaks, sites):
    """K7 and its plain version on the inputs of every quantizer site of
    one training step (``compare_plain_step``'s capture), grouped by
    shape: per launch, the median over the group's sites of CUDA events
    around one call, and the kernels' device time from one torch.profiler
    trace of the whole group; with the bound; and each summed over the
    step's launches."""
    from quantized_vit_tpu_torch.ops.quant_vjp import (
        lsfq_nonlinear_bwd_fused, lsfq_nonlinear_bwd_plain)

    bw = peaks[2]
    f32_peak = next((v for k, v in F32_PEAKS.items()
                     if k in record["device"]), F32_PEAKS["SXM"])
    groups = {}
    for site in sites:
        groups.setdefault(tuple(site[1][0].shape), []).append(site)
    by_shape = {}
    for shape, ss in groups.items():
        n = int(np.prod(shape))
        # 12 bytes per element (x, g read; grad_x written); 25 f32
        # operations per element (the TPU kernel's cost estimate)
        t_mem, t_ops = 12 * n / bw, 25 * n / f32_peak

        def each(fn):
            return lambda: [fn(*a, **kw) for _, a, kw in ss]

        k7 = each(lsfq_nonlinear_bwd_fused)
        pl = each(lsfq_nonlinear_bwd_plain)
        dev_k7 = kernel_device_us(k7, reps=5)
        dev_pl = kernel_device_us(pl, reps=2)
        by_shape[shape] = {
            "sites": [p.rsplit("/", 1)[0] + "/" + p.rsplit("_", 1)[-1]
                      for p, _, _ in ss],
            "us": statistics.median(
                cuda_ms(lambda: lsfq_nonlinear_bwd_fused(*a, **kw)) * 1e3
                for _, a, kw in ss),
            # the kernels' own time on the card, without the host work
            # between launches that the events above enclose
            "device_us": None if dev_k7 is None else dev_k7 / len(ss),
            "plain_us": statistics.median(
                cuda_ms(lambda: lsfq_nonlinear_bwd_plain(*a, **kw),
                        iters=5, warmup=1) * 1e3 for _, a, kw in ss),
            "plain_device_us": None if dev_pl is None else dev_pl / len(ss),
            "bound_us": max(t_mem, t_ops) * 1e6,
            "bound_by": "bytes" if t_mem >= t_ops else "operations"}
    per_step = {}  # ms over the step's launches; None off the card
    for k in ("us", "device_us", "plain_us", "plain_device_us", "bound_us"):
        vals = [v[k] and v[k] * len(v["sites"]) for v in by_shape.values()]
        per_step[k] = None if None in vals else sum(vals) / 1e3
    for shape, v in by_shape.items():
        log(f"[time] quant_bwd {'x'.join(map(str, shape)):16s} "
            f"{v['us']:8.1f} us (device {v['device_us']})  plain "
            f"{v['plain_us']:8.1f} (device {v['plain_device_us']})  bound "
            f"{v['bound_us']:6.1f} ({v['bound_by']})  {len(v['sites'])} "
            f"sites")
    log(f"[time] quant_bwd on one step's {len(sites)} sites (ms): {per_step}")
    return by_shape, per_step


def train_timing(dev, record, peaks, cfg, loop, loop_plain, opt, params, x,
                 y, steps, sites):
    """K7 per launch at each quantizer site of a training step, on that
    step's inputs, against its bound and its plain version; the whole
    training step with K7 and with the plain chain (in turns: plain, K7,
    K7, plain); a plain PyTorch ViT-B/16 training step (f32 and bf16
    autocast, torch.optim.Adam) as the yardstick."""
    by_shape, per_step = time_k7_sites(record, peaks, sites)
    sites.clear()  # the captured activations and cotangents

    def step_times(lp):
        """ms of forward + backward, clip_grads, GETA.step (host share
        and to the end of its device work), one step."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if dev.type == "cuda" else None
        sync()
        h0 = time.perf_counter()
        if ev:
            ev[0].record()
        _, _, grads = lp.loss_and_grads(params, x, y)
        if ev:
            ev[1].record()
        grads = opt.clip_grads(grads)
        sync()
        h1 = time.perf_counter()
        opt.step(params, grads)  # a fix-phase step; the result is dropped
        h2 = time.perf_counter()
        if ev:
            ev[2].record()
        sync()
        h3 = time.perf_counter()
        fb = ev[0].elapsed_time(ev[1]) if ev else (h1 - h0) * 1e3
        return {"fwd_bwd_ms": fb, "to_geta_ms": (h1 - h0) * 1e3,
                "geta_host_ms": (h2 - h1) * 1e3,
                "geta_ms": (h3 - h1) * 1e3, "step_ms": (h3 - h0) * 1e3}

    reps = 3 if dev.type == "cuda" else 1
    runs = {"plain": [], "k7": []}
    step_times(loop)  # warm-up
    step_times(loop_plain)
    for which in ("plain", "k7", "k7", "plain"):
        lp = loop if which == "k7" else loop_plain
        runs[which] += [step_times(lp) for _ in range(reps)]
    step = {w: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
            for w, rs in runs.items()}
    prof = {w: profile_step(lambda: step_times(lp))
            for w, lp in (("k7", loop), ("plain", loop_plain))}
    for w, pr in prof.items():
        if pr is not None:  # against the step without the profiler
            pr["idle_share_of_step"] = max(
                0.0, 1.0 - pr["kernel_ms"] / step[w]["step_ms"])
    yard = {"f32_ms": cuda_ms(torch_vit_train_step(cfg, x, y, False),
                              iters=5, warmup=2),
            "bf16_autocast_ms": cuda_ms(torch_vit_train_step(cfg, x, y, True),
                                        iters=5, warmup=2)}
    record["train_timing"] = {"k7_by_shape": {
        "x".join(map(str, s)): v for s, v in by_shape.items()},
        "k7_per_step_ms": per_step, "step": step, "runs": runs,
        "step_profile": prof,
        "torch_vit_train_step": yard, "batch": BATCH}
    log(f"[time] train step b{BATCH}: K7 {step['k7']} ; plain chain "
        f"{step['plain']} ; plain PyTorch ViT step f32 "
        f"{yard['f32_ms']:.1f} ms, bf16 autocast "
        f"{yard['bf16_autocast_ms']:.1f} ms")
    for w, pr in prof.items():
        if pr is not None:
            log(f"[time] {w} step profile: wall {pr['wall_ms']:.1f} ms, "
                f"kernels {pr['kernel_ms']:.1f} ms ({pr['kernels']} "
                f"launches), idle {pr['idle_share']:.3f} (of the "
                f"unprofiled step {pr['idle_share_of_step']:.3f}); top "
                f"{[(n[:40], round(ms, 2), c) for n, ms, c in pr['top']]}")

    errs = [r for r in record["parity"]
            if r["kernel"] == "quant_bwd" and "small" not in r["case"]]
    train = record["train"]
    trace = train["k7_trace"]
    per_run = sorted({r["k7_launches"] for r in train["per_step"]})
    plain_step = (per_step["plain_device_us"] if per_step["plain_device_us"]
                  is not None else per_step["plain_us"])
    by = lambda key: {"x".join(map(str, s)): v[key]  # noqa: E731
                      for s, v in by_shape.items()}
    record["kernels"].append({
        "name": "quant_bwd", "route": "cuda",
        "source": "quantized_vit_tpu_torch/csrc/quant_bwd.cu",
        "replaces": "quantized_vit_tpu/ops/quant_vjp.py:172",
        # counted over the training run (TRAIN_STEPS steps)
        "launches": train["launches"]["quant_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in errs),
        "share_differ": max(r["share_differ"] for r in errs),
        "bit_exact": all(r["bit_exact"] for r in errs),
        # K7's device time over those launches, from the run's CUDA trace
        # (off the card: one step's sites timed with events, times steps)
        "ms": trace["device_ms"] if trace else per_step["us"] * steps,
        "ms_from": ("trace of the training run" if trace
                    else "one step's sites x steps"),
        # the run launched no plain chain: the plain version's device time
        # on one training step's site inputs, times the run's steps
        "plain_ms": plain_step * steps,
        "plain_ms_from": "one step's sites x steps",
        # every step quantizes the same sites (the launch check holds it)
        "bound_ms": per_step["bound_us"] * steps, "bound_by": "bytes",
        "library_ms": None,
        "launches_per_step": per_run[0] if len(per_run) == 1 else per_run,
        "ms_per_step": {
            "trace": trace["device_ms"] / steps if trace else None,
            "sites_device": per_step["device_us"],
            "sites_events": per_step["us"],
            "profiled_step": (prof["k7"] or {}).get("quant_bwd_ms")},
        "device_us_per_launch": by("device_us"),
        "us_per_launch": by("us"), "plain_us_per_launch": by("plain_us"),
        "bound_us_per_launch": by("bound_us"),
    })


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def traced(fn):
    """``fn()`` under torch.profiler's CUDA trace: (its result, the
    trace's kernel events); no trace (None) off the card."""
    if DEV != "cuda":
        return fn(), None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    return out, _kernel_events(prof)


def k7_in_trace(kern):
    """K7's launches (its main kernel's count) and device ms (both of its
    kernels) in a trace's kernel events; None without them."""
    k7 = [e for e in kern or () if "quant_bwd" in e.name]
    if not k7:
        return None
    return {"launches": sum("quant_bwd_kernel" in e.name for e in k7),
            "device_ms": sum(e.device_time_total for e in k7) / 1e3,
            "kernels_in_trace": len(kern)}


def host_split(fn, us, reps: int = 50):
    """Where the ``us`` of one timed call of ``fn`` go: ``host_us``, the
    host's time to issue one call (``reps`` calls back to back on the host
    clock, with no wait for the card), ``device_us``, its kernels' device
    time (:func:`kernel_device_us`), and ``card_share``, device_us / us
    (the rest of ``us`` is the card waiting for the host)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e6 / reps
    sync()
    dev = kernel_device_us(fn)
    return {"host_us": host, "device_us": dev,
            "card_share": None if dev is None else dev / us}


def kernel_device_us(fn, reps: int = 20):
    """The summed device time of every kernel ``fn`` launches, per call,
    from torch.profiler's CUDA trace; None off the card or when the trace
    holds no device time."""
    from quantized_vit_tpu_torch.tools._ablation import device_us

    return device_us(fn, reps) if DEV == "cuda" else None


def profile_step(fn):
    """One call of ``fn`` (a whole training step) under torch.profiler:
    wall ms, the summed time of its kernels, their count, the card's idle
    share of the wall time, K7's device ms and the ten kernels that took
    the most time; None off the card or when the trace holds no device
    time."""
    if DEV != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kern = _kernel_events(prof)
    if not kern:
        return None
    by_name = {}
    for e in kern:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    k7 = k7_in_trace(kern)
    return {"wall_ms": wall, "kernel_ms": busy, "kernels": len(kern),
            "idle_share": max(0.0, 1.0 - busy / wall),
            "quant_bwd_ms": k7["device_ms"] if k7 else 0.0,
            "top": [(n, ms, c) for n, (ms, c) in top]}


def torch_vit_train_step(cfg, x, y, bf16: bool):
    """One training step of a plain unquantized PyTorch ViT of the same
    architecture (nn.Linear / LayerNorm / scaled_dot_product_attention,
    torch.optim.Adam), f32 or under bf16 autocast: a yardstick, never
    called by the port."""
    import torch.nn.functional as F
    from torch import nn

    d, heads = cfg.embed_dim, cfg.num_heads
    hid = int(d * cfg.mlp_ratio)
    torch.manual_seed(1)

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.n1, self.n2 = nn.LayerNorm(d, 1e-6), nn.LayerNorm(d, 1e-6)
            self.qkv, self.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)
            self.fc1, self.fc2 = nn.Linear(d, hid), nn.Linear(hid, d)

        def forward(self, t):
            b, n, _ = t.shape
            qkv = self.qkv(self.n1(t)).reshape(
                b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            t = t + self.proj(o.transpose(1, 2).reshape(b, n, d))
            return t + self.fc2(F.gelu(self.fc1(self.n2(t))))

    class ViT(nn.Module):
        def __init__(self):
            super().__init__()
            p = cfg.patch_size
            self.pe = nn.Conv2d(cfg.in_channels, d, p, p)
            self.cls = nn.Parameter(torch.zeros(1, 1, d))
            self.pos = nn.Parameter(torch.randn(1, cfg.num_tokens, d) * .02)
            self.blocks = nn.ModuleList(Block() for _ in range(cfg.depth))
            self.norm = nn.LayerNorm(d, 1e-6)
            self.head = nn.Linear(d, cfg.num_classes)

        def forward(self, img):
            t = self.pe(img.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
            t = torch.cat([self.cls.expand(t.shape[0], 1, d), t], 1)
            t = t + self.pos
            for blk in self.blocks:
                t = blk(t)
            return self.head(self.norm(t)[:, 0])

    net = ViT().to(x.device)
    adam = torch.optim.Adam(net.parameters(), lr=1e-4)
    dt = torch.bfloat16 if bf16 else torch.float32

    def step():
        adam.zero_grad(set_to_none=True)
        with torch.autocast(x.device.type, dtype=dt, enabled=bf16):
            loss = F.cross_entropy(net(x), y.long())
        loss.backward()
        adam.step()

    return step


def bf16_vit_forward(cfg, x):
    """Plain bf16 PyTorch ViT-B/16 forward of the same architecture on the
    same patchified input (the yardstick bench.py uses on its chip); random
    weights. Never called by the port."""
    import torch.nn.functional as F

    g = torch.Generator(device=DEV).manual_seed(1)
    d, hid, heads = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio), \
        cfg.num_heads
    bf16 = torch.bfloat16

    def w(*shape):
        return (torch.randn(shape, generator=g, device=DEV) * 0.02).to(
            bf16)

    kp = cfg.patch_size**2 * cfg.in_channels
    pe_w, pe_b = w(d, kp), w(d)
    cls, pos = w(1, 1, d), w(1, cfg.num_tokens, d)
    blocks = [dict(g1=w(d) + 1, b1=w(d), wqkv=w(3 * d, d), bqkv=w(3 * d),
                   wp=w(d, d), bp=w(d), g2=w(d) + 1, b2=w(d), w1=w(hid, d),
                   bb1=w(hid), w2=w(d, hid), bb2=w(d))
              for _ in range(cfg.depth)]
    gn, bn, wh, bh = w(d) + 1, w(d), w(cfg.num_classes, d), w(
        cfg.num_classes)
    xb = x.to(bf16)
    b = xb.shape[0]

    def fwd():
        t = F.linear(xb, pe_w, pe_b)
        t = torch.cat([cls.expand(b, 1, d), t], dim=1) + pos
        n = t.shape[1]
        for p in blocks:
            h = F.layer_norm(t, (d,), p["g1"], p["b1"], 1e-6)
            qkv = F.linear(h, p["wqkv"], p["bqkv"]).reshape(
                b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
            t = t + F.linear(o.transpose(1, 2).reshape(b, n, d), p["wp"],
                             p["bp"])
            h = F.layer_norm(t, (d,), p["g2"], p["b2"], 1e-6)
            t = t + F.linear(F.gelu(F.linear(h, p["w1"], p["bb1"])),
                             p["w2"], p["bb2"])
        h = F.layer_norm(t[:, 0], (d,), gn, bn, 1e-6)
        return F.linear(h, wh, bh)

    return fwd



# ---------------------------------------------------------------------------
# phase 7: train -> compress -> export -> serve
# ---------------------------------------------------------------------------

# the uniform subnet: every prunable group of the training run's initial
# params zeroed at this share (an even count), its quantizers reset to
# these bits (packed int4, the latency entry's format)
UNIFORM_SPARSITY = 0.5
UNIFORM_BITS = 4.0
SUBNET_CHAIN_BATCHES = (1, 3)


def subnet_launches(art, cfg, batch, float_dtype):
    """Launches of one forward of a compressed subnet's artifact: the
    attention route of ``batch`` (:func:`expected_launches`) and, per
    block, the MLP route ``mlp_route`` picks at its own hidden width and
    weight formats."""
    from quantized_vit_tpu_torch.serve import uses_chain
    from quantized_vit_tpu_torch.serve.vit_int4 import mlp_route

    route = "chain" if uses_chain(batch) else "block"
    out = dict(expected_launches(cfg.depth, route), fused_mlp=0)
    m = batch * (-(-cfg.num_tokens // 16) * 16)
    for blk in art["blocks"]:
        mlp = mlp_route(m, blk["fc2"].w.shape[1], blk["fc1"].w.shape[1],
                        blk["fc1"].fmt, blk["fc2"].fmt,
                        itemsize=torch.empty((), dtype=float_dtype)
                        .element_size())
        if mlp == "chain":
            out["fused_quant_matmul"] += 2
        else:
            out[mlp] += 1
    return out


def timed_split(record, tag, batch, fn):
    """The last checked forward (``record["forward"][-1]``, whose logits
    must equal the plain path's) timed: ms (:func:`cuda_ms`), one call
    under torch.profiler (:func:`profile_step`: wall, its kernels' device
    time and the top ten, the card's idle share) and the host's time to
    issue a call (:func:`host_split`); logged with the card."""
    f = record["forward"][-1]
    if not f["logits_equal"]:
        raise Failed(f"forward {tag} b{batch}: logits differ from the "
                     f"plain path's by {f['max_abs_diff']}")
    f["ms"] = cuda_ms(fn)
    f["profile"] = profile_step(fn)
    f["host_split"] = host_split(fn, f["ms"] * 1e3)
    p = f["profile"]
    log(f"[split {tag} b{batch}] {f['ms']:.3f} ms ({record['nvidia_smi']}"
        f"); host {f['host_split']['host_us']:.0f} us a call"
        + ("" if p is None else
           f"; traced wall {p['wall_ms']:.3f}, kernels {p['kernel_ms']:.3f}"
           f" ms ({p['kernels']}), idle {p['idle_share']:.2f}; top "
           + ", ".join(f"{n[:40]} {ms:.3f}x{c}" for n, ms, c in p["top"][:6])
           ))
    return {"ms": f["ms"], "launches": f["launches"],
            "max_abs_diff": f["max_abs_diff"], "profile": p,
            "host_split": f["host_split"]}


def subnet_phase(dev, record, trained, arts):
    """The training phase's params through the compression path:
    ``OTO.construct_subnet`` (the GETA subnet: per-block head counts and
    hidden widths), ``export_vit_int4``, the artifact writer and reader,
    then the forward on the batch-32 route and the chain (batch 1 and 3),
    and the batch-1 latency entry where the subnet is uniform (else its
    refusal, checked). Beside it a uniform subnet
    (``random_set_zero_groups`` at ``UNIFORM_SPARSITY`` on the run's
    initial params, quantizers at ``UNIFORM_BITS``) through all three
    routes, and yardsticks at full width on the batch-32 route and the
    chain: the trained params unpruned and ``arts``. Each forward with the
    launch counters set to 0 just before and read just after, its logits
    equal to the plain path's; the widths, MACs and BOPs before and after,
    and each forward's time with its kernels' split (:func:`timed_split`).
    """
    from quantized_vit_tpu_torch.artifact import (load_vit_int4_artifact,
                                                  save_vit_int4_artifact)
    from quantized_vit_tpu_torch.graph import OTO
    from quantized_vit_tpu_torch.models import init_quant_params_tree
    from quantized_vit_tpu_torch.serve import (export_vit_int4,
                                               prepare_kernels,
                                               prepare_latency_artifact,
                                               vit_int4_forward,
                                               vit_int4_forward_latency)
    from quantized_vit_tpu_torch.utils import patchify_batch

    t_phase = time.time()
    oto, params = trained["oto"], trained["params"]
    uniform = oto.random_set_zero_groups(
        init_quant_params_tree(trained["init"], init_bits=UNIFORM_BITS),
        target_group_sparsity=UNIFORM_SPARSITY, num_group_divisible=2,
        seed=0)
    x = torch.from_numpy(patchify_batch(
        trained["images"], oto.cfg.patch_size)).to(dev)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    out = {"card": record["nvidia_smi"]}
    # the yardsticks, on the same images: the trained params unpruned
    # (every quantizer as the GETA subnet's, all widths), and ``arts``,
    # the forward phase's seed-0 ViT-B/16 artifacts (int8-stored, packed
    # int4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the layers requantized to 8 bits
        unpruned = export_vit_int4(oto.cfg, params, pack_weights=False)
    refs = {"geta_unpruned": (unpruned, oto.cfg),
            "random_int8": (arts["art"], arts["cfg"]),
            "random_int4": (arts["art_packed"], arts["cfg"])}
    for name, (art, cfg) in refs.items():
        plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
        rec = {}
        for b in (BATCH,) + SUBNET_CHAIN_BATCHES:
            xb = x[:b]
            tag = f"full_{name},{'chain' if b < 4 else 'block'}"
            check_forward(
                record, dev, tag,
                lambda: vit_int4_forward(art, xb, cfg, plan=plan, **kw),
                lambda: vit_int4_forward(art, xb, cfg, use_kernels=False,
                                         **kw),
                subnet_launches(art, cfg, b, kw["float_dtype"]), b, cfg)
            rec[f"b{b}"] = timed_split(record, tag, b, lambda: (
                vit_int4_forward(art, xb, cfg, plan=plan, **kw)))
        out[name] = {"forwards": rec}
        del plan
    del unpruned, refs
    for name, tree in (("geta", params), ("uniform", uniform)):
        cost = {"macs": oto.compute_macs(tree), "bops": oto.compute_bops(tree)}
        sub_model, sub_params = oto.construct_subnet(tree)
        sub_oto = OTO(sub_model, sub_params)
        cfg = sub_model.cfg
        rec = {"heads_per_block": list(cfg.heads_per_block),
               "hidden_per_block": list(cfg.hidden_per_block),
               "macs": [cost["macs"], sub_oto.compute_macs(sub_params)],
               "bops": [cost["bops"], sub_oto.compute_bops(sub_params)]}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            art = export_vit_int4(cfg, sub_params,
                                  pack_weights=name == "uniform")
        rec["requantized_layers"] = len(caught)
        art_dir = f"{ART_DIR}_subnet_{name}"
        save_vit_int4_artifact(art_dir, art, cfg)
        art, cfg2 = load_vit_int4_artifact(art_dir, device=dev)
        if (cfg2.heads_per_block != cfg.heads_per_block
                or cfg2.hidden_per_block != cfg.hidden_per_block):
            raise Failed(f"subnet {name}: the artifact's config {cfg2} "
                         f"lost the widths of {cfg}")
        fmts = sorted({(b[k].fmt) for b in art["blocks"]
                       for k in ("qkv", "proj", "fc1", "fc2")})
        rec["formats"] = fmts
        log(f"[subnet {name}] heads {rec['heads_per_block']} hidden "
            f"{rec['hidden_per_block']} formats {fmts}; MACs "
            f"{rec['macs'][0] / 1e9:.3f}G -> {rec['macs'][1] / 1e9:.3f}G, "
            f"BOPs {rec['bops'][0] / 1e12:.3f}T -> "
            f"{rec['bops'][1] / 1e12:.3f}T; {rec['requantized_layers']} "
            "layers requantized to 8 bits")
        plan = prepare_kernels(art, cfg) if dev.type == "cuda" else None
        rec["forwards"] = {}
        for b in (BATCH,) + SUBNET_CHAIN_BATCHES:
            xb = x[:b]
            tag = f"subnet_{name},{'chain' if b < 4 else 'block'}"
            check_forward(
                record, dev, tag,
                lambda: vit_int4_forward(art, xb, cfg, plan=plan, **kw),
                lambda: vit_int4_forward(art, xb, cfg, use_kernels=False,
                                         **kw),
                subnet_launches(art, cfg, b, kw["float_dtype"]), b, cfg)
            rec["forwards"][f"b{b}"] = timed_split(
                record, tag, b, lambda: vit_int4_forward(art, xb, cfg,
                                                         plan=plan, **kw))
        x1 = x[:1]
        if len(set(cfg.heads_per_block)) == len(
                set(cfg.hidden_per_block)) == 1:
            lat, meta = prepare_latency_artifact(art, cfg)
            check_forward(
                record, dev, f"subnet_{name},latency",
                lambda: vit_int4_forward_latency(lat, x1, cfg, meta, **kw),
                lambda: vit_int4_forward(art, x1, cfg, use_kernels=False,
                                         **kw),
                expected_launches(cfg.depth, "latency"), 1, cfg)
            rec["forwards"]["latency"] = timed_split(
                record, f"subnet_{name},latency", 1,
                lambda: vit_int4_forward_latency(lat, x1, cfg, meta, **kw))
        else:
            try:
                prepare_latency_artifact(art, cfg)
            except ValueError as e:
                rec["latency_refused"] = str(e)
            else:
                raise Failed(f"subnet {name}: the latency entry took a "
                             "non-uniform stack")
        if name == "uniform" and "latency" not in rec["forwards"]:
            raise Failed("the uniform subnet did not reach the latency "
                         f"entry: {rec}")
        log(f"[subnet {name}] forwards (ms, {record['nvidia_smi']}): "
            + ", ".join(f"{k} {v['ms']:.3f}"
                        for k, v in rec["forwards"].items())
            + (f"; latency refused: {rec['latency_refused']}"
               if "latency_refused" in rec else ""))
        out[name] = rec
        del plan, art
    out["phase_s"] = round(time.time() - t_phase, 1)
    record["subnet"] = out
    log(f"[subnet] phase {out['phase_s']} s")



# ---------------------------------------------------------------------------
# phase 8: HESSO, HESSO-CRIC, the inference CLIs on image files, and the
# RPC serving front
# ---------------------------------------------------------------------------


class EventProbe(StepProbe):
    """:class:`StepProbe` that also marks the end of each step: a CUDA
    event on the card (the host's clock in a CPU rehearsal), so the time
    per step is the span between two consecutive marks."""

    def __init__(self, opt):
        super().__init__(opt)
        self.marks = []

    def step(self, params, grads):
        out = super().step(params, grads)
        if DEV == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return out

    def step_ms(self):
        sync()
        m = self.marks
        if DEV == "cuda":
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def qat_model(seed, dev):
    """The ViT-B/16 QAT model (K7 on every nonlinear quantizer's
    backward) and its params with the quantizers at 8 bits."""
    from quantized_vit_tpu_torch.models import (QuantConfig,
                                                VisionTransformer,
                                                init_quant_params_tree,
                                                tree_map)

    cfg = dataclasses.replace(
        main_cfg(), quant=QuantConfig(enabled=True, fused_vjp=True))
    model = VisionTransformer(cfg, seed=seed, device=dev)
    params = init_quant_params_tree(
        tree_map(lambda p: p.detach().clone(), model.param_tree()),
        init_bits=8.0)
    return model, params


def seeded_batches(cfg, steps, seed):
    rng = np.random.default_rng(seed)
    hw = (cfg.img_size, cfg.img_size, cfg.in_channels)
    return (rng.standard_normal((steps * BATCH, *hw), dtype=np.float32),
            rng.integers(0, cfg.num_classes, steps * BATCH))


def pruned_rows_zero(opt, params):
    """Whether every committed group's rows are exactly zero in every
    prunable tensor of its group; and how many groups that covers."""
    from quantized_vit_tpu_torch.opt import get_path, group_matrix

    n = 0
    for g in opt._prunable():
        idx = opt.state[g.id]["pruned"]
        if not idx:
            continue
        n += len(idx)
        for e in g.entries:
            gm = group_matrix(get_path(params, e.path), e.transform,
                              g.num_groups, g.num_heads)
            if gm is not None and bool(gm[idx].any()):
                return False, n
    return True, n


def hesso_phase(dev, record):
    """HESSO on the ViT-B/16 QAT model at batch BATCH, driven by
    ``TrainLoop`` through warmup and two pruning periods with the launch
    counters set to 0 just before and read just after; then its subnet
    through ``export_vit_int4`` on the batch-32 route."""
    from quantized_vit_tpu_torch.graph import OTO
    from quantized_vit_tpu_torch.models import apply
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import (export_vit_int4,
                                               prepare_kernels,
                                               vit_int4_forward)
    from quantized_vit_tpu_torch.utils import (ArrayDataset, DataLoader,
                                               TrainLoop, patchify_batch)

    t_phase = time.time()
    model, params = qat_model(1, dev)
    cfg = model.cfg
    images, labels = seeded_batches(cfg, HESSO_STEPS, 1)
    oto = OTO(model, params)
    oto.mark_unprunable_by_param_names(["patch_embed", "pos_embed",
                                        "cls_token", "head"])
    opt = oto.hesso(**HESSO_KW)
    probe = EventProbe(opt)
    gen = torch.Generator(device=dev).manual_seed(1)
    loop = TrainLoop(
        apply_fn=lambda p, x, g: apply(model, p, x, deterministic=False,
                                       generator=g),
        optimizer=probe, num_classes=cfg.num_classes, device=dev)
    loader = DataLoader(ArrayDataset(images, labels), BATCH, shuffle=True,
                        seed=1)
    _build.reset_launches()
    params, tm = loop.train_one_epoch(params, loader, 0, gen)
    launches = dict(_build.LAUNCHES)
    step_ms = probe.step_ms()
    metrics = opt.compute_metrics(params)
    zero_ok, n_pruned = pruned_rows_zero(opt, params)
    # K7's device time in one step's backward (the run itself untraced)
    x0 = torch.from_numpy(images[:BATCH]).to(dev)
    y0 = torch.from_numpy(labels[:BATCH]).to(dev)
    _, kern = traced(lambda: loop.loss_and_grads(params, x0, y0, gen))
    k7 = k7_in_trace(kern)
    del kern
    out = {"card": record["nvidia_smi"], "steps": tm["steps"],
           "losses": tm["step_losses"], "seconds": tm["seconds"],
           "k7_launches_per_step": [r["k7_launches"] for r in probe.rows],
           "launches": launches,
           "pruning_period": [r["pruning_period"] for r in probe.rows],
           "n_pruned": [r["n_pruned"] for r in probe.rows],
           "target_redundant_groups": opt.target_num_redundant_groups,
           "num_zero_groups": metrics["num_zero_groups"],
           "group_sparsity": metrics["group_sparsity"],
           "pruned_rows_zero": zero_ok, "step_ms": step_ms,
           "step_ms_median": (statistics.median(step_ms) if step_ms
                              else None),
           "k7_step": k7}
    record["hesso"] = out
    log(f"[hesso] {tm['steps']} steps, losses "
        f"{[round(v, 4) for v in tm['step_losses']]}; pruned per step "
        f"{out['n_pruned']}; sparsity {metrics['group_sparsity']:.4f} "
        f"({metrics['num_zero_groups']} zero groups, target "
        f"{opt.target_num_redundant_groups}); rows zero {zero_ok}")
    log(f"[hesso] ms per step (events, {record['nvidia_smi']}): "
        f"{[round(v, 1) for v in step_ms]}, median "
        f"{out['step_ms_median']}; K7 in one step's backward: {k7}")
    per_step = sum(n for _, _, n in k7_sites(cfg))
    if tm["steps"] != HESSO_STEPS or not all(np.isfinite(tm["step_losses"])):
        raise Failed(f"hesso: {tm['steps']} steps, losses "
                     f"{tm['step_losses']}")
    if dev.type == "cuda" and (
            any(n != per_step for n in out["k7_launches_per_step"])
            or launches["quant_bwd"] != per_step * HESSO_STEPS):
        raise Failed(f"hesso: K7 launches per step "
                     f"{out['k7_launches_per_step']} != {per_step}")
    if (max(out["pruning_period"]) != HESSO_KW["pruning_periods"]
            or n_pruned != opt.target_num_redundant_groups
            or metrics["num_zero_groups"] != opt.target_num_redundant_groups
            or not zero_ok):
        raise Failed(f"hesso: the target sparsity not reached: {out}")

    # the subnet on the batch-32 route
    sub_model, sub_params = oto.construct_subnet(params)
    scfg = sub_model.cfg
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")  # layers requantized to 8 bits
        art = export_vit_int4(scfg, sub_params, pack_weights=False)
    x = torch.from_numpy(patchify_batch(images[:BATCH],
                                        cfg.patch_size)).to(dev)
    plan = prepare_kernels(art, scfg) if dev.type == "cuda" else None
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    check_forward(
        record, dev, "subnet_hesso,block",
        lambda: vit_int4_forward(art, x, scfg, plan=plan, **kw),
        lambda: vit_int4_forward(art, x, scfg, use_kernels=False, **kw),
        subnet_launches(art, scfg, BATCH, kw["float_dtype"]), BATCH, scfg)
    f = record["forward"][-1]
    out["subnet"] = {"heads_per_block": list(scfg.heads_per_block),
                     "hidden_per_block": list(scfg.hidden_per_block),
                     "requantized_layers": len(caught),
                     "launches": f["launches"],
                     "logits_equal": f["logits_equal"],
                     "ms": cuda_ms(lambda: vit_int4_forward(
                         art, x, scfg, plan=plan, **kw))}
    log(f"[hesso subnet] heads {out['subnet']['heads_per_block']} hidden "
        f"{out['subnet']['hidden_per_block']}; b{BATCH} forward "
        f"{out['subnet']['ms']:.3f} ms ({record['nvidia_smi']})")
    if not f["logits_equal"]:
        raise Failed(f"hesso subnet: logits differ from the plain path's "
                     f"by {f['max_abs_diff']}")
    out["phase_s"] = round(time.time() - t_phase, 1)
    log(f"[hesso] phase {out['phase_s']} s")


def cric_phase(dev, record):
    """HESSO-CRIC in a hand loop at batch BATCH that passes each step's
    loss: two sampling cycles, the final redundant set, the hybrid steps;
    the reset at termination must hand back the cached params (those
    handed in at ``start_cric_step``) bit for bit."""
    from quantized_vit_tpu_torch.graph import OTO
    from quantized_vit_tpu_torch.models import apply, flatten_tree
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.utils import TrainLoop

    t_phase = time.time()
    model, params = qat_model(2, dev)
    cfg = model.cfg
    images, labels = seeded_batches(cfg, CRIC_STEPS, 2)
    oto = OTO(model, params)
    oto.mark_unprunable_by_param_names(["patch_embed", "pos_embed",
                                        "cls_token", "head"])
    opt = oto.hesso_cric(**CRIC_KW)
    gen = torch.Generator(device=dev).manual_seed(2)
    loop = TrainLoop(
        apply_fn=lambda p, x, g: apply(model, p, x, deterministic=False,
                                       generator=g),
        optimizer=opt, num_classes=cfg.num_classes, device=dev)

    def equal(a, b):
        fa, fb = flatten_tree(a), flatten_tree(b)
        return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k])
                                          for k in fa)

    rows, handed, reset_ok, final_set = [], None, None, None
    _build.reset_launches()
    for i in range(CRIC_STEPS):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        x = torch.from_numpy(images[sl]).to(dev)
        y = torch.from_numpy(labels[sl]).to(dev)
        if opt.num_steps + 1 == CRIC_KW["start_cric_step"]:
            handed = {k: v.clone() for k, v in flatten_tree(params).items()}
        loss, _, grads = loop.loss_and_grads(params, x, y, gen)
        params = opt.step(params, grads, loss=float(loss))
        if opt.terminated_step == opt.num_steps:  # the final reset
            reset_ok = (equal(params, opt.cache_params)
                        and equal(flatten_tree(params), handed))
            final_set = sum(len(st["active_redundant"])
                            for st in opt.state.values())
        rows.append({"step": opt.num_steps, "loss": float(loss),
                     "cycle": opt.curr_cycle_period,
                     "violating": opt.num_active_violating(),
                     "terminated": opt.is_terminated})
    sync()
    launches = dict(_build.LAUNCHES)
    metrics = opt.compute_metrics(params)
    zero_ok, n_pruned = pruned_rows_zero(opt, params)
    out = {"steps": CRIC_STEPS, "rows": rows, "launches": launches,
           "terminated_step": opt.terminated_step,
           "reset_bit_for_bit": reset_ok, "final_redundant": final_set,
           "target_redundant_groups": opt.target_num_redundant_groups,
           "num_zero_groups": metrics["num_zero_groups"],
           "pruned_rows_zero": zero_ok,
           "seconds": round(time.time() - t_phase, 1)}
    record["cric"] = out
    log(f"[cric] cycles {[r['cycle'] for r in rows]} violating "
        f"{[r['violating'] for r in rows]}; terminated at step "
        f"{opt.terminated_step}; reset bit for bit {reset_ok}; final set "
        f"{final_set} of target {opt.target_num_redundant_groups}; zero "
        f"groups {metrics['num_zero_groups']}; K7 launches "
        f"{launches['quant_bwd']}; {out['seconds']} s")
    cycles = {r["cycle"] for r in rows if not r["terminated"]}
    if not all(np.isfinite([r["loss"] for r in rows])):
        raise Failed(f"cric: losses {[r['loss'] for r in rows]}")
    if not {1, 2} <= cycles or not opt.is_terminated:
        raise Failed(f"cric: two cycles not run: {rows}")
    if not reset_ok:
        raise Failed("cric: the reset did not give back the cached params")
    if (final_set != opt.target_num_redundant_groups
            or n_pruned != final_set or not zero_ok
            or metrics["num_zero_groups"] != final_set):
        raise Failed(f"cric: the final redundant set: {out}")
    if dev.type == "cuda" and launches["quant_bwd"] == 0:
        raise Failed("cric: K7 never launched")


class RpcWorker:
    """``python -m quantized_vit_tpu_torch.serve.rpc`` on ``ART_DIR`` as a
    child process (on the card, with no ``--device`` flag; ``--device
    cpu`` in a rehearsal). A thread reads its stdout for the port line;
    its stderr goes to ``build/rpc_worker.log``."""

    def __init__(self):
        flags = ["--artifact", ART_DIR]
        if DEV != "cuda":
            flags += ["--device", "cpu"]
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.log_path = os.path.join(OUT_DIR, "rpc_worker.log")
        self._log = open(self.log_path, "w")
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "quantized_vit_tpu_torch.serve.rpc",
             *flags], stdout=subprocess.PIPE, stderr=self._log, env=env,
            cwd=ROOT, text=True)
        self.port = None
        self.ready_s = None
        self._ready = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            if line.startswith("RPC_SERVING_PORT=") and self.port is None:
                self.port = int(line.strip().split("=", 1)[1])
                self.ready_s = round(time.time() - self.t0, 1)
                self._ready.set()
        self._ready.set()  # the worker ended

    def wait_port(self) -> int:
        self._ready.wait(RPC_PORT_TIMEOUT_S)
        if self.port is None or self.proc.poll() is not None:
            with open(self.log_path) as f:
                err = f.read()[-2000:]
            raise Failed(f"rpc worker died or stayed silent for "
                         f"{RPC_PORT_TIMEOUT_S} s (rc {self.proc.poll()}): "
                         f"{err}")
        return self.port

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode


def cli_rpc_phase(dev, record, trained):
    """HESSO-CRIC, then the inference CLIs on image files and the RPC
    serving front, the worker starting while CRIC runs."""
    worker = RpcWorker()
    try:
        cric_phase(dev, record)
        cli_phase(dev, record, trained, worker)
        rpc_phase(dev, record, worker)
    finally:
        record.setdefault("rpc", {})["worker_rc"] = worker.stop()


def write_folder(root, size, seed):
    """``root/c<i>/img<j>.png``: FOLDER_CLASSES classes of
    FOLDER_PER_CLASS seeded RGB images; ``root + '_gray'`` one grayscale
    file. Returns the grayscale file's path."""
    import shutil

    from PIL import Image

    rng = np.random.default_rng(seed)
    shutil.rmtree(root, ignore_errors=True)
    for c in range(FOLDER_CLASSES):
        d = os.path.join(root, f"c{c}")
        os.makedirs(d)
        for j in range(FOLDER_PER_CLASS):
            Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                         dtype=np.uint8), "RGB").save(
                os.path.join(d, f"img{j}.png"))
    gray_dir = root + "_gray"
    shutil.rmtree(gray_dir, ignore_errors=True)
    os.makedirs(gray_dir)
    gray = os.path.join(gray_dir, "gray.png")
    Image.fromarray(rng.integers(0, 256, (size, size), dtype=np.uint8),
                    "L").save(gray)
    return gray


def cli_phase(dev, record, trained, worker):
    """``cli.eval`` on phase 6's params and on phase 7's GETA subnet (each
    from a checkpoint written here) over a generated image folder, equal
    to a direct ``evaluate`` over the same loader; ``cli.predict`` equal
    to the softmax of a direct forward; a non-RGB file refused."""
    from quantized_vit_tpu_torch.cli import _common as common
    from quantized_vit_tpu_torch.cli import eval as ceval
    from quantized_vit_tpu_torch.cli import predict as cpredict
    from quantized_vit_tpu_torch.models import apply
    from quantized_vit_tpu_torch.opt import save_checkpoint
    from quantized_vit_tpu_torch.utils import (DataLoader,
                                               ImageFolderDataset, evaluate,
                                               native_prep_available)

    t_phase = time.time()
    oto, params = trained["oto"], trained["params"]
    cfg = oto.cfg
    gray = write_folder(FOLDER_DIR, cfg.img_size, 3)
    try:
        ImageFolderDataset([gray], [0], img_size=cfg.img_size).get(
            np.asarray([0]))
    except ValueError as e:
        gray_refused = str(e)
    else:
        raise Failed("a non-RGB image file was not refused")
    sub_model, sub_params = oto.construct_subnet(params)
    ckpts = {"full": (os.path.join(TRAIN_CKPT, "eval_full"), oto.model,
                      params, {"steps": TRAIN_STEPS}),
             "subnet": (os.path.join(TRAIN_CKPT, "eval_subnet"), sub_model,
                        sub_params,
                        {"subnet": dataclasses.asdict(sub_model.cfg)})}
    for path, _, tree, extra in ckpts.values():
        save_checkpoint(path, tree, None, extra)
    flags = ["--dataset", "folder", "--data-path", FOLDER_DIR, "--model",
             "vit_b16", "--img-size", str(cfg.img_size), "--num-classes",
             str(cfg.num_classes), "--batch-size", str(BATCH), "--device",
             str(dev)]
    worker.wait_port()  # no worker start-up on the card while timed
    out = {"card": record["nvidia_smi"], "gray_refused": gray_refused,
           "native_prep": native_prep_available(), "eval": {}}
    for name, (path, model, tree, _) in ckpts.items():
        argv = flags + ["--checkpoint", path]
        sync()
        t0 = time.perf_counter()
        got = ceval.main(argv)
        sync()
        wall = time.perf_counter() - t0
        _, val_ds = common.build_datasets(ceval.parse_args(argv))
        want = evaluate(lambda p, x, m=model: apply(m, p, x), tree,
                        DataLoader(val_ds, BATCH, pad_last=True), device=dev)
        out["eval"][name] = {"cli": got, "direct": want,
                             "equal": got == want, "wall_s": wall,
                             "images_per_s": got["samples"] / wall}
        log(f"[eval {name}] {got}; direct {want}; "
            f"{got['samples'] / wall:.1f} images/s "
            f"({record['nvidia_smi']})")
        if got != want or got["samples"] != len(val_ds):
            raise Failed(f"cli.eval {name}: {got} != direct {want}")
    image = os.path.join(FOLDER_DIR, "c1", "img0.png")
    path = ckpts["full"][0]
    top = cpredict.main(["--checkpoint", path, "--image", image, "--model",
                         "vit_b16", "--img-size", str(cfg.img_size),
                         "--num-classes", str(cfg.num_classes), "--topk",
                         "5", "--device", str(dev)])
    x = torch.from_numpy(cpredict.load_image(image, cfg.img_size)).to(dev)
    with torch.no_grad():
        probs = torch.softmax(apply(oto.model, params, x)[0], dim=-1)
    probs = probs.cpu().numpy()
    want = [(int(i), float(probs[i])) for i in np.argsort(-probs)[:5]]
    out["predict"] = {"cli": top, "direct": want, "equal": top == want}
    log(f"[predict] {top}; equal to the direct forward's softmax "
        f"{top == want}")
    if top != want:
        raise Failed(f"cli.predict {top} != direct {want}")
    if dev.type == "cuda" and not out["native_prep"]:
        raise Failed("the native batch-prep engine did not build")
    out["phase_s"] = round(time.time() - t_phase, 1)
    record["cli"] = out


def rpc_phase(dev, record, worker):
    """``MultiHostFrontend`` over an in-process batcher on ``ART_DIR`` and
    an ``RpcBackendStub`` of the worker: RPC_REQUESTS requests, both
    backends used, every answer equal to a direct forward of its image
    (as phase 4 compares the batcher's answers); the in-process backend's
    launches counted from 0 over the burst."""
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import (ContinuousBatcher,
                                               MultiHostFrontend, rpc)

    port = worker.wait_port()
    forward, cfg = rpc.load_forward(ART_DIR, device=dev)
    local = ContinuousBatcher(forward, max_batch=8, max_delay_ms=5.0)
    local.warmup(np.zeros((cfg.img_size, cfg.img_size, cfg.in_channels),
                          np.float32))
    stub = rpc.RpcBackendStub("127.0.0.1", port)
    images = np.random.default_rng(4).standard_normal(
        (RPC_REQUESTS, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(
            np.float32)
    done = [0.0] * RPC_REQUESTS
    sync()
    _build.reset_launches()
    t0 = time.monotonic()
    with MultiHostFrontend([local, stub]) as fe:
        sent, futs = [], []
        for i, img in enumerate(images):
            sent.append(time.monotonic())
            f = fe.submit(img)
            f.add_done_callback(
                lambda _, i=i: done.__setitem__(i, time.monotonic()))
            futs.append(f)
        answers = np.stack([f.result(timeout=120) for f in futs])
        wall = time.monotonic() - t0
        sync()
        launches = dict(_build.LAUNCHES)
        remote = stub.stats
        local_stats = dict(local.stats)
    lat = [(d - s) * 1e3 for d, s in zip(done, sent)]
    direct = np.concatenate([forward(images[i:i + 1]).cpu().numpy()
                             for i in range(RPC_REQUESTS)])
    equal = bool(np.array_equal(answers, direct))
    stub2 = rpc.RpcBackendStub("127.0.0.1", port)
    stub2.shutdown_server()
    try:
        rc = worker.proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        rc = None
    out = record.setdefault("rpc", {})
    out.update({
        "card": record["nvidia_smi"], "requests": RPC_REQUESTS,
        "worker_ready_s": worker.ready_s,
        "local": {"requests": local_stats["requests"],
                  "batch_hist": local_stats["batch_hist"]},
        "remote": {"requests": remote["stats"]["requests"],
                   "batch_hist": remote["stats"]["batch_hist"]},
        "launches_local": launches, "answers_equal_direct": equal,
        "max_abs_diff": float(np.abs(answers - direct).max()),
        "wall_s": wall, "req_per_s": RPC_REQUESTS / wall,
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p99_ms": float(np.percentile(lat, 99)),
        "worker_exit_after_shutdown": rc})
    log(f"[rpc] {RPC_REQUESTS} requests: local {out['local']}, remote "
        f"{out['remote']}; {out['req_per_s']:.1f} req/s, p50 "
        f"{out['latency_p50_ms']:.2f} ms, p99 {out['latency_p99_ms']:.2f} "
        f"ms ({record['nvidia_smi']}); worker up in {worker.ready_s} s; "
        f"answers equal direct forwards {equal}; local launches "
        f"{launches}")
    if not equal:
        raise Failed(f"rpc: answers differ from direct forwards by "
                     f"{out['max_abs_diff']}")
    if out["local"]["requests"] == 0 or out["remote"]["requests"] == 0:
        raise Failed(f"rpc: a backend served nothing: {out}")
    if dev.type == "cuda" and (
            launches["patch_finalize"] == 0
            or launches["fused_quant_matmul"] == 0
            or launches["attention_block"] + launches["attention_qkv"] == 0):
        raise Failed(f"rpc: the in-process backend's kernels did not run: "
                     f"{launches}")


# ---------------------------------------------------------------------------
# phase 9: multi-device serving, tensor parallel and column-sharded FSDP
# ---------------------------------------------------------------------------

# the processes of the 'model' axis sharing the card: 1 in this process,
# the others spawned
MESH_TPS = (1, 2, 4)
MESH_ITERS = 5
MESH_CLI_N = 2
MESH_CLI_REQUESTS = 16
# the TP forward's deviation from the single-device f32 forward, at most
# this times the single-device bf16 forward's (tests/serve/test_vit_tp.py
# :58-84's criterion)
TP_DEV_FACTOR = 1.5


def tp_launches(depth):
    """Launches of one TP forward: K1 for the embed and head and per block
    qkv, proj, fc1, fc2; K4 once; per block K6 once, the levels launch and
    K14 twice."""
    return dict(expected_launches(depth, "latency"), block_stack=0,
                fused_quant_matmul=2 + 4 * depth, attention_qkv=depth,
                gather_rows=2 * depth, ln_quant_levels=2 * depth)


def fsdp_col_launches(depth, b_loc, n_pad, d, hid, fmt):
    """Launches of one column-FSDP forward of ``b_loc`` images a process:
    the single-device forward's (its attention and MLP routes) and K14 once
    a block."""
    from quantized_vit_tpu_torch.serve.vit_int4 import mlp_route, uses_chain

    mlp = mlp_route(b_loc * n_pad, d, hid, fmt, fmt, 2)
    route = "chain" if uses_chain(b_loc) else "block"
    return dict(expected_launches(depth, route, mlp), gather_rows=depth)


def mesh_forwards(peers, cfg_kw, x_np, iters, with_single):
    """This process's share of phase 9 on its shards of the seed-0
    packed-int4 artifact (the whole batch ``x_np``, host patches): the
    health check, the TP forward in f32/f32 and bf16/bf16 and the column
    FSDP forward in bf16, each once with the launch counters and the
    collective counts set to 0 just before and read just after (logits,
    launches, collectives, fences and their host time), then timed in
    turns: ``iters`` rounds of each forward (a host barrier, the
    forward, a synchronize) and, with ``with_single`` (rank 0), of the
    single-device bf16 forward of the whole batch, the others waiting at
    the barrier."""
    from quantized_vit_tpu_torch.models import ViTConfig
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.parallel import (COLLECTIVES,
                                                  collective_health_check,
                                                  reset_collectives)
    from quantized_vit_tpu_torch.serve import (
        prepare_fsdp_kernels, prepare_kernels, prepare_tp_artifact,
        prepare_tp_kernels, random_vit_int4_artifact, shard_fsdp_artifact,
        shard_tp_artifact, vit_int4_forward, vit_int4_forward_fsdp,
        vit_int4_forward_tp)

    dev = peers.device
    cuda = dev.type == "cuda"
    rank, tp = peers.rank, peers.tp
    cfg = ViTConfig(**cfg_kw)
    out = {}
    rep = collective_health_check(peers, timeout_s=SPAWN_TIMEOUT_S / 2)
    out["health"] = dataclasses.asdict(rep)
    art = random_vit_int4_artifact(cfg, seed=0, pack_weights=True,
                                   device=dev)
    x = torch.from_numpy(x_np).to(dev)
    b = x.shape[0]
    kw = dict(images_layout="patches")
    tart = shard_tp_artifact(prepare_tp_artifact(art, cfg, tp), rank, tp)
    fart = shard_fsdp_artifact(art, rank, tp)
    t0 = time.perf_counter()
    tplan = prepare_tp_kernels(tart, cfg, peers, batches=(b,),
                               comm_dtype=torch.float32) if cuda else None
    def done():  # this process's device (DEV is the parent's setting)
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        tplan.comm(b, torch.bfloat16)
    fplan = prepare_fsdp_kernels(fart, cfg, peers) if cuda else None
    done()
    out["prepare_host_ms"] = (time.perf_counter() - t0) * 1e3
    splan = (prepare_kernels(art, cfg) if cuda and with_single else None)
    if not with_single:
        del art
    fwds = {
        "tp_f32": lambda: vit_int4_forward_tp(
            tart, x, cfg, peers, float_dtype=torch.float32,
            comm_dtype=torch.float32, plan=tplan, **kw),
        "tp_bf16": lambda: vit_int4_forward_tp(
            tart, x, cfg, peers, float_dtype=torch.bfloat16,
            comm_dtype=torch.bfloat16, plan=tplan, **kw),
        "fsdp_bf16": lambda: vit_int4_forward_fsdp(
            fart, x, cfg, peers, float_dtype=torch.bfloat16, plan=fplan,
            **kw)}
    for name, fn in fwds.items():
        peers.barrier()
        _build.reset_launches()
        reset_collectives()
        f0, fs0 = peers.fences, peers.fence_s
        logits = fn()
        done()
        out[name] = {
            "logits": logits.float().cpu().numpy(),
            "launches": dict(_build.LAUNCHES),
            "collectives": {f"{k}:{d}": v
                            for (k, d), v in COLLECTIVES.items()},
            "fences": peers.fences - f0,
            "fence_host_ms": (peers.fence_s - fs0) * 1e3}
    turns = dict(fwds)
    if with_single:
        turns["single_bf16"] = lambda: vit_int4_forward(
            art, x, cfg, float_dtype=torch.bfloat16, plan=splan, **kw)
    ms = {k: [] for k in list(fwds) + ["single_bf16"]}
    for _ in range(iters):
        for name in ms:
            peers.barrier()
            t0 = time.perf_counter()
            if name in turns:
                turns[name]()
                done()
            dt = (time.perf_counter() - t0) * 1e3
            if name in turns:
                ms[name].append(dt)
    out["wall_ms"] = {k: statistics.median(v) for k, v in ms.items() if v}
    if cuda:  # one call of each under torch.profiler, every process
        out["profile"] = {}
        for name, fn in fwds.items():
            peers.barrier()
            out["profile"][name] = profile_step(fn)
        if with_single:  # no collective: this process alone
            out["profile"]["single_bf16"] = profile_step(
                turns["single_bf16"])
    out["shard_bytes"] = {
        "tp": sum(b_[k].w.numel() for b_ in tart["blocks"]
                  for k in _BLOCK_NAMES),
        "fsdp": sum(b_[k].w.numel() for b_ in fart["blocks"]
                    for k in _BLOCK_NAMES)}
    return out


def mesh_spawned(rank, tp, init_method, dev, cfg_kw, x_np, iters):
    """One of tp processes sharing the card in phase 9 (``run_processes``):
    the gloo group, then :func:`mesh_forwards`."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from quantized_vit_tpu_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    peers = initialize_distributed(init_method, tp, rank, device=dev)
    try:
        return mesh_forwards(peers, cfg_kw, x_np, iters, rank == 0)
    finally:
        peers.close()


def levels_cases(dev, parity, cfg, m):
    """The levels-only K1 launch (``run_ln_levels``) at ``m`` rows of
    ``cfg``'s width, bf16 and f32 rows, linear and pow quantizers: its
    levels against the plain version and against the level scratch K1's
    own ln_quant prologue writes (K1 launched at the picker's work split
    with a scratch this phase reads back), byte for byte."""
    from quantized_vit_tpu_torch.ops import fused as F

    d = cfg.embed_dim
    rng = np.random.default_rng(990)
    f32 = torch.float32
    w = torch.from_numpy(rng.integers(-7, 8, (d, 3 * d)).astype(np.int8))
    g = torch.from_numpy((rng.standard_normal(d) * 0.1 + 1).astype(
        np.float32))
    be = torch.from_numpy((rng.standard_normal(d) * 0.02).astype(np.float32))
    out = []
    for stream in (torch.bfloat16, f32):
        x = torch.from_numpy((rng.standard_normal((m, d)) * 0.8).astype(
            np.float32)).to(dev, stream)
        for pow_ in (False, True):
            layer = dict(act_d=torch.tensor(0.05), act_t=torch.tensor(
                1.07 if pow_ else 1.0), act_top=127, act_pow=pow_)
            layer = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                     for k, v in layer.items()}
            case = (f"[{m}x{d}]({str(stream)[6:]},"
                    f"{'pow' if pow_ else 'linear'})")
            plain = F.ln_quant_levels_plain(x, g.to(dev), be.to(dev),
                                            **layer)
            got = F.ln_quant_levels(x, g.to(dev), be.to(dev), **layer)
            out.append(parity_row("ln_quant_levels", case, "exact", got,
                                  plain))
            if dev.type != "cuda":
                continue
            plan = F.plan_matmul(w.to(dev), 1e-3, None, fmt="int8",
                                 prologue="ln_quant", ln_scale=g.to(dev),
                                 ln_bias=be.to(dev), **layer)
            lay = F.matmul_layout(m, d, 3 * d, "ln_quant",
                                  x.element_size(),
                                  F._card_sms(x.device.index))
            scratch = torch.zeros(sum(F._round_up(v, 16) for v in
                                      lay.scratch_bytes().values()),
                                  dtype=torch.uint8, device=dev)
            F._launch_matmul(plan, x, lay, scratch=scratch,
                             out_dtype=torch.bfloat16)
            k1 = scratch[:m * lay.kp].view(torch.int8).view(m, lay.kp)[:, :d]
            out.append(parity_row("ln_quant_levels", f"{case}:vs K1 scratch",
                                  "exact", got, k1.contiguous()))
    for r in out:
        parity.add(r)
    return out


def mesh_phase(dev, record, parity, arts, peaks):
    """Phase 9: multi-device serving on the seed-0 packed-int4 ViT-B/16
    artifact at batch 32, the 'model' axis's processes sharing the card
    (tp = 1 in this process, the others spawned): the TP forward in
    f32/f32 and bf16/bf16 against the single-device f32 forward (no
    further from it than TP_DEV_FACTOR x the single-device bf16
    forward's), the column-FSDP forward bit-equal to the single-device
    bf16 forward, the health check, each run's launches, collectives and
    fences; the levels-only K1 launch against its plain version and K1's
    own scratch; the serve CLI's mesh branch at N = MESH_CLI_N, tp and
    fsdp (``--input-uint8`` with fsdp), answers against direct
    forwards; then the levels launch's kernels-line entry."""
    from quantized_vit_tpu_torch.cli import serve
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.ops import fused as F
    from quantized_vit_tpu_torch.parallel import Peers, run_processes
    from quantized_vit_tpu_torch.serve import (prepare_kernels,
                                               vit_int4_forward)

    t_phase = time.time()
    cfg, art, x = arts["cfg"], arts["art_packed"], arts["x"]
    b, _, d, n_real, n_pad, _, hid, _, _ = shapes(cfg)
    cuda = dev.type == "cuda"
    plan = prepare_kernels(art, cfg) if cuda else None
    kw = dict(images_layout="patches", plan=plan)
    ref = {dt: vit_int4_forward(art, x, cfg, float_dtype=getattr(torch, dt),
                                **kw).float().cpu()
           for dt in ("float32", "bfloat16")}
    dev_single = float((ref["bfloat16"] - ref["float32"]).abs().max())
    rec = {"batch": b, "dev_single_bf16": dev_single, "tp": {}}
    rows = levels_cases(dev, parity, cfg, b * n_pad)
    x_np = x.cpu().numpy()
    cfg_kw = dataclasses.asdict(cfg)
    want_tp = tp_launches(cfg.depth)
    for tp in MESH_TPS:
        t0 = time.time()
        if tp == 1:
            res = [mesh_forwards(Peers(0, 1, dev), cfg_kw, x_np, MESH_ITERS,
                                 True)]
        else:
            try:
                res = run_processes(mesh_spawned, tp,
                                    os.path.join(OUT_DIR, "dist"),
                                    args=(DEV, cfg_kw, x_np, MESH_ITERS),
                                    timeout_s=SPAWN_TIMEOUT_S)
            except RuntimeError as e:
                raise Failed(f"phase 9 at tp={tp}: {e}")
        want_fsdp = fsdp_col_launches(cfg.depth, b // tp, n_pad, d, hid,
                                      art["blocks"][0]["fc1"].fmt)
        r = {"spawn_s": round(time.time() - t0, 1),
             "health": [p["health"] for p in res],
             "wall_ms_rank0": res[0]["wall_ms"],
             "profile_rank0": res[0].get("profile"),
             "prepare_host_ms": [p["prepare_host_ms"] for p in res],
             "shard_bytes": res[0]["shard_bytes"]}
        for name in ("tp_f32", "tp_bf16", "fsdp_bf16"):
            got = torch.from_numpy(np.concatenate([p[name]["logits"]
                                                   for p in res]))
            base = ref["bfloat16"] if name == "fsdp_bf16" else \
                ref["float32"]
            diff = float((got - base).abs().max())
            top1 = float((got.argmax(1) == ref["float32"].argmax(1))
                         .float().mean())
            want = want_fsdp if name.startswith("fsdp") else want_tp
            r[name] = {"max_abs_diff": diff, "top1_agree_f32": top1,
                       "equal": bool(torch.equal(got, base)),
                       "launches": res[0][name]["launches"],
                       "collectives": res[0][name]["collectives"],
                       "fences": res[0][name]["fences"],
                       "fence_host_ms": [p[name]["fence_host_ms"]
                                         for p in res]}
            log(f"[mesh {name} tp={tp}] max|d| vs single-device "
                f"{'bf16' if name.startswith('fsdp') else 'f32'} {diff:.4g}"
                f" (bf16 single {dev_single:.4g}), top-1 {top1:.4f}, "
                f"equal {r[name]['equal']}, collectives "
                f"{r[name]['collectives']}, fences {r[name]['fences']} "
                f"({r[name]['fence_host_ms']} ms host)")
            if cuda and any(p[name]["launches"] != want for p in res):
                raise Failed(f"phase 9 {name} tp={tp}: launches "
                             f"{[p[name]['launches'] for p in res]} != "
                             f"{want}")
            if (tuple(got.shape) != (b, cfg.num_classes)
                    or not torch.isfinite(got).all()):
                raise Failed(f"phase 9 {name} tp={tp}: logits "
                             f"{tuple(got.shape)} not finite or wrong shape")
            if name == "fsdp_bf16" and not r[name]["equal"]:
                raise Failed(f"phase 9 column FSDP tp={tp}: logits differ "
                             f"from the single-device forward's by {diff}")
            if (name.startswith("tp")
                    and diff > TP_DEV_FACTOR * dev_single + 1e-6):
                raise Failed(f"phase 9 {name} tp={tp}: deviation {diff} > "
                             f"{TP_DEV_FACTOR} x {dev_single}")
        if any(not h["ok"] or h["num_devices"] != tp for h in r["health"]):
            raise Failed(f"phase 9 health check at tp={tp}: {r['health']}")
        rec["tp"][str(tp)] = r
        log(f"[mesh tp={tp}] rank 0 wall ms {r['wall_ms_rank0']} "
            f"({r['spawn_s']} s; {record['nvidia_smi']})")
        for name, p in (r["profile_rank0"] or {}).items():
            if p:
                log(f"[mesh profile {name} tp={tp}] traced wall "
                    f"{p['wall_ms']:.3f}, kernels {p['kernel_ms']:.3f} ms "
                    f"({p['kernels']}), idle {p['idle_share']:.2f}; top "
                    + ", ".join(f"{n[:40]} {ms_:.3f}x{c}"
                                for n, ms_, c in p["top"][:6]))
    rec["cli"] = mesh_cli(dev, record, serve)
    # the levels launch's kernels-line entry: launches on the TP forward
    # at tp = 1, time at its main-path site (one process's rows, bf16)
    m = b * n_pad
    xl = torch.from_numpy(np.random.default_rng(991).standard_normal(
        (m, d)).astype(np.float32)).to(dev, torch.bfloat16)
    blk = art["blocks"][0]
    lv_kw = dict(act_d=blk["qkv"].act["d"], act_t=blk["qkv"].act["t"],
                 act_top=blk["qkv"].top, act_pow=blk["qkv"].act_pow)
    g, be = blk["norm1"]["scale"], blk["norm1"]["bias"]
    if cuda:
        lplan = F.plan_ln_levels(g, be, device=dev, **lv_kw)
        lv_out = torch.empty((m, d), dtype=torch.int8, device=dev)
        us = cuda_ms(lambda: F.run_ln_levels(lplan, xl, out=lv_out)) * 1e3
    else:
        us = cuda_ms(lambda: F.ln_quant_levels(xl, g, be, **lv_kw)) * 1e3
    plain_us = cuda_ms(lambda: F.ln_quant_levels_plain(xl, g, be,
                                                       **lv_kw)) * 1e3
    # at ~5 us of card time the events read the wrapper's host time: the
    # kernel's device time (torch.profiler) is the row's time
    split = host_split(lambda: F.run_ln_levels(lplan, xl, out=lv_out),
                       us) if cuda else {"device_us": None}
    dev_us = split["device_us"] or us
    # bytes: x read once (bf16), gamma and beta, the levels written
    bound_us = (m * d * 2 + 2 * d * 4 + m * d) / peaks[2] * 1e6
    entry = {
        "name": "ln_quant_levels", "route": "cuda",
        "source": "quantized_vit_tpu_torch/csrc/fused_quant_matmul.cu",
        "replaces": "quantized_vit_tpu/ops/fused.py:556",
        "launches": rec["tp"]["1"]["tp_bf16"]["launches"]["ln_quant_levels"],
        "path": "tp_tp1",
        "max_abs_err": max(r_["max_abs_err"] for r_ in rows),
        "share_differ": max(r_["share_differ"] for r_ in rows),
        "bit_exact": all(r_["bit_exact"] for r_ in rows),
        "ms": dev_us * 2 * cfg.depth / 1e3,
        "plain_ms": plain_us * 2 * cfg.depth / 1e3,
        "timing": "ms: device time (torch.profiler) x launches; events "
                  "in us_events_per_launch",
        "us_events_per_launch": {f"tp_b{b}": us},
        "host_split": split,
        "bound_ms": bound_us * 2 * cfg.depth / 1e3, "bound_by": "bytes",
        "library_ms": None,
        "us_per_launch": {f"tp_b{b}": dev_us},
        "bound_us_per_launch": {f"tp_b{b}": bound_us},
        "note": "K1's ln_quant prologue phase alone (the TP forward's "
                "quantize before each all-gather, vit_tp.py:201)"}
    kernels = record["kernels"]
    names = [k_["name"] for k_ in kernels]
    kernels.insert(names.index("fused_quant_matmul") + 1, entry)
    for k_ in kernels:
        for key, run in (("tp_tp1", rec["tp"]["1"]["tp_bf16"]),
                         ("fsdp_tp1", rec["tp"]["1"]["fsdp_bf16"])):
            if run["launches"].get(k_["name"]):
                k_.setdefault("mesh_launches", {})[key] = \
                    run["launches"][k_["name"]]
    rec["phase_s"] = round(time.time() - t_phase, 1)
    record["mesh"] = rec
    bad = [r_ for r_ in rows if not r_["ok"]]
    log(f"[mesh] levels launch: {len(rows) - len(bad)}/{len(rows)} rows "
        f"pass; {dev_us:.2f} us a launch on the card, {us:.2f} by events "
        f"(plain {plain_us:.2f}, bound {bound_us:.2f}); phase "
        f"{rec['phase_s']} s")
    if bad:
        raise Failed("levels launch parity: " + "; ".join(
            f"{r_['case']}: max {r_['max_abs_err']}" for r_ in bad))


def mesh_cli(dev, record, serve):
    """The serve CLI's mesh branch at N = MESH_CLI_N on phase 4's saved
    artifact (int8-stored): tp on float requests, fsdp on uint8 requests
    (``--input-uint8``, scaled on the device). The answers no further from
    the single-device f32 forward of the same images than TP_DEV_FACTOR x
    the bf16 forward's; whether fsdp's equal the bf16 forward's is
    recorded."""
    from quantized_vit_tpu_torch.artifact import load_vit_int4_artifact
    from quantized_vit_tpu_torch.serve import vit_int4_forward
    from quantized_vit_tpu_torch.utils import (patchify_batch,
                                               patchify_batch_u8)

    art, cfg = load_vit_int4_artifact(ART_DIR, device=dev)
    out = {}
    for mode, uint8 in (("tp", False), ("fsdp", True)):
        argv = ["--artifact", ART_DIR, "--requests", str(MESH_CLI_REQUESTS),
                "--max-batch", "8", "--device", str(dev), "--mesh-model",
                str(MESH_CLI_N), "--mesh-mode", mode]
        t0 = time.time()
        res = serve.main(argv + (["--input-uint8"] if uint8 else []))
        images = res["images"]
        if uint8:  # the CLI's cast and scale on the device
            xs = torch.from_numpy(patchify_batch_u8(
                images, cfg.patch_size)).to(dev).to(torch.float32) * \
                torch.full((), 1.0 / 255.0, dtype=torch.float32, device=dev)
        else:
            xs = torch.from_numpy(patchify_batch(images,
                                                 cfg.patch_size)).to(dev)
        direct = {dt: vit_int4_forward(
            art, xs, cfg, float_dtype=getattr(torch, dt),
            images_layout="patches").float().cpu().numpy()
            for dt in ("float32", "bfloat16")}
        dev_single = float(np.abs(direct["bfloat16"]
                                  - direct["float32"]).max())
        # the batcher's batches split into 1-4 images a process, whose
        # routes may differ from a batch-16 forward's: the TP criterion
        # for both modes, fsdp's equality recorded
        diff = float(np.abs(res["answers"] - direct["float32"]).max())
        ok = diff <= TP_DEV_FACTOR * dev_single + 1e-6
        out[mode] = {k: res[k] for k in (
            "requests", "wall_s", "throughput_rps", "latency_p50_ms",
            "latency_p99_ms", "batch_hist", "batches_per_worker",
            "health_latency_s")}
        out[mode].update(input_uint8=uint8, max_abs_diff_f32=diff,
                         equal_bf16=bool(np.array_equal(
                             res["answers"], direct["bfloat16"])),
                         dev_single_bf16=dev_single, ok=ok,
                         seconds=round(time.time() - t0, 1))
        log(f"[mesh cli {mode} N={MESH_CLI_N}{' uint8' if uint8 else ''}] "
            f"{res['throughput_rps']} req/s, p50 {res['latency_p50_ms']} "
            f"ms ({record['nvidia_smi']}); max|d| {diff:.4g} (bf16 single "
            f"{dev_single:.4g}), ok {ok}")
        if not ok:
            raise Failed(f"mesh CLI {mode}: answers off the direct forward "
                         f"by {diff}")
    return out


# ---------------------------------------------------------------------------
# phase 10: multi-device training, GPipe and serving with a data axis
# ---------------------------------------------------------------------------

TRAIN_MESH_LAYOUTS = ((2, 2), (1, 2), (2, 1))
TRAIN_MESH_STEPS = 3
# the elastic run: a checkpoint at step ELASTIC_START, ELASTIC_STEPS steps,
# the failure injected at the health check before the third of them
ELASTIC_START = 3
ELASTIC_STEPS = 4
SERVE_DP_ITERS = 3
# The gathered gradients of a layout's first step, against two
# single-process references on the same weights and images: the step on the
# whole batch ("full") and the mean of the steps on each data line's half
# ("split", what a data axis of 2 computes). The (1, 1) layout runs the
# full step's operations in its order, and the (2, 1) layout each half's
# (the same shapes) with a rank-order mean: each within EXACT_TOL of its
# reference. Tensor parallelism sums the row-parallel products in another
# order, and at ViT-B's depth with 8-bit quantizers a reordered sum moves
# activations across quantization levels, which the backward amplifies; so
# the (1, 2) and (2, 2) layouts are held to the conditioning of the step
# itself: their distance from the full step at most TP_GRAD_FACTOR times the
# split step's distance from it (as phase 9 holds the TP forward to a
# multiple of the bf16 forward's deviation). A distance: over the weight,
# bias, LayerNorm and embedding leaves, ||a - b|| / ||b|| of all of them
# together; over the quantizer scalars (d, q_m, t; sums whose terms
# cancel), the largest |a - b| over the L1 mass of the scalar's summands
# (tests/test_torch_qat_vit.py's measure, recorded on the full step).
EXACT_TOL = 1e-6
TP_GRAD_FACTOR = 3.0
# the quantized ring against the exact sum, relative to each leaf's largest
# magnitude (tests/parallel/test_collectives.py's bounds)
RING_MAX, RING_MEAN = 0.15, 0.02
PIPE_TOL = 1e-4


def _digest(tree):
    """{path: sha1 of the leaf's bytes} of a tree of tensors."""
    import hashlib

    from quantized_vit_tpu_torch.models import flatten_tree

    return {k: hashlib.sha1(v.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()
        for k, v in flatten_tree(tree).items()}


def _peak_mib(dev):
    return (torch.cuda.max_memory_allocated(dev) / 2**20
            if dev.type == "cuda" else None)


_SCALAR_NAMES = ("d_quant", "q_m", "t_quant")


def _grad_errors(got, ref, masses):
    """(distance of the weight-like leaves, distance of the quantizer
    scalars, non-finite leaves, the five leaves farthest off by their own
    scale) of gathered gradients ``got`` from ``ref`` (flat, CPU); see
    the comment above EXACT_TOL."""
    from quantized_vit_tpu_torch.models import flatten_tree

    got = flatten_tree(got)
    num = den = worst_s = 0.0
    bad, rows = [], []
    for k, want in ref.items():
        g = got[k].detach().float().cpu()
        if not torch.isfinite(g).all():
            bad.append(k)
        diff = (g.double() - want.double())
        err = float(diff.abs().max())
        if k.rsplit("/", 1)[-1].startswith(_SCALAR_NAMES):
            scale = masses.get(k, 0.0)
            worst_s = max(worst_s, err / max(scale, 1e-30))
        else:
            scale = float(want.abs().max())
            num += float((diff * diff).sum())
            den += float((want.double() ** 2).sum())
        rows.append((err / max(scale, 1e-30), k, err, scale))
    rows.sort(reverse=True)
    return (num / max(den, 1e-300)) ** 0.5, worst_s, bad, rows[:5]


def _record_masses(named):
    """Patches K7's entry (``quant_vjp.lsfq_nonlinear_bwd_fused``) to also
    record, per quantizer scalar of ``named`` ({path: leaf}), the L1 mass
    of its gradient's summands (the plain chain's terms, f64); returns
    (masses, undo)."""
    from quantized_vit_tpu_torch.ops import quant_vjp as qv

    fused = qv.lsfq_nonlinear_bwd_fused
    by_ptr = {v.data_ptr(): k for k, v in named.items()}
    masses = {}

    def recording(x, g, d, q_m, t, **kw):
        terms = qv.nonlinear_bwd_terms(x, g, d, q_m, t, **kw)[1:]
        for p, term in zip((d, q_m, t), terms):
            masses[by_ptr[p.data_ptr()]] = float(term.abs().sum(
                dtype=torch.float64))
        return fused(x, g, d, q_m, t, **kw)

    qv.lsfq_nonlinear_bwd_fused = recording

    def undo():
        qv.lsfq_nonlinear_bwd_fused = fused

    return masses, undo


def _train_layout(mesh, cfg, params, x, y, ref, steps, barrier,
                  trace=False):
    """``steps`` timed DP x TP steps from ``params`` at ``mesh`` (every rank
    of it calls this): the first step's loss and gathered gradients
    against the single-process step's (``ref``), then rank 0's step ms,
    the fences a step of each axis and their host ms, K7's launches a
    step in this process, its peak memory; with ``trace``, on the card,
    one more step, rank 0's traced (``profile_step``: kernel ms, idle
    share)."""
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.parallel import (gather_state,
                                                  init_train_state,
                                                  train_step)

    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(params, mesh, cfg)
    axes = [a for a in ("model", "data") if mesh.shape[a] > 1]
    out = {"layout": tuple(mesh.shape.values()), "ms": [], "loss": [],
           "k7": [], "fences": [], "fence_host_ms": []}
    for i in range(steps):
        peers = [mesh.peers(a) for a in axes]
        f0 = [(p.fences, p.fence_s) for p in peers]
        barrier()
        _build.reset_launches()
        t0 = time.perf_counter()
        state, loss, grads = train_step(state, x, y, cfg, mesh)
        loss = float(loss)  # the host waits for the step
        if cuda:
            torch.cuda.synchronize(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(loss)
        out["k7"].append(_build.LAUNCHES.get("quant_bwd", 0))
        out["fences"].append({a: p.fences - f[0]
                              for a, p, f in zip(axes, peers, f0)})
        out["fence_host_ms"].append({a: (p.fence_s - f[1]) * 1e3
                                     for a, p, f in zip(axes, peers, f0)})
        if i == 0:
            full = gather_state(grads, mesh, cfg)
            if mesh.rank == 0:
                out["grad"] = {
                    name: _grad_errors(full, ref[name], ref["masses"])
                    for name in ("full", "split")}
            del full
        del grads
    if cuda and trace:  # one more step, rank 0's under torch.profiler
        barrier()

        def step():
            nonlocal state
            state, loss_, _ = train_step(state, x, y, cfg, mesh)
            float(loss_)

        if mesh.rank == 0:
            out["profile"] = profile_step(step)
        else:
            step()
    out["loss_rel"] = abs(out["loss"][0] - ref["loss"]) / abs(ref["loss"])
    out["peak_mib"] = _peak_mib(dev)
    return state, out


def _ring_check(mesh, cfg, state, x, y):
    """The int8 ring at the data axis on this step's local gradients
    against the exact sum: per leaf, the largest and the mean error
    relative to the leaf's largest magnitude; and a digest of the ring's
    result (the same on every replica of the data line)."""
    from quantized_vit_tpu_torch.models import flatten_tree
    from quantized_vit_tpu_torch.parallel import dp_all_reduce_grads
    from quantized_vit_tpu_torch.parallel.train_step import loss_and_grads

    _, local = loss_and_grads(state.params, x, y, cfg, mesh,
                              sync_data=False)
    dpeers = mesh.peers("data")
    exact = flatten_tree(dp_all_reduce_grads(local, dpeers))
    quant = flatten_tree(dp_all_reduce_grads(local, dpeers, quantized=True))
    worst, mean = 0.0, 0.0
    for k, e in exact.items():
        scale = max(float(e.abs().max()), 1e-30)
        err = (quant[k] - e).abs() / scale
        worst = max(worst, float(err.max()))
        mean = max(mean, float(err.mean()))
    digest = _digest(quant)
    same = dpeers.all_gather_object(digest)
    return {"max_rel": worst, "mean_rel": mean,
            "replicas_equal": all(d == same[0] for d in same)}


def _serve_dp(mesh, cfg, art, x, iters, with_single, tag):
    """The TP (f32/f32) and column-FSDP (bf16) forwards at ``mesh``'s model
    line, each once with the launch counters set to 0 just before and
    read just after, then timed in turns (a host barrier, the forward, a
    synchronize) with, on rank 0 (``with_single``), the single-device
    bf16 forward of the whole batch."""
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.serve import (
        prepare_fsdp_kernels, prepare_kernels, prepare_tp_artifact,
        prepare_tp_kernels, shard_fsdp_artifact, shard_tp_artifact,
        vit_int4_forward, vit_int4_forward_fsdp, vit_int4_forward_tp)

    dev = mesh.device
    cuda = dev.type == "cuda"
    line = mesh.peers("model")
    world = mesh.world_peers()
    rank, tp = line.rank, line.tp
    tart = shard_tp_artifact(prepare_tp_artifact(art, cfg, tp), rank, tp)
    fart = shard_fsdp_artifact(art, rank, tp)
    b = x.shape[0]
    kw = dict(images_layout="patches")
    tplan = (prepare_tp_kernels(tart, cfg, line, batches=(b,),
                                comm_dtype=torch.float32) if cuda else None)
    fplan = prepare_fsdp_kernels(fart, cfg, line) if cuda else None
    splan = prepare_kernels(art, cfg) if cuda and with_single else None

    def done():
        if cuda:
            torch.cuda.synchronize(dev)

    fwds = {
        "tp_f32": lambda: vit_int4_forward_tp(
            tart, x, cfg, line, float_dtype=torch.float32,
            comm_dtype=torch.float32, plan=tplan, **kw),
        "fsdp_bf16": lambda: vit_int4_forward_fsdp(
            fart, x, cfg, line, float_dtype=torch.bfloat16, plan=fplan,
            **kw)}
    out = {}
    for name, fn in fwds.items():
        world.barrier()
        _build.reset_launches()
        f0 = line.fences
        logits = fn()
        done()
        out[name] = {"logits": logits.float().cpu().numpy(),
                     "launches": dict(_build.LAUNCHES),
                     "fences": line.fences - f0}
    turns = dict(fwds)
    if with_single:
        turns["single_bf16"] = lambda: vit_int4_forward(
            art, x, cfg, float_dtype=torch.bfloat16, plan=splan, **kw)
    ms = {k: [] for k in list(fwds) + ["single_bf16"]}
    for _ in range(iters):
        for name in ms:
            world.barrier()
            t0 = time.perf_counter()
            if name in turns:
                turns[name]()
                done()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    out["wall_ms"] = {k: statistics.median(v) for k, v in ms.items() if v}
    out["tag"] = tag
    return out


def _pipe_check(mesh_pipe, cfg_kw, x, dev):
    """GPipe at the stages of ``mesh_pipe`` and 2 microbatches: the float
    ViT-B/16 forward (seed 0, TF32 off) against the single-process
    forward of the same model; (max |diff|, rank 0's ms, single ms)."""
    from quantized_vit_tpu_torch.models import (QuantConfig, ViTConfig,
                                                VisionTransformer, apply)
    from quantized_vit_tpu_torch.parallel import vit_pipeline_forward

    cfg = ViTConfig(**cfg_kw, quant=QuantConfig.off())
    model = VisionTransformer(cfg, seed=0, device=dev)
    params = model.param_tree()
    with torch.no_grad():
        mesh_pipe.world_peers().barrier()
        t0 = time.perf_counter()
        got = vit_pipeline_forward(model, params, x, mesh=mesh_pipe,
                                   n_microbatches=2)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = apply(model, params, x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        single_ms = (time.perf_counter() - t0) * 1e3
    return float((got - want).abs().max()), ms, single_ms


def train_mesh_worker(rank, world, init_method, dev_name, cfg_kw, x_np,
                      y_np, serve_x_np, ref_path, work_dir):
    """One of the four processes of phase 10, sharing the card (the phase's
    docstring gives the order); returns its record."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from quantized_vit_tpu_torch.models import (QuantConfig, ViTConfig,
                                                VisionTransformer,
                                                init_quant_params_tree,
                                                tree_map)
    from quantized_vit_tpu_torch.parallel import (
        HealthCheckError, collective_health_check, create_mesh,
        gather_params, initialize_distributed, reinitialize_distributed,
        restore_sharded_checkpoint, run_with_elastic_recovery,
        save_sharded_checkpoint, train_step)
    from quantized_vit_tpu_torch.parallel.train_step import (
        TrainState, gather_state, logical_shards, state_from_params)
    from quantized_vit_tpu_torch.serve import random_vit_int4_artifact

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scfg = ViTConfig(**cfg_kw)  # the serving artifact's config
    cfg_kw = {k: v for k, v in cfg_kw.items() if k != "quant"}
    initialize_distributed(init_method, world, rank, device=dev_name)
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = ViTConfig(**cfg_kw, quant=QuantConfig(enabled=True,
                                                fused_vjp=True))
    model = VisionTransformer(cfg, seed=0, device=dev)
    params = init_quant_params_tree(
        tree_map(lambda p: p.detach().clone(), model.param_tree()),
        init_bits=8.0)
    del model
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    # the reference gradients: only the ranks that are rank 0 of a layout
    # (0 of (2, 2) and (1, 2), 2 of (2, 1)) compare them
    ref = torch.load(ref_path + ".loss.pt")
    if rank in (0, 2):
        ref.update(torch.load(ref_path + ".grads.pt"))
    art = random_vit_int4_artifact(scfg, seed=0, pack_weights=True,
                                   device=dev)
    sx = torch.from_numpy(serve_x_np).to(dev)
    out = {"rank": rank, "stamps": []}
    t_last = [time.perf_counter()]

    def stamp(what):  # seconds spent since the last stamp
        now = time.perf_counter()
        out["stamps"].append((what, round(now - t_last[0], 1)))
        t_last[0] = now

    # (2, 2): the timed steps, the ring, the checkpoint, serving
    mesh = create_mesh((2, 2), device=dev)
    barrier = mesh.world_peers().barrier
    stamp("setup")
    state, out["train_2x2"] = _train_layout(mesh, cfg, params, x, y, ref,
                                            TRAIN_MESH_STEPS, barrier,
                                            trace=True)
    stamp("train 2x2")
    out["ring"] = _ring_check(mesh, cfg, state, x, y)
    stamp("ring")
    ckpt = os.path.join(work_dir, "ckpt")
    tree = logical_shards(state.params, mesh, cfg)
    full = gather_params(tree, mesh)
    out["saved_digest"] = _digest(full) if rank in (0, 2) else None
    del full
    t0 = time.perf_counter()
    save_sharded_checkpoint(ckpt, tree, {"step": ELASTIC_START}, mesh=mesh)
    out["ckpt_save_s"] = time.perf_counter() - t0
    del tree
    stamp("checkpoint")
    out["serve_2x2"] = _serve_dp(mesh, scfg, art, sx, SERVE_DP_ITERS,
                                 rank == 0, "2x2")
    stamp("serve 2x2")
    # the elastic run: (2, 2) until the injected failure, then (1, 2)
    calls = {"n": 0}

    def flaky_health(m):
        calls["n"] += 1
        if calls["n"] == 3:  # the watchdog fires before the third step
            raise HealthCheckError("injected: rank lost (watchdog)")
        return collective_health_check(m, timeout_s=SPAWN_TIMEOUT_S / 2)

    seen = []

    def step_fn(p, m, step):
        st = p if isinstance(p, TrainState) else state_from_params(
            p, m, cfg, count=step)
        st, _, _ = train_step(st, x, y, cfg, m)
        seen.append((step, m.size))
        return st

    t0 = time.perf_counter()
    final, mesh12, failures = run_with_elastic_recovery(
        step_fn, state, mesh, ckpt, steps=ELASTIC_START + ELASTIC_STEPS,
        start_step=ELASTIC_START, health_fn=flaky_health,
        surviving_ranks_fn=lambda: [0, 1], model_parallel=2,
        store_dir=work_dir)
    out["elastic"] = {"failures": failures, "seen": seen,
                      "s": time.perf_counter() - t0}
    stamp("elastic")
    del state
    done_marker = os.path.join(work_dir, "pair0_done")
    if mesh12 is not None:  # ranks 0, 1: the (1, 2) group
        barrier = mesh12.world_peers().barrier
        out["elastic"]["final"] = _digest(gather_state(final.params, mesh12,
                                                       cfg))
        del final
        tree, extra = restore_sharded_checkpoint(ckpt, mesh=mesh12)
        out["restore_1x2"] = _digest(gather_params(tree, mesh12))
        st = state_from_params(tree, mesh12, cfg, count=extra["step"])
        del tree
        for step in range(extra["step"], ELASTIC_START + ELASTIC_STEPS):
            st, _, _ = train_step(st, x, y, cfg, mesh12)
        out["uninterrupted"] = _digest(gather_state(st.params, mesh12, cfg))
        del st
        stamp("restore, uninterrupted run")
        _, out["train_1x2"] = _train_layout(mesh12, cfg, params, x, y, ref,
                                            TRAIN_MESH_STEPS, barrier)
        stamp("train 1x2")
        pipe = create_mesh((2,), ("pipe",), device=dev)
        out["pipe"] = _pipe_check(pipe, cfg_kw, x, dev)
        stamp("gpipe")
        out["serve_1x2"] = _serve_dp(mesh12, scfg, art, sx, SERVE_DP_ITERS,
                                     False, "1x2")
        stamp("serve 1x2")
        mesh12.close()
        if mesh12.rank == 0:
            open(done_marker, "w").close()
    else:  # ranks 2, 3: the (2, 1) group, on a fresh store
        reinitialize_distributed(f"file://{work_dir}/pair1", 2, rank - 2)
        mesh21 = create_mesh((2, 1), device=dev)
        tree, _ = restore_sharded_checkpoint(ckpt, mesh=mesh21)
        out["restore_2x1"] = _digest(gather_params(tree, mesh21))
        del tree
        stamp("restore 2x1")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not os.path.exists(done_marker):  # one pair on the card
            if time.monotonic() > deadline:
                raise RuntimeError("the (1, 2) group never finished")
            time.sleep(0.05)
        stamp("wait for the (1, 2) group")
        barrier = mesh21.world_peers().barrier
        _, out["train_2x1"] = _train_layout(mesh21, cfg, params, x, y, ref,
                                            TRAIN_MESH_STEPS, barrier)
        stamp("train 2x1")
        out["serve_2x1"] = _serve_dp(mesh21, scfg, art, sx, SERVE_DP_ITERS,
                                     rank == 2, "2x1")
        stamp("serve 2x1")
        mesh21.close()
    out["peak_mib"] = _peak_mib(dev)
    reinitialize_distributed("", 1, 0)
    return out


def train_mesh_phase(dev, record, arts):
    """Phase 10: multi-device training at ViT-B/16 width (the config of
    ``main_cfg``, QAT with K7 on every nonlinear quantizer's backward,
    seed 0, batch BATCH) and serving with a data axis, four processes
    sharing the card. In this process: the single-process step (the
    model's own forward and backward, the reference) and the (1, 1)
    layout of the DP x TP step. Spawned, in order: the (2, 2) step
    (TRAIN_MESH_STEPS steps; the first step's loss within 1e-4 relative
    of the reference's, its gathered gradients as the comment above
    EXACT_TOL sets out); the int8 ring at dp = 2 on a step's gradients
    against the exact sum (RING_MAX, RING_MEAN; every replica
    bit-identical); a
    sharded checkpoint of the (2, 2) params (as the JAX package's holds;
    a resume starts Adam's moments at zero); TP (f32) and column-FSDP
    (bf16) serving at (2, 2) on phase 9's artifact; an elastic run from
    that checkpoint with a HealthCheckError injected before the third of
    ELASTIC_STEPS steps, which resumes on (1, 2) (ranks 2, 3 leave); on
    the (1, 2) group the checkpoint restored (params equal to the
    gathered ones), an uninterrupted (1, 2) run from it (final params
    bit-equal to the elastic run's), the (1, 2) step, GPipe at 2 stages
    and 2 microbatches (the float model within PIPE_TOL of the
    single-process forward, TF32 off) and (1, 2) serving; then on ranks
    2, 3 as a (2, 1) group: the checkpoint restored, the (2, 1) step and
    (2, 1) serving. Serving logits: column FSDP bit-equal to the
    single-device forward, TP within 1e-4 of the (1, tp) TP forward.
    Each layout's step prints rank 0's ms, the fences a step and their
    host ms, K7's launches a step in every process and each process's
    peak memory."""
    from quantized_vit_tpu_torch.models import apply, flatten_tree
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.parallel import create_mesh, run_processes
    from quantized_vit_tpu_torch.serve import (prepare_tp_artifact,
                                               shard_tp_artifact,
                                               vit_int4_forward,
                                               vit_int4_forward_tp)

    t_phase = time.time()
    cuda = dev.type == "cuda"
    model, params = qat_model(0, dev)
    cfg = model.cfg
    x_np, y_np = seeded_batches(cfg, 1, 21)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    # the single-process step: the model's forward and backward
    live = {k: v.detach().clone().requires_grad_(True)
            for k, v in flatten_tree(params).items()}
    _build.reset_launches()
    from quantized_vit_tpu_torch.models import unflatten_tree

    def step(xb, yb):
        logits = apply(model, unflatten_tree(live), xb)
        onehot = torch.nn.functional.one_hot(yb, cfg.num_classes).float()
        loss = -torch.mean(torch.sum(torch.log_softmax(logits, -1) * onehot,
                                     -1))
        return loss, torch.autograd.grad(loss, list(live.values()))

    masses, undo = _record_masses(live)
    try:
        loss, grads = step(x, y)
    finally:
        undo()
    single_k7 = _build.LAUNCHES.get("quant_bwd", 0)
    half = x.shape[0] // 2
    halves = [step(x[i * half:(i + 1) * half], y[i * half:(i + 1) * half])[1]
              for i in range(2)]
    ref = {"loss": float(loss.detach()), "masses": masses,
           "full": {k: g.detach().float().cpu()
                    for k, g in zip(live, grads)},
           "split": {k: ((a + b) / 2).detach().float().cpu()
                     for k, a, b in zip(live, *halves)}}
    base = _grad_errors(ref["split"], ref["full"], masses)
    del live, grads, halves
    work = os.path.join(OUT_DIR, "dist", f"train_mesh_{time.time_ns()}")
    os.makedirs(work, exist_ok=True)
    ref_path = os.path.join(work, "ref")
    torch.save({k: ref[k] for k in ("loss", "masses")}, ref_path + ".loss.pt")
    torch.save({k: ref[k] for k in ("full", "split")}, ref_path + ".grads.pt")
    rec = {"batch": int(x.shape[0]), "single_loss": ref["loss"],
           "single_k7": single_k7, "split_distance": base[:2]}
    log(f"[train mesh] the split step's distance from the full step "
        f"{base[0]:.3e} (scalars {base[1]:.3e}); farthest "
        f"{[(w[1], f'{w[2]:.3g}/{w[3]:.3g}') for w in base[3][:3]]}")
    # the (1, 1) layout in this process
    one = create_mesh((1, 1), device=dev)
    _, rec["train_1x1"] = _train_layout(one, cfg, params, x, y, ref,
                                        TRAIN_MESH_STEPS, lambda: None,
                                        trace=True)
    del model, params
    gc.collect()
    # phase 9's artifact and images; the (1, tp) references
    scfg, art, sx = arts["cfg"], arts["art_packed"], arts["x"]
    kw = dict(images_layout="patches")
    single = {dt: vit_int4_forward(art, sx, scfg, float_dtype=getattr(
        torch, dt), **kw).float().cpu() for dt in ("float32", "bfloat16")}
    tp1 = vit_int4_forward_tp(shard_tp_artifact(prepare_tp_artifact(
        art, scfg, 1), 0, 1), sx, scfg, float_dtype=torch.float32,
        comm_dtype=torch.float32, **kw).float().cpu()
    t0 = time.time()
    try:
        res = run_processes(
            train_mesh_worker, 4, os.path.join(OUT_DIR, "dist"),
            args=(DEV, dataclasses.asdict(scfg), x_np, y_np,
                  sx.cpu().numpy(), ref_path, work),
            timeout_s=SPAWN_TIMEOUT_S)
    except RuntimeError as e:
        raise Failed(f"phase 10: {e}")
    rec["spawn_s"] = round(time.time() - t0, 1)
    fails = []
    lay_runs = {"1x1": [rec["train_1x1"]]}
    for key, ranks in (("2x2", (0, 1, 2, 3)), ("1x2", (0, 1)),
                       ("2x1", (2, 3))):
        lay_runs[key] = [res[r][f"train_{key}"] for r in ranks]
    rec["train"] = {}
    for key, runs in lay_runs.items():
        r0 = runs[0]
        row = {"loss": r0["loss"], "loss_rel": r0["loss_rel"],
               "ms_rank0": r0["ms"], "k7_per_step": [r["k7"] for r in runs],
               "fences": r0["fences"], "fence_host_ms": r0["fence_host_ms"],
               "peak_mib": [r["peak_mib"] for r in runs],
               "grad": r0["grad"], "profile_rank0": r0.get("profile")}
        rec["train"][key] = row
        gf, gs = r0["grad"]["full"], r0["grad"]["split"]
        log(f"[train mesh {key}] loss {r0['loss'][0]:.6f} (single "
            f"{ref['loss']:.6f}, rel {r0['loss_rel']:.2e}); gradients vs "
            f"the full step {gf[0]:.2e} (scalars {gf[1]:.2e}), vs the split "
            f"step {gs[0]:.2e} ({gs[1]:.2e}); farthest "
            f"{[(w[1], f'{w[2]:.3g}/{w[3]:.3g}') for w in gf[3][:3]]}; "
            f"rank 0 step ms {[round(v, 1) for v in r0['ms']]}; fences a "
            f"step {r0['fences'][-1]} ({r0['fence_host_ms'][-1]} ms host); "
            f"K7 a step {row['k7_per_step']}; peak MiB {row['peak_mib']} "
            f"({record['nvidia_smi']})")
        p = r0.get("profile")
        if p:
            log(f"[train mesh {key} profile] traced wall {p['wall_ms']:.1f}"
                f" ms, kernels {p['kernel_ms']:.1f} ms ({p['kernels']}), "
                f"idle {p['idle_share']:.2f}, K7 {p['quant_bwd_ms']:.2f} ms;"
                " top " + ", ".join(f"{n[:40]} {ms_:.2f}x{c}"
                                    for n, ms_, c in p["top"][:5]))
        if r0["loss_rel"] > 1e-4:
            fails.append(f"{key} loss {r0['loss'][0]} vs {ref['loss']}")
        exact = {"1x1": gf, "2x1": gs}.get(key)
        if exact is not None:
            ok = exact[0] <= EXACT_TOL and exact[1] <= EXACT_TOL
        else:
            ok = (gf[0] <= TP_GRAD_FACTOR * base[0] + EXACT_TOL
                  and gf[1] <= TP_GRAD_FACTOR * base[1] + EXACT_TOL)
        if not ok or gf[2]:
            fails.append(f"{key} gradients {gf[:3]} / split {gs[:3]} "
                         f"(the split step's distance {base[:2]})")
        if cuda and any(k != single_k7 for r in runs for k in r["k7"]):
            fails.append(f"{key} K7 launches {row['k7_per_step']} != "
                         f"{single_k7} a step")
    ring = [res[r]["ring"] for r in range(4)]
    rec["ring"] = ring
    log(f"[train mesh ring dp=2] max rel {max(r['max_rel'] for r in ring):.4f}"
        f", mean rel {max(r['mean_rel'] for r in ring):.5f}, replicas equal "
        f"{all(r['replicas_equal'] for r in ring)}")
    if any(r["max_rel"] >= RING_MAX or r["mean_rel"] >= RING_MEAN
           or not r["replicas_equal"] for r in ring):
        fails.append(f"int8 ring {ring}")
    saved = res[0]["saved_digest"]
    restored = {"1x2": res[0]["restore_1x2"], "2x1": res[2]["restore_2x1"]}
    el = res[0]["elastic"]
    rec["ckpt"] = {"save_s": res[0]["ckpt_save_s"],
                   "restored_equal": {k: v == saved
                                      for k, v in restored.items()}}
    rec["elastic"] = {"failures": el["failures"], "seen": el["seen"],
                      "s": el["s"], "others": [res[r]["elastic"]["seen"]
                                               for r in (2, 3)],
                      "bit_equal": el["final"] == res[0]["uninterrupted"]}
    log(f"[train mesh ckpt] restored equal {rec['ckpt']['restored_equal']}; "
        f"elastic: failures {el['failures']}, steps {el['seen']}, final "
        f"params bit-equal to the uninterrupted (1, 2) run: "
        f"{rec['elastic']['bit_equal']} ({el['s']:.1f} s)")
    want_seen = ([(s, 4) for s in range(ELASTIC_START, ELASTIC_START + 2)]
                 + [(s, 2) for s in range(ELASTIC_START,
                                          ELASTIC_START + ELASTIC_STEPS)])
    if (not all(rec["ckpt"]["restored_equal"].values())
            or el["failures"] != 1 or el["seen"] != want_seen
            or not rec["elastic"]["bit_equal"]):
        fails.append(f"checkpoint / elastic {rec['ckpt']} {rec['elastic']}")
    pipe_err, pipe_ms, pipe_single = res[0]["pipe"]
    rec["pipe"] = {"max_abs_diff": pipe_err, "ms_rank0": pipe_ms,
                   "single_ms": pipe_single}
    log(f"[train mesh gpipe 2 stages] max |diff| {pipe_err:.3g} vs the "
        f"single-process forward; {pipe_ms:.1f} ms (single {pipe_single:.1f}"
        f" ms, one call each, host clock)")
    if not pipe_err <= PIPE_TOL:
        fails.append(f"GPipe forward differs by {pipe_err}")
    rec["serve"] = {}
    tp_ref = {"2x1": tp1, "2x2": torch.from_numpy(np.concatenate(
        [res[r]["serve_1x2"]["tp_f32"]["logits"] for r in (0, 1)]))}
    for key, ranks in (("2x2", (0, 1, 2, 3)), ("2x1", (2, 3))):
        runs = [res[r][f"serve_{key}"] for r in ranks]
        row = {"wall_ms_rank0": runs[0]["wall_ms"]}
        for name in ("tp_f32", "fsdp_bf16"):
            got = torch.from_numpy(np.concatenate([r[name]["logits"]
                                                   for r in runs]))
            base = tp_ref[key] if name == "tp_f32" else single["bfloat16"]
            diff = float((got - base).abs().max())
            row[name] = {"max_abs_diff": diff,
                         "equal": bool(torch.equal(got, base)),
                         "launches": runs[0][name]["launches"],
                         "fences": runs[0][name]["fences"]}
            if tuple(got.shape) != tuple(single["float32"].shape) or (
                    name == "tp_f32" and diff > 1e-4) or (
                    name == "fsdp_bf16" and not row[name]["equal"]):
                fails.append(f"serving {name} at {key}: {diff}")
        rec["serve"][key] = row
        nz = {n: {k: v for k, v in row[n]["launches"].items() if v}
              for n in ("tp_f32", "fsdp_bf16")}
        log(f"[serve dp=2 {key}] TP f32 vs (1, tp) "
            f"{row['tp_f32']['max_abs_diff']:.3g}, FSDP bf16 equal "
            f"{row['fsdp_bf16']['equal']}; launches TP {nz['tp_f32']}, FSDP "
            f"{nz['fsdp_bf16']}; fences {row['tp_f32']['fences']} / "
            f"{row['fsdp_bf16']['fences']}; rank 0 wall ms "
            f"{row['wall_ms_rank0']} ({record['nvidia_smi']})")
    rec["peak_mib"] = [r["peak_mib"] for r in res]
    rec["phase_s"] = round(time.time() - t_phase, 1)
    record["train_mesh"] = rec
    for k_ in record.get("kernels", []):
        if k_["name"] == "quant_bwd":
            k_.setdefault("mesh_launches", {})["train_2x2_step"] = \
                rec["train"]["2x2"]["k7_per_step"][0][0]
        for key in ("2x2", "2x1"):
            for name in ("tp_f32", "fsdp_bf16"):
                n = rec["serve"][key][name]["launches"].get(k_["name"])
                if n:
                    k_.setdefault("mesh_launches", {})[
                        f"{name.split('_')[0]}_{key}"] = n
    rec["stamps"] = {r: res[r]["stamps"] for r in (0, 2)}
    log(f"[train mesh] phase {rec['phase_s']} s (spawned {rec['spawn_s']} s;"
        f" rank 0 {res[0]['stamps']}; rank 2 {res[2]['stamps']})")
    if fails:
        raise Failed("phase 10: " + "; ".join(fails))



# ---------------------------------------------------------------------------
# phase 11: UltraNet end to end
# ---------------------------------------------------------------------------


def ultra_trees(seed: int = 0):
    """UltraNet's params and batch_stats as numpy trees: the port's
    initializers from ``seed``, BN parameters and statistics drawn from
    numpy as tests/artifact/test_model_artifacts.py draws them (a trained
    model's small statistics)."""
    from quantized_vit_tpu_torch.models import (ULTRANET_LAYERS, UltraNet,
                                                flatten_tree, unflatten_tree)

    m = UltraNet(seed=seed, device="cpu")

    def np_tree(tree):
        return unflatten_tree({k: v.detach().numpy().copy()
                               for k, v in flatten_tree(tree).items()})

    params, stats = np_tree(m.param_tree()), np_tree(m.batch_stats_tree())
    rng = np.random.default_rng(seed)
    for i, (feat, _, _) in enumerate(ULTRANET_LAYERS):
        stats[f"bn_{i}"]["mean"] = rng.normal(0, 0.05, feat).astype(
            np.float32)
        stats[f"bn_{i}"]["var"] = rng.uniform(0.5, 1.5, feat).astype(
            np.float32)
        params[f"bn_{i}"]["scale"] = rng.uniform(0.5, 1.5, feat).astype(
            np.float32)
        params[f"bn_{i}"]["bias"] = rng.normal(0, 0.1, feat).astype(
            np.float32)
    return params, stats


def ultra_layers(model, x, train, inputs=None):
    """Per block of ``model`` on ``x``: (its input, BN output, activation
    after the quantizer and pool). With ``inputs``, block i takes
    ``inputs[i]`` (another run's) instead of its own previous output."""
    from quantized_vit_tpu_torch.models import ULTRANET_LAYERS
    from quantized_vit_tpu_torch.models.ultranet import max_pool_2x2
    from quantized_vit_tpu_torch.quant import quantize_activation

    rows, act = [], x
    for i, (_, _, pool) in enumerate(ULTRANET_LAYERS):
        if inputs is not None:
            act = inputs[i]
        bn = getattr(model, f"bn_{i}")(getattr(model, f"conv_{i}")(act),
                                       train)
        out = quantize_activation(bn, model.a_bit)
        rows.append((act, bn, max_pool_2x2(out) if pool else out))
        act = rows[-1][2]
    return rows


def ultra_level_flips(got, want, what, fails):
    """Levels of two BN outputs (the card's, the CPU's): equal but where
    the CPU's value lies within ULTRA_TIE levels of a half-level, there at
    most one apart. Returns the count of positions that differ."""
    pre = np.clip(want.astype(np.float64), 0, 1) * 15
    g = np.round(np.clip(got, 0, 1) * 15)
    w = np.round(np.clip(want, 0, 1) * 15)
    d = np.abs(g - w)
    tie = np.abs(pre - np.floor(pre) - 0.5) < ULTRA_TIE
    if d.max(initial=0) > 1 or ((d > 0) & ~tie).any():
        fails.append(f"{what}: levels differ off a tie "
                     f"({int(((d > 0) & ~tie).sum())} positions)")
    return int((d > 0).sum())


def bf16_ultranet_forward(params, stats, x):
    """A yardstick the port never calls: UltraNet's architecture as plain
    bf16 cuDNN convs (channels last) with the BN folded to a scale and a
    shift, a clamp to [0, 1] in place of the activation quantizer and no
    weight quantizer."""
    from quantized_vit_tpu_torch.models import ULTRANET_LAYERS

    bf = torch.bfloat16
    layers = []
    for i, (_, _, pool) in enumerate(ULTRANET_LAYERS):
        k = params[f"conv_{i}"]["kernel"].permute(3, 2, 0, 1).to(bf)
        a = params[f"bn_{i}"]["scale"] * torch.rsqrt(
            stats[f"bn_{i}"]["var"] + 1e-5)
        b = params[f"bn_{i}"]["bias"] - stats[f"bn_{i}"]["mean"] * a
        layers.append((k.contiguous(memory_format=torch.channels_last),
                       a.to(bf)[:, None, None], b.to(bf)[:, None, None],
                       pool))
    n = len(ULTRANET_LAYERS)
    k8 = params[f"conv_{n}"]["kernel"].permute(3, 2, 0, 1).to(bf)
    b8 = params[f"conv_{n}"]["bias"].to(bf)
    xb = x.permute(0, 3, 1, 2).to(bf).contiguous(
        memory_format=torch.channels_last)

    def fwd():
        h = xb
        for k, a, b, pool in layers:
            h = torch.clamp(torch.nn.functional.conv2d(h, k, padding=1) * a
                            + b, 0, 1)
            if pool:
                h = torch.nn.functional.max_pool2d(h, 2)
        return torch.nn.functional.conv2d(h, k8, b8)

    return fwd


def _npz_members(path):
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def ultranet_phase(dev, record):
    """Phase 11 (the module docstring's item 11): UltraNet on the card
    against the CPU, its subnet, the integer artifact, the FPGA headers
    and the reference npz; each check fails the run."""
    import copy
    import shutil
    import tempfile

    from quantized_vit_tpu_torch.artifact import (export_ultranet_hls,
                                                  export_ultranet_int,
                                                  generate_ultranet_config,
                                                  hls_texts,
                                                  load_ultranet_artifact,
                                                  save_ultranet_artifact,
                                                  UltraNetExportConfig,
                                                  write_hls)
    from quantized_vit_tpu_torch.models.ultranet import channels_of
    from quantized_vit_tpu_torch.graph import OTO
    from quantized_vit_tpu_torch.interop import export_reference_ultranet
    from quantized_vit_tpu_torch.models import (UltraNetInt,
                                                ultranet_apply,
                                                ultranet_params_from_jax)

    t_phase = time.time()
    fails = []
    rec = {"hw": list(ULTRA_HW), "batch": ULTRA_BATCH,
           "check_batch": ULTRA_CHECK_BATCH}
    params, stats = ultra_trees(0)
    rng = np.random.default_rng(11)
    x_np = rng.random((ULTRA_BATCH, *ULTRA_HW, 3)).astype(np.float32)
    xc_np = x_np[:ULTRA_CHECK_BATCH]

    def on(device, dtype=torch.float32):
        m = ultranet_params_from_jax(params, stats, device=device)
        return m.to(dtype)

    # 1. each block on the CPU's input activation, eval and train
    rec["layers"] = {}
    for train in (False, True):
        cpu, card = on("cpu"), on(dev)
        with torch.no_grad():
            ref = ultra_layers(cpu, torch.from_numpy(xc_np), train)
            got = ultra_layers(card, None, train, inputs=[
                r[0].to(dev) for r in ref])
        tol = ULTRA_BN_TOL[int(train)]
        diffs, flips = [], 0
        for i, (r, g) in enumerate(zip(ref, got)):
            want, have = r[1].numpy(), g[1].cpu().numpy()
            diffs.append(float(np.abs(have - want).max()))
            flips += ultra_level_flips(have, want, f"bn_{i} train={train}",
                                       fails)
        if max(diffs) > tol:
            fails.append(f"BN outputs (train={train}) {max(diffs):.3g} > "
                         f"{tol}")
        row = {"bn_max_abs_diff": max(diffs), "level_flips_at_ties": flips}
        if train:
            st = {k: float(np.abs(v.cpu().numpy() - dict(
                cpu.named_buffers())[k].numpy()).max() / max(float(np.abs(
                    dict(cpu.named_buffers())[k].numpy()).max()), 1e-30))
                for k, v in card.named_buffers()}
            row["running_stats_rel"] = max(st.values())
            if row["running_stats_rel"] > 1e-5:
                fails.append(f"running statistics {row['running_stats_rel']}")
        rec["layers"]["train" if train else "eval"] = row
        log(f"[ultranet layers, train={train}] BN max |diff| "
            f"{max(diffs):.3g} (tol {tol}), level flips at ties {flips}"
            + (f", running stats rel {row['running_stats_rel']:.3g}"
               if train else ""))
    # the whole net end to end in f64: eval outputs, train outputs, the
    # updated running statistics and the gradients of sum(p^2)
    e2e = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        m = on(device, torch.float64)
        xd = torch.from_numpy(xc_np).to(device, torch.float64)
        leaves = dict(m.named_parameters())
        with torch.no_grad():
            io, p_eval = m(xd)
        p_train = m(xd, train=True)
        grads = torch.autograd.grad((p_train ** 2).sum(),
                                    list(leaves.values()))
        e2e[name] = {"io": io, "p_eval": p_eval, "p_train": p_train.detach(),
                     "stats": dict(m.named_buffers()),
                     "grads": dict(zip(leaves, grads))}
    worst = {}
    for key in ("io", "p_eval", "p_train"):
        a, b = e2e["card"][key].cpu(), e2e["cpu"][key]
        worst[key] = float((a - b).abs().max() / b.abs().max())
    for key in ("stats", "grads"):
        worst[key] = max(float((e2e["card"][key][k].cpu() - v).norm()
                               / max(float(v.norm()), 1e-300))
                         for k, v in e2e["cpu"][key].items())
    rec["f64_rel"] = worst
    log(f"[ultranet f64 end to end] card vs CPU, relative: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    if max(worst.values()) > ULTRA_F64_TOL:
        fails.append(f"f64 end to end {worst}")
    del e2e

    # the card's model at batch 32, f32
    model = on(dev)
    x = torch.from_numpy(x_np).to(dev)
    with torch.no_grad():
        io, p = model(x)
    if tuple(p.shape) != (ULTRA_BATCH, 6, ULTRA_HW[0] // 16,
                          ULTRA_HW[1] // 16, 6) or not bool(
                              torch.isfinite(io).all()):
        fails.append(f"eval forward {tuple(p.shape)}")
    tparams = model.param_tree()
    tstats = model.batch_stats_tree()

    # 2. GETA's random zeroing, the subnet and its costs
    oto = OTO(model, tparams, batch_stats=tstats)
    zeroed = oto.random_set_zero_groups(target_group_sparsity=ULTRA_SPARSITY,
                                        seed=0)
    sub, sp, ss = oto.construct_subnet(zeroed)
    macs = (oto.compute_macs(tparams), oto.compute_macs(sp))
    with torch.no_grad():
        sio, s_p = ultranet_apply(sub, sp, ss, x)
    rec["subnet"] = {"channels": list(sub.channels), "macs": list(macs),
                     "bops": [oto.compute_bops(tparams),
                              oto.compute_bops(sp)]}
    log(f"[ultranet subnet] channels {sub.channels}, MACs {macs[0]:.4g} -> "
        f"{macs[1]:.4g} a sample")
    if not macs[1] < macs[0] or not bool(torch.isfinite(sio).all()) or \
            tuple(s_p.shape) != tuple(p.shape):
        fails.append(f"subnet {rec['subnet']}")

    # 3. the integer artifact: export on the card, save, load, run
    exp = UltraNetExportConfig(input_shape=(*ULTRA_HW, 3))
    work = tempfile.mkdtemp(prefix="ultranet_", dir=OUT_DIR)
    art_dir = os.path.join(work, "artifact")
    save_ultranet_artifact(art_dir, tparams, tstats, exp)
    tables, meta = load_ultranet_artifact(art_dir, device=dev)
    int_model = UltraNetInt(device=dev).load_int_params(tables)
    x_lv = torch.round(torch.clamp(x, 0, 1) * 255).to(torch.int32)
    with torch.no_grad():
        iio, ip = int_model(x_lv)
    cpu_tables = {k: v.cpu() for k, v in tables.items()}
    cio, cp = UltraNetInt(device="cpu").load_int_params(cpu_tables)(
        x_lv.cpu())
    box_rel = float(((iio.cpu() - cio).abs() / cio.abs().clamp_min(1.0))
                    .max())
    own = export_ultranet_int({k: {kk: vv.detach().cpu() for kk, vv in
                                   v.items()} for k, v in tparams.items()},
                              {k: {kk: vv.cpu() for kk, vv in v.items()}
                               for k, v in tstats.items()}, exp)
    table_flips = sum(int((own[k] != cpu_tables[k]).sum()) for k in own)
    rec["int"] = {"p_bit_equal": bool(torch.equal(ip.cpu(), cp)),
                  "box_rel": box_rel, "meta_model": meta["model"],
                  "tables_vs_cpu_export_differ": table_flips,
                  "p_abs_max": float(cp.abs().max())}
    log(f"[ultranet int] raw predictions bit-equal to the CPU's "
        f"{rec['int']['p_bit_equal']}, boxes rel {box_rel:.3g}; the CPU's "
        f"own export differs at {table_flips} table entries (ties)")
    if not rec["int"]["p_bit_equal"] or box_rel > 1e-6 or \
            meta["model"] != "ultranet":
        fails.append(f"integer forward {rec['int']}")

    # the native packer (built with g++ at its first use here) on the
    # tables' kernel levels, against its numpy path
    from quantized_vit_tpu_torch.artifact import native

    t0 = time.time()
    rec["native"] = {"available": native.native_available(),
                     "first_use_s": round(time.time() - t0, 2)}
    lv = np.concatenate([cpu_tables[f"conv_{i}_kernel_int"].reshape(
        -1, 16).numpy() for i in range(4, 8)]).astype(np.int8)
    rec["native"]["pack_equal"] = bool(
        np.array_equal(native.pack_int4_host(lv), native._pack_int4_np(lv))
        and np.array_equal(native.unpack_int4_host(
            native.pack_int4_host(lv)), lv))
    log(f"[ultranet native packer] built and loaded in "
        f"{rec['native']['first_use_s']} s (available "
        f"{rec['native']['available']}); pack/unpack equal to numpy "
        f"{rec['native']['pack_equal']}")
    if dev.type == "cuda" and not rec["native"]["available"]:
        fails.append("native packer did not build or load")
    if not rec["native"]["pack_equal"]:
        fails.append("native packer")

    # 4. the FPGA headers and the reference npz, card against CPU
    card_texts = export_ultranet_hls(tparams, tstats,
                                     os.path.join(work, "hls_card"), exp)
    texts = hls_texts(cpu_tables, generate_ultranet_config(
        exp, channels=channels_of(tparams)))
    write_hls(os.path.join(work, "hls_cpu"), texts,
              params["conv_8"]["bias"])
    same = {f: open(os.path.join(work, "hls_card", f), "rb").read()
            == open(os.path.join(work, "hls_cpu", f), "rb").read()
            for f in ("param.h", "config.h", "last_bias.npy",
                      "last_bias.bin")}
    npz_card, cfg_card = export_reference_ultranet(
        tparams, tstats, os.path.join(work, "npz_card"),
        input_shape=(3, *ULTRA_HW))
    npz_cpu, cfg_cpu = export_reference_ultranet(
        params, stats, os.path.join(work, "npz_cpu"),
        input_shape=(3, *ULTRA_HW))
    same["npz"] = _npz_members(npz_card) == _npz_members(npz_cpu)
    same["config.json"] = open(cfg_card, "rb").read() == open(
        cfg_cpu, "rb").read()
    same["texts"] = card_texts == texts
    rec["files_identical"] = same
    log(f"[ultranet files] card vs CPU byte-identical: {same}")
    if not all(same.values()):
        fails.append(f"files {same}")

    # timings at batch ULTRA_BATCH
    train_model = copy.deepcopy(model)
    leaves = list(train_model.parameters())

    def train_step():
        pt = train_model(x, train=True)
        return torch.autograd.grad((pt ** 2).sum(), leaves)

    def eval_fwd():
        with torch.no_grad():
            return model(x)

    def int_fwd():
        with torch.no_grad():
            return int_model(x_lv)

    def sub_fwd():
        with torch.no_grad():
            return ultranet_apply(sub, sp, ss, x)

    bf16_fwd = bf16_ultranet_forward(tparams, tstats, x)
    ms = {"int_forward": cuda_ms(int_fwd), "float_eval": cuda_ms(eval_fwd),
          "train_step": cuda_ms(train_step), "subnet_eval": cuda_ms(sub_fwd),
          "bf16_cudnn_yardstick": cuda_ms(bf16_fwd)}
    rec["ms"] = ms
    clock = "events" if dev.type == "cuda" else "host clock"
    for k, v in ms.items():
        log(f"[ultranet ms] {k} {v:.3f} ms at batch {ULTRA_BATCH}, "
            f"{ULTRA_HW[0]}x{ULTRA_HW[1]} ({clock}; {record['nvidia_smi']})")
    # where the time goes: one traced call each, kernels grouped by name
    rec["split"] = {}
    for k, fn in (("int_forward", int_fwd), ("float_eval", eval_fwd),
                  ("train_step", train_step)):
        sp = kernel_split(traced(fn)[1], top=5)
        if sp is None:
            continue
        rec["split"][k] = sp
        log(f"[ultranet split] {k}: {sp['kernels']} kernels, "
            f"{sp['kernel_ms']:.3f} ms on the card; top " + ", ".join(
                f"{n[:48]} {ms:.3f}x{c}" for n, ms, c in sp["top"]))
    shutil.rmtree(work, ignore_errors=True)
    rec["phase_s"] = round(time.time() - t_phase, 1)
    record["ultranet"] = rec
    log(f"[ultranet] phase {rec['phase_s']} s")
    if fails:
        raise Failed("phase 11: " + "; ".join(fails))



# ---------------------------------------------------------------------------
# phase 12: the other model families
# ---------------------------------------------------------------------------


class Family:
    """One family's run: the model class and its config (quantizers on
    with K7, ``fused_vjp``), its inputs and targets as numpy, the forward
    keywords of a training and an eval forward, and its loss."""

    def __init__(self, name, cls, cfg, inputs, target, train_kw, eval_kw,
                 loss, bn=False):
        self.name, self.cls, self.cfg = name, cls, cfg
        self.inputs, self.target = inputs, target
        self.train_kw, self.eval_kw = train_kw, eval_kw
        self.loss, self.bn = loss, bn

    def model(self, params, stats, cfg=None):
        """A model of ``cfg`` (default the family's) holding the trees'
        tensors (built on the meta device)."""
        from quantized_vit_tpu_torch.models import bind_tree

        return bind_tree(self.cls(cfg or self.cfg, device="meta"), params,
                         stats)

    def forward(self, model, params, stats, inputs, train):
        """(output, new batch_stats or None)."""
        from quantized_vit_tpu_torch.models import apply_variables

        kw = self.train_kw if train else self.eval_kw
        mutable = train and self.bn
        out = apply_variables(model, params, *inputs, batch_stats=stats,
                              mutable=mutable, **kw)
        return out if mutable else (out, None)

    def check_inputs(self, n, device, dtype=None):
        out = []
        for a in self.inputs:
            t = torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)
            out.append(t.to(dtype) if dtype is not None
                       and t.is_floating_point() else t)
        return out


def reconstruction(out, x):
    return torch.mean(torch.square(out - x))


def family_specs():
    """ResNet-20 and MobileNet on CIFAR's 32 x 32 x 3 at batch 128, the
    BERT-base encoder at 128 tokens and batch 32 with a ragged mask, the
    U-Net autoencoder at 64 x 64 and batch 32 (seeded numpy data)."""
    from quantized_vit_tpu_torch import models as M

    q = M.QuantConfig(enabled=True, fused_vjp=True)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((CIFAR_BATCH, CIFAR_HW, CIFAR_HW, 3),
                            dtype=np.float32)
    y = rng.integers(0, 10, CIFAR_BATCH)
    bert = M.TransformerConfig(**{**dict(
        vocab_size=30522, max_len=512, embed_dim=768, depth=12,
        num_heads=12, num_classes=2), **BERT_KW, "quant": q})
    tokens = rng.integers(0, bert.vocab_size, (BERT_BATCH, BERT_SEQ))
    lengths = rng.integers(BERT_SEQ // 4, BERT_SEQ + 1, BERT_BATCH)
    mask = (np.arange(BERT_SEQ)[None] < lengths[:, None]).astype(np.int64)
    ae_x = rng.standard_normal((AE_BATCH, AE_HW, AE_HW, 3), dtype=np.float32)
    kw = ({"deterministic": False}, {"deterministic": True})
    cross_entropy = torch.nn.functional.cross_entropy
    return [
        Family("resnet20", M.ResNet, M.ResNetConfig(**{**dict(
            stage_sizes=(3, 3, 3), widths=(16, 32, 64)), **RESNET_KW,
            "quant": q}), (x,), y, *kw, cross_entropy, bn=True),
        Family("mobilenet", M.MobileNet, M.MobileNetConfig(quant=q), (x,), y,
               *kw, cross_entropy, bn=True),
        Family("bert_base", M.TransformerEncoder, bert, (tokens, mask),
               rng.integers(0, 2, BERT_BATCH), *kw, cross_entropy),
        Family("autoencoder", M.ConvAutoencoder, M.AutoencoderConfig(
            skip_concat=True, quant=q), (ae_x,), ae_x, {}, {},
            reconstruction),
    ]


def quant_layers(model):
    from quantized_vit_tpu_torch.models.layers import _QuantLayer

    return {n: m for n, m in model.named_modules()
            if isinstance(m, _QuantLayer)}


def family_levels(cpu_m, card_m, x_cpu, dev, what, fails):
    """Each quantizer of one layer on the same input on the card and on
    the CPU: levels equal but where the CPU's pre-value lies within
    FAMILY_TIE levels of a half-level, there one apart. Returns (flips,
    the CPU's quantized operands: activation, weight)."""
    flips, ops = 0, {}
    for suffix, inp in (("act", x_cpu), ("wt", cpu_m.kernel.detach())):
        if suffix == "act" and not cpu_m.config.quantize_acts:
            ops[suffix] = inp
            continue
        with torch.no_grad():
            q_c = cpu_m._quantize(inp, suffix)
            q_g = card_m._quantize(inp.to(dev), suffix).cpu()
        d = float(getattr(cpu_m, f"d_quant_{suffix}"))
        t = float(getattr(cpu_m, f"t_quant_{suffix}"))
        q_m = float(getattr(cpu_m, f"q_m_{suffix}"))
        a = inp.double().abs()
        pre = torch.where(a >= q_m, torch.full_like(a, abs(q_m) + 1e-6),
                          a) ** t / d
        lc, lg = torch.round(q_c.double() / d), torch.round(q_g.double() / d)
        diff = (lc - lg).abs()
        tie = (pre - pre.floor() - 0.5).abs() < FAMILY_TIE
        if diff.max() > 1 or bool(((diff > 0) & ~tie).any()):
            fails.append(f"{what} {suffix}: levels differ off a tie")
        flips += int((diff > 0).sum())
        ops[suffix] = q_c
    return flips, ops


def family_card_vs_cpu(fam, params, stats, dev, fails):
    """The card's eval forward against the CPU's at FAMILY_CHECK_BATCH, as
    phase 11 holds UltraNet's: the quantizers at 8 bits (d from each
    weight's range), each quantized layer on the CPU's input (levels
    equal off ties; its product on the CPU's quantized operands within
    FAMILY_CPU_TOL of its largest magnitude), and the whole net in f64
    within FAMILY_F64_TOL."""
    from quantized_vit_tpu_torch.models import init_quant_params_tree, tree_map

    p8 = init_quant_params_tree(tree_map(lambda v: v.detach(), params), 8.0)
    cpu_p = tree_map(lambda v: v.cpu(), p8)
    cpu_s = None if stats is None else tree_map(lambda v: v.cpu(), stats)
    cpu = fam.model(cpu_p, cpu_s)
    card = fam.model(p8, stats)
    caps = {}
    layers = quant_layers(cpu)
    hooks = [m.register_forward_pre_hook(
        lambda m, a, n=n: caps.__setitem__(n, a[0].detach()))
        for n, m in layers.items()]
    with torch.no_grad():
        fam.forward(cpu, cpu_p, cpu_s, fam.check_inputs(FAMILY_CHECK_BATCH,
                                                        "cpu"), False)
    for h in hooks:
        h.remove()
    card_layers = quant_layers(card)
    flips, worst = 0, 0.0
    for n, x in caps.items():
        f, ops = family_levels(layers[n], card_layers[n], x, dev,
                               f"{fam.name}/{n}", fails)
        flips += f
        outs = []
        for m, device in ((layers[n], "cpu"), (card_layers[n], dev)):
            cfg = m.config
            m.config = dataclasses.replace(cfg, enabled=False)
            try:
                with torch.no_grad():
                    outs.append(torch.func.functional_call(
                        m, {"kernel": ops["wt"].to(device)},
                        (ops["act"].to(device),)).cpu())
            finally:
                m.config = cfg
        worst = max(worst, float((outs[1] - outs[0]).abs().max()
                                 / outs[0].abs().max().clamp_min(1e-30)))
    if worst > FAMILY_CPU_TOL:
        fails.append(f"{fam.name}: a layer's product {worst:.3g} > "
                     f"{FAMILY_CPU_TOL}")
    # the whole net in f64
    f64 = torch.float64
    ys = []
    for device in ("cpu", dev):
        p = tree_map(lambda v: v.to(device, f64), p8)
        s = None if stats is None else tree_map(lambda v: v.to(device, f64),
                                                stats)
        m = fam.model(p, s)
        with torch.no_grad():
            ys.append(fam.forward(m, p, s, fam.check_inputs(
                FAMILY_CHECK_BATCH, device, f64), False)[0].cpu())
    rel64 = float((ys[1] - ys[0]).abs().max() / ys[0].abs().max())
    if not rel64 <= FAMILY_F64_TOL:
        fails.append(f"{fam.name}: f64 end to end {rel64:.3g}")
    return {"layers": len(caps), "level_flips_at_ties": flips,
            "layer_product_rel": worst, "f64_rel": rel64}


class FamilyGrads:
    """The face of a TrainLoop that ``compare_plain_step`` reads: one
    training forward's loss and gradients for a family at ``cfg`` (with
    K7 or the plain chain), the BatchNorms on the batch's statistics."""

    def __init__(self, fam, cfg, stats):
        self.fam, self.cfg, self.stats = fam, cfg, stats

    def loss_and_grads(self, params, inputs, target):
        from quantized_vit_tpu_torch.models import (flatten_tree,
                                                    unflatten_tree)

        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten_tree(params).items()}
        tree = unflatten_tree(leaves)
        model = self.fam.model(tree, self.stats, self.cfg)
        out, _ = self.fam.forward(model, tree, self.stats, inputs, True)
        loss = self.fam.loss(out, target)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), None, unflatten_tree(dict(zip(leaves, g)))


def subnet_vs_zeroed(zero_fn, sub_fn, zero_trees, sub_trees, inputs):
    """The subnet's forward against the zeroed model's on the same inputs,
    relative to the output's largest magnitude (floor 1): in f64 (the
    check: the zeroed rows add exact zeros, so the two differ only in
    summation order) and in f32 (recorded: the library picks other
    algorithms for the sliced shapes, so f32 sums round differently)."""
    from quantized_vit_tpu_torch.models import tree_map

    out = []
    for dtype in (torch.float64, torch.float32):
        def cast(t):
            return None if t is None else tree_map(lambda v: v.to(dtype), t)

        x = [v.to(dtype) if v.is_floating_point() else v for v in inputs]
        with torch.no_grad():
            y0 = zero_fn(cast(zero_trees[0]), cast(zero_trees[1]), x)
            y1 = sub_fn(cast(sub_trees[0]), cast(sub_trees[1]), x)
        out.append(float((y1 - y0).abs().max()
                         / y0.abs().max().clamp_min(1.0)))
    return tuple(out)


def kernel_split(kern, top: int = 3):
    """A trace's kernels (``traced``'s events): their count, summed
    device ms and the ``top`` names that took the most (ms, launches);
    None off the card."""
    if not kern:
        return None
    by = {}
    for e in kern:
        t = by.setdefault(e.name, [0.0, 0])
        t[0] += e.device_time_total / 1e3
        t[1] += 1
    most = sorted(by.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernels": len(kern),
            "kernel_ms": sum(v[0] for v in by.values()),
            "top": [(n[:60], round(v[0], 4), v[1]) for n, v in most]}


def family_qat(fam, dev, rec, fails, smi):
    """Phase 12's run of one QAT family: FAMILY_STEPS GETA steps with K7
    (its launches a step, one step traced), the plain chain against K7,
    the card against the CPU, the random zeroing and the subnet, and the
    timings. Returns the trained params and statistics."""
    from quantized_vit_tpu_torch.graph import OTO
    from quantized_vit_tpu_torch.models import (flatten_tree,
                                                init_quant_params_tree,
                                                tree_map, unflatten_tree)
    from quantized_vit_tpu_torch.ops import _build

    t0 = time.time()
    model = fam.cls(fam.cfg, seed=0, device=dev)
    params = init_quant_params_tree(tree_map(
        lambda p: p.detach().clone(), model.param_tree()), init_bits=32.0)
    stats = (tree_map(lambda b: b.clone(), model.batch_stats_tree())
             if fam.bn else None)
    n_layers = len(quant_layers(model))
    want = 2 * n_layers  # a weight and an activation quantizer a layer
    inputs = fam.check_inputs(len(fam.inputs[0]), dev)
    target = torch.from_numpy(np.asarray(fam.target)).to(dev)
    oto = OTO(model, params, batch_stats=stats)
    opt = oto.geta(**FAMILY_GETA_KW)

    def loss_grads(p, s):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten_tree(p).items()}
        out, new = fam.forward(model, unflatten_tree(leaves), s, inputs,
                               True)
        loss = fam.loss(out, target)
        g = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), unflatten_tree(dict(zip(leaves, g))), new

    def step(p, s):
        loss, g, new = loss_grads(p, s)
        return opt.step(p, opt.clip_grads(g)), new, float(loss)

    losses, per_step, geta_ms, trace, split = [], [], [], None, {}
    secs = {"setup": time.time() - t0}
    for i in range(FAMILY_STEPS):
        n0 = _build.LAUNCHES["quant_bwd"]
        if i == 1:  # one step under torch.profiler's CUDA trace
            (params, new, loss), kern = traced(lambda: step(params, stats))
            trace = k7_in_trace(kern)
            split["geta_step"] = kernel_split(kern)
            del kern
        else:
            loss, g, new = loss_grads(params, stats)
            sync()
            t1 = time.perf_counter()
            params = opt.step(params, opt.clip_grads(g))
            sync()
            geta_ms.append((time.perf_counter() - t1) * 1e3)
            loss = float(loss)
        stats = new if fam.bn else None
        losses.append(loss)
        per_step.append(_build.LAUNCHES["quant_bwd"] - n0)
    secs["steps"] = time.time() - t0 - sum(secs.values())
    row = {"quant_layers": n_layers, "k7_per_step_expected": want,
           "k7_per_step": per_step, "losses": losses,
           "geta_step_ms": geta_ms,
           "k7_traced_step": None if trace is None else trace["launches"],
           "k7_traced_device_ms": None if trace is None
           else trace["device_ms"]}
    if not all(np.isfinite(losses)):
        fails.append(f"{fam.name}: losses {losses}")
    if dev.type == "cuda" and (any(n != want for n in per_step)
                               or trace is None
                               or trace["launches"] != want or want == 0):
        fails.append(f"{fam.name}: K7 launches a step {per_step}, traced "
                     f"{row['k7_traced_step']}, want {want}")

    # the plain chain against K7 on one step, as phase 6 holds it (cuDNN
    # on its deterministic algorithms, so the two backwards sum alike)
    plain_cfg = dataclasses.replace(fam.cfg, quant=dataclasses.replace(
        fam.cfg.quant, fused_vjp=False))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        row["plain_vs_k7"], _ = compare_plain_step(
            FamilyGrads(fam, fam.cfg, stats),
            FamilyGrads(fam, plain_cfg, stats), params, inputs, target)
    finally:
        torch.backends.cudnn.deterministic = det
    if not row["plain_vs_k7"]["ok"]:
        fails.append(f"{fam.name}: plain chain vs K7 {row['plain_vs_k7']}")

    secs["plain_vs_k7"] = time.time() - t0 - sum(secs.values())
    # the card against the CPU
    row["card_vs_cpu"] = family_card_vs_cpu(fam, params, stats, dev, fails)
    secs["card_vs_cpu"] = time.time() - t0 - sum(secs.values())

    # GETA's random zeroing, the subnet and its MACs
    zeroed = oto.random_set_zero_groups(
        params, target_group_sparsity=FAMILY_SPARSITY, seed=0)
    sub = (oto.construct_subnet(zeroed, batch_stats=stats) if fam.bn
           else oto.construct_subnet(zeroed))
    sub_model, sub_params = sub[0], sub[1]
    sub_stats = sub[2] if fam.bn else None
    rel, rel32 = subnet_vs_zeroed(
        lambda p, s_, x: fam.forward(model, p, s_, x, False)[0],
        lambda p, s_, x: fam.forward(sub_model, p, s_, x, False)[0],
        (zeroed, stats), (sub_params, sub_stats), inputs)
    macs = (oto.compute_macs(params), oto.compute_macs(sub_params))
    row["subnet"] = {"macs": list(macs), "forward_rel": rel,
                     "forward_rel_f32": rel32,
                     "params": [sum(v.numel() for v in flatten_tree(t)
                                    .values()) for t in (params,
                                                         sub_params)]}
    if not rel <= FAMILY_SUBNET_TOL or not macs[1] < macs[0]:
        fails.append(f"{fam.name}: subnet {row['subnet']}")

    # timings at the full batch
    def eval_fwd():
        with torch.no_grad():
            return fam.forward(model, params, stats, inputs, False)

    def train_step():
        return loss_grads(params, stats)

    secs["subnet"] = time.time() - t0 - sum(secs.values())
    row["ms"] = {"eval_forward": cuda_ms(eval_fwd),
                 "train_step": cuda_ms(train_step)}
    split["eval_forward"] = kernel_split(traced(eval_fwd)[1])
    row["split"] = split
    secs["timing"] = time.time() - t0 - sum(secs.values())
    row["seconds"] = {k: round(v, 1) for k, v in secs.items()}
    row["phase_s"] = round(time.time() - t0, 1)
    rec[fam.name] = row
    clock = "events" if dev.type == "cuda" else "host clock"
    log(f"[families] {fam.name}: eval forward {row['ms']['eval_forward']:.3f}"
        f" ms, train step (forward + backward) {row['ms']['train_step']:.3f}"
        f" ms at batch {len(fam.inputs[0])} ({clock}); K7 a step "
        f"{per_step} (want {want}, traced {row['k7_traced_step']}, "
        f"{row['k7_traced_device_ms']} ms on the card); plain "
        f"vs K7 loss equal {row['plain_vs_k7']['loss_equal']}, grads "
        f"{row['plain_vs_k7']['grads_bit_identical']}/"
        f"{row['plain_vs_k7']['grads_other']} bit-identical; card vs CPU "
        f"{row['card_vs_cpu']}; subnet MACs {macs[0]:.4g} -> "
        f"{macs[1]:.4g}, forward rel {rel:.3g} (f64; f32 {rel32:.3g}); "
        f"{row['phase_s']} s {row['seconds']} ({smi})")
    for k, sp in row["split"].items():
        if sp is not None:
            log(f"  {fam.name} {k}: {sp['kernels']} kernels, "
                f"{sp['kernel_ms']:.3f} ms on the card; top " + ", ".join(
                    f"{n[:40]} {ms:.3f}x{c}" for n, ms, c in sp["top"]))


def llama_compression(dev, rec, fails):
    """The Llama-style block (BERT-base widths, GQA with 4 kv heads, RoPE,
    SwiGLU, causal) at depth 2: the random zeroing at kv-head
    granularity, the subnet (gate rows with fc1's, heads_per_block in
    query heads), its forward against the zeroed model's, its MACs."""
    from quantized_vit_tpu_torch import models as M
    from quantized_vit_tpu_torch.graph import OTO

    cfg = M.TransformerConfig(**{**dict(
        vocab_size=30522, max_len=512, embed_dim=768, depth=2,
        num_heads=12, num_classes=2), **BERT_KW, "num_kv_heads": 4,
        "rope": True, "mlp_type": "swiglu", "causal": True,
        "quant": M.QuantConfig(enabled=True, fused_vjp=True)})
    model = M.TransformerEncoder(cfg, seed=1, device=dev)
    params = M.init_quant_params_tree(model.param_tree(), init_bits=8.0)
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ))).to(dev)
    oto = OTO(model, params)
    # one of the four kv heads a block: whole query groups go with it
    zeroed = oto.random_set_zero_groups(target_group_sparsity=FAMILY_SPARSITY,
                                        num_group_divisible=1, seed=0)
    sub, sp = oto.construct_subnet(zeroed)
    rel, rel32 = subnet_vs_zeroed(
        lambda p, _, x: M.apply_variables(model, p, *x),
        lambda p, _, x: M.apply_variables(sub, p, *x),
        (zeroed, None), (sp, None), [tokens])
    macs = (oto.compute_macs(params), oto.compute_macs(sp))
    g = cfg.q_per_kv
    row = {"heads_per_block": list(sub.cfg.heads_per_block),
           "hidden_per_block": list(sub.cfg.hidden_per_block),
           "macs": list(macs), "forward_rel": rel, "forward_rel_f32": rel32,
           "gate_follows_fc1": all(
               sp[f"blocks_{i}"]["gate"]["kernel"].shape
               == sp[f"blocks_{i}"]["fc1"]["kernel"].shape
               for i in range(cfg.depth))}
    rec["llama_block"] = row
    log(f"[families] llama block: heads {row['heads_per_block']}, hidden "
        f"{row['hidden_per_block']}, MACs {macs[0]:.4g} -> {macs[1]:.4g}, "
        f"subnet forward rel {rel:.3g} (f64; f32 {rel32:.3g})")
    if (not rel <= FAMILY_SUBNET_TOL or not macs[1] < macs[0]
            or any(h % g for h in sub.cfg.heads_per_block)
            or not row["gate_follows_fc1"]
            or min(sub.cfg.heads_per_block) == cfg.num_heads):
        fails.append(f"llama block: {row}")


def lora_checks(dev, rec, fails):
    """LoRA: a LoraDense 768 -> 3072 of rank 8 on LORA_ROWS rows and a
    LoraEmbedding 30522 x 768 of rank 8 (random adapters from seeds):
    ``merge_lora`` lossless (the merged layer's output within 1e-5 of the
    adapter's, relative), a HESSO run on the adapters' gradients (the base
    frozen by ``lora_grad_mask``) that zeroes lora_b's columns with the
    base's, the card against the CPU, and the timings. LoRA layers carry
    no quantizer (the JAX package's are float): no K7 here."""
    from quantized_vit_tpu_torch.graph import (lora_embedding_entries,
                                               lora_layer_entries)
    from quantized_vit_tpu_torch.models import (LoraDense, LoraEmbedding,
                                                flatten_tree,
                                                lora_grad_mask, merge_lora,
                                                tree_map, unflatten_tree)
    from quantized_vit_tpu_torch.opt import HESSO, HESSOConfig, NodeGroup

    t0 = time.time()
    fin, fout, vocab = LORA_DIMS
    rng = np.random.default_rng(14)
    layers = {
        "dense": (LoraDense(fin, fout, rank=LORA_RANK, seed=2, device=dev),
                  torch.from_numpy(rng.standard_normal(
                      (LORA_ROWS, fin), dtype=np.float32)).to(dev),
                  lora_layer_entries),
        "embedding": (LoraEmbedding(vocab, fin, rank=LORA_RANK, seed=3,
                                    device=dev),
                      torch.from_numpy(rng.integers(0, vocab, LORA_ROWS))
                      .to(dev), lora_embedding_entries)}
    for name, (layer, inp, entries) in layers.items():
        with torch.no_grad():  # trained-like adapters
            for p in (layer.lora_a, layer.lora_b):
                p.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape), dtype=np.float32) * 0.05))
        row = {}
        tree = layer.param_tree()
        with torch.no_grad():
            y = layer(inp)
            merged = merge_lora({"l": tree},
                                default_scaling=layer.scaling)["l"]
            y_m = (inp @ merged["kernel"] + merged["bias"] if name == "dense"
                   else merged["embedding"][inp])
            y_cpu = layer.to("cpu")(inp[:FAMILY_CHECK_BATCH].cpu())
            layer.to(dev)
        row["merge_rel"] = float((y_m - y).abs().max() / y.abs().max())
        row["card_vs_cpu_rel"] = float(
            (y[:FAMILY_CHECK_BATCH].cpu() - y_cpu).abs().max()
            / y_cpu.abs().max())
        if row["merge_rel"] > 1e-5 or row["card_vs_cpu_rel"] > FAMILY_CPU_TOL:
            fails.append(f"lora {name}: {row}")
        # HESSO on the adapters' gradients, the base frozen
        tree = tree_map(lambda v: v.detach().clone(), layer.param_tree())
        mask = flatten_tree(lora_grad_mask(tree))
        n = fout if name == "dense" else fin
        group = NodeGroup(id=name, entries=entries({name: tree}, name),
                          num_groups=n)
        opt = HESSO([group], {name: tree}, HESSOConfig(
            lr=1e-3, target_group_sparsity=0.25, start_pruning_step=1,
            pruning_steps=2, pruning_periods=1))
        p = {name: tree}
        target = torch.zeros_like(y)

        def grads(p):
            leaves = {k: v.detach().requires_grad_(mask[k])
                      for k, v in flatten_tree(p[name]).items()}
            out = torch.func.functional_call(layer, leaves, (inp,))
            loss = torch.mean(torch.square(out - target))
            trainable = [k for k in leaves if mask[k]]
            g = dict(zip(trainable, torch.autograd.grad(
                loss, [leaves[k] for k in trainable])))
            return {name: unflatten_tree({
                k: g.get(k, torch.zeros_like(v)) for k, v in leaves.items()})}

        for _ in range(3):
            p = opt.step(p, grads(p))
        base = p[name]["kernel" if name == "dense" else "embedding"]
        zero_cols = base.abs().sum(0) == 0
        row["hesso_zero_columns"] = int(zero_cols.sum())
        row["lora_b_zero_with_base"] = bool(
            (p[name]["lora_b"].abs().sum(0)[zero_cols] == 0).all())
        if (row["hesso_zero_columns"] != int(0.25 * n)
                or not row["lora_b_zero_with_base"]):
            fails.append(f"lora {name} HESSO: {row}")

        def eval_fwd():
            with torch.no_grad():
                return layer(inp)

        adapters = [layer.lora_a, layer.lora_b]

        def train_step():
            return torch.autograd.grad(
                torch.mean(torch.square(layer(inp))), adapters)

        row["ms"] = {"eval_forward": cuda_ms(eval_fwd),
                     "train_step": cuda_ms(train_step)}
        rec[f"lora_{name}"] = row
        log(f"[families] lora {name}: eval forward "
            f"{row['ms']['eval_forward']:.3f} ms, train step (adapters' "
            f"gradients) {row['ms']['train_step']:.3f} ms at {LORA_ROWS} "
            f"rows; merge rel {row['merge_rel']:.3g}, card vs CPU "
            f"{row['card_vs_cpu_rel']:.3g}, HESSO zeroed "
            f"{row['hesso_zero_columns']} columns with lora_b "
            f"{row['lora_b_zero_with_base']}")
    rec["lora_s"] = round(time.time() - t0, 1)


def converter_check(dev, rec, fails):
    """``model_to_quantize_model`` on a float ResNet-20: its twin with
    weight quantizers at 32 bits gives the float model's eval forward
    (within 1e-5 of its largest magnitude)."""
    from quantized_vit_tpu_torch import models as M

    cfg = M.ResNetConfig(**{**dict(stage_sizes=(3, 3, 3),
                                   widths=(16, 32, 64)), **RESNET_KW})
    model = M.ResNet(cfg, seed=4, device=dev)
    qm, qp = M.model_to_quantize_model(
        model, model.param_tree(), quant=M.QuantConfig(
            enabled=True, quantize_acts=False), init_bits=32.0)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (CIFAR_BATCH, CIFAR_HW, CIFAR_HW, 3), dtype=np.float32)).to(dev)
    with torch.no_grad():
        y, yq = model(x), qm(x)
    rel = float((yq - y).abs().max() / y.abs().max())
    rec["model_to_quantize_model"] = {
        "quant_layers": len(M.collect_quant_params(qp)), "forward_rel": rel}
    log(f"[families] model_to_quantize_model: ResNet-20 at 32 bits, "
        f"{rec['model_to_quantize_model']['quant_layers']} quantized layers,"
        f" forward rel {rel:.3g}")
    if not rel <= 1e-5:
        fails.append(f"model_to_quantize_model: {rel}")


def families_phase(dev, record):
    """Phase 12 (the module docstring's item 12): ResNet-20, MobileNet,
    the BERT-base encoder and the U-Net autoencoder trained through K7,
    each held against the plain chain and the CPU, compressed and timed;
    the Llama-style block's compression; LoRA; the converter. Each check
    fails the run."""
    t0 = time.time()
    fails, rec = [], {}
    for fam in family_specs():
        family_qat(fam, dev, rec, fails, record["nvidia_smi"])
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    llama_compression(dev, rec, fails)
    lora_checks(dev, rec, fails)
    converter_check(dev, rec, fails)
    rec["phase_s"] = round(time.time() - t0, 1)
    record["families"] = rec
    log(f"[families] phase {rec['phase_s']} s")
    if fails:
        raise Failed("phase 12: " + "; ".join(fails[:8]))

# ---------------------------------------------------------------------------
# phase 13: interop and the automatic grouping
# ---------------------------------------------------------------------------


def same_trees(a, b) -> bool:
    """Two trees of tensors with the same paths, shapes, dtypes and
    bits."""
    from quantized_vit_tpu_torch.models import flatten_tree

    fa, fb = flatten_tree(a), flatten_tree(b)
    return set(fa) == set(fb) and all(
        fa[k].dtype == fb[k].dtype and tuple(fa[k].shape) == tuple(
            fb[k].shape) and torch.equal(fa[k].cpu(), fb[k].cpu())
        for k in fa)


def same_files(a, b) -> bool:
    """Two directories with the same file names and bytes."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return False
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True



def interop_serving(dev, rec, fails, smi):
    """Phase 13 (a): the ViT-B/16 QAT tree (LSFQ at INTEROP_BITS, seed 0)
    through a reference ``.pt``: read back by ``load_params_any``,
    exported by ``cli.export vit`` and served at BATCH on the block route
    (K1, K4, then K3 + K1 proj + K2 a block), the int4-packed artifact the
    CLI writes and the int8-stored one of the same tree; then ``cli.export
    torch`` into the reference-shaped torch ViT against the port's float
    forward, and the ONNX export's contract. Returns the QAT tree and its
    config (for the discovery checks)."""
    from quantized_vit_tpu_torch import models as M
    from quantized_vit_tpu_torch.artifact import load_vit_int4_artifact
    from quantized_vit_tpu_torch.cli import _common as common
    from quantized_vit_tpu_torch.cli import export as texport
    from quantized_vit_tpu_torch.interop import vit_params_to_torch
    from quantized_vit_tpu_torch.interop.torch_model import (
        build_torch_vit, export_onnx, load_interchange)
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.opt.checkpoint import save_checkpoint
    from quantized_vit_tpu_torch.serve import (export_vit_int4,
                                               prepare_kernels,
                                               vit_int4_forward)
    from quantized_vit_tpu_torch.utils import patchify_batch

    cfg = dataclasses.replace(main_cfg(), quant=M.QuantConfig(enabled=True))
    model = M.VisionTransformer(cfg, seed=0, device=dev)
    params = M.init_quant_params_tree(M.tree_map(
        lambda p: p.detach().clone(), model.param_tree()), INTEROP_BITS)
    del model
    shutil.rmtree(INTEROP_DIR, ignore_errors=True)
    os.makedirs(INTEROP_DIR)
    pt = os.path.join(INTEROP_DIR, "vit_b16.pt")
    t0 = time.perf_counter()
    torch.save({k: torch.from_numpy(v) for k, v in
                vit_params_to_torch(params).items()}, pt)
    tree, _, _ = common.load_params_any(pt, device=DEV)
    sync()
    rec["pt_round_trip_s"] = time.perf_counter() - t0
    rec["pt_bytes"] = os.path.getsize(pt)
    rec["pt_tree_bit_equal"] = same_trees(tree, params)
    if not rec["pt_tree_bit_equal"]:
        fails.append("the .pt round trip changed the tree")

    # cli.export vit of the .pt and of the source tree's checkpoint
    src = os.path.join(INTEROP_DIR, "source")
    save_checkpoint(src, params)
    flags = ["--model", "vit_b16", "--img-size", str(cfg.img_size),
             "--num-classes", str(cfg.num_classes), "--device", DEV]
    arts = {}
    for name, ck in (("pt", pt), ("source", src)):
        arts[name] = os.path.join(INTEROP_DIR, f"art_{name}")
        texport.main(["vit", "--checkpoint", ck, "--out", arts[name]]
                     + flags)
    rec["artifacts_byte_equal"] = same_files(arts["pt"], arts["source"])
    if not rec["artifacts_byte_equal"]:
        fails.append("cli.export vit: the .pt's artifact differs from the "
                     "source tree's")

    rng = np.random.default_rng(13)
    images = rng.standard_normal(
        (BATCH, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    x = torch.from_numpy(patchify_batch(images, cfg.patch_size)).to(dev)
    kw = dict(float_dtype=torch.bfloat16, images_layout="patches")
    want = expected_launches(cfg.depth)

    def serve(art, acfg):
        plan = prepare_kernels(art, acfg) if dev.type == "cuda" else None
        _build.reset_launches()
        y = vit_int4_forward(art, x, acfg, plan=plan, **kw)
        sync()
        return y, dict(_build.LAUNCHES)

    rows = {}
    loaded = {k: load_vit_int4_artifact(d, device=DEV)
              for k, d in arts.items()}
    stored = {"pt": export_vit_int4(cfg, tree, pack_weights=False),
              "source": export_vit_int4(cfg, params, pack_weights=False)}
    for fmt, pair in (("int4-packed", loaded),
                      ("int8-stored", {k: (a, cfg)
                                       for k, a in stored.items()})):
        (y_pt, n_pt), (y_src, n_src) = (serve(*pair["pt"]),
                                        serve(*pair["source"]))
        art, acfg = pair["pt"]
        with torch.no_grad():
            plain = vit_int4_forward(art, x, acfg, use_kernels=False, **kw)
        row = {"launches": {k: v for k, v in n_pt.items() if v},
               "logits_bit_equal": bool(torch.equal(
            y_pt, y_src)), "vs_plain_max_abs": float(
            (y_pt - plain).abs().max()),
            "shape_ok": tuple(y_pt.shape) == (BATCH, cfg.num_classes)
            and bool(torch.isfinite(y_pt).all())}
        rows[fmt] = row
        if dev.type == "cuda" and (n_pt != want or n_src != want):
            fails.append(f"interop {fmt}: launches {n_pt} / {n_src} != "
                         f"{want}")
        if not (row["logits_bit_equal"] and row["shape_ok"]
                and row["vs_plain_max_abs"] <= LOGIT_TOL):
            fails.append(f"interop {fmt}: {row}")
    rec["serve"] = rows
    del loaded, stored

    # cli.export torch -> the reference-shaped module on the card and the
    # CPU, against the port's float forward (TF32 off)
    tdir = os.path.join(INTEROP_DIR, "torch")
    texport.main(["torch", "--checkpoint", pt, "--out", tdir] + flags)
    with open(os.path.join(tdir, "arch.json")) as f:
        arch = json.load(f)
    sd = {k: v.numpy() for k, v in torch.load(
        os.path.join(tdir, "model.pt")).items()}
    card = load_interchange(build_torch_vit(arch, device=DEV), sd).eval()
    cpu = load_interchange(build_torch_vit(arch, device="cpu"), sd).eval()
    float_tree = M.unflatten_tree({
        k: v for k, v in M.flatten_tree(tree).items()
        if k.rsplit("/", 1)[-1] not in M.QUANT_PARAM_NAMES})
    port_float = M.model_for_params(
        dataclasses.replace(cfg, quant=M.QuantConfig.off()), float_tree)
    xf = torch.from_numpy(images[:INTEROP_TORCH_BATCH]).to(dev)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            y_card = card(xf.permute(0, 3, 1, 2))
            y_port = port_float(xf, deterministic=True)
            y_cpu = cpu(xf.cpu().permute(0, 3, 1, 2))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    rec["torch_module"] = {
        "vs_port_float_max_abs": float((y_card - y_port).abs().max()),
        "vs_cpu_max_abs": float((y_card.cpu() - y_cpu).abs().max()),
        "logit_absmax": float(y_port.abs().max())}
    for name, ref in (("port float", y_port), ("cpu", y_cpu.to(dev))):
        if not torch.allclose(y_card, ref, rtol=INTEROP_TOL,
                              atol=INTEROP_TOL):
            fails.append(f"torch module vs {name}: {rec['torch_module']}")

    # the ONNX export: a file with the onnx package, else its RuntimeError
    try:
        import onnx  # noqa: F401
        rec["onnx_present"] = True
    except ImportError:
        rec["onnx_present"] = False
    onnx_path = os.path.join(INTEROP_DIR, "vit_b16.onnx")
    try:
        export_onnx(onnx_path, card, cfg.img_size, cfg.in_channels)
        rec["onnx"] = os.path.getsize(onnx_path)
        if not rec["onnx_present"] or rec["onnx"] == 0:
            fails.append(f"onnx: wrote {rec['onnx']} bytes with onnx "
                         f"present {rec['onnx_present']}")
    except RuntimeError as e:
        rec["onnx"] = str(e)[:80]
        if rec["onnx_present"] or "onnx" not in str(e):
            fails.append(f"onnx: {e}")
    del card, cpu, port_float
    log(f"[interop] ViT-B/16 LSFQ {INTEROP_BITS:g}-bit through a reference "
        f".pt ({rec['pt_bytes']} bytes): round trip "
        f"{rec['pt_round_trip_s']:.2f} s, tree bit-equal "
        f"{rec['pt_tree_bit_equal']}; cli.export vit artifacts byte-equal "
        f"{rec['artifacts_byte_equal']}; served b{BATCH} {rows}; torch "
        f"module {rec['torch_module']}; onnx present {rec['onnx_present']}"
        f" -> {rec['onnx']} ({smi})")
    return cfg, tree


def trace_ms(model, params, x, stats=None, **kw):
    """(make_fx's host ms, node count, the graph) of one trace of
    ``apply_variables``, which the discovery then walks."""
    from quantized_vit_tpu_torch.graph import trace_apply

    t0 = time.perf_counter()
    graph = trace_apply(model, params, x, stats, kw)
    sync()
    return (time.perf_counter() - t0) * 1e3, len(graph.nodes), graph


def discovery_checks(dev, rec, fails, vit_cfg, vit_tree, smi):
    """Phase 13 (b): the discovered groups equal the declarative builders'
    on ResNet-20 and MobileNet (phase 12's configurations) and UltraNet at
    ULTRA_HW; on ViT-B/16's QAT forward at batch 1 the declared groups
    cover the trace, and discovery stays conservative."""
    from quantized_vit_tpu_torch import models as M
    from quantized_vit_tpu_torch.graph import (discover_node_groups,
                                               mobilenet_node_groups,
                                               resnet_node_groups,
                                               ultranet_node_groups,
                                               validate_node_groups,
                                               vit_node_groups)

    def as_sets(groups):
        return {(tuple(sorted((e.path, e.transform.value)
                              for e in g.entries)),
                 g.num_groups, g.is_prunable) for g in groups}

    specs = {f.name: f for f in family_specs()[:2]}
    ultra = M.UltraNet(device=dev)
    cases = [(name, M.ResNet(f.cfg, seed=0, device=dev) if name ==
              "resnet20" else M.MobileNet(f.cfg, seed=0, device=dev),
              (1, CIFAR_HW, CIFAR_HW, 3), {"deterministic": True})
             for name, f in specs.items()]
    cases.append(("ultranet", ultra, (1, *ULTRA_HW, 3), {"train": False}))
    rows = {}
    for name, model, shape, kw in cases:
        params = M.tree_map(lambda p: p.detach(), model.param_tree())
        stats = model.batch_stats_tree()
        x = torch.zeros(shape, device=dev)
        ms, nodes, graph = trace_ms(model, params, x, stats, **kw)
        groups = discover_node_groups(model, params, x, batch_stats=stats,
                                      model_kwargs=kw, graph=graph)
        declared = (ultranet_node_groups(params) if name == "ultranet"
                    else (resnet_node_groups if name == "resnet20"
                          else mobilenet_node_groups)(model.cfg, params))
        rows[name] = {"make_fx_ms": ms, "nodes": nodes,
                      "groups": len(groups),
                      "equals_declared": as_sets(groups) == as_sets(
                          declared)}
        if not rows[name]["equals_declared"]:
            fails.append(f"discovery on {name} differs from its builder")
    del ultra, cases

    vmodel = M.model_for_params(vit_cfg, vit_tree)
    x1 = torch.zeros(1, vit_cfg.img_size, vit_cfg.img_size, 3, device=dev)
    ms, nodes, graph = trace_ms(vmodel, vit_tree, x1, deterministic=True)
    val = validate_node_groups(graph, vit_node_groups(vit_cfg, vit_tree),
                               vit_tree)
    groups = discover_node_groups(vmodel, vit_tree, x1,
                                  model_kwargs={"deterministic": True},
                                  graph=graph)
    del graph
    by_kernel = {e.path: g for g in groups for e in g.entries}
    fixed = ["blocks_0/attn/qkv/kernel", "patch_embed/proj/kernel",
             "head/kernel"]
    fc1 = [by_kernel[f"blocks_{i}/mlp/fc1/kernel"]
           for i in range(vit_cfg.depth)]
    rows["vit_b16"] = {
        "make_fx_ms": ms, "nodes": nodes, "groups": len(groups),
        "validate": val,
        "unprunable": {p: not by_kernel[p].is_prunable for p in fixed},
        "fc1_groups": sorted({(g.is_prunable, g.num_groups) for g in fc1})}
    if val != {"missing": [], "uncovered": []}:
        fails.append(f"ViT-B/16 validate_node_groups: {val}")
    if not all(rows["vit_b16"]["unprunable"].values()) or any(
            not g.is_prunable or g.num_groups != vit_cfg.block_hidden(i)
            for i, g in enumerate(fc1)):
        fails.append(f"ViT-B/16 discovery not conservative: "
                     f"{rows['vit_b16']}")
    rec["discovery"] = rows
    for name, r in rows.items():
        log(f"[discovery] {name}: make_fx {r['make_fx_ms']:.1f} ms host, "
            f"{r['nodes']} nodes, {r['groups']} groups " + (
                f"equal to the builder's {r['equals_declared']}"
                if "equals_declared" in r else
                f"validate {r['validate']}, unprunable {r['unprunable']}, "
                f"fc1 (prunable, groups) {r['fc1_groups']}") + f" ({smi})")


def auto_qat_checks(dev, rec, fails, smi):
    """Phase 13 (c): LSFQ ResNet-20 (``fused_vjp``: K7 at every quantizer)
    with its groups from ``discover_node_groups``: FAMILY_STEPS GETA steps
    at CIFAR_BATCH, then ``construct_subnet_auto`` against
    ``construct_subnet_resnet`` on the same sparse tree (bit-equal), and
    the compressed eval forward against the sparse one (as phase 12's
    subnets: in f64, f32 recorded)."""
    from quantized_vit_tpu_torch import models as M
    from quantized_vit_tpu_torch.compress import (construct_subnet_auto,
                                                  construct_subnet_resnet,
                                                  kept_groups)
    from quantized_vit_tpu_torch.graph import (discover_node_groups,
                                               resnet_node_groups)
    from quantized_vit_tpu_torch.ops import _build
    from quantized_vit_tpu_torch.opt import GETA, GETAConfig

    fam = family_specs()[0]
    model = fam.cls(fam.cfg, seed=0, device=dev)
    params = M.init_quant_params_tree(M.tree_map(
        lambda p: p.detach().clone(), model.param_tree()), init_bits=32.0)
    stats = M.tree_map(lambda b: b.clone(), model.batch_stats_tree())
    want = 2 * len(quant_layers(model))
    inputs = fam.check_inputs(len(fam.inputs[0]), dev)
    target = torch.from_numpy(np.asarray(fam.target)).to(dev)
    groups, plan = discover_node_groups(
        model, params, inputs[0][:1], batch_stats=stats,
        model_kwargs=fam.eval_kw, return_plan=True)
    opt = GETA(groups, params, GETAConfig(**FAMILY_GETA_KW))
    per_step, losses = [], []
    for _ in range(FAMILY_STEPS):
        n0 = _build.LAUNCHES["quant_bwd"]
        leaves = {k: v.detach().requires_grad_()
                  for k, v in M.flatten_tree(params).items()}
        out, stats = fam.forward(model, M.unflatten_tree(leaves), stats,
                                 inputs, True)
        loss = fam.loss(out, target)
        g = torch.autograd.grad(loss, list(leaves.values()))
        params = opt.step(params, opt.clip_grads(
            M.unflatten_tree(dict(zip(leaves, g)))))
        sync()
        per_step.append(_build.LAUNCHES["quant_bwd"] - n0)
        losses.append(float(loss.detach()))
    zero_groups = sum(int(g.num_groups - len(kept_groups(g, params)))
                      for g in groups if g.is_prunable)
    new, shapes, new_stats = construct_subnet_auto(params, groups, plan,
                                                   batch_stats=stats)
    new_cfg, ref, ref_stats = construct_subnet_resnet(
        fam.cfg, params, resnet_node_groups(fam.cfg, params), stats)
    sub = fam.model(new, new_stats, new_cfg)
    rel, rel32 = subnet_vs_zeroed(
        lambda p, s_, x: fam.forward(model, p, s_, x, False)[0],
        lambda p, s_, x: fam.forward(sub, p, s_, x, False)[0],
        (params, stats), (new, new_stats), inputs)
    row = {"k7_per_step": per_step, "k7_per_step_expected": want,
           "losses": losses, "zeroed_groups": zero_groups,
           "params": [sum(v.numel() for v in M.flatten_tree(t).values())
                      for t in (params, new)],
           "tree_bit_equal": same_trees(new, ref),
           "stats_bit_equal": same_trees(new_stats, ref_stats),
           "forward_rel": rel, "forward_rel_f32": rel32}
    rec["auto_qat"] = row
    if dev.type == "cuda" and any(n != want for n in per_step):
        fails.append(f"auto QAT: K7 launches a step {per_step}, want {want}")
    if not (row["tree_bit_equal"] and row["stats_bit_equal"]
            and row["forward_rel"] <= FAMILY_SUBNET_TOL
            and all(np.isfinite(losses))):
        fails.append(f"auto QAT subnet: {row}")
    log(f"[auto QAT] ResNet-20 LSFQ b{CIFAR_BATCH}, discovered groups: K7 a "
        f"step {per_step} (want {want}), losses {losses}, zeroed groups "
        f"{zero_groups}, params {row['params'][0]} -> {row['params'][1]}, "
        f"construct_subnet_auto bit-equal to construct_subnet_resnet "
        f"{row['tree_bit_equal']} (stats {row['stats_bit_equal']}), "
        f"compressed vs sparse forward {rel:.3g} in f64, {rel32:.3g} in f32 "
        f"({smi})")


def interop_autogroups_phase(dev, record):
    """Phase 13 (the module docstring's item 13): interop on the main
    path, discovery at the families' configurations, auto QAT and
    compression. Each check fails the run."""
    t0 = time.time()
    fails, rec = [], {}
    smi = record["nvidia_smi"]
    cfg, tree = interop_serving(dev, rec, fails, smi)
    rec["interop_s"] = round(time.time() - t0, 1)
    discovery_checks(dev, rec, fails, cfg, tree, smi)
    del tree
    rec["discovery_s"] = round(time.time() - t0 - rec["interop_s"], 1)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    auto_qat_checks(dev, rec, fails, smi)
    rec["phase_s"] = round(time.time() - t0, 1)
    record["interop"] = rec
    log(f"[interop] phase {rec['phase_s']} s (interop {rec['interop_s']} s,"
        f" discovery {rec['discovery_s']} s)")
    if fails:
        raise Failed("phase 13: " + "; ".join(fails[:8]))


if __name__ == "__main__":
    sys.exit(main())
