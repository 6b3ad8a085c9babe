"""The CUDA kernels (built from ``csrc/``) and their plain versions.

Each serving kernel's wrapper (``fused_quant_matmul``, ``fused_mlp``
for K2 and K8, ``attention_block``/``attention_heads``,
``patch_finalize``, ``attention_qkv``, ``vit_block_stack``,
``ln_quant_levels`` (K1's LayerNorm + quant prologue alone),
``attention_qkv_proj``, ``int4_matmul``, ``int8_matmul`` and
``quant_matmul_fa`` of one integer GEMM, ``flash_attention``, and the
FSDP gathers ``gather_rows`` and ``fused_mlp_gather``) takes CPU tensors
to its plain version; on CUDA tensors it prepares the layer (``plan_*``) and launches
(``run_*``). The training kernel, the quantizer backward
``lsfq_nonlinear_bwd_fused`` (K7), does the same with its plain version
``lsfq_nonlinear_bwd_plain``."""

from ._build import LAUNCHES, reset_launches
from .attention import (AttentionPlan, HeadsPlan, QkvAttentionPlan,
                        QkvProjPlan, attention_block, attention_block_plain,
                        attention_heads, attention_heads_plain,
                        attention_qkv, attention_qkv_plain,
                        attention_qkv_proj, attention_qkv_proj_plain,
                        flash_attention, flash_attention_plain,
                        plan_attention_block, plan_attention_heads,
                        plan_attention_qkv, plan_attention_qkv_proj,
                        run_attention_block, run_attention_heads,
                        run_attention_qkv, run_attention_qkv_proj)
from .block_stack import (StackPlan, plan_block_stack, run_block_stack,
                          vit_block_stack, vit_block_stack_plain)
from .fused import (LevelsPlan, MatmulPlan, MlpPlan, fused_mlp,
                    fused_mlp_plain, fused_quant_matmul,
                    fused_quant_matmul_plain, ln_quant_levels,
                    ln_quant_levels_plain, plan_ln_levels, plan_matmul,
                    plan_mlp, plan_mlp_chunked, run_ln_levels, run_matmul,
                    run_mlp, run_mlp_chunked)
from .int4_matmul import (IntMatmulPlan, int4_matmul, int4_matmul_plain,
                          int4_matmul_xla, int8_matmul, int8_matmul_plain,
                          int8_matmul_xla, plan_int_matmul, quant_matmul_fa,
                          quant_matmul_fa_plain, run_int_matmul)
from .patch import patch_finalize, patch_finalize_plain
from .quant_vjp import lsfq_nonlinear_bwd_fused, lsfq_nonlinear_bwd_plain
from .ring_gather import (GatherPlan, check_row_shards, fused_mlp_gather,
                          fused_mlp_gather_plain, gather_rows,
                          gather_rows_plain, plan_gather_rows,
                          run_gather_rows, run_mlp_gather)
from .reference import int4_matmul_ref, int8_matmul_ref, quant_linear_ref

__all__ = ["LAUNCHES", "reset_launches", "AttentionPlan", "HeadsPlan",
           "QkvAttentionPlan", "QkvProjPlan", "attention_block",
           "attention_block_plain", "attention_heads",
           "attention_heads_plain", "attention_qkv", "attention_qkv_plain",
           "attention_qkv_proj", "attention_qkv_proj_plain",
           "flash_attention", "flash_attention_plain",
           "plan_attention_block", "plan_attention_heads",
           "plan_attention_qkv", "plan_attention_qkv_proj",
           "run_attention_block", "run_attention_heads", "run_attention_qkv",
           "run_attention_qkv_proj", "IntMatmulPlan", "int4_matmul",
           "int4_matmul_plain", "int4_matmul_xla", "int8_matmul",
           "int8_matmul_plain", "int8_matmul_xla", "plan_int_matmul",
           "quant_matmul_fa", "quant_matmul_fa_plain", "run_int_matmul",
           "StackPlan", "plan_block_stack", "run_block_stack",
           "vit_block_stack", "vit_block_stack_plain", "MatmulPlan",
           "MlpPlan", "fused_mlp", "fused_mlp_plain", "fused_quant_matmul",
           "fused_quant_matmul_plain", "plan_matmul", "plan_mlp",
           "plan_mlp_chunked", "run_matmul", "run_mlp", "run_mlp_chunked",
           "LevelsPlan", "ln_quant_levels", "ln_quant_levels_plain",
           "plan_ln_levels", "run_ln_levels",
           "patch_finalize", "patch_finalize_plain",
           "lsfq_nonlinear_bwd_fused", "lsfq_nonlinear_bwd_plain",
           "int4_matmul_ref", "int8_matmul_ref", "quant_linear_ref",
           "GatherPlan", "check_row_shards", "fused_mlp_gather",
           "fused_mlp_gather_plain", "gather_rows", "gather_rows_plain",
           "plan_gather_rows", "run_gather_rows", "run_mlp_gather"]
