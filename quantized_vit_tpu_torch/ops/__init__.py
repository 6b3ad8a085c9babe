"""The CUDA kernels (built from ``csrc/``) and their plain versions.

Each serving kernel's wrapper (``fused_quant_matmul``, ``fused_mlp``,
``attention_block``/``attention_heads``, ``patch_finalize``,
``attention_qkv``, ``vit_block_stack``) takes CPU tensors to its plain
version; on CUDA tensors it prepares the layer (``plan_*``) and launches
(``run_*``). The training kernel, the quantizer backward
``lsfq_nonlinear_bwd_fused`` (K7), does the same with its plain version
``lsfq_nonlinear_bwd_plain``."""

from ._build import LAUNCHES, reset_launches
from .attention import (AttentionPlan, HeadsPlan, QkvAttentionPlan,
                        attention_block, attention_block_plain,
                        attention_heads, attention_heads_plain,
                        attention_qkv, attention_qkv_plain,
                        plan_attention_block, plan_attention_heads,
                        plan_attention_qkv, run_attention_block,
                        run_attention_heads, run_attention_qkv)
from .block_stack import (StackPlan, plan_block_stack, run_block_stack,
                          vit_block_stack, vit_block_stack_plain)
from .fused import (MatmulPlan, MlpPlan, fused_mlp, fused_mlp_plain,
                    fused_quant_matmul, fused_quant_matmul_plain, plan_matmul,
                    plan_mlp, run_matmul, run_mlp)
from .patch import patch_finalize, patch_finalize_plain
from .quant_vjp import lsfq_nonlinear_bwd_fused, lsfq_nonlinear_bwd_plain
from .reference import int4_matmul_ref, int8_matmul_ref, quant_linear_ref

__all__ = ["LAUNCHES", "reset_launches", "AttentionPlan", "HeadsPlan",
           "QkvAttentionPlan", "attention_block", "attention_block_plain",
           "attention_heads", "attention_heads_plain", "attention_qkv",
           "attention_qkv_plain", "plan_attention_block",
           "plan_attention_heads", "plan_attention_qkv",
           "run_attention_block", "run_attention_heads", "run_attention_qkv",
           "StackPlan", "plan_block_stack", "run_block_stack",
           "vit_block_stack", "vit_block_stack_plain", "MatmulPlan",
           "MlpPlan", "fused_mlp", "fused_mlp_plain", "fused_quant_matmul",
           "fused_quant_matmul_plain", "plan_matmul", "plan_mlp",
           "run_matmul", "run_mlp", "patch_finalize", "patch_finalize_plain",
           "lsfq_nonlinear_bwd_fused", "lsfq_nonlinear_bwd_plain",
           "int4_matmul_ref", "int8_matmul_ref", "quant_linear_ref"]
