"""Serving kernels (CUDA, built from ``csrc/``) and their plain versions.

Each kernel's wrapper (``fused_quant_matmul``, ``fused_mlp``,
``attention_block``/``attention_heads``, ``patch_finalize``) takes CPU
tensors to its plain version; on CUDA tensors it prepares the layer
(``plan_*``) and launches (``run_*``)."""

from ._build import LAUNCHES, reset_launches
from .attention import (AttentionPlan, HeadsPlan, attention_block,
                        attention_block_plain, attention_heads,
                        attention_heads_plain, attention_qkv_plain,
                        plan_attention_block, plan_attention_heads,
                        run_attention_block, run_attention_heads)
from .fused import (MatmulPlan, MlpPlan, fused_mlp, fused_mlp_plain,
                    fused_quant_matmul, fused_quant_matmul_plain, plan_matmul,
                    plan_mlp, run_matmul, run_mlp)
from .patch import patch_finalize, patch_finalize_plain
from .reference import int4_matmul_ref, int8_matmul_ref, quant_linear_ref

__all__ = ["LAUNCHES", "reset_launches", "AttentionPlan", "HeadsPlan",
           "attention_block", "attention_block_plain", "attention_heads",
           "attention_heads_plain", "attention_qkv_plain",
           "plan_attention_block", "plan_attention_heads",
           "run_attention_block", "run_attention_heads", "MatmulPlan",
           "MlpPlan", "fused_mlp", "fused_mlp_plain", "fused_quant_matmul",
           "fused_quant_matmul_plain", "plan_matmul", "plan_mlp",
           "run_matmul", "run_mlp", "patch_finalize", "patch_finalize_plain",
           "int4_matmul_ref", "int8_matmul_ref", "quant_linear_ref"]
