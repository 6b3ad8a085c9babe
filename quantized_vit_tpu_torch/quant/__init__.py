from .packing import pack_int4, unpack_int4
from .lsfq import (dge, lsfq_dequant, lsfq_levels, lsfq_linear,
                   lsfq_nonlinear, lsfq_nonlinear_fused, lsfq_top_level)
from .bitwidth import (bit_width, clip_transform, d_for_bits,
                       init_quant_params, quant_residual, quantize_simple)

__all__ = ["pack_int4", "unpack_int4", "dge", "lsfq_dequant", "lsfq_levels",
           "lsfq_linear", "lsfq_nonlinear", "lsfq_nonlinear_fused",
           "lsfq_top_level", "bit_width", "clip_transform", "d_for_bits",
           "init_quant_params", "quant_residual", "quantize_simple"]
