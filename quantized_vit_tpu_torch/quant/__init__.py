from .packing import pack_int4, unpack_int4
from .lsfq import (dge, lsfq_dequant, lsfq_levels, lsfq_linear,
                   lsfq_nonlinear, lsfq_nonlinear_fused, lsfq_top_level)
from .bitwidth import (bit_width, clip_transform, d_for_bits,
                       init_quant_params, quant_residual, quantize_simple)
from .dorefa import (fold_batchnorm, quantize_activation,
                     quantize_activation_levels, quantize_weight,
                     quantize_weight_levels, uniform_quantize)
from .integer import (bn_act_quantize_int, bn_act_w_bias_float,
                      requantize_int, weight_quantize_float,
                      weight_quantize_int)

__all__ = ["pack_int4", "unpack_int4", "dge", "lsfq_dequant", "lsfq_levels",
           "lsfq_linear", "lsfq_nonlinear", "lsfq_nonlinear_fused",
           "lsfq_top_level", "bit_width", "clip_transform", "d_for_bits",
           "init_quant_params", "quant_residual", "quantize_simple",
           "uniform_quantize", "quantize_weight", "quantize_activation",
           "quantize_weight_levels", "quantize_activation_levels",
           "fold_batchnorm", "weight_quantize_float", "weight_quantize_int",
           "bn_act_w_bias_float", "bn_act_quantize_int", "requantize_int"]
