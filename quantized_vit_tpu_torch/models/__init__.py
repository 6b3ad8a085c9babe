from .layers import (QUANT_PARAM_NAMES, QuantConfig, QuantConv, QuantDense,
                     bitwidth_dict, collect_quant_params, flatten_tree,
                     init_quant_params_tree, tree_map, unflatten_tree)
from .vit import (ViTConfig, VisionTransformer, apply, model_for_params,
                  params_from_jax, params_to_numpy, vit_base_patch16_224,
                  vit_base_patch16_224_in21k, vit_base_patch32_224,
                  vit_base_patch32_224_in21k, vit_huge_patch14_224_in21k,
                  vit_large_patch16_224, vit_large_patch16_224_in21k,
                  vit_large_patch32_224_in21k)
from .ultranet import (A_BIT, ULTRANET_ANCHORS, ULTRANET_LAYERS,
                       ULTRANET_OUT_CHANNELS, W_BIT, BatchNorm, DoReFaBatchNorm,
                       DoReFaBatchNorm1d, DoReFaConv, DoReFaDense, UltraNet,
                       UltraNetInt, ultranet_apply, yolo_decode)
from .ultranet import int_params_from_jax as ultranet_int_params_from_jax
from .ultranet import params_from_jax as ultranet_params_from_jax

__all__ = ["QUANT_PARAM_NAMES", "QuantConfig", "QuantConv", "QuantDense",
           "bitwidth_dict", "collect_quant_params", "flatten_tree",
           "init_quant_params_tree", "tree_map", "unflatten_tree",
           "ViTConfig", "VisionTransformer", "apply", "model_for_params",
           "params_from_jax", "params_to_numpy", "vit_base_patch16_224",
           "vit_base_patch16_224_in21k", "vit_base_patch32_224",
           "vit_base_patch32_224_in21k", "vit_huge_patch14_224_in21k",
           "vit_large_patch16_224", "vit_large_patch16_224_in21k",
           "vit_large_patch32_224_in21k", "A_BIT", "ULTRANET_ANCHORS",
           "ULTRANET_LAYERS", "ULTRANET_OUT_CHANNELS", "W_BIT", "BatchNorm",
           "DoReFaBatchNorm", "DoReFaBatchNorm1d", "DoReFaConv", "DoReFaDense",
           "UltraNet", "UltraNetInt", "ultranet_apply", "yolo_decode",
           "ultranet_int_params_from_jax", "ultranet_params_from_jax"]
