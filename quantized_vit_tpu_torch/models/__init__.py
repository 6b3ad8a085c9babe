from .layers import (QUANT_PARAM_NAMES, QuantConfig, QuantConv, QuantDense,
                     bitwidth_dict, collect_quant_params, flatten_tree,
                     init_quant_params_tree, tree_map, unflatten_tree)
from .vit import (ViTConfig, VisionTransformer, apply, params_from_jax,
                  params_to_numpy, vit_base_patch16_224,
                  vit_base_patch16_224_in21k, vit_base_patch32_224,
                  vit_base_patch32_224_in21k, vit_huge_patch14_224_in21k,
                  vit_large_patch16_224, vit_large_patch16_224_in21k,
                  vit_large_patch32_224_in21k)

__all__ = ["QUANT_PARAM_NAMES", "QuantConfig", "QuantConv", "QuantDense",
           "bitwidth_dict", "collect_quant_params", "flatten_tree",
           "init_quant_params_tree", "tree_map", "unflatten_tree",
           "ViTConfig", "VisionTransformer", "apply", "params_from_jax",
           "params_to_numpy", "vit_base_patch16_224",
           "vit_base_patch16_224_in21k", "vit_base_patch32_224",
           "vit_base_patch32_224_in21k", "vit_huge_patch14_224_in21k",
           "vit_large_patch16_224", "vit_large_patch16_224_in21k",
           "vit_large_patch32_224_in21k"]
