from .layers import (QUANT_PARAM_NAMES, BatchNorm, GroupNorm, QuantConfig,
                     QuantConv, QuantConvTranspose, QuantDense, TreeModule,
                     apply_variables, batch_stats_from_jax, bind_tree,
                     bitwidth_dict, collect_quant_params, flatten_tree,
                     init_quant_params_tree, model_to_quantize_model,
                     tree_map, unflatten_tree)
from .vit import (ViTConfig, VisionTransformer, apply, model_for_params,
                  params_from_jax, params_to_numpy, vit_base_patch16_224,
                  vit_base_patch16_224_in21k, vit_base_patch32_224,
                  vit_base_patch32_224_in21k, vit_huge_patch14_224_in21k,
                  vit_large_patch16_224, vit_large_patch16_224_in21k,
                  vit_large_patch32_224_in21k)
from .ultranet import (A_BIT, ULTRANET_ANCHORS, ULTRANET_LAYERS,
                       ULTRANET_OUT_CHANNELS, W_BIT, DoReFaBatchNorm,
                       DoReFaBatchNorm1d, DoReFaConv, DoReFaDense, UltraNet,
                       UltraNetInt, ultranet_apply, yolo_decode)
from .ultranet import int_params_from_jax as ultranet_int_params_from_jax
from .ultranet import params_from_jax as ultranet_params_from_jax
from .autoencoder import AutoencoderConfig, ConvAutoencoder
from .autoencoder import params_from_jax as autoencoder_params_from_jax
from .mobilenet import MobileNet, MobileNetConfig, mobilenet_small
from .mobilenet import params_from_jax as mobilenet_params_from_jax
from .resnet import ResNet, ResNetConfig, resnet8, resnet20
from .resnet import params_from_jax as resnet_params_from_jax
from .transformer import (SeparateQKVAttention, TransformerConfig,
                          TransformerEncoder, transformer_encoder_base,
                          transformer_encoder_tiny)
from .transformer import params_from_jax as transformer_params_from_jax
from .lora import LoraDense, LoraEmbedding, lora_grad_mask, merge_lora
from .lora import params_from_jax as lora_params_from_jax

__all__ = ["QUANT_PARAM_NAMES", "BatchNorm", "GroupNorm", "QuantConfig",
           "QuantConv", "QuantConvTranspose", "QuantDense", "TreeModule",
           "apply_variables", "batch_stats_from_jax", "bind_tree",
           "bitwidth_dict", "collect_quant_params", "flatten_tree",
           "init_quant_params_tree", "model_to_quantize_model", "tree_map",
           "unflatten_tree",
           "ViTConfig", "VisionTransformer", "apply", "model_for_params",
           "params_from_jax", "params_to_numpy", "vit_base_patch16_224",
           "vit_base_patch16_224_in21k", "vit_base_patch32_224",
           "vit_base_patch32_224_in21k", "vit_huge_patch14_224_in21k",
           "vit_large_patch16_224", "vit_large_patch16_224_in21k",
           "vit_large_patch32_224_in21k", "A_BIT", "ULTRANET_ANCHORS",
           "ULTRANET_LAYERS", "ULTRANET_OUT_CHANNELS", "W_BIT",
           "DoReFaBatchNorm", "DoReFaBatchNorm1d", "DoReFaConv", "DoReFaDense",
           "UltraNet", "UltraNetInt", "ultranet_apply", "yolo_decode",
           "ultranet_int_params_from_jax", "ultranet_params_from_jax",
           "AutoencoderConfig", "ConvAutoencoder",
           "autoencoder_params_from_jax", "MobileNet", "MobileNetConfig",
           "mobilenet_small", "mobilenet_params_from_jax", "ResNet",
           "ResNetConfig", "resnet8", "resnet20", "resnet_params_from_jax",
           "SeparateQKVAttention", "TransformerConfig", "TransformerEncoder",
           "transformer_encoder_base", "transformer_encoder_tiny",
           "transformer_params_from_jax", "LoraDense", "LoraEmbedding",
           "lora_grad_mask", "merge_lora", "lora_params_from_jax"]
