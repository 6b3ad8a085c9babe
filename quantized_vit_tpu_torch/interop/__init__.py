"""Reference checkpoints and formats (``quantized_vit_tpu/interop``): the
ViT and UltraNet state-dict converters and the ``.pt`` loader, the
reference-shaped torch ViT (``torch_model``: the ``torch`` and ``onnx``
export targets' module), and UltraNet's reference-format npz and
config.json."""

from .npz_export import (export_reference_ultranet, ultranet_reference_arrays,
                         ultranet_reference_config)
from .torch_import import (load_torch_checkpoint, normalize_state_dict,
                           ultranet_params_from_torch,
                           ultranet_params_to_torch, vit_params_from_torch,
                           vit_params_to_torch)

__all__ = ["export_reference_ultranet", "ultranet_reference_arrays",
           "ultranet_reference_config", "load_torch_checkpoint",
           "normalize_state_dict", "ultranet_params_from_torch",
           "ultranet_params_to_torch", "vit_params_from_torch",
           "vit_params_to_torch"]
