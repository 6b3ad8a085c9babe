"""Reference checkpoints and formats (``quantized_vit_tpu/interop``), the
UltraNet half: the reference-format npz and config.json, the ``.pt``
loader and the UltraNet state-dict converters. The ViT converters and the
torch module builders come with the rest of interop/ (ROADMAP.md, modules
to port, 'Other model families, interop, auto-discovery')."""

from .npz_export import (export_reference_ultranet, ultranet_reference_arrays,
                         ultranet_reference_config)
from .torch_import import (load_torch_checkpoint, normalize_state_dict,
                           ultranet_params_from_torch,
                           ultranet_params_to_torch)

__all__ = ["export_reference_ultranet", "ultranet_reference_arrays",
           "ultranet_reference_config", "load_torch_checkpoint",
           "normalize_state_dict", "ultranet_params_from_torch",
           "ultranet_params_to_torch"]
