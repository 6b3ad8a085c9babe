from .io import load_artifact_tree, save_artifact_tree
from .hls import (export_ultranet_hls, hls_texts, inc_bias_tiles,
                  int_bit_width, pack_words, tile_pe, write_hls)
from .native import (native_available, pack_int4_host, quantize_levels_host,
                     unpack_int4_host)
from .ultranet import (UltraNetExportConfig, export_ultranet_int,
                       generate_ultranet_config, load_ultranet_artifact,
                       save_ultranet_artifact)
from .vit import load_vit_int4_artifact, save_vit_int4_artifact

__all__ = ["load_artifact_tree", "save_artifact_tree",
           "load_vit_int4_artifact", "save_vit_int4_artifact",
           "UltraNetExportConfig", "export_ultranet_int",
           "generate_ultranet_config", "load_ultranet_artifact",
           "save_ultranet_artifact", "export_ultranet_hls", "hls_texts",
           "inc_bias_tiles", "int_bit_width", "pack_words", "tile_pe",
           "write_hls", "native_available", "pack_int4_host",
           "quantize_levels_host", "unpack_int4_host"]
