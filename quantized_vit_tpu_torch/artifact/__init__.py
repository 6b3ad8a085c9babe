from .io import load_artifact_tree, save_artifact_tree
from .vit import load_vit_int4_artifact, save_vit_int4_artifact

__all__ = ["load_artifact_tree", "save_artifact_tree",
           "load_vit_int4_artifact", "save_vit_int4_artifact"]
