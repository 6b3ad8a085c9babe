from .vit import ViTConfig

__all__ = ["ViTConfig"]
