from .native_prep import patchify_batch, patchify_batch_u8

__all__ = ["patchify_batch", "patchify_batch_u8"]
