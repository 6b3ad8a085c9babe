"""Training utilities (losses, data pipeline, guards, epoch drivers) and
host-side input preparation."""

from .data import (ArrayDataset, DataLoader, ImageFolderDataset,
                   normalize_image, read_split_data)
from .guards import NonFiniteLossError, all_finite, assert_tree_finite
from .losses import (cross_entropy_onehot_target, group_lasso_loss,
                     kd_loss, mixup, one_hot, softmax_cross_entropy)
from .native_prep import (PrefetchLoader, gather_rows, native_prep_available,
                          normalize_u8_batch, patchify_batch,
                          patchify_batch_u8)
from .training import TrainLoop, evaluate, topk_accuracy

__all__ = ["ArrayDataset", "DataLoader", "ImageFolderDataset",
           "normalize_image", "read_split_data", "NonFiniteLossError", "all_finite",
           "assert_tree_finite", "cross_entropy_onehot_target",
           "group_lasso_loss", "kd_loss", "mixup", "one_hot",
           "softmax_cross_entropy", "PrefetchLoader", "gather_rows",
           "native_prep_available", "normalize_u8_batch", "patchify_batch",
           "patchify_batch_u8", "TrainLoop", "evaluate", "topk_accuracy"]
