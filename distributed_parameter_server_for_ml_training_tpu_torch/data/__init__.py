from .cifar import (
    CIFAR100_MEAN,
    CIFAR100_STD,
    NUM_CLASSES,
    Dataset,
    augment_batch,
    augment_with_draws,
    load_cifar100,
    make_batches,
    normalize,
    shard_range,
    standardize,
    synthetic_cifar100,
    synthetic_imagenet,
    to_float,
)

__all__ = ["CIFAR100_MEAN", "CIFAR100_STD", "NUM_CLASSES", "Dataset",
           "augment_batch", "augment_with_draws", "load_cifar100",
           "make_batches", "normalize", "shard_range", "standardize",
           "synthetic_cifar100", "synthetic_imagenet", "to_float"]
