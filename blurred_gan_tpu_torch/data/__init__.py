"""The data package's public names, as the JAX package's ``data`` exports
them. Importing them loads neither the native decoder nor Pillow: each is
loaded by the first image folder that decodes."""

from blurred_gan_tpu_torch.data.pipeline import (
    ArrayDataset,
    DataPipeline,
    ShardedArrayDataset,
    image_folder_dataset,
    load_mnist,
    load_celeba,
    synthetic_dataset,
    write_shards,
)

__all__ = [
    "ArrayDataset",
    "DataPipeline",
    "ShardedArrayDataset",
    "image_folder_dataset",
    "load_mnist",
    "load_celeba",
    "synthetic_dataset",
    "write_shards",
]
