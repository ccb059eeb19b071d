"""The utils package's public names, as the JAX package's ``utils`` exports
them (and its ``profiling`` module)."""

from blurred_gan_tpu_torch.utils.config import JsonSerializable, ParseableFromCommandLine
from blurred_gan_tpu_torch.utils.logging import MetricsLogger
from blurred_gan_tpu_torch.utils import profiling
from blurred_gan_tpu_torch.utils.rundir import create_result_subdir, locate_latest_checkpoint_dir
from blurred_gan_tpu_torch.utils.images import (
    normalize_images,
    samples_grid,
    save_image_grid,
    NHWC_to_NCHW,
    NCHW_to_NHWC,
)

__all__ = [
    "JsonSerializable",
    "ParseableFromCommandLine",
    "MetricsLogger",
    "create_result_subdir",
    "locate_latest_checkpoint_dir",
    "normalize_images",
    "samples_grid",
    "save_image_grid",
    "NHWC_to_NCHW",
    "NCHW_to_NHWC",
]
