"""The ops package's public names, as the JAX package's ``ops`` exports them.
Importing them builds nothing: the blur kernel is compiled at its first
launch (``ops/blur_cuda.py``)."""

from blurred_gan_tpu_torch.ops.blur import (
    appropriate_kernel_size,
    appropriate_std,
    maximum_reasonable_std,
    gaussian_kernel_1d,
    effective_blur_params,
    blur_matrix,
    blur_images,
    gaussian_blur_depthwise,
)

__all__ = [
    "appropriate_kernel_size",
    "appropriate_std",
    "maximum_reasonable_std",
    "gaussian_kernel_1d",
    "effective_blur_params",
    "blur_matrix",
    "blur_images",
    "gaussian_blur_depthwise",
]
