"""The metrics package's public names, as the JAX package's ``metrics``
exports them. As there, ``kid`` and ``prdc`` here are the functions, which
hide their modules of the same name: import the modules by their full path."""

from blurred_gan_tpu_torch.metrics.swd import (
    SWDAPI,
    SWDMetric,
    downscale_minibatch,
    laplacian_pyramid,
    reconstruct_laplacian_pyramid,
    pyr_down,
    pyr_up,
    patch_descriptors,
    finalize_descriptors,
    sliced_wasserstein_distance,
    swd_resolutions,
)
from blurred_gan_tpu_torch.metrics.fid import (
    FIDMetric,
    calculate_fid,
    frechet_distance,
    inception_preprocess,
    FeatureStats,
    random_conv_features,
)
from blurred_gan_tpu_torch.metrics.prdc import prdc, prdc_from_images
from blurred_gan_tpu_torch.metrics.kid import kid, kid_from_images
from blurred_gan_tpu_torch.metrics.inception import (
    inception_features,
    inception_feature_fn,
    load_inception_weights,
    random_inception_params,
    save_inception_weights,
)

__all__ = [
    "SWDAPI",
    "SWDMetric",
    "downscale_minibatch",
    "calculate_fid",
    "inception_preprocess",
    "laplacian_pyramid",
    "reconstruct_laplacian_pyramid",
    "pyr_down",
    "pyr_up",
    "patch_descriptors",
    "finalize_descriptors",
    "sliced_wasserstein_distance",
    "swd_resolutions",
    "FIDMetric",
    "frechet_distance",
    "FeatureStats",
    "random_conv_features",
    "prdc",
    "prdc_from_images",
    "kid",
    "kid_from_images",
    "inception_features",
    "inception_feature_fn",
    "load_inception_weights",
    "random_inception_params",
    "save_inception_weights",
]
