"""The CelebA-128 training cell's blur kernels' share of their roofline
(``readers.blur_roofline``)."""

from portbench.readers import blur_roofline as read  # noqa: F401
