"""The CelebA-128 training cell's share of device time in copies, casts and
transposes (``readers.copy_share``)."""

from portbench.readers import copy_share as read  # noqa: F401
