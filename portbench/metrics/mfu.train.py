"""The CelebA-128 train step's share of the card's dense peak (``readers.mfu_step``)."""

from portbench.readers import mfu_step as read  # noqa: F401
