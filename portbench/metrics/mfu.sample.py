"""The sampled generator forward's share of the card's dense peak (``readers.mfu_sample``)."""

from portbench.readers import mfu_sample as read  # noqa: F401
