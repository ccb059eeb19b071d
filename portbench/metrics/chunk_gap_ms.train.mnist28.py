"""The MNIST-28 training cell's idle time at a chunk boundary (``readers.chunk_gap_ms``)."""

from portbench.readers import chunk_gap_ms as read  # noqa: F401
