"""The sampling cell's device idle share (``readers.device_idle``)."""

from portbench.readers import device_idle as read  # noqa: F401
