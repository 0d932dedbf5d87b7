"""Device: per cent of the traced window with no device operation."""

from ttsbench.lib.readers import device_idle as read  # noqa: F401
