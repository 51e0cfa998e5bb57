"""`mtsbench.readers.rate`."""
from mtsbench.readers import rate as read  # noqa: F401
