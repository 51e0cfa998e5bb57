"""`mtsbench.readers.mfu`."""
from mtsbench.readers import mfu as read  # noqa: F401
