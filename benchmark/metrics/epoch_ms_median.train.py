"""`mtsbench.readers.epoch_ms_median`."""
from mtsbench.readers import epoch_ms_median as read  # noqa: F401
