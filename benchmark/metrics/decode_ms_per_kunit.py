"""`mtsbench.readers.decode_ms_per_kunit`."""
from mtsbench.readers import decode_ms_per_kunit as read  # noqa: F401
