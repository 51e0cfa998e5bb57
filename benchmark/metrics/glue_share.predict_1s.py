"""`mtsbench.readers.glue_share`."""
from mtsbench.readers import glue_share as read  # noqa: F401
