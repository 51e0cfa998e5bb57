"""`mtsbench.readers.idle_share`."""
from mtsbench.readers import idle_share as read  # noqa: F401
