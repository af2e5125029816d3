"""The host side of serving: the native frame pump and loop metrics."""
from .ingest import (  # noqa: F401
    FramePump, deinterleave_c2, rgba_to_r, ycbcr422_split)
from .metrics import Metrics  # noqa: F401
