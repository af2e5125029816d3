"""The compiled card.io C++ as an oracle for the port.

Counterpart of the JAX package's refbridge/: the reference's unity build,
wrapped by native/refshim/oracle.cpp, linked into a ctypes library
(build.py) from the objects the repository carries, and exposed as a
numpy oracle (oracle.py). records.py turns the port's results into
the oracle's record form. Callers gate on available() (missing() says
what is absent); build() raises when the link fails.
"""

from .build import available, build, missing
from .oracle import RefFrameResult, RefGroupResult, RefOracle
from .records import (
    FrameRecord, corner_array, corner_points, frame_records, group_from_ref,
    group_to_ref, make_record, ref_frame_record)

__all__ = [
    "available", "build", "missing", "RefOracle",
    "RefFrameResult", "RefGroupResult", "FrameRecord", "corner_array",
    "corner_points", "frame_records", "group_from_ref", "group_to_ref",
    "make_record", "ref_frame_record"]
