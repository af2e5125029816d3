from .state import (  # noqa: F401
    ScannerResult,
    ScannerState,
    camera_scanner_step,
    scan_frames,
    scanner_add_frame,
    scanner_reset,
    scanner_result,
    scanner_step,
)
from .host import HostScanner  # noqa: F401
from .checkpoint import (  # noqa: F401
    load_params_npz,
    load_session,
    load_session_npz,
    save_params,
    save_session,
    save_session_npz,
    state_from_numpy,
    state_to_numpy,
)
