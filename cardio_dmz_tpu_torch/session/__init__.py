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
