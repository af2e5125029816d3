"""Multi-stream batched scanning: the serving step.

Many concurrent camera streams stepped together through the scan pipeline
and the session state machine. Every function of the port is already
stream-major, so the batched step is scanner_step over the stream axis;
the JAX package reaches the same shape with vmap.
"""

from ..constants import ORIENTATION_LANDSCAPE_RIGHT
from ..session.state import camera_scanner_step, scanner_reset, scanner_step


def init_stream_states(n_streams, device, now):
    """Fresh ScannerStates for n_streams streams on `device`; now =
    (year, month)."""
    return scanner_reset(now, n_streams, device)


def batched_scanner_step(params, states, frames, scan_expiry=False,
                         config=None):
    """One step for every stream: the PAN scan, and with scan_expiry the
    expiry read too. frames: (S, 270, 428) uint8 on the states' device.
    config: a ScanConfig; it overrides scan_expiry. Returns (states,
    (FrameResult, ScannerResult)), all stream-major."""
    return scanner_step(params, states, frames, scan_expiry, config=config)


def batched_camera_step(params, states, y, cb, cr, scan_expiry=False,
                        orientation=ORIENTATION_LANDSCAPE_RIGHT, config=None):
    """One camera -> digits step for every stream: edge detection, the
    exact homography and warp, and the scan of batched_scanner_step.
    y: (S, 480, 640) u8; cb/cr: (S, 240, 320) u8 half-size chroma, on the
    states' device. Returns (states, (found, FrameResult, ScannerResult))."""
    return camera_scanner_step(params, states, y, cb, cr,
                               scan_expiry=scan_expiry, config=config,
                               orientation=orientation)
