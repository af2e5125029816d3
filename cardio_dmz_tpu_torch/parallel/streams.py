"""Multi-stream batched scanning: the serving step.

Many concurrent camera streams stepped together through the scan pipeline
and the session state machine. Every function of the port is already
stream-major, so the batched step is scanner_step over the stream axis;
the JAX package reaches the same shape with vmap.
"""

from ..session.state import scanner_reset, scanner_step


def init_stream_states(n_streams, device, now):
    """Fresh ScannerStates for n_streams streams on `device`; now =
    (year, month)."""
    return scanner_reset(now, n_streams, device)


def batched_scanner_step(params, states, frames):
    """One PAN-only step for every stream. frames: (S, 270, 428) uint8 on
    the states' device. Returns (states, (FrameResult, ScannerResult)),
    all stream-major."""
    return scanner_step(params, states, frames)
