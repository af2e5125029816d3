from .streams import (  # noqa: F401
    batched_camera_step, batched_scanner_step, init_stream_states)
