from .streams import batched_scanner_step, init_stream_states  # noqa: F401
