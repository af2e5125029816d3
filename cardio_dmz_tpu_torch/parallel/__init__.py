from .graphed import graph_step  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh, gather_streams, make_mesh, shard_streams, split_sizes)
from .streams import (  # noqa: F401
    batched_camera_step, batched_scan_frames, batched_scanner_step,
    init_stream_states, make_sharded_camera_step, make_sharded_step)
