"""cardio_dmz_tpu_torch: the PyTorch/CUDA port of cardio_dmz_tpu.

The same module paths as the JAX package, in PyTorch's idiom: stream-major
tensors with a leading stream axis S instead of vmap, nn.Modules for the
models, an explicit `device` everywhere, and hand-written CUDA kernels
where the JAX package has Pallas kernels (ops/cuda/). It imports torch and
numpy, never jax and never cardio_dmz_tpu; it reads the model weights
from cardio_dmz_tpu/models/params/ by path.

What exists, batched over streams (parallel/streams.py):
* the serving path on rectified cards: vseg -> hseg -> digit prep (CUDA
  kernel) + 3-model conv ensemble -> frame gates -> session EWMA and
  Luhn/BIN acceptance (batched_scanner_step);
* with scan_expiry, the expiry read beside it: scharr band -> stripes ->
  char groups -> regrid -> trim -> slash anchoring -> expiry conv ->
  cross-frame slot table -> date (scan/expiry_device.py);
* the camera path in front of either: edge detection on 12 bands -> the
  exact Eigen-QR homography (CUDA kernel) -> the exact cvWarpPerspective
  warp (CUDA kernel) -> the scan (batched_camera_step).

And the host side of serving around them:
* session.HostScanner: the single-stream scanner an app calls frame by
  frame, the PAN step on the device and the expiry on the host
  (scan/expiry_seg_host.py, scan/expiry_categorize_host.py, which are also
  the oracle of the device's expiry read); api.blur_card;
* session/checkpoint.py: save_session / load_session (torch.save) and the
  .npz layout either package loads; save_params / load_params_npz;
* runtime: FramePump (the native frame ring, page-locked batches) and
  Metrics;
* parallel: make_mesh / shard_streams / make_sharded_step, the stream axis
  split over a list of devices, each shard's step a CUDA graph
  (graph_step, the port's jax.jit, which HostScanner and tools/bench.py
  use too);
* tools/serve_demo.py: camera threads -> FramePump -> the split step ->
  Metrics.

And training: train/ (the synthetic generators, with the glyphs from a
table instead of PIL; the trainable model forms of models/zoo.py; fit,
with Adam, over a mesh's data and model axes) and tools/train_models.py;
entry.py holds the counterparts of __graft_entry__.py (entry,
dryrun_multichip).

And the compiled card.io C++ as an oracle: refbridge/ links the
reference's objects (native/refshim/build/) with the system OpenCV and
wraps them with ctypes; tools/parity_ab.py and tools/tune_emboss.py hold
the port and the renderer against it.
"""

from . import (  # noqa: F401
    api, config, constants, models, ops, parallel, refbridge, runtime, scan,
    session, tools, train, utils)
from .api import blur_card  # noqa: F401
from .models import load_all_params  # noqa: F401
from .parallel import (  # noqa: F401
    batched_camera_step, batched_scan_frames, batched_scanner_step,
    init_stream_states, make_mesh, make_sharded_camera_step,
    make_sharded_step, shard_streams)
from .runtime import FramePump, Metrics  # noqa: F401
from .session import (  # noqa: F401
    HostScanner, load_session, save_session, scan_frames)
