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
"""

from . import (  # noqa: F401
    api, config, constants, models, ops, parallel, scan, session, utils)
from .models import load_all_params  # noqa: F401
from .parallel import (  # noqa: F401
    batched_camera_step, batched_scanner_step, init_stream_states)
from .session import scan_frames  # noqa: F401
