"""cardio_dmz_tpu_torch: the PyTorch/CUDA port of cardio_dmz_tpu.

The same module paths as the JAX package, in PyTorch's idiom: stream-major
tensors with a leading stream axis S instead of vmap, nn.Modules for the
models, an explicit `device` everywhere, and hand-written CUDA kernels
where the JAX package has Pallas kernels (ops/cuda/). It imports torch and
numpy, never jax and never cardio_dmz_tpu; it reads the model weights
from cardio_dmz_tpu/models/params/ by path.

What exists: the PAN-only serving path, vseg -> hseg -> digit prep (CUDA
kernel) + 3-model conv ensemble -> frame gates -> session EWMA and
Luhn/BIN acceptance, batched over streams (parallel/streams.py).
"""

from . import (  # noqa: F401
    constants, models, ops, parallel, scan, session, utils)
from .models import load_all_params  # noqa: F401
from .parallel import batched_scanner_step, init_stream_states  # noqa: F401
from .session import scan_frames  # noqa: F401
