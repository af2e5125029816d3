"""The native frame-pump ingest runtime, bound with ctypes.

The port's own binding of its own copy of the JAX package's frame pump,
csrc/framepump.cpp (see the source for the design: SIMD-friendly byte
shuffles, and a seqlock ring that keeps the latest frame of every stream).
It is built with g++ into cardio_dmz_tpu_torch/_build/libframepump.so the
first time it is used, or again when the source is newer; a failed build
raises, and there is no numpy stand-in. Nothing is built at import.

FramePump hands the serving loop host *tensors*: page-locked ones when the
step runs on a CUDA device, so that the upload, `batch.to(device,
non_blocking=True)`, overlaps the host's work.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np
import torch

from ..ops.cuda._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "framepump.cpp")
_SO = os.path.join(BUILD_DIR, "libframepump.so")
_LOCK = threading.Lock()
_LIB = None


def build():
    """Compile framepump.cpp into the build directory; returns the
    library's path. Raises RuntimeError with g++'s output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, _SO)
    return _SO


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if (not os.path.exists(_SO) or
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            build()
        lib = ctypes.CDLL(_SO)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.fp_deinterleave_c2.argtypes = [u8p, u8p, u8p, ctypes.c_int64]
        lib.fp_rgba_to_r.argtypes = [u8p, u8p, ctypes.c_int64]
        lib.fp_ycbcr422_split.argtypes = [u8p, u8p, u8p, u8p,
                                          ctypes.c_int64, ctypes.c_int64]
        lib.fp_create.restype = ctypes.c_void_p
        lib.fp_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.fp_destroy.argtypes = [ctypes.c_void_p]
        lib.fp_push_frame.restype = ctypes.c_int
        lib.fp_push_frame.argtypes = [ctypes.c_void_p, ctypes.c_int64, u8p,
                                      ctypes.c_uint64]
        lib.fp_acquire_batch.restype = ctypes.c_int64
        lib.fp_acquire_batch.argtypes = [ctypes.c_void_p, u8p, u64p, u64p]
        _LIB = lib
        return lib


def _u8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def deinterleave_c2(interleaved):
    """Host-side 2-channel deinterleave (even/odd bytes) of a numpy u8
    array: (..., 2*W) -> two (..., W) planes."""
    a = np.ascontiguousarray(interleaved, np.uint8)
    n = a.size // 2
    c1 = np.empty(n, np.uint8)
    c2 = np.empty(n, np.uint8)
    _lib().fp_deinterleave_c2(_u8ptr(a), _u8ptr(c1), _u8ptr(c2), n)
    shape = a.shape[:-1] + (a.shape[-1] // 2,)
    return c1.reshape(shape), c2.reshape(shape)


def rgba_to_r(rgba):
    """The R plane of interleaved RGBA bytes: (..., 4*N) -> (..., N)."""
    a = np.ascontiguousarray(rgba, np.uint8)
    n = a.size // 4
    r = np.empty(n, np.uint8)
    _lib().fp_rgba_to_r(_u8ptr(a), _u8ptr(r), n)
    return r.reshape(a.shape[:-1] + (a.shape[-1] // 4,))


def ycbcr422_split(cbycry, width, height):
    """CbYCrY 4:2:2 -> (Y (H, W), Cb (H, W/2), Cr (H, W/2))."""
    a = np.ascontiguousarray(cbycry, np.uint8)
    if a.size != width * height * 2:
        raise ValueError(f"a {width}x{height} CbYCrY frame is "
                         f"{width * height * 2} bytes; got {a.size}")
    y = np.empty((height, width), np.uint8)
    cb = np.empty((height, width // 2), np.uint8)
    cr = np.empty((height, width // 2), np.uint8)
    _lib().fp_ycbcr422_split(_u8ptr(a), _u8ptr(y), _u8ptr(cb), _u8ptr(cr),
                             width, height)
    return y, cb, cr


class FramePump:
    """Multi-stream latest-frame ring: camera threads push, the serving
    loop acquires contiguous batches for the upload to the device.

    device: where the step runs, one device or the list a step is split
    over. It decides only how the batches are held: with a CUDA device
    among them they are page-locked, so that a non_blocking copy is
    asynchronous.

    acquire_batch fills one of two host buffers in turn. A non_blocking
    upload may still be reading a buffer when the loop comes round to it,
    so after starting the copies of a batch the loop calls fence(): it
    records an event on each CUDA device's current stream, and
    acquire_batch waits for the events of the buffer it is about to
    overwrite. A loop that uploads with blocking copies, or runs on the
    CPU, needs no fence."""

    N_BUFFERS = 2

    def __init__(self, n_streams, frame_shape=(270, 428), *, device):
        self.n_streams = n_streams
        self.frame_shape = tuple(frame_shape)
        self.frame_bytes = int(np.prod(frame_shape))
        devices = device if isinstance(device, (list, tuple)) else [device]
        self._cuda = sorted({torch.device(d) for d in devices
                             if torch.device(d).type == "cuda"}, key=str)
        self._buffers = [
            torch.empty((n_streams,) + self.frame_shape, dtype=torch.uint8,
                        pin_memory=bool(self._cuda))
            for _ in range(self.N_BUFFERS)]
        self._events = [[] for _ in range(self.N_BUFFERS)]
        self._turn = self._last = 0
        self._pump = _lib().fp_create(n_streams, self.frame_bytes)
        if not self._pump:
            raise MemoryError("framepump allocation failed")
        self._last_ids = np.zeros(n_streams, np.uint64)

    def push(self, stream, frame, frame_id):
        """Publish a (H, W) u8 numpy frame as stream's latest."""
        a = np.ascontiguousarray(frame, np.uint8)
        if a.shape != self.frame_shape:
            raise ValueError(f"frame {a.shape}; the pump holds "
                             f"{self.frame_shape}")
        rc = _lib().fp_push_frame(self._pump, stream, _u8ptr(a),
                                  int(frame_id))
        if rc != 0:
            raise IndexError(f"bad stream id {stream}")

    def acquire_batch(self):
        """The latest frame of every stream. Returns (batch (S, H, W) u8
        host tensor, frame_ids (S,) numpy uint64, n_fresh: streams whose
        frame changed since the last call). The tensor is one of the pump's
        two buffers: it is valid until the call after the next."""
        turn = self._turn
        self._turn = (turn + 1) % self.N_BUFFERS
        for event in self._events[turn]:
            event.synchronize()
        self._events[turn] = []
        batch = self._buffers[turn]
        ids = np.zeros(self.n_streams, np.uint64)
        fresh = _lib().fp_acquire_batch(
            self._pump, _u8ptr(batch.numpy()),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self._last_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        self._last = turn
        return batch, ids, int(fresh)

    def fence(self):
        """Mark the uploads of the batch acquired last: an event on the
        current stream of each CUDA device the pump serves. Call it right
        after starting the non_blocking copies."""
        for device in self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self._events[self._last].append(event)

    def close(self):
        if self._pump:
            _lib().fp_destroy(self._pump)
            self._pump = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
