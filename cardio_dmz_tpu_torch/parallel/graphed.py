"""The port's counterpart of jax.jit: a step captured once per input shape
as a CUDA graph, then replayed.

The JAX package jits its steps: the serving steps
(parallel/streams.make_sharded_step, session/host.HostScanner,
tools/bench.py), the train step (train/trainer.make_train_step), the
accuracy sweeps, the parity tool's device functions and the stage
profilers' timed stages. XLA compiles each into one program, dispatched
once a call. The port's steps are PyTorch ops issued
one by one from Python, hundreds to thousands a step. graph_step(fn,
device) records the kernels one call of fn launches into a
torch.cuda.CUDAGraph and replays them with one launch. A replay runs
exactly the kernels of the eager step, the three hand kernels of ops/cuda/
included, so it gives the eager step's bits. This module has no
counterpart file in the JAX package; it stands for jax.jit.

Keyed as jit is: one graph per structure, shapes and dtypes of the
arguments, on the step's device; a new key captures anew, as jit retraces.
For a new key:

* the arguments are copied into static input buffers on the device;
* fn runs WARMUP_CALLS times on them, eagerly, on the device's side
  stream, so that every table the ops build at first use
  (functools.lru_cache, keyed by device) and every kernel library is
  ready before the capture;
* one call of fn is captured on that stream, into the device's one graph
  memory pool; its outputs are the static output buffers.

Each call copies its arguments into the static inputs (copy_), replays the
graph and returns clones of the static outputs: new tensors, as a jitted
function returns new arrays, so nothing a call returned changes at the
next. A capture that fails (a host synchronisation in fn: .item(), bool()
or int() of a tensor, .tolist(), nonzero, boolean-mask indexing, a copy
from pageable host memory) raises CaptureError naming the error and where
in the port it happened; the step never carries on eagerly.

On the CPU no graph exists: the same staging runs fn on the static inputs
at each call, so the CPU tests hold the staging itself.

Arguments and results are tensors, None, and (nested) tuples, NamedTuples
and dicts of them (a train step's parameters and optimizer state are
dicts, as the JAX step's pytrees are); a dict's key holds its keys in
sorted order. A Python number among the arguments raises TypeError: a
graph would freeze it.
"""

import collections
import os
import threading
import time
import traceback
import weakref

import torch

from ..ops.cuda import digit_prep, persp_qr, warp_gather
from .mesh import _map, as_device

WARMUP_CALLS = 3

# The kernel wrappers of ops/cuda/, whose LAUNCHES count every call that
# launches the kernel, a call recorded into a capture included.
KERNELS = {"digit_prep": digit_prep, "warp_gather": warp_gather,
           "persp_qr": persp_qr}
# Since the last reset_launches, by kernel name: the wrapper calls that a
# capture recorded (counted by the wrapper, run by no device until a
# replay) and the launches that replays made.
CAPTURED = collections.Counter()
REPLAYED = collections.Counter()

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# device -> (the graph memory pool's handle, the graphs that share it). A
# pool is released when its last graph is freed, and its handle cannot be
# used again: a capture with no live graph on its device takes a new one.
_POOLS = {}
_STREAMS = {}        # device -> the side stream of warm-up and capture
_CAPTURE_LOCK = threading.Lock()    # one capture at a time in a process


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def reset_launches():
    """Set every kernel's launch count to 0: the wrappers' and the graphs'."""
    for module in KERNELS.values():
        module.LAUNCHES = 0
    CAPTURED.clear()
    REPLAYED.clear()


def launches():
    """{kernel: launches that ran on the device since reset_launches}: the
    wrapper's count, less the calls a capture only recorded, plus the
    launches of the replays."""
    return {name: module.LAUNCHES - CAPTURED[name] + REPLAYED[name]
            for name, module in KERNELS.items()}


def pool_bytes(device):
    """Bytes the graph memory pool of `device` holds (its segments), 0
    before the device's first capture."""
    device = as_device(device)
    if device not in _POOLS:
        return 0
    pool = tuple(_POOLS[device][0])
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg["segment_pool_id"]) == pool)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _key(tree):
    """The jit key of an argument tree: its structure (a dict's keys in
    sorted order), and each tensor's shape and dtype."""
    if isinstance(tree, dict):
        return dict, tuple((k, _key(tree[k])) for k in sorted(tree))
    if isinstance(tree, tuple):
        return type(tree), tuple(_key(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if tree is None:
        return None
    raise TypeError(f"graph_step takes tensors, None, and tuples and dicts "
                    f"of them; got a {type(tree).__name__}, which a graph "
                    f"would freeze")


def _copy_into(static, tree):
    for dst, src in zip(_leaves(static), _leaves(tree)):
        if dst is not None:
            dst.copy_(src)


def _clone(tree):
    def clone(x):
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"a graphed step returns tensors, None, and "
                            f"tuples and dicts of them; got a "
                            f"{type(x).__name__}")
        return x.clone()
    return _map(clone, tree)


def _where(error):
    """"path:line function" of the innermost frame in error's traceback
    that is neither torch's nor this module's: the step's own code that
    broke the capture."""
    skip = (os.path.dirname(torch.__file__), os.path.abspath(__file__))
    frames = [f for f in traceback.extract_tb(error.__traceback__)
              if not f.filename.startswith(skip)]
    if not frames:
        return "?"
    f = frames[-1]
    path = os.path.relpath(f.filename, _PKG) if f.filename.startswith(_PKG) \
        else os.path.basename(f.filename)
    return f"{path}:{f.lineno} {f.name}"


def _kernel_counts():
    return {name: module.LAUNCHES for name, module in KERNELS.items()}


class _Graph:
    """One key's static buffers and graph (None on the CPU)."""

    def __init__(self, fn, device, args):
        self.fn, self.device = fn, device
        self.static_in = _map(lambda t: None if t is None else
                              torch.empty_like(t, device=device), args)
        _copy_into(self.static_in, args)
        self.graph, self.static_out, self.launches = None, None, {}
        t0 = time.perf_counter()
        if device.type == "cuda":
            with torch.cuda.device(device):
                self._capture(device)
        else:
            for _ in range(WARMUP_CALLS):
                fn(*self.static_in)
        self.capture_s = time.perf_counter() - t0

    def _capture(self, device):
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        if not _POOLS.get(device, (None, ()))[1]:
            _POOLS[device] = (torch.cuda.graph_pool_handle(),
                              weakref.WeakSet())
        pool, graphs = _POOLS[device]
        stream = _STREAMS[device]
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_CALLS):
                self.fn(*self.static_in)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        before = _kernel_counts()
        with _CAPTURE_LOCK, torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = self.fn(*self.static_in)
            except Exception as error:
                try:
                    graph.capture_end()     # ends the invalidated capture
                except RuntimeError:
                    pass
                raise self._failed(device, error) from error
            try:
                graph.capture_end()
            except RuntimeError as error:
                raise self._failed(device, error) from error
        self.launches = {name: n - before[name]
                         for name, n in _kernel_counts().items()
                         if n != before[name]}
        CAPTURED.update(self.launches)
        graphs.add(graph)
        self.graph, self.static_out = graph, out

    def _failed(self, device, error):
        name = getattr(self.fn, "__qualname__", None) or repr(self.fn)
        first = str(error).strip().splitlines()[0] if str(error) else \
            type(error).__name__
        return CaptureError(
            f"graph_step: the capture of {name} on {device} failed at "
            f"{_where(error)}: {first}. A CUDA graph holds no host "
            f"synchronisation (.item(), bool() or int() of a tensor, "
            f".tolist(), nonzero, boolean-mask indexing) and no copy from "
            f"pageable host memory; the step is not run eagerly instead")

    def run(self, args):
        """Copy args into the static inputs and replay the graph (on the
        CPU: call fn on them); returns the static outputs, which the next
        run overwrites."""
        _copy_into(self.static_in, args)
        if self.graph is None:
            return self.fn(*self.static_in)
        with torch.cuda.device(self.device):    # replays on its stream
            self.graph.replay()
        REPLAYED.update(self.launches)
        return self.static_out

    def __call__(self, args):
        return _clone(self.run(args))


class GraphedStep:
    """fn captured once a key on `device` and replayed; see the module
    docstring. entries: {key: the key's graph and buffers}, each with
    capture_s (seconds of its warm-up and capture) and launches (the
    kernels of ops/cuda/ that one replay launches)."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = as_device(device)
        self.entries = {}

    def _entry(self, args):
        key = _key(args)
        entry = self.entries.get(key)
        if entry is None:
            entry = _Graph(self.fn, self.device, args)
            self.entries[key] = entry
        return entry

    def __call__(self, *args):
        return self._entry(args)(args)

    def replay(self, *args):
        """A call without its results: the arguments copied in and the
        graph replayed (captured first for a new key), no output cloned.
        What a timer times: the replay alone."""
        self._entry(args).run(args)


def graph_step(fn, device):
    """fn(*args) -> outputs as a GraphedStep on `device` (a torch.device or
    its name; the caller's, never a default): the port's jax.jit."""
    return GraphedStep(fn, device)
