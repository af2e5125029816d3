"""Measurement helpers of the port's profilers: timing, one profiled step,
and a count of the work a step runs.

Counterpart of the helpers each JAX profiler repeats (profile_pan's
bench_chain, profile_expiry's bench, stage_bytes' _cost; telem is the
port's scan/frame.telemetry_zeros). On a TPU they time self-feeding jitted
chains and read XLA's cost analysis; here:

* event_ms: ms a replay of a stage's CUDA graph (parallel/graphed.
  graph_step), between two CUDA events around many replays, as the JAX
  tools time jitted stages. The card runs replays in stream order, so no
  chain is needed. On the CPU the host clock, and clock_name says so.
* profile_step: one call under torch.profiler: device time, device
  operations, the heaviest kernels, and the device's idle share.
* WorkCounter: a TorchDispatchMode that counts the FLOPs and bytes of the
  aten ops a call runs, the port's counterpart of XLA's "flops" and
  "bytes accessed"; the three CUDA kernels report their own formulas
  (ops/cuda/_build.counted_launch), so a step counts the same on the CPU
  and on the card.
* bound: the roofline rule of a count against the H100's peaks.
"""

import collections
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..parallel.graphed import graph_step

# One H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit): HBM bytes/s;
# float32 and float64 outside the tensor cores. The port's products run in
# full f32 with TF32 off, so f32 is the peak of its FLOPs.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
PEAK_NOTE = "f32 67e12 FLOP/s, HBM 3.35e12 B/s, H100 SXM data sheet"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ops that allocate without writing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def bound(flops, n_bytes, kind="f32"):
    """(bound_ms, bound_by): the larger of n_bytes over the memory rate and
    flops over the peak rate of their kind ("f32" or "f64")."""
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_FLOPS[kind]
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def clock_name(device):
    """What event_ms times with on `device`."""
    return "cuda events" if torch.device(device).type == "cuda" \
        else "cpu host clock"


def device_label(device):
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


# what event_ms times, for the profilers' "#" header lines
TIMING = "graphed (replays of each stage's CUDA graph)"


def event_ms(fn, device, iters=20, warmup=None):
    """ms a replay of fn's CUDA graph on `device`. fn takes no arguments
    (its graph's key is ()); graph_step(fn, device) runs its warm-up calls
    and the capture at the first replay, then come `warmup` replays (3, or
    `iters` if fewer) and `iters` replays between two CUDA events recorded
    on the current stream, then a synchronize. A replay clones no output.
    On the CPU, where no graph exists, the host clock around `iters` calls
    of the staging."""
    device = torch.device(device)
    step = graph_step(fn, device)
    step.replay()                  # warm-up calls and the capture
    for _ in range(min(3, iters) if warmup is None else warmup):
        step.replay()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            step.replay()
        return 1e3 * (time.perf_counter() - t0) / iters
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters


def stage_line(name, ms, device, streams=None):
    """One profiler line: the stage, its ms (and frames/s at `streams`),
    and the clock that timed it."""
    fps = f" ({1e3 * streams / ms:8.0f} fps)" if streams else ""
    return f"{name:34s} {ms:9.3f} ms{fps}  [{clock_name(device)}]"


def profile_step(fn):
    """One call of fn under torch.profiler, after one call to warm up:
    device ms in all, the number of device operations, those whose kernel
    works on float64 (name holds "double"), the five kernels with the most
    device time as (name, ms, launches); the host-clock ms of a call
    (median of 3, each ended by a synchronize) and the device's idle share
    of it, 1 - device ms / host ms. The profiler now and then records no
    device work at all; after three such calls the device numbers are None
    (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    host_ms = statistics.median(times)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.self_device_time_total > 0]
        if rows:
            break
    else:
        return {"device_ms": None, "top": [], "device_ops": None,
                "f64_ops": None, "f64_ms": None, "host_ms": host_ms,
                "idle_share": None}
    f64 = [e for e in rows if "double" in e.key]
    rows.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return {"device_ms": device_ms,
            "top": [(e.key[:70], e.self_device_time_total / 1e3, e.count)
                    for e in rows[:5]],
            "device_ops": sum(e.count for e in rows),
            "f64_ops": sum(e.count for e in f64),
            "f64_ms": sum(e.self_device_time_total for e in f64) / 1e3,
            "host_ms": host_ms,
            "idle_share": max(0.0, 1.0 - device_ms / host_ms)}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(t):
    return t.numel() * t.element_size()


def port_frame():
    """"path:line function" of the innermost caller in this package (not
    this module), relative to the package: the port code that ran an op."""
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(_PKG) and path != __file__:
            return (f"{os.path.relpath(path, _PKG)}:{frame.f_lineno} "
                    f"{frame.f_code.co_name}")
        frame = frame.f_back
    return "?"


class WorkCounter(TorchDispatchMode):
    """Counts the work of every aten op run inside it.

    * bytes: every tensor input's bytes and every output's, op by op: the
      counterpart of XLA's "bytes accessed", an upper bound on the traffic,
      since eager PyTorch materializes every intermediate. A view, and an
      output that aliases an input (an in-place op's), count nothing.
    * flops: the products by torch.utils.flop_counter's formulas (2 M N K);
      a floating-point pointwise or reduction op one an element of the
      larger of its inputs and its output.
    * int_ops: an element of the output of every other op (integer and bool
      arithmetic, comparisons, copies, casts, indexing).
    * kernels: the three CUDA kernels, each counted once a launch by its
      wrapper's formula (ops/cuda/*.work), on either route; the ops of
      their plain versions are not counted.

    by_op holds {aten op: [calls, flops, bytes, int_ops]}; read_storages
    the storages some counted op read; with keep_outputs, `outputs` holds
    (bytes, aten op, port_frame()) of every output written."""

    def __init__(self, keep_outputs=False):
        super().__init__()
        self.paused = 0
        self.keep_outputs = keep_outputs
        self.flops = 0
        self.bytes = 0
        self.int_ops = 0
        self.by_op = collections.defaultdict(lambda: [0, 0, 0, 0])
        self.kernels = collections.defaultdict(lambda: [0, 0, 0])
        self.read_storages = set()
        self.outputs = []

    def add_kernel(self, name, flops, n_bytes, kind):
        row = self.kernels[name]
        row[0] += 1
        row[1] += flops
        row[2] += n_bytes
        self.flops += flops
        self.bytes += n_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        row = self.by_op[str(func)]
        row[0] += 1
        packet = func.overloadpacket
        if func.is_view or packet.__name__ in _NO_TRAFFIC:
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        read = {t.untyped_storage().data_ptr() for t in ins}
        self.read_storages |= read
        written = [t for t in outs
                   if t.untyped_storage().data_ptr() not in read]
        n_bytes = sum(map(nbytes, ins)) + sum(map(nbytes, written))
        flops = int_ops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif (outs and outs[0].is_floating_point()
              and (torch.Tag.pointwise in func.tags
                   or torch.Tag.reduction in func.tags)):
            flops = max(t.numel() for t in ins + outs
                        if t.is_floating_point())
        else:
            int_ops = max((t.numel() for t in outs), default=0)
        self.flops += flops
        self.bytes += n_bytes
        self.int_ops += int_ops
        row[1] += flops
        row[2] += n_bytes
        row[3] += int_ops
        if self.keep_outputs:
            frame = port_frame()
            self.outputs.extend((nbytes(t), str(func), frame)
                                for t in written)

    def summary(self):
        """The totals, the kernels' tally and by_op as plain numbers."""
        return {"flops": self.flops, "bytes": self.bytes,
                "int_ops": self.int_ops,
                "kernels": {k: tuple(v) for k, v in self.kernels.items()},
                "by_op": {k: tuple(v) for k, v in self.by_op.items()}}


def count_step(step, params, states, *inputs):
    """One call of step(states, *inputs) -> (states, outputs) counted by a
    WorkCounter. Returns (counter, minimum bytes): the roofline's rule,
    the step's inputs, the states and the parameters it reads (of params,
    {name: nn.Module}, those some counted op read) read once, and the new
    states and the results written once (each tensor once; a state leaf
    passed through unchanged is not written)."""
    with WorkCounter() as counter:
        new_states, outputs = step(states, *inputs)
    read = _tensors((states, inputs))
    seen = {(t.untyped_storage().data_ptr(), t.storage_offset(), t.shape)
            for t in read}
    written = 0
    for t in _tensors((new_states, outputs)):
        key = (t.untyped_storage().data_ptr(), t.storage_offset(), t.shape)
        if key not in seen:
            seen.add(key)
            written += nbytes(t)
    weights = sum(nbytes(t) for m in params.values()
                  for t in (*m.parameters(), *m.buffers())
                  if t.untyped_storage().data_ptr() in counter.read_storages)
    return counter, sum(map(nbytes, read)) + weights + written
