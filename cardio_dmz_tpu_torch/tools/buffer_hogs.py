"""The largest buffers a serving step materializes, and the device time by
the port's source.

Counterpart of the JAX package's tools/hlo_hogs.py. There XLA fuses the
graph and the tool ranks the output buffers of the optimized HLO's
unfused instructions; eager PyTorch materializes every op's output, so
this tool ranks those: one step of a graph of tools/stage_bytes.py
(`--graph` scan: the scanner step with the expiry read; pan: without it;
camera: the camera step with it) counted by tools/profiling.WorkCounter,
each output with its aten op and the port function that made it (the
innermost frame of cardio_dmz_tpu_torch in the stack). The three CUDA
kernels' outputs are not dispatched ops and are not listed.

With --cycles (the JAX tool's rank_cycles, which reads the TPU backend's
estimated cycles), the device's own times on the card instead: one step
under torch.profiler, each kernel's device time given to the innermost
port function (or kernel region) above the op that launched it, ranked by
source and by kernel.

    python -m cardio_dmz_tpu_torch.tools.buffer_hogs [--streams 256]
        [--graph scan|camera|pan] [--top 40] [--cycles]

runs on the CUDA device; --device cpu ranks the buffers on the CPU
(--cycles needs the card).
"""

import argparse
import collections
import re

import torch

from .profiling import WorkCounter

GRAPH_NAMES = {"scan": "scan_full", "pan": "scan_pan",
               "camera": "camera_full"}
# a python frame as torch.profiler names it: "<path>.py(<line>): <name>"
_PY_FRAME = re.compile(r"(?:^|/)cardio_dmz_tpu_torch/(.+?\.py)\((\d+)\): "
                       r"(.+)$")
# port frames that stand between an op and the code that ran it
_PLUMBING = ("tools/profiling.py", "ops/cuda/_build.py")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--graph", default="scan", choices=sorted(GRAPH_NAMES))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--cycles", action="store_true",
                    help="also rank the card's device time by port source")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    return ap.parse_args(argv)


def rank_buffers(step, states, inputs, top):
    """(bytes executed, [(bytes, aten op, port frame)] of the `top`
    largest outputs of one counted step)."""
    with WorkCounter(keep_outputs=True) as counter:
        step(states, *inputs)
    return counter.bytes, sorted(counter.outputs, key=lambda r: -r[0])[:top]


def source_of(event):
    """The innermost port function ("path(def line): name") in the Python
    stack of event or of its parents, or a kernel's profiler region; "?"
    if none. An op's stack is its Python frames, innermost first; a
    profiler that records Python calls as events of their own has them as
    the op's parents instead."""
    while event is not None:
        if event.name.endswith(" kernel"):
            return event.name                   # a counted_launch region
        for frame in (event.name, *event.stack):
            m = _PY_FRAME.search(frame)
            if m and m.group(1) not in _PLUMBING:
                return f"{m.group(1)}({m.group(2)}): {m.group(3)}"
        event = event.cpu_parent
    return "?"


def rank_device_time(fn, top):
    """One call of fn on the card under torch.profiler with Python stacks
    (the verbose experimental config keeps each op's stack):
    ({source: [ms, launches]}, {(kernel, source): [ms, launches]}, total
    ms), each ranked and cut to `top`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True,
                 experimental_config=torch._C._profiler._ExperimentalConfig(
                     verbose=True)) as prof:
        fn()
        torch.cuda.synchronize()
    by_src = collections.defaultdict(lambda: [0.0, 0])
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    for event in prof.events():
        if not event.kernels:
            continue
        src = source_of(event)
        for k in event.kernels:
            for row in (by_src[src], by_kernel[(k.name[:60], src)]):
                row[0] += k.duration / 1e3
                row[1] += 1
    total = sum(ms for ms, _ in by_src.values())
    if total <= 0:
        raise RuntimeError("torch.profiler tied no device time to an op")

    def ranked(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1][0])[:top])
    return ranked(by_src), ranked(by_kernel), total


def main(argv=None):
    """Prints the ranking(s); returns {"bytes": .., "buffers": [..]} and,
    with --cycles, "by_source", "by_kernel" and "device_ms"."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device
    from .stage_bytes import build_graphs

    args = parse_args(argv)
    device = named_device(args.device, "buffer_hogs")
    if args.cycles and device.type != "cuda":
        raise SystemExit("buffer_hogs --cycles ranks the card's device time; "
                         "run it on a CUDA device")
    name = GRAPH_NAMES[args.graph]
    params = load_all_params(device)
    step, states, inputs = build_graphs(params, args.streams, device)[name]
    states, _ = step(states, *inputs)             # builds the device tables
    total, rows = rank_buffers(step, states, inputs, args.top)
    print(f"# {args.graph} ({name}) @{args.streams} on {device}: "
          f"{total / 1e9:.2f} GB/step (bytes executed)")
    print(f"{'MB out':>9}  {'aten op':<28} port function")
    for n_bytes, op, frame in rows:
        print(f"{n_bytes / 1e6:9.2f}  {op:<28} {frame}")
    out = {"bytes": total, "buffers": rows}
    if args.cycles:
        by_src, by_kernel, device_ms = rank_device_time(
            lambda: step(states, *inputs), args.top)
        print(f"\n# device time {device_ms:.3f} ms in one step, by port "
              f"source")
        for src, (ms, n) in by_src.items():
            print(f"{ms:9.3f} ms {n:5d} launches  {src}")
        print("# -- top kernels --")
        for (kernel, src), (ms, n) in list(by_kernel.items())[:15]:
            print(f"{ms:9.3f} ms {n:5d}  {kernel:<60} {src}")
        out.update(by_source=by_src, by_kernel=by_kernel,
                   device_ms=device_ms)
    return out


if __name__ == "__main__":
    main()
