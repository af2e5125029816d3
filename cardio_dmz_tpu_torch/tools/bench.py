"""Benchmark: scan-pipeline throughput in frames/s on one device, or a
single stream's frame latency.

Counterpart of the JAX package's tools/bench.py: a batch of concurrent
camera streams stepped through the scan pipeline (vseg -> hseg -> 3-conv
digit ensemble -> session EWMA + acceptance; with the expiry read by
default; with --camera the edge detection, homography and warp in front),
on the inputs the JAX bench makes, printing ONE JSON line with its keys
and metric names:

    python -m cardio_dmz_tpu_torch.tools.bench [--camera] [--no-expiry]
                                               [--latency] [--smoke]

runs on the CUDA device; --device cpu runs on the CPU. The step is graphed
(parallel/graphed.graph_step: captured once, replayed every step), as the
JAX bench jits its step; a `#` line on stderr says so. Time is host
clock. A throughput shape times the steps together, ending in
torch.cuda.synchronize(); a latency shape (--latency, one stream) times
each step alone, from its launch to a synchronize after it, and reports
the median of those times, so a stall inside the window does not move it.
The JAX bench reports a latency shape's mean step time under the same
metric name.

vs_baseline compares with the only published reference number: ~22 fps
full-pipeline on an iPhone 4S (reference eigen.h:15-21; BASELINE.md).
The JAX bench's --warp-bf16 and its latency-shaped graph are TPU
switches; the port has neither.
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

BASELINE_FPS = 22.0
N_DISTINCT_PREVIEWS = 16


def scan_inputs(streams):
    """The rectified shapes' frames: (S, 270, 428) u8 noise from
    RandomState(0), as the JAX bench draws them."""
    rng = np.random.RandomState(0)
    return (rng.randint(0, 256, (streams, 270, 428)).astype(np.uint8),)


def camera_inputs(streams, noise_frames=False):
    """The camera shapes' (y, cb, cr) planes, as the JAX bench makes them:
    16 distinct rendered card previews (distinct PANs, jittered PAN rows,
    background noise) tiled over the streams, or with noise_frames
    uniform noise (the worst-case probe)."""
    from .. import synthetic
    from ..constants import (
        LANDSCAPE_HORIZONTAL_INSET, LANDSCAPE_VERTICAL_INSET)

    rng = np.random.RandomState(0)
    if noise_frames:
        return (rng.randint(0, 256, (streams, 480, 640)).astype(np.uint8),
                rng.randint(0, 256, (streams, 240, 320)).astype(np.uint8),
                rng.randint(0, 256, (streams, 240, 320)).astype(np.uint8))
    n_distinct = min(streams, N_DISTINCT_PREVIEWS)
    x0, y0 = LANDSCAPE_HORIZONTAL_INSET, LANDSCAPE_VERTICAL_INSET
    ys = []
    for i in range(n_distinct):
        pan = synthetic.safe_pan(np.random.default_rng(100 + i))
        card = synthetic.render_frame(pan, y0=150 + (i % 5) * 8, seed=i,
                                      noise=2).astype(np.int32)
        fy = np.full((480, 640), 50, np.int32)
        fy += rng.randint(-3, 4, fy.shape)
        fy[y0:y0 + 270, x0:x0 + 428] = card
        ys.append(np.clip(fy, 0, 255).astype(np.uint8))
    reps = -(-streams // n_distinct)
    y = np.tile(np.stack(ys), (reps, 1, 1))[:streams]
    chroma = np.full((streams, 240, 320), 128, np.uint8)
    return y, chroma, chroma.copy()


def make_inputs(args):
    """(numpy input planes, metric) of parsed bench arguments."""
    if args.camera:
        return (camera_inputs(args.streams, args.noise_frames),
                "camera_pipeline_throughput")
    return scan_inputs(args.streams), "scan_pipeline_throughput"


def make_step(params, camera, expiry):
    """step(states, *inputs) -> (states, complete): one batched scanner
    step, or with camera one batched camera step, graphed on the device
    the params live on."""
    from ..parallel.graphed import graph_step
    from ..parallel.streams import batched_camera_step, batched_scanner_step

    if camera:
        def step(states, y, cb, cr):
            states, (_, _, results) = batched_camera_step(
                params, states, y, cb, cr, scan_expiry=expiry)
            return states, results.complete
    else:
        def step(states, frames):
            states, (_, results) = batched_scanner_step(
                params, states, frames, scan_expiry=expiry)
            return states, results.complete
    return graph_step(step, next(params["vseg_mlp"].buffers()).device)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--expiry", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="include the in-graph expiry path (default on; "
                         "--no-expiry for the PAN-only pipeline)")
    ap.add_argument("--camera", action="store_true",
                    help="bench the full camera path: 480x640 YCbCr frame "
                         "-> edge detection -> rectification -> digits")
    ap.add_argument("--latency", action="store_true",
                    help="report p50 frame->digits latency instead of "
                         "throughput: the median time of a single-stream "
                         "step, each step timed alone")
    ap.add_argument("--noise-frames", action="store_true",
                    help="camera mode: uniform-noise frames (worst-case "
                         "probe) instead of rendered card previews")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI smoke")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.streams, args.iters, args.warmup = 8, 3, 1
    if args.latency:
        args.streams = 1
        args.iters = max(args.iters, 50)
    return args


def main(argv=None):
    """Run the bench; prints the JSON line and returns it as a dict."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device
    from ..parallel.streams import init_stream_states

    args = parse_args(argv)
    device = named_device(args.device, "bench")
    params = load_all_params(device)
    arrays, metric = make_inputs(args)
    inputs = tuple(torch.from_numpy(a).to(device) for a in arrays)
    step = make_step(params, args.camera, args.expiry)
    states = init_stream_states(args.streams, device, time.localtime()[:2])

    for _ in range(args.warmup):
        states, complete = step(states, *inputs)
    synchronize(device)

    if args.latency:
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            states, complete = step(states, *inputs)
            synchronize(device)
            times.append(time.perf_counter() - t0)
        elapsed = sum(times)
        step_ms = 1000.0 * statistics.median(times)
    else:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            states, complete = step(states, *inputs)
        synchronize(device)
        elapsed = time.perf_counter() - t0
        step_ms = 1000.0 * elapsed / args.iters
    fps = args.streams * args.iters / elapsed
    print(f"# device={device_name(device)} streams={args.streams} "
          f"iters={args.iters} step={step_ms:.1f}ms expiry={args.expiry} "
          f"camera={args.camera}", file=sys.stderr)
    print("# the step is graphed: " + (
        "one CUDA graph, captured in the warm-up, replayed every step"
        if device.type == "cuda" else
        "its staging runs the step eagerly on the CPU, where no graph "
        "exists"), file=sys.stderr)
    if args.latency:
        # the median step time of one stream == p50 frame->digits
        # latency; baseline = 1/22 fps = 45.5 ms
        record = {
            "metric": ("camera_frame_latency_p50" if args.camera
                       else "scan_frame_latency_p50"),
            "value": round(step_ms, 2),
            "unit": "ms",
            "vs_baseline": round((1000.0 / BASELINE_FPS) / step_ms, 2),
        }
    else:
        record = {
            "metric": metric,
            "value": round(fps, 1),
            "unit": "frames/sec/chip",
            "vs_baseline": round(fps / BASELINE_FPS, 2),
        }
    print(json.dumps(record), flush=True)
    return record


def cli(argv=None):
    """Console entry point: main's line, exit code 0."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
