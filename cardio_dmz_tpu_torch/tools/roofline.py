"""Roofline account of every serving graph: work, step time, and the
shares of the H100's peaks.

Counterpart of the JAX package's tools/roofline.py, with its shapes,
inputs (RandomState(0) noise cards, then noise previews) and record keys:
for each shape one eager step is counted by tools/profiling.WorkCounter
(the JAX tool reads XLA's cost analysis; a counter sees ops as they are
dispatched, and a graph's replay dispatches none), the graphed step
(parallel/graphed.graph_step, the port's jax.jit) is timed as the JAX tool
times its jitted one (`--iters` steps with the states carried, host clock
up to a synchronize, after one call that captures the graph), and one
graphed step is profiled (device time and the device's idle share). Per
shape, one JSON line:

* gflops_per_step, mflops_per_frame; hbm_mb_per_step (bytes executed:
  every op's inputs and outputs, an upper bound on traffic, as XLA's
  "bytes accessed" is) and min_mb_per_step (the roofline rule: inputs,
  states and parameters read once, new states and results written once);
  int_ops (integer, bool, copy and indexing elements, apart from FLOPs);
* step_ms, fps; mfu_pct and hbm_util_pct over the host-clock step, as in
  JAX, and mfu_pct_of_device_ms / hbm_util_pct_of_device_ms over the
  step's device time; device_ms and idle_share (torch.profiler);
* floor_ms_compute (FLOPs at the f32 peak: the port's products run in
  full f32 with TF32 off, outside the tensor cores) and floor_ms_hbm (the
  minimum bytes at the HBM rate); roofline_fps_ceiling and which of the
  two bounds the step;
* peak (the peaks used) and device (the card's name and power limit).

Shapes: "full" (the scanner step with the expiry read), "pan" (without
it), "camera" (batched_camera_step with the expiry read, the camera step
a user calls; the JAX tool's camera graph stops before the result).

    python -m cardio_dmz_tpu_torch.tools.roofline [--streams 256]
                                                  [--iters 30]

runs on the CUDA device. With --device cpu it only counts: every time,
share, floor and ceiling is null, and device is "cpu".
"""

import argparse
import json
import time

import numpy as np
import torch

from .profile_camera import camera_inputs, noise
from .profiling import (
    HBM_BYTES_PER_S, PEAK_FLOPS, PEAK_NOTE, count_step, device_label,
    profile_step, synchronize)

SHAPES = ("full", "pan", "camera")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="also write the records to this JSON file")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    return ap.parse_args(argv)


def shape_steps(params, streams, device):
    """{shape: (step, inputs)}: step(states, *inputs) -> (states,
    outputs)."""
    from ..parallel.streams import batched_camera_step, batched_scanner_step

    rng = np.random.RandomState(0)
    frames = noise(rng, device, streams, 270, 428)
    planes = camera_inputs(rng, streams, device)

    def scan(expiry):
        return lambda st, fr: batched_scanner_step(params, st, fr, expiry)

    def camera(st, y, cb, cr):
        return batched_camera_step(params, st, y, cb, cr, scan_expiry=True)

    return {"full": (scan(True), (frames,)), "pan": (scan(False), (frames,)),
            "camera": (camera, planes)}


def analyze(name, step, params, states, inputs, streams, iters, device):
    """One shape's record (printed as a JSON line and returned)."""
    states, _ = step(states, *inputs)                   # builds the tables
    counter, min_bytes = count_step(step, params, states, *inputs)
    flops, n_bytes = counter.flops, counter.bytes
    rec = {
        "shape": name, "streams": streams,
        "step_ms": None, "fps": None,
        "gflops_per_step": round(flops / 1e9, 3),
        "mflops_per_frame": round(flops / streams / 1e6, 3),
        "hbm_mb_per_step": round(n_bytes / 1e6, 2),
        "hbm_kb_per_frame": round(n_bytes / streams / 1e3, 1),
        "min_mb_per_step": round(min_bytes / 1e6, 3),
        "int_ops": counter.int_ops,
        "mfu_pct": None, "hbm_util_pct": None,
        "mfu_pct_of_device_ms": None, "hbm_util_pct_of_device_ms": None,
        "device_ms": None, "idle_share": None,
        "floor_ms_compute": None, "floor_ms_hbm": None,
        "roofline_fps_ceiling": None, "bound": None,
        "peak": PEAK_NOTE, "device": device_label(device),
    }
    if torch.device(device).type == "cuda":
        from ..parallel.graphed import graph_step
        graphed = graph_step(step, device)
        states, _ = graphed(states, *inputs)             # captures the graph
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            states, _ = graphed(states, *inputs)
        synchronize(device)
        sec = (time.perf_counter() - t0) / iters
        prof = profile_step(lambda: graphed(states, *inputs))
        t_flops = flops / PEAK_FLOPS["f32"]
        t_mem = min_bytes / HBM_BYTES_PER_S
        rec.update({
            "step_ms": round(1e3 * sec, 3),
            "fps": round(streams / sec, 1),
            "mfu_pct": round(100.0 * t_flops / sec, 4),
            "hbm_util_pct": round(100.0 * n_bytes / HBM_BYTES_PER_S / sec,
                                  3),
            "device_ms": prof["device_ms"],
            "idle_share": prof["idle_share"],
            "floor_ms_compute": round(1e3 * t_flops, 5),
            "floor_ms_hbm": round(1e3 * t_mem, 5),
            "roofline_fps_ceiling": round(streams / max(t_flops, t_mem)),
            "bound": "hbm" if t_mem > t_flops else "compute",
        })
        if prof["device_ms"]:
            dev_s = prof["device_ms"] / 1e3
            rec["mfu_pct_of_device_ms"] = round(100.0 * t_flops / dev_s, 4)
            rec["hbm_util_pct_of_device_ms"] = round(
                100.0 * n_bytes / HBM_BYTES_PER_S / dev_s, 3)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    """One record a shape; returns {shape: record}."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device
    from ..parallel.streams import init_stream_states

    args = parse_args(argv)
    device = named_device(args.device, "roofline")
    params = load_all_params(device)
    steps = shape_steps(params, args.streams, device)
    results = {}
    for name in args.shapes.split(","):
        step, inputs = steps[name]
        results[name] = analyze(
            name, step, params,
            init_stream_states(args.streams, device, (2026, 1)), inputs,
            args.streams, args.iters, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
