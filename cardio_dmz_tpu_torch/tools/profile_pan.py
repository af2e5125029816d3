"""Per-stage profiler of the PAN-only card pipeline.

Counterpart of the JAX package's tools/profile_pan.py: vseg, hseg,
categorize and the PAN-only step, each timed alone at `--streams` on the
JAX tool's inputs (RandomState(0) noise frames and strips), printed as ms
and frames/s. Each stage is timed by tools/profiling.event_ms: CUDA
events around `--iters` replays of the stage's CUDA graph (the JAX tool
times jitted stages), which the card runs in stream order, so the JAX
tool's self-feeding chains are not needed.

    python -m cardio_dmz_tpu_torch.tools.profile_pan [--streams 64]

runs on the CUDA device; --device cpu times on the CPU's host clock.
"""

import argparse

import numpy as np
import torch

from .profiling import TIMING, device_label, event_ms, stage_line

STAGES = ("vseg (270 rows MLP)", "hseg (staged search)",
          "categorize (3-conv x16)", "full PAN-only step")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Time each stage; prints a line a stage and returns {stage: ms}."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device
    from ..parallel.streams import batched_scanner_step, init_stream_states
    from ..scan.categorize import number_scores
    from ..scan.hseg import best_n_hseg
    from ..scan.vseg import best_n_vseg

    args = parse_args(argv)
    device = named_device(args.device, "profile_pan")
    s = args.streams
    params = load_all_params(device)
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (s, 270, 428)).astype(np.uint8)).to(device)
    strips = torch.from_numpy(
        rng.randint(0, 256, (s, 27, 428)).astype(np.uint8)).to(device)
    pattern = torch.ones(s, dtype=torch.int32, device=device)
    length = torch.full((s,), 16, dtype=torch.int32, device=device)
    offsets = (30 + 19 * torch.arange(16, dtype=torch.int32, device=device)
               ).expand(s, 16).contiguous()
    states = init_stream_states(s, device, (2026, 1))
    stages = dict(zip(STAGES, (
        lambda: best_n_vseg(params["vseg_mlp"], frames),
        lambda: best_n_hseg(strips, pattern, length),
        lambda: number_scores(params, strips, offsets, length),
        lambda: batched_scanner_step(params, states, frames))))
    print(f"# device={device_label(device)} streams={s} "
          f"iters={args.iters} {TIMING}")
    times = {}
    for name, fn in stages.items():
        times[name] = event_ms(fn, device, args.iters)
        print(stage_line(name, times[name], device, s), flush=True)
    return times


if __name__ == "__main__":
    main()
