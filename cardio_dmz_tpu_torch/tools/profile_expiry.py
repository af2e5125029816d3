"""Per-stage timing of the in-graph expiry read.

Counterpart of the JAX package's tools/profile_expiry.py, on its inputs
(RandomState(0) noise frames, the PAN row at 150, every stream enabled):
the full step (PAN + expiry) against the PAN-only step; the expiry seg
(best_expiry_seg_device), and apart its scharr band and stripe selection;
categorize_windows and aggregate_windows. With --fine, the seg's inside:
_process_stripe over the three stripes, the char trim, and the slash
conv. The JAX tool times a TPU form of the trim (each crop a one-hot
contraction); this one times the port's own trim path, as
best_expiry_seg_device runs it: the 21-row bands, window_select's
gathered crops and _trim_char. Each stage is timed by
tools/profiling.event_ms, as replays of its CUDA graph.

    python -m cardio_dmz_tpu_torch.tools.profile_expiry [--streams 64]
                                                        [--fine]

runs on the CUDA device; --device cpu times on the CPU's host clock.
"""

import argparse

import numpy as np
import torch

from .profiling import TIMING, device_label, event_ms, stage_line

STAGES = ("full step", "pan-only", "expiry seg (all)", "  scharr",
          "  stripes", "categorize", "aggregate")
FINE_STAGES = ("  process_stripe", "  trim", "  slash conv")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--fine", action="store_true",
                    help="time the seg's insides instead")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    return ap.parse_args(argv)


def _inputs(streams, device):
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (streams, 270, 428)).astype(np.uint8)).to(device)
    vseg_y = torch.full((streams,), 150, dtype=torch.int32, device=device)
    return frames, vseg_y, (vseg_y + 27).clamp(0, 269)


def stages(params, streams, device):
    """{stage: fn} of the main run."""
    from ..parallel.streams import batched_scanner_step, init_stream_states
    from ..scan import expiry_device as ed

    frames, vseg_y, y_start = _inputs(streams, device)
    enabled = torch.ones(streams, dtype=torch.bool, device=device)
    states = init_stream_states(streams, device, (2026, 1))
    windows = ed.best_expiry_seg_device(params["slash_mlp"], frames, vseg_y,
                                        enabled)
    scores = ed.categorize_windows(params["expiry_conv"], frames, windows)
    sobel = ed.scharr_dx_abs_below(frames, y_start)
    fresh = ed.expiry_state_init(streams, device)
    return dict(zip(STAGES, (
        lambda: batched_scanner_step(params, states, frames,
                                     scan_expiry=True),
        lambda: batched_scanner_step(params, states, frames),
        lambda: ed.best_expiry_seg_device(params["slash_mlp"], frames,
                                          vseg_y, enabled),
        lambda: ed.scharr_dx_abs_below(frames, y_start),
        lambda: ed.select_stripes(sobel, y_start),
        lambda: ed.categorize_windows(params["expiry_conv"], frames,
                                      windows),
        lambda: ed.aggregate_windows(fresh, windows, scores))))


def fine_stages(params, streams, device):
    """{stage: fn} of --fine: the seg's insides on its own intermediates."""
    from ..scan import expiry_device as ed

    frames, _, y_start = _inputs(streams, device)
    sobel = ed.scharr_dx_abs_below(frames, y_start)
    bases, sums, ok = ed.select_stripes(sobel, y_start)
    r_lefts, g_top, g_cw, _ = ed._process_stripe(sobel, bases, sums, ok)

    def bands():
        band_top = (g_top[:, :, 0] - 2).clamp(
            0, ed.CARD_HEIGHT - ed.EXPANDED_H)
        return ed._band_rows(sobel, (band_top - ed._SCHARR_BASE).clamp(
            0, ed._BAND_ROWS - ed.EXPANDED_H), ed.EXPANDED_H)

    def trim():
        lefts = r_lefts.flatten(2)
        crops = ed.window_select(bands(), lefts - 2, ed.EXPANDED_W)
        return ed._trim_char(
            crops, lefts, g_top[..., None].expand(r_lefts.shape).flatten(2),
            g_cw[..., None].expand(r_lefts.shape).flatten(2))

    n_windows = g_top.shape[2] * (ed.MAX_CHARS - 4)
    zeros = torch.zeros(g_top.shape[:2] + (n_windows,), dtype=torch.int32,
                        device=device)
    return dict(zip(FINE_STAGES, (
        lambda: ed._process_stripe(sobel, bases, sums, ok),
        trim,
        lambda: ed.slash_probs_conv(params["slash_mlp"], bands(), zeros,
                                    zeros))))


def main(argv=None):
    """Time each stage; prints a line a stage and returns {stage: ms}."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device

    args = parse_args(argv)
    device = named_device(args.device, "profile_expiry")
    params = load_all_params(device)
    make = fine_stages if args.fine else stages
    print(f"# device={device_label(device)} streams={args.streams} "
          f"iters={args.iters} {TIMING}")
    times = {}
    for name, fn in make(params, args.streams, device).items():
        times[name] = event_ms(fn, device, args.iters)
        print(stage_line(name, times[name], device, args.streams),
              flush=True)
    return times


if __name__ == "__main__":
    main()
