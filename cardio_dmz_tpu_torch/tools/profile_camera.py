"""Per-stage profiler of the camera path in front of the scan.

Counterpart of the JAX package's tools/profile_camera.py, on its inputs
(RandomState(0) noise previews, 480x640 Y + 240x320 Cb/Cr): on the top and
on the left api.detection_boxes band of the Y plane, sobel7 (dx and dy),
adaptive_canny7, and canny + hough_best_line with the camera's Hough
constants; then detect_edges over all 12 bands (4 edges x 3 planes), the
exact warp of a fixed quad, preprocess_frame (detection and warp), and the
full scanner step (PAN + expiry) on noise cards. Each stage is timed alone
by tools/profiling.event_ms, as replays of its CUDA graph.

    python -m cardio_dmz_tpu_torch.tools.profile_camera [--streams 64]

runs on the CUDA device; --device cpu times on the CPU's host clock.
"""

import argparse

import numpy as np
import torch

from .profiling import TIMING, device_label, event_ms, stage_line

BANDS = (("top", False), ("left", True))
# the warp stage's corners (the JAX tool's lines 104-106), a quad a stream
WARP_QUAD = [[106, 105], [533, 105], [106, 374], [533, 374]]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    return ap.parse_args(argv)


def noise(rng, device, *shape):
    """A uint8 noise tensor of `shape` drawn from `rng`, on `device`."""
    return torch.from_numpy(rng.randint(0, 256, shape).astype(
        np.uint8)).to(device)


def camera_inputs(rng, streams, device):
    """Noise previews from `rng`: (y, cb, cr) on `device`, drawn in that
    order, as the JAX tools draw them."""
    return (noise(rng, device, streams, 480, 640),
            noise(rng, device, streams, 240, 320),
            noise(rng, device, streams, 240, 320))


def hough_of_band(band, vertical):
    """canny + the band's best line, with detect_edges' constants."""
    from ..constants import (
        HORIZONTAL_ANGLE, HOUGH_GRADIENT_ANGLE_THRESHOLD,
        HOUGH_THETA_RES, HOUGH_THRESHOLD_LENGTH_DIVISOR,
        MAX_ANGLE_DEVIATION, VERTICAL_ANGLE)
    from ..ops import adaptive_canny7, hough_best_line

    edges, dx, dy = adaptive_canny7(band)
    base = VERTICAL_ANGLE if vertical else HORIZONTAL_ANGLE
    h, w = band.shape[-2:]
    return hough_best_line(
        edges, dx, dy, rho=1.0, theta=HOUGH_THETA_RES,
        threshold=max(w, h) // HOUGH_THRESHOLD_LENGTH_DIVISOR,
        theta_min=base - MAX_ANGLE_DEVIATION,
        theta_max=base + MAX_ANGLE_DEVIATION, vertical=vertical,
        gradient_angle_threshold=HOUGH_GRADIENT_ANGLE_THRESHOLD)


def stages(params, streams, device):
    """{stage: fn}, in the JAX tool's order."""
    from .. import api
    from ..ops import adaptive_canny7, sobel7, unwarp_card
    from ..parallel.streams import batched_scanner_step, init_stream_states

    rng = np.random.RandomState(0)
    y, cb, cr = camera_inputs(rng, streams, device)
    boxes = api.detection_boxes(tuple(y.shape), 3)
    out = {}
    for edge, vertical in BANDS:
        x, yy, w, h = boxes[edge]
        band = y[:, yy:yy + h, x:x + w]
        out[f"sobel7 {edge} band {tuple(band.shape)}"] = (
            lambda b=band: (sobel7(b, dx=True, dy=False),
                            sobel7(b, dx=False, dy=True)))
        out[f"canny {edge} band"] = lambda b=band: adaptive_canny7(b)
        out[f"canny+hough {edge} band"] = (
            lambda b=band, v=vertical: hough_of_band(b, v))
    corners = torch.tensor(WARP_QUAD, dtype=torch.float32,
                           device=device).expand(streams, 4, 2).contiguous()
    cards = noise(rng, device, streams, 270, 428)
    states = init_stream_states(streams, device, (2026, 1))
    out.update({
        "detect_edges (all 12 bands)": lambda: api.detect_edges(y, cb, cr),
        "warp 428x270": lambda: unwarp_card(y, corners),
        "preprocess_frame (fused)": lambda: api.preprocess_frame(y, cb, cr),
        "scanner_step (PAN+expiry)": lambda: batched_scanner_step(
            params, states, cards, scan_expiry=True)})
    return out


def main(argv=None):
    """Time each stage; prints a line a stage and returns {stage: ms}."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device

    args = parse_args(argv)
    device = named_device(args.device, "profile_camera")
    params = load_all_params(device)
    print(f"# streams={args.streams} device={device_label(device)} "
          f"iters={args.iters} {TIMING}")
    times = {}
    for name, fn in stages(params, args.streams, device).items():
        times[name] = event_ms(fn, device, args.iters)
        print(stage_line(name, times[name], device), flush=True)
    return times


if __name__ == "__main__":
    main()
