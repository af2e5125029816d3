"""Ablation profile of the camera step.

Counterpart of the JAX package's tools/profile_camera_ablate.py: the
camera step with the expiry read, in four forms on the JAX tool's inputs
(RandomState(0) noise previews, then noise cards), each stepped
`--iters` times with its states carried and timed by
tools/profiling.event_ms, as replays of the step's CUDA graph (the step
writes its new states over the carried ones, so a replay carries them as
the JAX tool's loop does); the marginal cost of a stage is the full form's
time less the form without it:

* full           - preprocess_frame (detection, persp QR, the exact warp)
                   and scanner_add_frame, as camera_scanner_step runs them
* detect ablated - the JAX tool's static quad (its lines 69-70) ->
                   persp QR -> the exact warp; the JAX tool's source
                   window (api.warp_src_bounds) is a TPU lowering the port
                   does not have, so the warp reads the whole frame
* warp ablated   - detection runs; the card is the static centre crop
                   [105:375, 106:534]
* scan only      - batched_scanner_step on noise cards

    python -m cardio_dmz_tpu_torch.tools.profile_camera_ablate
        [--streams 64]

runs on the CUDA device; --device cpu times on the CPU's host clock.
"""

import argparse
import functools

import numpy as np
import torch
from torch.utils._pytree import tree_flatten

from .profile_camera import camera_inputs, noise
from .profiling import TIMING, device_label, event_ms, stage_line

STATIC_QUAD = [[106.0, 105.0], [533.0, 108.0], [103.0, 374.0],
               [530.0, 377.0]]
CROP = (105, 106)             # the centre crop's top left (row, column)
STAGES = ("camera step (full)", "  detect ablated", "  warp ablated",
          "scan only (no camera)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    return ap.parse_args(argv)


@functools.lru_cache(maxsize=None)
def _static_quad(device):
    """STATIC_QUAD kept on `device`: made once, not copied from the host at
    every step."""
    return torch.tensor(STATIC_QUAD, dtype=torch.float32, device=device)


def camera_forms(params):
    """The camera step's three forms, {name: step(states, y, cb, cr) ->
    (states, FrameResult)}: "full", "no_detect", "no_warp"."""
    from .. import api
    from ..constants import (
        CARD_HEIGHT, CARD_WIDTH, ORIENTATION_LANDSCAPE_RIGHT)
    from ..ops import unwarp_card
    from ..scan.frame import telemetry_zeros
    from ..session.state import scanner_add_frame

    def scan(states, y, card, gate):
        telemetry = telemetry_zeros(y.shape[0], y.device)._replace(
            focus_score=api.focus_score(y),
            brightness_score=api.brightness_score(y))
        return scanner_add_frame(params, states, card, True,
                                 telemetry=telemetry, frame_gate=gate)

    def full(states, y, cb, cr):
        found, card = api.preprocess_frame(y, cb, cr,
                                           ORIENTATION_LANDSCAPE_RIGHT)
        return scan(states, y, card, found)

    def no_detect(states, y, cb, cr):
        corners = _static_quad(y.device).expand(y.shape[0], 4, 2)
        gate = torch.ones(y.shape[0], dtype=torch.bool, device=y.device)
        return scan(states, y, unwarp_card(y, corners), gate)

    def no_warp(states, y, cb, cr):
        _, corners = api.detect_edges(y, cb, cr, ORIENTATION_LANDSCAPE_RIGHT)
        top, left = CROP
        card = y[:, top:top + CARD_HEIGHT, left:left + CARD_WIDTH]
        return scan(states, y, card, corners.found_all)

    return {"full": full, "no_detect": no_detect, "no_warp": no_warp}


def scan_form(params, scan_expiry):
    """step(states, frames) -> (states, (FrameResult, ScannerResult)): the
    batched scanner step."""
    from ..parallel.streams import batched_scanner_step

    def step(states, frames):
        return batched_scanner_step(params, states, frames,
                                    scan_expiry=scan_expiry)
    return step


def main(argv=None):
    """Time the four forms; prints a line each and the marginals, and
    returns {stage: ms}."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device
    from ..parallel.streams import init_stream_states

    args = parse_args(argv)
    device = named_device(args.device, "profile_camera_ablate")
    s = args.streams
    params = load_all_params(device)
    rng = np.random.RandomState(0)
    planes = camera_inputs(rng, s, device)
    frames = noise(rng, device, s, 270, 428)
    forms = camera_forms(params)
    steps = ((forms["full"], planes), (forms["no_detect"], planes),
             (forms["no_warp"], planes), (scan_form(params, True), (frames,)))
    print(f"# streams={s} device={device_label(device)} iters={args.iters} "
          f"{TIMING}")
    times = {}
    for name, (step, inputs) in zip(STAGES, steps):
        carried = init_stream_states(s, device, (2026, 1))

        def advance(step=step, inputs=inputs, carried=carried):
            new = step(carried, *inputs)[0]
            for old, leaf in zip(tree_flatten(carried)[0],
                                 tree_flatten(new)[0]):
                old.copy_(leaf)
        times[name] = event_ms(advance, device, args.iters, warmup=1)
        print(stage_line(name, times[name], device, s), flush=True)
    full, nd, nw, so = (times[k] for k in STAGES)
    print(f"\nmarginal detect ~{full - nd:.3f} ms, marginal warp "
          f"~{full - nw:.3f} ms, camera-side total ~{full - so:.3f} ms")
    return times


if __name__ == "__main__":
    main()
