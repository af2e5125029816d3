"""Stage-level profile of the card warp.

Counterpart of the JAX package's tools/profile_warp.py, on its inputs
(RandomState(0) noise frames, the guide rect's corners moved by up to 10
px a stream), each stage timed alone at `--streams` by
tools/profiling.event_ms, as replays of its CUDA graph:

* qr     - persp QR alone (the homographies of the quads)
* coords - persp QR and the float64 coordinate maps of the warp's plain
           route (ops/persp.warp_coord_maps; the kernel computes them
           itself)
* kernel - the warp kernel alone, frames to cards, on the homography of
           the guide rect computed once
* full   - unwarp_card, the exact route: persp QR, then the kernel
* gather - unwarp_card(method="gather"), the float warp of the accuracy
           sweep's previews (ops/warp.warp_perspective)

The JAX tool's "bands" and "dense" stages time TPU lowerings (the warp's
source windows, _band_base, and warp_perspective_dense) that the port
does not have; they are left out.

    python -m cardio_dmz_tpu_torch.tools.profile_warp [--streams 64]
        [--stage qr,coords,kernel,full,gather]

runs on the CUDA device; --device cpu times on the CPU's host clock.
"""

import argparse

import numpy as np
import torch

from .profiling import TIMING, clock_name, device_label, event_ms

STAGES = ("qr", "coords", "kernel", "full", "gather")
GUIDE = [[106, 105], [534, 105], [106, 375], [534, 375]]
CARD_DEST = [[0.0, 0.0], [427.0, 0.0], [0.0, 269.0], [427.0, 269.0]]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--stage", default="all",
                    help="comma list of " + ",".join(STAGES))
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    return ap.parse_args(argv)


def stages(streams, device):
    """{stage: fn} of STAGES."""
    from ..ops.persp import eigen_persp_transform, warp_coord_maps
    from ..ops.warp import unwarp_card, warp_perspective_exact

    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(
        0, 256, (streams, 480, 640)).astype(np.uint8)).to(device)
    srcs = torch.from_numpy(
        (np.float32(GUIDE)[None] + rng.uniform(-10, 10, (streams, 4, 2))
         ).astype(np.float32)).to(device)
    dest = torch.tensor(CARD_DEST, dtype=torch.float32, device=device)
    fixed = eigen_persp_transform(
        torch.tensor(GUIDE, dtype=torch.float32, device=device).expand(
            streams, 4, 2), dest)

    def coords():
        return warp_coord_maps(eigen_persp_transform(srcs, dest), (270, 428))

    return dict(zip(STAGES, (
        lambda: eigen_persp_transform(srcs, dest),
        coords,
        lambda: warp_perspective_exact(imgs, fixed, (270, 428)),
        lambda: unwarp_card(imgs, srcs),
        lambda: unwarp_card(imgs, srcs, method="gather"))))


def main(argv=None):
    """Time each stage; prints a line a stage and returns {stage: ms}."""
    from ..parallel.mesh import named_device

    args = parse_args(argv)
    device = named_device(args.device, "profile_warp")
    wanted = STAGES if args.stage == "all" else tuple(args.stage.split(","))
    unknown = set(wanted) - set(STAGES)
    if unknown:
        raise SystemExit(f"unknown stage(s) {sorted(unknown)}; the stages "
                         f"are {STAGES}")
    fns = stages(args.streams, device)
    print(f"# device={device_label(device)} streams={args.streams} "
          f"iters={args.iters} {TIMING}")
    times = {}
    for name in wanted:
        times[name] = event_ms(fns[name], device, args.iters)
        print(f"{name:8s} step {times[name]:9.3f} ms @ {args.streams} "
              f"streams  [{clock_name(device)}]", flush=True)
    return times


if __name__ == "__main__":
    main()
