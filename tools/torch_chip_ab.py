"""Measure the PyTorch port of several checkouts on one NVIDIA card, in
turns, with this checkout's chip_smoke.py phases.

    python3 tools/torch_chip_ab.py [--out FILE] ROOT [ROOT ...]

Each ROOT is the root of a checkout: this repo, or a parent commit
unpacked with `git archive` into a directory that .gitignore lists. Give
them in the order to run, e.g. parent, change, change, parent. For each,
a fresh process imports cardio_dmz_tpu_torch from ROOT, builds ROOT's
kernels and measures, with chip_smoke.py's phases:
- each kernel alone (device time, chip_smoke.kernel_ms): digit prep on
  noise, real and all-equal strips (phase 3), persp QR beside
  torch.linalg.solve_ex, its chain floor and an empty launch (phase 7),
  the exact warp's public entry
  ops.warp_perspective_exact (coordinate maps included, wherever ROOT
  computes them), ROOT's warp kernel against its plain version (phase 8)
  where ROOT has the fused kernel, and its gather from precomputed maps
  alone where ROOT has that instead;
- pan-256 and camera-256 serving (phases 6 and 10), before the kernels:
  frames/s, step ms, peak memory, the stage split, the card-shaped
  float64/int32 tensors of one camera step and its profile;
- full-256 and camera-full-256 serving (phases 12 and 13: PAN + expiry),
  where ROOT's steps take scan_expiry.
Each ROOT's run ends in one line "AB {json}"; with --out FILE the json is
also appended to FILE, a line a run, for when the output is too long to
keep. Needs a card and nvcc.
"""

import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def warp_entry(cs, port, warp_gather, dev):
    """The exact warp at 256 noise frames through landscape envelope
    quads: the public entry's device time, and the old from-maps gather
    alone where ROOT has it."""
    import torch
    rng = np.random.RandomState(2)
    frames = torch.from_numpy(rng.randint(
        0, 256, (cs.N_STREAMS,) + cs.FRAME_SHAPE).astype(np.uint8)).to(dev)
    dst = torch.tensor(cs.CARD_DEST, dtype=torch.float32, device=dev)
    m = port.ops.eigen_persp_transform(
        cs._quads(cs.GUIDE_LANDSCAPE, rng, cs.N_STREAMS).to(dev), dst)
    out = {"entry_ms": cs.kernel_ms(lambda: port.ops.warp_perspective_exact(
        frames, m, cs.CARD_SHAPE))[0]}
    if hasattr(warp_gather, "warp_gather_exact"):
        xq, yq = port.ops.warp_coord_maps(m, cs.CARD_SHAPE)
        pixels = xq.numel()
        n_bytes = (cs.tapped_pixels(port, m, cs.FRAME_SHAPE) + 8 * pixels
                   + pixels)
        bound_ms, bound_by = cs.bound(n_bytes)
        out["gather_from_maps"] = {
            "ms": cs.kernel_ms(lambda: warp_gather.warp_gather_exact(
                frames, xq, yq))[0],
            "plain_ms": cs.kernel_ms(lambda: warp_gather.warp_gather_reference(
                frames, xq, yq))[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}
        out["maps_ms"] = cs.kernel_ms(lambda: port.ops.warp_coord_maps(
            m, cs.CARD_SHAPE))[0]
    return out


def measure(root, out_file=None):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import cardio_dmz_tpu_torch as port
    from cardio_dmz_tpu_torch.ops.cuda import digit_prep, persp_qr, warp_gather
    if not port.__file__.startswith(root):
        raise RuntimeError(f"imported {port.__file__}, not from {root}")
    cs = _load_chip_smoke()
    kernels = {"digit_prep": digit_prep, "warp_gather": warp_gather,
               "persp_qr": persp_qr}
    dev = torch.device("cuda", 0)
    card = cs.device_phase()
    cs.build_phase(kernels)
    fixture = cs.load_npz(cs.fixture_path(port, "smoke_session.npz"))
    camera = cs.load_npz(cs.fixture_path(port, "camera_session.npz"))
    # the serving steps first, so that no kernel timing's torch.profiler
    # fallback (the parent's plain digit prep cannot be graph-captured) is
    # active in the process before its steps are timed
    params = port.load_all_params(dev)
    out = {"root": root, "card": card,
           "pan": cs.serving_phase(port, kernels, params, fixture,
                                   cs.fixture_pans(fixture), card, dev),
           "camera": cs.camera_serving_phase(port, kernels, params, camera,
                                             cs.fixture_pans(camera), card,
                                             dev),
           "digit_prep": cs.kernel_phase(port, digit_prep, fixture, dev),
           "persp_qr": cs.persp_phase(persp_qr, dev),
           "persp_floors": cs.persp_floors(dev),
           "warp": warp_entry(cs, port, warp_gather, dev)}
    if "scan_expiry" in inspect.signature(
            port.batched_scanner_step).parameters:
        expiry = cs.load_npz(cs.fixture_path(port, "expiry_session.npz"))
        dates = cs.fixture_dates(expiry)
        out["full"] = cs.full_serving_phase(port, kernels, params, expiry,
                                            dates, card, dev)
        out["camera_full"] = cs.full_camera_serving_phase(
            port, kernels, params, expiry, dates, card, dev)
    if hasattr(warp_gather, "warp_perspective_reference"):
        out["warp"]["kernel"] = cs.warp_phase(port, warp_gather, dev)
    maps = out["camera"].pop("card_maps")
    out["camera"]["card_maps"] = {"count": len(maps),
                                  "ops": sorted(set(maps))}
    print("AB " + json.dumps(out), flush=True)
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "a") as f:
            f.write(json.dumps(out) + "\n")


def main(argv):
    out_file = None
    if len(argv) >= 2 and argv[0] == "--out":
        out_file, argv = os.path.abspath(argv[1]), argv[2:]
    if len(argv) >= 2 and argv[0] == "--one":
        measure(argv[1], out_file)
        return 0
    if not argv:
        sys.exit(__doc__)
    failed = 0
    for root in argv:
        print(f"=== {root}", flush=True)
        command = [sys.executable, os.path.abspath(__file__)]
        if out_file:
            command += ["--out", out_file]
        failed |= subprocess.run(command + ["--one", root]).returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
