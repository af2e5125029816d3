"""Session-level accepted-read correctness sweep (the >=99.5% gate).

Counterpart of the JAX package's tools/accuracy_sweep.py. Runs hundreds
of randomized synthetic card sessions (PAN, geometry, photometrics varied)
through the batched scan pipeline, on rectified cards or (--camera) on
480x640 previews through the camera path, and reports:

* acceptance rate: sessions whose PAN completes within the frame budget;
* accepted-read correctness: of the accepted reads, how many equal the
  true PAN (the scanner's contract: the Luhn + stability + frame-lead
  gates make a WRONG accepted read far rarer than a non-read).

The sessions are drawn as the JAX tool draws them (np.random.default_rng
(seed), the same renderer without PIL), so the rectified sweep's frames
are the JAX package's bit for bit. The camera sweep places each card in
its previews with the float warp (ops/warp.warp_perspective), whose
pixels differ from the JAX package's in a few 1/32 coordinate bins.

The JAX tool jits three functions, and the port runs each as a CUDA graph
(parallel/graphed.graph_step, one key each: the last batch is padded as
the JAX tool pads it): the placement warp over a warp batch, the
rectified session scan with the parameters and the date closed over, and
the camera step.

Usage: python -m cardio_dmz_tpu_torch.tools.accuracy_sweep [--sessions 512]
       [--camera] [--device cuda]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..parallel.graphed import graph_step

CARD_SRC = [[0, 0], [427, 0], [0, 269], [427, 269]]
GUIDE_QUAD = [[106, 105], [534, 105], [106, 375], [534, 375]]


def render_sessions(rng, n_sessions, frames_per_session):
    """(frames (S, T, 270, 428) u8, pans): randomized rectified sessions,
    frame t of session s seeded 997 * s + t."""
    from .. import synthetic

    frames = np.zeros((n_sessions, frames_per_session, 270, 428), np.uint8)
    pans = []
    for s in range(n_sessions):
        length = 16 if s % 4 else 15
        prefix = (4,) if length == 16 else (3, 4)
        pan = synthetic.safe_pan(rng, length=length, prefix=prefix)
        y0 = int(rng.integers(140, 232))
        width = float(rng.uniform(17.5, 19.3))
        offset = int(rng.integers(25, 45))
        noise = int(rng.integers(0, 4))
        brightness = int(rng.integers(-25, 26))
        contrast = float(rng.uniform(0.85, 1.15))
        shading = int(rng.integers(0, 30))
        for t in range(frames_per_session):
            frames[s, t] = synthetic.render_frame(
                pan, y0=y0, width=width, offset=offset, seed=997 * s + t,
                noise=noise, brightness=brightness, contrast=contrast,
                shading=shading)
        pans.append(pan)
    return frames, pans


def _pad(x, n):
    """x with its first element repeated up to n along axis 0."""
    return np.concatenate([x, np.repeat(x[:1], n - len(x), 0)])


def render_camera_sessions(rng, n_sessions, frames_per_session, warp_batch,
                           device=None):
    """(previews (S, T, 480, 640) u8, pans): each session's card placed
    under per-frame jittered perspective quads around the guide rect, on
    a background of 50, warped on `device` (the card when None) in
    batches of warp_batch, the last one padded as the JAX tool pads it,
    by one graphed step: the homography, the float warp and the
    background."""
    from .. import synthetic
    from ..ops.warp import calc_persp_transform, warp_perspective
    from ..parallel.mesh import named_device

    device = named_device(device, "accuracy_sweep")
    S, T = n_sessions, frames_per_session
    cards = np.zeros((S, 270, 428), np.uint8)
    pans = []
    quads = np.zeros((S, T, 4, 2), np.float32)
    base = np.float32(GUIDE_QUAD)
    for s in range(S):
        length = 16 if s % 4 else 15
        prefix = (4,) if length == 16 else (3, 4)
        pan = synthetic.safe_pan(rng, length=length, prefix=prefix)
        cards[s] = synthetic.render_frame(
            pan, y0=int(rng.integers(145, 230)), width=18.5,
            offset=int(rng.integers(25, 42)), seed=7700 * s,
            noise=int(rng.integers(0, 3)),
            brightness=int(rng.integers(-20, 21)))
        pans.append(pan)
        jit = rng.uniform(-6, 6, (4, 2)).astype(np.float32)  # per session
        for t in range(T):
            quads[s, t] = base + jit + \
                rng.uniform(-1.5, 1.5, (4, 2)).astype(np.float32)

    src = torch.tensor(CARD_SRC, dtype=torch.float32, device=device)

    def place(card, quad):
        warped = warp_perspective(card, calc_persp_transform(src, quad),
                                  (480, 640))
        return torch.where(warped > 0, warped, 50)

    place = graph_step(place, device)
    flat_cards = np.repeat(cards[:, None], T, axis=1).reshape(S * T, 270, 428)
    flat_quads = quads.reshape(S * T, 4, 2)
    ys = np.zeros((S * T, 480, 640), np.uint8)
    for i in range(0, S * T, warp_batch):
        j = min(i + warp_batch, S * T)
        placed = place(
            torch.from_numpy(_pad(flat_cards[i:j], warp_batch)).to(device),
            torch.from_numpy(_pad(flat_quads[i:j], warp_batch)).to(device))
        ys[i:j] = placed[:j - i].cpu().numpy()
    return ys.reshape(S, T, 480, 640), pans


def _reads(states, n):
    """The first n streams' accepted reads: the completed digits as a
    string, None where the number did not complete."""
    complete = states.number_complete[:n].cpu().numpy()
    digits = states.completed_digits[:n].cpu().numpy()
    n_num = states.completed_n[:n].cpu().numpy()
    return ["".join(map(str, digits[i][:n_num[i]])) if complete[i] else None
            for i in range(n)]


def _progress(label, done, n_sessions, pans, reads, quiet):
    if not quiet:
        accepted = [p for p, r in zip(pans, reads) if r is not None]
        correct = sum(p == r for p, r in zip(pans, reads))
        print(f"# {label}{done}/{n_sessions} accepted={len(accepted)} "
              f"correct={correct}", file=sys.stderr)


def report(pans, reads, frames_per_session):
    """The JAX tool's report of sessions with true `pans` and accepted
    `reads` (None: not accepted)."""
    accepted = [(p, r) for p, r in zip(pans, reads) if r is not None]
    wrong = [(p, r) for p, r in accepted if r != p]
    return {
        "sessions": len(pans),
        "frames_per_session": frames_per_session,
        "accepted": len(accepted),
        "acceptance_rate_pct": round(100.0 * len(accepted) / len(pans), 2),
        "accepted_correct_pct": (
            round(100.0 * (len(accepted) - len(wrong)) / len(accepted), 3)
            if accepted else None),
        "wrong_reads": wrong[:10],
    }


def sweep_reads(n_sessions=512, frames_per_session=8, batch=64, seed=2026,
                quiet=False, device=None):
    """(pans, reads) of run_sweep's sessions, session for session: each
    batch's sessions scanned by one graphed call of batched_scan_frames
    (its final states)."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device
    from ..parallel.streams import batched_scan_frames

    device = named_device(device, "accuracy_sweep")
    params = load_all_params(device)
    rng = np.random.default_rng(seed)
    now = time.localtime()[:2]
    run = graph_step(lambda fr: batched_scan_frames(params, fr, now)[0],
                     device)
    pans, reads = [], []
    while len(pans) < n_sessions:
        n = min(batch, n_sessions - len(pans))
        frames, batch_pans = render_sessions(rng, n, frames_per_session)
        if n < batch:  # the JAX tool pads to its compiled batch shape
            frames = _pad(frames, batch)
        states = run(torch.from_numpy(frames).to(device))
        pans += batch_pans
        reads += _reads(states, n)
        _progress("", len(pans), n_sessions, pans, reads, quiet)
    return pans, reads


def camera_sweep_reads(n_sessions=128, frames_per_session=8, batch=32,
                       seed=2026, quiet=False, device=None):
    """(pans, reads) of run_camera_sweep's sessions, session for session:
    each frame of a batch one graphed camera step (its states)."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device
    from ..parallel.streams import batched_camera_step, init_stream_states

    device = named_device(device, "accuracy_sweep")
    params = load_all_params(device)
    rng = np.random.default_rng(seed)
    now = time.localtime()[:2]
    cbcr = torch.full((batch, 240, 320), 128, dtype=torch.uint8,
                      device=device)
    step = graph_step(lambda st, y, cb, cr: batched_camera_step(
        params, st, y, cb, cr, scan_expiry=False)[0], device)
    pans, reads = [], []
    while len(pans) < n_sessions:
        n = min(batch, n_sessions - len(pans))
        ys, batch_pans = render_camera_sessions(rng, n, frames_per_session,
                                                warp_batch=batch,
                                                device=device)
        if n < batch:
            ys = _pad(ys, batch)
        ys = torch.from_numpy(ys).to(device)
        states = init_stream_states(batch, device, now)
        for t in range(frames_per_session):
            states = step(states, ys[:, t], cbcr, cbcr)
        pans += batch_pans
        reads += _reads(states, n)
        _progress("camera ", len(pans), n_sessions, pans, reads, quiet)
    return pans, reads


def run_sweep(n_sessions=512, frames_per_session=8, batch=64, seed=2026,
              quiet=False, device=None):
    """Rectified sessions through batched_scan_frames (PAN only) in
    batches of `batch`; the report."""
    pans, reads = sweep_reads(n_sessions, frames_per_session, batch, seed,
                              quiet, device)
    return report(pans, reads, frames_per_session)


def run_camera_sweep(n_sessions=128, frames_per_session=8, batch=32,
                     seed=2026, quiet=False, device=None):
    """End-to-end camera-path version of run_sweep: 480x640 preview frames
    through detect -> exact warp -> scan (batched_camera_step, PAN only)
    with randomized perspective + photometrics; the report."""
    pans, reads = camera_sweep_reads(n_sessions, frames_per_session, batch,
                                     seed, quiet, device)
    return {"mode": "camera", **report(pans, reads, frames_per_session)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--camera", action="store_true",
                    help="end-to-end camera path (480x640 preview frames "
                         "with randomized perspective)")
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    args = ap.parse_args(argv)
    sweep = run_camera_sweep if args.camera else run_sweep
    result = sweep(args.sessions, args.frames, args.batch, args.seed,
                   device=args.device)
    print(json.dumps(result, indent=2))
    return result


def cli(argv=None):
    """Console entry point: main's report, exit code 0."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
