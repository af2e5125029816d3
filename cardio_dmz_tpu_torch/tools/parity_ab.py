"""Large-sweep A/B parity of the port against the COMPILED card.io C++.

Counterpart of the JAX package's tools/parity_ab.py, with the port in
place of JAX: the same flags, the same rng (default_rng(2026)) drawn in the
same order, the same counters and the same JSON keys. The compiled
reference is cardio_dmz_tpu_torch.refbridge (linked from the objects under
native/refshim/build/; it needs g++ and the system OpenCV).

* frames: rectified cards (the PIL-free renderer, bit for bit the JAX
  package's frames) through scan_card_image in batches of streams, the
  digit-prep kernel on the card, against ref_scan_card_image;
* PAN sessions: 10 frames each through HostScanner, against the
  reference's scanner;
* expiry sessions: 16 frames each through HostScanner (the host expiry
  read) and through the device full step (scanner_step, scan_expiry, all
  sessions as one batch of streams), in the CYTHON_DMZ date configuration
  the compiled reference is built in (past dates accepted);
* camera previews: a card pasted under a seeded perspective
  (synthetic.paste_card), detect_edges -> transform_card (the persp-QR
  and warp kernels), against dmz_detect_edges / dmz_transform_card, and
  each warped card's digits against the reference's; the float-warp
  counters rectify with ops/warp.warp_perspective in float. The sweep's
  previews are landscape right (FrameOrientation 3), as the JAX tool's;
  camera_cases cycles other orientations for the fixture. They are not
  the JAX tool's previews, which it pastes with its float
  warp_perspective: paste_card draws the same bits on any machine, as the
  fixture's SHA-256 needs, so the camera counters here and the JAX
  tool's (PARITY.md) come from other pixels of the same cards and
  quads.

The port's device functions (port_frames, port_expiry_windows,
device_sessions, port_camera, port_cards_from_corners, float_cards) run
their device work as CUDA graphs (parallel/graphed.graph_step), as the JAX
tool jits its: one graph a call and shape, the conversions to the host
made from a replay's results.

The case generators and the two sides are functions of their own:
tests/torch_fixture.py records the reference's answers to the first cases
(data/ref_session.npz) and chip_smoke.py replays them on the card.

Usage: python -m cardio_dmz_tpu_torch.tools.parity_ab [--frames 200]
       [--sessions 30] [--expiry-sessions 100] [--camera-frames 60]
       [--json] [--device cuda]
"""

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch

from .. import refbridge, synthetic
from ..api import detect_edges, transform_card
from ..config import ScanConfig
from ..models import load_all_params
from ..ops.warp import calc_persp_transform, warp_perspective
from ..parallel.graphed import graph_step
from ..parallel.mesh import named_device
from ..refbridge import (
    FrameRecord, corner_array, corner_points, frame_records,
    ref_frame_record)
from ..scan import scan_card_image
from ..session import HostScanner, scanner_reset
from ..session.state import scanner_step

NOW = (2026, 8)
CARD_SRC = [[0, 0], [427, 0], [0, 269], [427, 269]]
PREVIEW = (480, 640)
# the guide rect's corners in the card's corner order (the quad that card
# corners (0, 0), (427, 0), (0, 269), (427, 269) land on) a FrameOrientation
GUIDE_QUADS = {
    1: [[185, 454], [185, 26], [455, 454], [455, 26]],   # portrait
    2: [[455, 26], [455, 454], [185, 26], [185, 454]],   # portrait upside down
    3: [[106, 105], [534, 105], [106, 375], [534, 375]],  # landscape right
    4: [[534, 375], [106, 375], [534, 105], [106, 105]],  # landscape left
}
PAN_SESSION_FRAMES = 10
EXPIRY_SESSION_FRAMES = 16
SCAN_BATCH = 64


# ------------------------------------------------------------------ cases

def frame_cases(rng, n):
    """The frame sweep's n render parameters, drawn as the JAX tool draws
    them."""
    cases = []
    for i in range(n):
        length = 16 if i % 4 else 15
        prefix = (4,) if length == 16 else (3, 4)
        pan = synthetic.safe_pan(rng, length=length, prefix=prefix)
        y0 = int(rng.integers(140, 236))
        width = float(rng.uniform(17.3, 19.0))
        offset = int(rng.integers(25, 45))
        noise = int(rng.integers(0, 4))
        cases.append(dict(pan=pan, y0=y0, width=width, offset=offset,
                          noise=noise, seed=i,
                          style="emboss" if i % 3 else "flat"))
    return cases


def render_frame_case(case):
    return synthetic.render_frame(
        case["pan"], y0=case["y0"], width=case["width"],
        offset=case["offset"], seed=case["seed"], noise=case["noise"],
        style=case["style"])


def pan_session_cases(rng, n):
    """The PAN session sweep's n sessions: (pan, index)."""
    cases = []
    for s in range(n):
        length = 16 if s % 3 else 15
        prefix = (4,) if length == 16 else (3, 4)
        cases.append(dict(pan=synthetic.safe_pan(rng, length=length,
                                                 prefix=prefix), s=s))
    return cases


def render_pan_session(case):
    s = case["s"]
    return np.stack([synthetic.render_frame(
        case["pan"], y0=150 + (s % 5) * 4, seed=1000 * s + i, noise=1,
        style="emboss" if s % 3 else "flat")
        for i in range(PAN_SESSION_FRAMES)])


def expiry_session_cases(rng, n):
    """The expiry session sweep's n sessions: every eighth an out-of-window
    date (a rejection to agree on), every eighth from the fourth a past
    date, the rest in the window; randomized layout and noise."""
    cases = []
    for s in range(n):
        if s % 8 == 7:
            text = "%02d/%02d" % (rng.integers(1, 13), rng.integers(32, 40))
        elif s % 8 == 3:
            text = "%02d/%02d" % (rng.integers(1, 13), rng.integers(20, 26))
        else:
            text = "%02d/%02d" % (rng.integers(1, 13), rng.integers(27, 31))
        style = "flat" if s % 4 == 1 else "emboss"
        y0 = int(rng.integers(145, 205))
        ex = int(rng.integers(90, 170))
        ey = min(y0 + 27 + int(rng.integers(30, 46)), 240)
        spacing = int(rng.integers(12, 15))
        noise = int(rng.integers(0, 3))
        pan = synthetic.safe_pan(rng)
        cases.append(dict(text=text, pan=pan, y0=y0, ex=ex, ey=ey,
                          spacing=spacing, noise=noise, style=style, s=s))
    return cases


def sweep_expiry_case(session, n_frames=200, n_sessions=30,
                      n_expiry_sessions=100):
    """The expiry session case `session` of the sweep run at these sizes
    (the defaults'): the rng drawn as run() draws it."""
    rng = np.random.default_rng(2026)
    frame_cases(rng, n_frames)
    pan_session_cases(rng, n_sessions)
    return expiry_session_cases(rng, n_expiry_sessions)[session]


def render_expiry_session(case):
    return np.stack([synthetic.render_frame_with_expiry(
        case["pan"], case["text"], y0=case["y0"], expiry_y=case["ey"],
        expiry_x=case["ex"], expiry_spacing=case["spacing"],
        noise=case["noise"], style=case["style"],
        seed=7000 * case["s"] + i) for i in range(EXPIRY_SESSION_FRAMES)])


def camera_cases(rng, n, orientations=(3,)):
    """The camera sweep's n previews: a card, and the guide rect of its
    orientation (cycled over `orientations`) with each corner jittered by
    up to 6 px."""
    cases = []
    for i in range(n):
        pan = synthetic.safe_pan(rng)
        y0 = int(rng.integers(145, 230))
        offset = int(rng.integers(25, 42))
        noise = int(rng.integers(0, 3))
        orientation = orientations[i % len(orientations)]
        quad = np.float32(GUIDE_QUADS[orientation]) + rng.uniform(
            -6, 6, (4, 2)).astype(np.float32)
        cases.append(dict(pan=pan, y0=y0, offset=offset, noise=noise,
                          seed=9000 + i, quad=quad, orientation=orientation))
    return cases


def render_camera_case(case):
    """(y (480, 640), cb (240, 320)) u8: the card pasted under the case's
    quad on a background of 50, flat 128 chroma."""
    card = synthetic.render_frame(case["pan"], y0=case["y0"], width=18.5,
                                  offset=case["offset"], seed=case["seed"],
                                  noise=case["noise"])
    return (synthetic.paste_card(card, case["quad"], PREVIEW),
            np.full((PREVIEW[0] // 2, PREVIEW[1] // 2), 128, np.uint8))


# -------------------------------------------------------------- reference

def ref_frames(oracle, frames):
    """[FrameRecord] of ref_scan_card_image (PAN only) on each frame."""
    return [ref_frame_record(oracle.scan_card_image(y, scan_expiry=False))
            for y in frames]


def ref_session(oracle, frames, scan_expiry):
    """The reference scanner over one session: (its first PAN as a string
    or None, its first (month, year) with both set or None), read after
    every frame."""
    handle = oracle.scanner_create()
    pan = date = None
    try:
        for y in frames:
            oracle.scanner_add_frame(handle, y, scan_expiry=scan_expiry)
            r = oracle.scanner_result(handle)
            if pan is None and r:
                pan = "".join(map(str, r[0]))
            if date is None and r and r[1] and r[2]:
                date = (r[1], r[2])
    finally:
        oracle.scanner_destroy(handle)
    return pan, date


def ref_expiry_windows(oracle, frames):
    """The MM/YY groups ref_scan_card_image (with scan_expiry) finds on
    each frame: [[(top, left, char tops, char lefts)]], tuples of ints."""
    return [[(g.top, g.left, tuple(g.char_tops), tuple(g.char_lefts))
             for g in oracle.scan_card_image(y, scan_expiry=True)
             .expiry_groups] for y in frames]


def ref_camera(oracle, y, cb, orientation):
    """(found, corners (4, 2) f32 tl tr bl br, the card dmz_transform_card
    warps from them or None)."""
    ok, _, _, corners = oracle.detect_edges(y, cb, cb, orientation)
    corners = np.asarray(corners, np.float32)
    card = oracle.transform_card(y, corners, orientation) if ok else None
    return bool(ok), corners, card


# ------------------------------------------------------------------- port

def _frames_tensor(frames, device):
    return torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(
        device)


def port_frames(params, frames, device):
    """[FrameRecord] of the port's scan_card_image (PAN only) on (N, 270,
    428) frames, SCAN_BATCH streams a graphed call."""
    scan = graph_step(lambda y: scan_card_image(params, y), device)
    out = []
    for k in range(0, len(frames), SCAN_BATCH):
        out += frame_records(scan(_frames_tensor(frames[k:k + SCAN_BATCH],
                                                 device)))
    return out


def port_expiry_windows(params, frames, device):
    """The device expiry segmentation's MM/YY windows (scan_card_image with
    scan_expiry, the frames as one batch of streams, one graphed call) in
    ref_expiry_windows' form."""
    scan = graph_step(lambda y: scan_card_image(
        params, y, scan_expiry=True).expiry_groups, device)
    w = scan(_frames_tensor(frames, device))
    top, left, tops, lefts, valid = (
        x.cpu().numpy() for x in (w.top, w.left, w.char_tops, w.char_lefts,
                                  w.valid))
    return [[(int(top[t, k]), int(left[t, k]), tuple(tops[t, k].tolist()),
              tuple(lefts[t, k].tolist()))
             for k in range(valid.shape[1]) if valid[t, k]]
            for t in range(len(frames))]


def host_session(params, frames, scan_expiry):
    """HostScanner (on the device the params live on) over one session:
    (first PAN or None, first date or None), as ref_session reads them;
    the CYTHON_DMZ date configuration."""
    scanner = HostScanner(params, scan_expiry=scan_expiry, now=NOW,
                          allow_past_dates=True)
    pan = date = None
    for y in frames:
        scanner.add_frame(y)
        res = scanner.result()
        if pan is None and res.complete:
            pan = "".join(map(str, res.predictions[:res.n_numbers]))
        if date is None and res.complete and res.expiry_month:
            date = (res.expiry_month, res.expiry_year)
    return pan, date


def device_sessions(params, sessions, scan_expiry, device):
    """The device step (scanner_step, graphed) over (S, T, 270, 428)
    sessions, one stream a session: [(first PAN or None, first date or
    None)]; the CYTHON_DMZ date configuration."""
    config = ScanConfig(scan_expiry=scan_expiry,
                        expiry_allow_past_dates=True)

    def step(state, y):
        state, (_, res) = scanner_step(params, state, y, config=config)
        return state, res

    step = graph_step(step, device)
    n = len(sessions)
    state = scanner_reset(NOW, n, device)
    pans, dates = [None] * n, [None] * n
    for t in range(sessions.shape[1]):
        state, res = step(state, _frames_tensor(sessions[:, t], device))
        complete = res.complete.cpu().numpy()
        digits = res.predictions.cpu().numpy()
        n_num = res.n_numbers.cpu().numpy()
        month = res.expiry_month.cpu().numpy()
        year = res.expiry_year.cpu().numpy()
        for i in range(n):
            if pans[i] is None and complete[i]:
                pans[i] = "".join(map(str, digits[i, :n_num[i]]))
            if dates[i] is None and complete[i] and month[i]:
                dates[i] = (int(month[i]), int(year[i]))
    return list(zip(pans, dates))


def port_camera(y, cb, orientation, device):
    """detect_edges -> transform_card (the persp-QR and warp kernels), one
    graphed call, on (S, 480, 640) previews of one orientation: (found
    (S,), corners (S, 4, 2) tl tr bl br, cards (S, 270, 428) u8), numpy."""
    def camera(y, c):
        _, corners = detect_edges(y, c, c, orientation)
        return corners, transform_card(y, corners, orientation)

    corners, cards = graph_step(camera, device)(
        _frames_tensor(y, device), _frames_tensor(cb, device))
    found, pts = corner_array(corners)
    return found, pts, cards.cpu().numpy()


def port_cards_from_corners(y, corners, orientation, device):
    """transform_card of (S, 480, 640) previews from given (S, 4, 2)
    corners (tl tr bl br), one graphed call: the persp-QR and warp
    kernels. numpy."""
    card = graph_step(lambda y, c: transform_card(y, c, orientation), device)
    return card(_frames_tensor(y, device),
                corner_points(corners, device=device)).cpu().numpy()


def float_cards(y, corners, device):
    """The float route (ops/warp.warp_perspective, float bilinear), one
    graphed call, from (S, 4, 2) landscape-right corners tl tr bl br."""
    dst = torch.tensor(CARD_SRC, dtype=torch.float32, device=device)

    def warp(y, src):
        return warp_perspective(y, calc_persp_transform(
            src, dst.expand(len(src), 4, 2)), (270, 428), fixed_point=False)

    src = torch.as_tensor(np.asarray(corners, np.float32), device=device)
    return graph_step(warp, device)(_frames_tensor(y, device),
                                    src).cpu().numpy()


# ------------------------------------------------------------------ sweep

def _digit_counts(c, ours: FrameRecord, ref: FrameRecord, prefix):
    if ref.usable and ours.usable and \
            ours.hseg_n_offsets == ref.hseg_n_offsets:
        c[f"{prefix}digits"] += ref.hseg_n_offsets
        c[f"{prefix}digit_agree"] += sum(
            a == b for a, b in zip(ours.digits, ref.digits))


def run(oracle, params, device, n_frames=200, n_sessions=30,
        n_expiry_sessions=100, n_camera=60):
    """The sweep's counters (a Counter of the JAX tool's names)."""
    c = collections.Counter()
    rng = np.random.default_rng(2026)

    # per-frame PAN sweep
    cases = frame_cases(rng, n_frames)
    frames = np.stack([render_frame_case(k) for k in cases]) if cases \
        else np.zeros((0, 270, 428), np.uint8)
    for case, ref, ours in zip(cases, ref_frames(oracle, frames),
                               port_frames(params, frames, device)):
        c["frames"] += 1
        c["usable_agree"] += int(ref.usable == ours.usable)
        if not (ref.usable and ours.usable):
            continue
        c["usable_frames"] += 1
        c["vseg_agree"] += int(
            ours.vseg_y_offset == ref.vseg_y_offset
            and ours.vseg_pattern_type == ref.vseg_pattern_type)
        n = ours.hseg_n_offsets
        if n != ref.hseg_n_offsets:
            c["nlen_mismatch"] += 1
            continue
        hseg_same = ours.hseg_offsets == ref.hseg_offsets
        c["hseg_agree"] += int(hseg_same)
        truth = [int(d) for d in case["pan"]]
        agree = sum(a == b for a, b in zip(ours.digits, ref.digits))
        c["digits"] += n
        c["digit_agree"] += agree
        c["our_correct"] += sum(a == t for a, t in zip(ours.digits, truth))
        c["ref_correct"] += sum(b == t for b, t in zip(ref.digits, truth))
        if hseg_same:
            c["digits_same_hseg"] += n
            c["digit_agree_same_hseg"] += agree

    # session-level PAN sweep (host path)
    for case in pan_session_cases(rng, n_sessions):
        frames = render_pan_session(case)
        ref_pan, _ = ref_session(oracle, frames, scan_expiry=False)
        our_pan, _ = host_session(params, frames, scan_expiry=False)
        c["sessions"] += 1
        c["session_agree"] += int(ref_pan == our_pan)
        c["session_ref_correct"] += int(ref_pan == case["pan"])
        c["session_our_correct"] += int(our_pan == case["pan"])

    # session-level expiry sweep: the host read and the device step
    cases = expiry_session_cases(rng, n_expiry_sessions)
    sessions = [render_expiry_session(k) for k in cases]
    device_reads = device_sessions(params, np.stack(sessions), True,
                                   device) if sessions else []
    for case, frames, (_, dev_date) in zip(cases, sessions, device_reads):
        want = int(case["text"][:2]), 2000 + int(case["text"][3:])
        _, ref_date = ref_session(oracle, frames, scan_expiry=True)
        _, our_date = host_session(params, frames, scan_expiry=True)
        c["expiry_sessions"] += 1
        c["expiry_agree"] += int(ref_date == our_date)
        c["expiry_dev_agree"] += int(ref_date == dev_date)
        c["expiry_read_sessions"] += int(ref_date is not None)
        c["expiry_ref_correct"] += int(ref_date == want)
        c["expiry_our_correct"] += int(our_date == want)

    # camera-path sweep (detect + warp + scan), landscape right
    cases = camera_cases(rng, n_camera)
    if not cases:
        return c
    y, cb = map(np.stack, zip(*[render_camera_case(k) for k in cases]))
    found, corners, cards = port_camera(y, cb, 3, device)
    both, ref_cards = [], []
    for i in range(len(cases)):
        ok, ref_corners, ref_card = ref_camera(oracle, y[i], cb[i], 3)
        c["cam_frames"] += 1
        c["cam_found_agree"] += int(bool(found[i]) == ok)
        if not (ok and found[i]):
            continue
        c["cam_both_found"] += 1
        c["cam_corner_agree"] += int(
            np.abs(corners[i] - ref_corners).max() < 0.5)
        diff = np.abs(cards[i].astype(int) - ref_card.astype(int))
        c["cam_warp_close"] += int((diff <= 2).mean() > 0.99)
        c["cam_warp_exact"] += int((diff == 0).all())
        both.append(i)
        ref_cards.append(ref_card)
    if both:
        refs = ref_frames(oracle, ref_cards)
        for ref, ours in zip(refs, port_frames(params, cards[both], device)):
            _digit_counts(c, ours, ref, "cam_")
        floats = float_cards(y[both], corners[both], device)
        for ref, ours in zip(refs, port_frames(params, floats, device)):
            _digit_counts(c, ours, ref, "cam_float_")
    return c


def report(c):
    """The JAX tool's JSON report from the counters."""
    def pct(a, b):
        return round(100.0 * a / b, 2) if b else None

    return {
        "frames": c["frames"],
        "usable_agreement_pct": pct(c["usable_agree"], c["frames"]),
        "usable_frames": c["usable_frames"],
        "vseg_agreement_pct": pct(c["vseg_agree"], c["usable_frames"]),
        "hseg_exact_agreement_pct": pct(c["hseg_agree"], c["usable_frames"]),
        "digits_compared": c["digits"],
        "digit_agreement_pct": pct(c["digit_agree"], c["digits"]),
        "digit_agreement_given_same_hseg_pct": pct(
            c["digit_agree_same_hseg"], c["digits_same_hseg"]),
        "our_digit_accuracy_pct": pct(c["our_correct"], c["digits"]),
        "ref_digit_accuracy_pct": pct(c["ref_correct"], c["digits"]),
        "pan_sessions": c["sessions"],
        "session_pan_agreement_pct": pct(c["session_agree"], c["sessions"]),
        "session_our_accuracy_pct": pct(c["session_our_correct"],
                                        c["sessions"]),
        "session_ref_accuracy_pct": pct(c["session_ref_correct"],
                                        c["sessions"]),
        "expiry_sessions": c["expiry_sessions"],
        "expiry_date_agreement_pct": pct(c["expiry_agree"],
                                         c["expiry_sessions"]),
        "expiry_device_date_agreement_pct": pct(
            c["expiry_dev_agree"], c["expiry_sessions"]),
        "expiry_sessions_ref_read": c["expiry_read_sessions"],
        "expiry_our_accuracy_pct": pct(c["expiry_our_correct"],
                                       c["expiry_sessions"]),
        "expiry_ref_accuracy_pct": pct(c["expiry_ref_correct"],
                                       c["expiry_sessions"]),
        "camera_frames": c["cam_frames"],
        "camera_found_agreement_pct": pct(c["cam_found_agree"],
                                          c["cam_frames"]),
        "camera_corner_exact_pct": pct(c["cam_corner_agree"],
                                       c["cam_both_found"]),
        "camera_warp_close_pct": pct(c["cam_warp_close"],
                                     c["cam_both_found"]),
        "camera_warp_bit_exact_pct": pct(c["cam_warp_exact"],
                                         c["cam_both_found"]),
        "camera_digit_agreement_pct": pct(c["cam_digit_agree"],
                                          c["cam_digits"]),
        "camera_digit_agreement_float_warp_pct": pct(
            c["cam_float_digit_agree"], c["cam_float_digits"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--sessions", type=int, default=30)
    ap.add_argument("--expiry-sessions", type=int, default=100)
    ap.add_argument("--camera-frames", type=int, default=60)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the port runs on (default cuda; "
                         "raises when there is no card)")
    args = ap.parse_args(argv)

    device = named_device(args.device, "parity_ab")
    if not refbridge.available():
        raise SystemExit("parity_ab: the compiled reference cannot be "
                         "built: " + "; ".join(refbridge.missing()))
    oracle = refbridge.RefOracle.shared()
    t0 = time.perf_counter()
    counters = run(oracle, load_all_params(device), device, args.frames,
                   args.sessions, args.expiry_sessions, args.camera_frames)
    result = report(counters)
    print(json.dumps(result, indent=None if args.json else 2))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"parity_ab: {time.perf_counter() - t0:.3f} s on {device} "
          f"({name})", file=sys.stderr)
    return result


def cli(argv=None):
    """Console entry point: main's report, exit code 0."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
