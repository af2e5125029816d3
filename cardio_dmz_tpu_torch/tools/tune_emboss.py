"""Tune the embossed-glyph renderer against the COMPILED card.io C++.

Counterpart of the JAX package's tools/tune_emboss.py: a grid search of
the relief parameters of synthetic.py's style="emboss" renderer (the
vertical and horizontal relief amplitudes and the face tint), each combo
scored by how often the compiled reference's session reader
(cardio_dmz_tpu_torch.refbridge) reads randomized expiry dates at
randomized layouts (or, with --pan, the PAN). The parameters go to the
renderer as arguments (relief=(av, ah, tint)); nothing is patched. The
expiry font size (--fsize) takes only the sizes whose glyphs
data/expiry_glyphs.npz holds (synthetic.EXPIRY_FONT_SIZES). Every read is
the reference's, on the host; --device names the device the scoring runs
beside (default cuda, as every tool of the port), and nothing else of the
port runs there.

Usage: python -m cardio_dmz_tpu_torch.tools.tune_emboss [--sessions 12]
       [--av 40,55,70] [--ah 30,45,60] [--tint -25,-10,0] [--fsize 18]
       [--pan] [--device cuda]
"""

import argparse
import itertools
import sys

import numpy as np

from .. import synthetic


def expiry_score(oracle, rng, sessions, relief, frames=10, style="emboss",
                 eymax=252):
    """(sessions the reference read a date in, of them read right)."""
    reads = correct = 0
    for s in range(sessions):
        text = "%02d/%02d" % (rng.integers(1, 13), rng.integers(27, 31))
        want = (int(text[:2]), 2000 + int(text[3:]))
        pan = synthetic.safe_pan(rng)
        y0 = int(rng.integers(145, 205))
        ex = int(rng.integers(90, 170))
        ey = min(y0 + 27 + int(rng.integers(30, 46)), eymax)
        sp = int(rng.integers(12, 15))
        handle = oracle.scanner_create()
        ref_date = None
        try:
            for i in range(frames):
                y = synthetic.render_frame_with_expiry(
                    pan, text, y0=y0, expiry_y=ey, expiry_x=ex,
                    expiry_spacing=sp, noise=1, seed=7000 * s + i,
                    style=style, relief=relief)
                oracle.scanner_add_frame(handle, y, scan_expiry=True)
                r = oracle.scanner_result(handle)
                if r and r[1] and r[2]:
                    ref_date = (r[1], r[2])
                    break
        finally:
            oracle.scanner_destroy(handle)
        reads += int(ref_date is not None)
        correct += int(ref_date == want)
    return reads, correct


def pan_score(oracle, rng, sessions, relief, frames=10, style="emboss"):
    """Sessions whose PAN the reference read right."""
    ok = 0
    for s in range(sessions):
        pan = synthetic.safe_pan(rng)
        handle = oracle.scanner_create()
        got = None
        try:
            for i in range(frames):
                y = synthetic.render_frame(
                    pan, y0=150 + (s % 5) * 4, seed=1000 * s + i, noise=1,
                    style=style, relief=relief)
                oracle.scanner_add_frame(handle, y, scan_expiry=False)
                r = oracle.scanner_result(handle)
                if r:
                    got = "".join(map(str, r[0]))
                    break
        finally:
            oracle.scanner_destroy(handle)
        ok += int(got == pan)
    return ok


def _ints(text):
    return [int(v) for v in text.split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=12)
    ap.add_argument("--av", default="40,55,70")
    ap.add_argument("--ah", default="30,45,60")
    ap.add_argument("--tint", default="-25,-10,0")
    ap.add_argument("--fsize", default="18")
    ap.add_argument("--pan", action="store_true",
                    help="score the PAN row instead of expiry")
    ap.add_argument("--style", default="emboss")
    ap.add_argument("--eymax", type=int, default=252)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the device of the run (default cuda; raises "
                         "when there is no card)")
    args = ap.parse_args(argv)

    from .. import refbridge
    from ..parallel.mesh import named_device

    named_device(args.device, "tune_emboss")
    sizes = _ints(args.fsize)
    unknown = sorted(set(sizes) - set(synthetic.EXPIRY_FONT_SIZES))
    if unknown:
        raise SystemExit(
            f"tune_emboss: no glyphs of expiry font size(s) {unknown} in "
            f"{synthetic.EXPIRY_GLYPHS}; it holds "
            f"{list(synthetic.EXPIRY_FONT_SIZES)}")
    if not refbridge.available():
        raise SystemExit("tune_emboss: the compiled reference cannot be "
                         "built: " + "; ".join(refbridge.missing()))
    oracle = refbridge.RefOracle.shared()

    best = None
    for av, ah, tint, fs in itertools.product(
            _ints(args.av), _ints(args.ah), _ints(args.tint), sizes):
        rng = np.random.default_rng(11)
        relief = (av, ah, tint)
        if args.pan:
            ok = pan_score(oracle, rng, args.sessions, relief,
                           frames=args.frames, style=args.style)
            print(f"av={av} ah={ah} tint={tint} fs={fs}: pan {ok}/"
                  f"{args.sessions}", flush=True)
            key = ok
        else:
            reads, correct = expiry_score(oracle, rng, args.sessions, relief,
                                          frames=args.frames,
                                          style=args.style, eymax=args.eymax)
            print(f"av={av} ah={ah} tint={tint} fs={fs}: reads {reads}/"
                  f"{args.sessions} correct {correct}", flush=True)
            key = (correct, reads)
        if best is None or key > best[0]:
            best = (key, (av, ah, tint, fs))
    print("BEST:", best)
    return best


def cli(argv=None):
    """Console entry point: main's search, exit code 0."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
