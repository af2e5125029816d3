"""Bench matrix: every serving shape, one JSON line each.

Counterpart of the JAX package's tools/bench_matrix.py. Runs each shape
in its own process (python -m cardio_dmz_tpu_torch.tools.bench), one
after another, and prints one JSON line a shape, its bench line with
"shape" added, plus an optional combined file; exits 1 when a shape's
bench failed:

  full            256-stream rectified PAN+expiry (the bench's default)
  pan             256-stream rectified PAN-only
  camera          256-stream whole camera path (640x480 -> digits)
  latency         single-stream rectified p50 frame->digits latency
  camera_latency  single-stream camera-path p50 latency

The two rectified throughput shapes both print scan_pipeline_throughput
and the two camera ones camera_pipeline_throughput, as in the JAX
package: "shape" tells them apart.

Usage:
  python -m cardio_dmz_tpu_torch.tools.bench_matrix [--out results.json]
      [--shapes full,pan,...] [--iters N] [--device cuda]
"""

import argparse
import json
import os
import subprocess
import sys

# Latency shapes pin a high iteration count: a single-stream step is short
# and its host time spreads; throughput shapes are long enough already.
SHAPES = {
    "full": [],
    "pan": ["--no-expiry"],
    "camera": ["--camera"],
    "latency": ["--latency", "--iters", "200"],
    "camera_latency": ["--camera", "--latency", "--iters", "200"],
}
# the directory that holds the package, so that the child finds it from
# any working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    """Run the shapes; returns {shape: record}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the combined results to this JSON file")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma list of shapes to run")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--timeout", type=int, default=3600,
                    help="per-shape timeout in seconds")
    ap.add_argument("--device", default="cuda",
                    help="passed to each bench (default cuda)")
    args = ap.parse_args(argv)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    results = {}
    for shape in args.shapes.split(","):
        shape = shape.strip()
        cmd = [sys.executable, "-m", "cardio_dmz_tpu_torch.tools.bench",
               "--device", args.device] + SHAPES[shape]
        if args.iters:
            cmd += ["--iters", str(args.iters)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=args.timeout, env=env)
            line = [ln for ln in out.stdout.strip().splitlines()
                    if ln.startswith("{")]
            rec = json.loads(line[-1]) if line else {
                "error": (out.stderr or "no output")[-400:]}
            comment = [ln for ln in out.stderr.splitlines()
                       if ln.startswith("# device=")]
            if comment:
                print(comment[-1], file=sys.stderr)
        except subprocess.TimeoutExpired:
            rec = {"error": f"timeout after {args.timeout}s"}
        rec["shape"] = shape
        results[shape] = rec
        print(json.dumps(rec), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"# wrote {args.out}", file=sys.stderr)
    return results


def cli(argv=None):
    """Console entry point: 1 when a shape's record carries an error
    (its bench failed, printed no line or timed out), else 0."""
    return int(any("error" in rec for rec in main(argv).values()))


if __name__ == "__main__":
    sys.exit(cli())
