"""Per-stage work accounting of the serving graphs (counts, no timing).

Counterpart of the JAX package's tools/stage_bytes.py: the camera step's
ablated forms of tools/profile_camera_ablate.py (full, detection ablated,
warp ablated) and the scanner step with and without the expiry read, on
the JAX tool's inputs (RandomState(0) noise previews, then noise cards);
each graph's FLOPs and bytes from one step counted by
tools/profiling.WorkCounter (the JAX tool reads XLA's cost analysis), and
the marginal work of each stage as a difference of two graphs. A count
depends on the shapes and on the kernels' data-dependent bytes only, so
it is the same on the CPU and on the card.

    python -m cardio_dmz_tpu_torch.tools.stage_bytes [--streams 256]

runs on the CUDA device; --device cpu counts on the CPU.
"""

import argparse
import json

import numpy as np

from .profile_camera import camera_inputs, noise
from .profile_camera_ablate import camera_forms, scan_form
from .profiling import count_step

GRAPHS = ("camera_full", "camera_no_detect", "camera_no_warp", "scan_full",
          "scan_pan")
# (graph, graph without the stage, label) of each marginal
MARGINALS = (("camera_full", "camera_no_detect", "detect (marginal)"),
             ("camera_full", "camera_no_warp", "warp (marginal)"),
             ("camera_full", "scan_full", "camera side (total)"),
             ("scan_full", "scan_pan", "expiry (marginal)"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda; raises when "
                         "there is no card)")
    return ap.parse_args(argv)


def build_graphs(params, streams, device):
    """{graph: (step, states, inputs)} of GRAPHS: step(states, *inputs) ->
    (states, outputs), on fresh states."""
    from ..parallel.streams import init_stream_states

    rng = np.random.RandomState(0)
    planes = camera_inputs(rng, streams, device)
    frames = (noise(rng, device, streams, 270, 428),)
    forms = camera_forms(params)
    steps = {"camera_full": (forms["full"], planes),
             "camera_no_detect": (forms["no_detect"], planes),
             "camera_no_warp": (forms["no_warp"], planes),
             "scan_full": (scan_form(params, True), frames),
             "scan_pan": (scan_form(params, False), frames)}
    return {name: (step, init_stream_states(streams, device, (2026, 1)),
                   inputs) for name, (step, inputs) in steps.items()}


def count_graphs(params, streams, device, names=GRAPHS):
    """{graph: WorkCounter.summary() of one step, with "min_bytes"}, each
    counted after one uncounted step (which builds the ops' device
    tables)."""
    rows = {}
    for name, (step, states, inputs) in build_graphs(
            params, streams, device).items():
        if name in names:
            states, _ = step(states, *inputs)
            counter, min_bytes = count_step(step, params, states, *inputs)
            rows[name] = {**counter.summary(), "min_bytes": min_bytes}
    return rows


def main(argv=None):
    """Count each graph; prints the table, the marginals and the JSON line,
    and returns {graph: {"gflops", "gb", "min_gb", "int_ops"}}."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import named_device

    args = parse_args(argv)
    device = named_device(args.device, "stage_bytes")
    s = args.streams
    rows = count_graphs(load_all_params(device), s, device)
    print(f"# streams={s} device={device}: bytes executed (every op's "
          f"inputs and outputs) and the minimum (inputs, states, parameters "
          f"once)")
    print(f"{'graph':<22}{'GFLOP/step':>12}{'GB/step':>10}{'MB/frame':>10}"
          f"{'min GB':>10}")
    for name, r in rows.items():
        print(f"{name:<22}{r['flops'] / 1e9:>12.2f}{r['bytes'] / 1e9:>10.2f}"
              f"{r['bytes'] / s / 1e6:>10.2f}{r['min_bytes'] / 1e9:>10.3f}")
    print("-- marginals --")
    for a, b, label in MARGINALS:
        dfl = rows[a]["flops"] - rows[b]["flops"]
        dby = rows[a]["bytes"] - rows[b]["bytes"]
        print(f"{label:<22}{dfl / 1e9:>12.2f}{dby / 1e9:>10.2f}"
              f"{dby / s / 1e6:>10.2f}")
    out = {k: {"gflops": r["flops"] / 1e9, "gb": r["bytes"] / 1e9,
               "min_gb": r["min_bytes"] / 1e9, "int_ops": r["int_ops"]}
           for k, r in rows.items()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
