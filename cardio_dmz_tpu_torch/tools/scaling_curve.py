"""Step time at a fixed global stream batch across split sizes.

Counterpart of the JAX package's tools/scaling_curve.py: the serving step
split over n devices (make_sharded_step, with the expiry read), and with
--camera the full camera step a shard (make_sharded_camera_step), timed at
a FIXED global batch for n in 1/2/4/8, with t_1 / t_n as the efficiency.

What this measures: with devices=None and one card, the n "devices" are n
copies of cuda:0 (as entry.dryrun_multichip takes them), so the shards run
one after another on one card. The total work is constant, and an ideal
split keeps the step time flat as n grows: the curve measures the
OVERHEAD that splitting adds (n launches of every kernel, smaller
batches, the gather of the results), which is what the JAX tool measures
on its virtual CPU mesh. It cannot show a parallel speedup, and nothing
here asserts an efficiency. Over n distinct cards the shards' kernels
overlap and the same curve reads the split's speedup.

Usage:
  python -m cardio_dmz_tpu_torch.tools.scaling_curve [--camera] [--json]
      [--devices cuda:0,cuda:1]
"""

import argparse
import json
import time

import numpy as np
import torch


def measure(step, states, inputs, iters, warmup=2):
    """Seconds a step(states, *inputs), host clock over `iters` steps
    after `warmup`, each run ending in a synchronize of the shards'
    devices; inputs: lists of shards."""
    from .bench import synchronize
    devices = {shard.device for shards in inputs for shard in shards}
    for _ in range(warmup):
        states, _ = step(states, *inputs)
    for device in devices:
        synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        states, _ = step(states, *inputs)
    for device in devices:
        synchronize(device)
    return (time.perf_counter() - t0) / iters


def run(global_batch=32, iters=8, camera=False, sizes=(1, 2, 4, 8),
        devices=None):
    """{n: {"scan_step_ms", "efficiency_vs_1dev"[, "camera_step_ms",
    "camera_efficiency_vs_1dev"]}} for each n of `sizes` that the devices
    cover; the splits use the first n of them. devices: a list (a device
    may repeat); None takes parallel.mesh.card_devices, which raises
    without a card."""
    from ..models.weights import load_all_params
    from ..parallel.mesh import as_device, card_devices
    from ..parallel.streams import make_sharded_camera_step, make_sharded_step

    devices = card_devices(max(sizes), "scaling_curve") if devices is None \
        else [as_device(d) for d in devices]
    params = load_all_params(devices[0])
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (global_batch, 270, 428)).astype(np.uint8))
    now = time.localtime()[:2]

    results = {}
    sizes = [n for n in sizes if n <= len(devices)]
    for n in sizes:
        step, place, init = make_sharded_step(params, devices[:n],
                                              scan_expiry=True)
        t = measure(step, init(global_batch, now), (place(frames),), iters)
        results[n] = {"scan_step_ms": round(t * 1000, 2)}

        if camera:
            cam, place, init = make_sharded_camera_step(
                params, devices[:n], scan_expiry=True)
            planes = [torch.from_numpy(rng.randint(0, 256, shape).astype(
                np.uint8)) for shape in ((global_batch, 480, 640),
                                         (global_batch, 240, 320),
                                         (global_batch, 240, 320))]
            tc = measure(cam, init(global_batch, now),
                         tuple(place(x) for x in planes),
                         max(iters // 2, 2))
            results[n]["camera_step_ms"] = round(tc * 1000, 2)

    t1 = results[sizes[0]]["scan_step_ms"]
    for n in sizes:
        results[n]["efficiency_vs_1dev"] = round(
            t1 / results[n]["scan_step_ms"], 3)
    if camera:
        tc1 = results[sizes[0]]["camera_step_ms"]
        for n in sizes:
            results[n]["camera_efficiency_vs_1dev"] = round(
                tc1 / results[n]["camera_step_ms"], 3)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--camera", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices (a device may repeat); "
                         "default: copies of cuda:0, or the cards")
    args = ap.parse_args(argv)
    devices = args.devices.split(",") if args.devices else None
    results = run(args.global_batch, args.iters, args.camera,
                  devices=devices)
    print(json.dumps(results, indent=None if args.json else 2))
    return results


if __name__ == "__main__":
    main()
