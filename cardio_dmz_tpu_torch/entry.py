"""The port's entry hooks: the scan on one device, and a dry run of the
training, serving and camera steps over a device mesh.

Counterpart of the JAX package's __graft_entry__.py. Both run on the CUDA
device unless the caller names another; with no CUDA device and none
named they raise, they never carry on on the CPU.

    python -m cardio_dmz_tpu_torch.entry [n_devices]

runs entry()'s function once and then dryrun_multichip(n_devices), 8 by
default (n_devices copies of cuda:0 on a machine with one card).
"""

import sys
import time

import numpy as np
import torch

from .models import load_all_params
from .parallel import make_mesh, make_sharded_camera_step, make_sharded_step
from .parallel.mesh import card_devices, named_device
from .scan import scan_card_image
from .train import fit, init_pan_conv_params, pan_conv_loss


def entry(device=None):
    """(fn, example_args): the per-frame scan (vseg -> hseg -> digit
    ensemble -> gates) over a small batch of streams, on `device` (the
    CUDA device when None). fn(frames) -> (scores (S, 16, 10), usable (S,),
    vseg y_offset (S,)); example_args: 4 frames of seeded 270x428 noise on
    the device."""
    device = named_device(device, "entry")
    params = load_all_params(device)

    def fn(frames):
        res = scan_card_image(params, frames)
        return res.scores, res.usable, res.vseg.y_offset

    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (4, 270, 428)).astype(np.uint8)
    return fn, (torch.from_numpy(frames).to(device),)


def _mesh_devices(n_devices, devices):
    devices = card_devices(n_devices, "dryrun_multichip") \
        if devices is None else devices
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for a mesh of "
                         f"{n_devices}")
    return devices


def dryrun_multichip(n_devices, devices=None):
    """One step each, on tiny shapes, over a mesh of n_devices: training
    (one fit step of the PAN conv, the batch split over the data axis and,
    with n_devices even and >= 4, the hidden layer column-parallel over two
    model ranks; one CUDA graph when the mesh names one card n times),
    serving (make_sharded_step) and the full camera step
    (scan_expiry=True) on each data shard, each shard's step a graph. devices: the mesh's devices (a
    device may repeat); None takes the first n_devices CUDA devices, or
    n_devices copies of cuda:0 when there is one card. Returns a summary
    dict; raises if a step's output is wrong."""
    devices = _mesh_devices(n_devices, devices)
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(devices, model_parallel=model_parallel)
    home = mesh.devices[0][0]

    # --- training step: data parallel over the batch, model parallel
    # over the hidden layer ---
    rng = np.random.RandomState(0)
    params = init_pan_conv_params(torch.Generator().manual_seed(0), home)
    batch = n_devices * 2

    def data_iter():
        while True:
            cells = rng.rand(batch, 27, 19).astype(np.float32)
            labels = rng.randint(0, 10, batch).astype(np.int32)
            yield cells, labels

    _, losses = fit(pan_conv_loss, params, data_iter(), steps=1, mesh=mesh)
    if not np.isfinite(losses[0]):
        raise RuntimeError(f"dryrun_multichip: train loss {losses[0]}")

    # --- serving step: the stream batch split over the data axis ---
    serve_params = load_all_params(home)
    step, place, init = make_sharded_step(serve_params, mesh)
    n_streams = n_devices * 2
    now = time.localtime()[:2]
    states = init(n_streams, now)
    frames = place(torch.from_numpy(
        rng.randint(0, 256, (n_streams, 270, 428)).astype(np.uint8)))
    states, (_, results) = step(states, frames)
    if results.complete.shape != (n_streams,):
        raise RuntimeError(f"dryrun_multichip: serving results for "
                           f"{tuple(results.complete.shape)} streams")

    # --- the camera -> digits step with the expiry read, a shard each ---
    cam_step, cam_place, cam_init = make_sharded_camera_step(
        serve_params, mesh, scan_expiry=True)
    y = cam_place(torch.from_numpy(
        rng.randint(0, 256, (n_streams, 480, 640)).astype(np.uint8)))
    cb = cam_place(torch.from_numpy(
        rng.randint(0, 256, (n_streams, 240, 320)).astype(np.uint8)))
    _, (_, _, cam_results) = cam_step(cam_init(n_streams, now), y, cb, cb)
    if cam_results.complete.shape != (n_streams,):
        raise RuntimeError(f"dryrun_multichip: camera results for "
                           f"{tuple(cam_results.complete.shape)} streams")
    print(f"dryrun_multichip OK: mesh={mesh.shape}, train loss="
          f"{losses[0]:.3f}, streams={n_streams}, camera=ok")
    return {"mesh": mesh.shape, "train_loss": losses[0],
            "streams": n_streams}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(int(argv[0]) if argv else 8)


if __name__ == "__main__":
    main()
