"""Multi-stream batched scanning: the serving step.

Many concurrent camera streams stepped together through the scan pipeline
and the session state machine. Every function of the port is already
stream-major, so the batched step is scanner_step over the stream axis;
the JAX package reaches the same shape with vmap. make_sharded_step and
make_sharded_camera_step split the stream axis over a list of devices
(parallel/mesh.py) and, as the JAX package jits its sharded step, run each
shard's step as a CUDA graph (parallel/graphed.py).
"""

import contextlib
import copy
import functools

import torch

from ..constants import ORIENTATION_LANDSCAPE_RIGHT
from ..session.state import (
    camera_scanner_step, scan_frames, scanner_reset, scanner_step)
from .graphed import graph_step
from .mesh import data_devices, gather_streams, shard_streams


def init_stream_states(n_streams, device, now):
    """Fresh ScannerStates for n_streams streams on `device`; now =
    (year, month)."""
    return scanner_reset(now, n_streams, device)


def batched_scanner_step(params, states, frames, scan_expiry=False,
                         config=None):
    """One step for every stream: the PAN scan, and with scan_expiry the
    expiry read too. frames: (S, 270, 428) uint8 on the states' device.
    config: a ScanConfig; it overrides scan_expiry. Returns (states,
    (FrameResult, ScannerResult)), all stream-major."""
    return scanner_step(params, states, frames, scan_expiry, config=config)


def batched_camera_step(params, states, y, cb, cr, scan_expiry=False,
                        orientation=ORIENTATION_LANDSCAPE_RIGHT, config=None,
                        iso_speed=None, shutter_speed=None, torch_is_on=None):
    """One camera -> digits step for every stream: edge detection, the
    exact homography and warp, and the scan of batched_scanner_step.
    y: (S, 480, 640) u8; cb/cr: (S, 240, 320) u8 half-size chroma, on the
    states' device. iso_speed, shutter_speed, torch_is_on: the cameras'
    metadata, (S,) tensors or None. Returns (states, (found, FrameResult,
    ScannerResult))."""
    return camera_scanner_step(params, states, y, cb, cr,
                               scan_expiry=scan_expiry, config=config,
                               orientation=orientation, iso_speed=iso_speed,
                               shutter_speed=shutter_speed,
                               torch_is_on=torch_is_on)


def batched_scan_frames(params, frames, now, scan_expiry=False):
    """Whole sessions for a (S, T, 270, 428) frame tensor, from fresh
    states on the frames' device: session.scan_frames, which is
    stream-major already. Returns (final_states, (FrameResults,
    ScannerResults)) with the per-frame results stacked as (S, T, ...)."""
    return scan_frames(params, frames, now, scan_expiry=scan_expiry)


def device_scope(device):
    """The context a shard's step runs in: its CUDA device made current
    (the kernel wrappers launch on the current stream of the current
    device), nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate_params(params, devices):
    """{device: params on it}: the modules as they are where they already
    live, a copy elsewhere. A device named twice shares one copy."""
    home = next(next(iter(params.values())).buffers()).device
    copies = {}
    for device in devices:
        if device in copies:
            continue
        copies[device] = params if home == device else {
            name: copy.deepcopy(module).to(device)
            for name, module in params.items()}
    return copies


def _sharded(params, mesh, sizes, step_one):
    """(step, place, init) of step_one(params, state, *inputs) with the
    stream axis split over `mesh`, each shard's step graphed on the
    shard's device; see make_sharded_step. step.shard_steps: the
    GraphedSteps, one a shard."""
    devices = data_devices(mesh)
    copies = replicate_params(params, devices)
    shard_steps = [graph_step(functools.partial(step_one, copies[device]),
                              device) for device in devices]

    def place(x):
        return shard_streams(devices, x, sizes)

    def init(n_streams, now):
        return place(init_stream_states(n_streams, devices[0], now))

    def step(states, *inputs):
        new_states, outputs = [], []
        for k, (device, state) in enumerate(zip(devices, states)):
            with device_scope(device):
                state, out = shard_steps[k](
                    state, *(shards[k] for shards in inputs))
            new_states.append(state)
            outputs.append(out)
        return new_states, gather_streams(outputs, devices[0])

    step.shard_steps = shard_steps
    return step, place, init


def make_sharded_step(params, mesh, scan_expiry=False, sizes=None):
    """batched_scanner_step with the stream axis split over `mesh` (a Mesh
    or a list of devices; a device may appear twice) and the parameters
    copied to each device. sizes: streams a shard (as even as they go when
    None). Returns (step, place, init), as the JAX package's:

    * place(x): a stream-major tensor or NamedTuple -> its list of shards,
      each on its device (non_blocking copies);
    * init(n_streams, now): place(fresh states);
    * step(states, frames), both lists of shards -> (states, (FrameResult,
      ScannerResult)): the states stay sharded, the results come back
      stream-major on the first device.

    Each shard's step is a CUDA graph on the shard's device
    (graphed.graph_step, the port's jax.jit), captured at its first call
    with a new shape and replayed after. The replays go out one after
    another from the calling thread; on distinct CUDA devices they
    overlap, since a replay does not wait for the device."""
    def step_one(shard_params, state, frames):
        return batched_scanner_step(shard_params, state, frames, scan_expiry)

    return _sharded(params, mesh, sizes, step_one)


def make_sharded_camera_step(params, mesh, scan_expiry=False, sizes=None):
    """batched_camera_step split over `mesh` as make_sharded_step splits
    the scanner step: a full camera step on each shard (the JAX package,
    too, has no sharded form of the camera step of its own: its callers
    jit the camera step over stream-sharded inputs), each shard's step a
    CUDA graph. Returns (step, place, init); step(states, y, cb, cr), each
    a list of shards -> (states,
    (found, FrameResult, ScannerResult)) with the outputs stream-major on
    the first device."""
    def step_one(shard_params, state, y, cb, cr):
        return batched_camera_step(shard_params, state, y, cb, cr,
                                   scan_expiry=scan_expiry)

    return _sharded(params, mesh, sizes, step_one)
