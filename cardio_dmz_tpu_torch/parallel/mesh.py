"""The device list and the split of the stream axis over it.

Counterpart of the JAX package's parallel/mesh.py. There a Mesh with a
"data" and a "model" axis and a NamedSharding let XLA partition one graph;
here the scale axis is the same batch of concurrent camera streams, and
the split is explicit: a stream-major tensor (or NamedTuple of tensors) is
cut into one shard a device along its leading axis, each device steps its
shard, and the results are concatenated stream-major again. Parameters are
tiny and copied to every device. The "model" axis is kept for training's
tensor-parallel layers; serving uses the first device of each model group.
"""

import typing

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh(typing.NamedTuple):
    """devices[i][j]: data-parallel group i, model-parallel rank j."""
    devices: tuple

    @property
    def shape(self):
        return {DATA_AXIS: len(self.devices),
                MODEL_AXIS: len(self.devices[0])}

    @property
    def data_devices(self):
        """The device that serves each data-parallel group's shard."""
        return [row[0] for row in self.devices]


def as_device(device):
    """A torch.device with its index filled in, so that "cuda", "cuda:0"
    and torch.device("cuda", 0) name one entry of the per-device tables
    the ops cache (functools.lru_cache keyed by device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def require_cuda(what):
    """The current CUDA device, for an entry point whose default is the
    card; RuntimeError naming `what` when there is none: the port never
    falls back to the CPU unless it is named."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; name the device(s) to "
                           f"use, for example 'cpu'")
    return as_device("cuda")


def named_device(device, what):
    """`device` as a torch.device; None names the card. A CUDA device
    without a card raises (naming `what`): an entry point whose default is
    the card never falls back to the CPU unless "cpu" is named."""
    if device is None or torch.device(device).type == "cuda":
        require_cuda(what)
    return as_device("cuda" if device is None else device)


def card_devices(n, what):
    """The default devices of a tool that splits over n devices: n copies
    of cuda:0 on a machine with one card (their shards then run one after
    another), else its first min(n, count) cards. Raises, naming `what`,
    when there is no card."""
    first = require_cuda(what)
    count = torch.cuda.device_count()
    if count == 1:
        return [first] * n
    return [torch.device("cuda", i) for i in range(min(count, n))]


def make_mesh(devices=None, model_parallel=1) -> Mesh:
    """A (data, model) mesh over `devices`; every CUDA device when None
    (there is no CPU default: name "cpu" to get it). model_parallel=1 is
    pure data parallelism, the right shape for stream serving: the models
    are far too small to shard. A device may be named more than once; its
    shards then run one after another on it."""
    if devices is None:
        require_cuda("make_mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [as_device(d) for d in devices]
    n = len(devices)
    if n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices do not split into model-parallel "
                         f"groups of {model_parallel}")
    return Mesh(tuple(tuple(devices[i:i + model_parallel])
                      for i in range(0, n, model_parallel)))


def data_devices(mesh):
    """The serving devices of a Mesh, or of a plain list of devices."""
    if isinstance(mesh, Mesh):
        return mesh.data_devices
    return [as_device(d) for d in mesh]


def split_sizes(n_streams, n_shards):
    """Streams a shard, as even as they go: the first n_streams % n_shards
    shards hold one more."""
    base, extra = divmod(n_streams, n_shards)
    return [base + (i < extra) for i in range(n_shards)]


def _map(fn, tree):
    """fn applied to every leaf of a tree of (nested) tuples, NamedTuples
    and dicts, the tree's structure kept."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        mapped = [_map(fn, x) for x in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") \
            else tuple(mapped)
    return fn(tree)


def shard_streams(mesh, batch, sizes=None):
    """Cut a stream-major tensor, or (nested) NamedTuple of tensors, into
    one shard a device along the leading axis and copy each shard to its
    device (non_blocking: a pinned host batch uploads while the host goes
    on). sizes: streams a shard; as even as they go when None. Returns the
    list of shards."""
    devices = data_devices(mesh)
    leaf = batch
    while isinstance(leaf, tuple):
        leaf = leaf[0]
    n = leaf.shape[0]
    sizes = list(sizes) if sizes is not None else split_sizes(n, len(devices))
    if len(sizes) != len(devices) or sum(sizes) != n:
        raise ValueError(f"shard sizes {sizes} do not cover {n} streams over "
                         f"{len(devices)} devices")
    shards, start = [], 0
    for device, size in zip(devices, sizes):
        part = slice(start, start + size)
        shards.append(_map(lambda t: t[part].to(device, non_blocking=True),
                           batch))
        start += size
    return shards


def gather_streams(shards, device=None):
    """The inverse of shard_streams: the shards concatenated stream-major
    on `device` (the first shard's when None)."""
    first = shards[0]
    if isinstance(first, tuple):
        parts = [gather_streams(list(field), device)
                 for field in zip(*shards)]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    device = first.device if device is None else as_device(device)
    return torch.cat([s.to(device) for s in shards], dim=0)
