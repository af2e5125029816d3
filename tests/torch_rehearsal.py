"""A rehearsal on the CPU of what a CUDA graph's capture refuses, for the
port's graphed steps (parallel/graphed.graph_step).

On the card a capture fails on a host synchronisation and on a copy from
pageable host memory. The CPU has neither, so HostWork watches the aten
ops a call dispatches instead: an op that reads a value back to the host,
boolean-mask indexing, and a tensor with elements that no op of the call
made (one built from host data at every call: on the card a copy from
pageable memory), 0-d ones included; a value that fill_ reads as a
scalar is not a copy. refused(call) runs a call as
graph_step's warm-up does and returns what it found; recorded_steps lets
a tool run with its graph_step calls recorded, so that each step can be
rehearsed on the arguments the tool gave it. Imports no jax.
"""

import contextlib
import weakref
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops that read a value back to the host; _linalg_check_errors is the check
# torch.linalg.inv and solve run on their LU's info (inv_ex and solve_ex
# skip it)
SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "item",
            "is_nonzero", "equal", "_unique2", "unique_dim",
            "unique_consecutive", "repeat_interleave", "bincount", "histc",
            "_linalg_check_errors"}


def tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class HostWork(TorchDispatchMode):
    """Records what a CUDA graph cannot hold, as far as the CPU shows it:
    an op that reads a value back to the host, boolean-mask indexing, and
    a tensor, of any rank, with elements that no op of the call made (a
    tensor built from host data each call, which on the card is a copy
    from pageable memory). Tensors the call did not make but that outlive
    it (the arguments, the parameters, the tables the ops cache) are told
    apart by refused: they come back as the same objects at the next
    call."""

    def __init__(self):
        super().__init__()
        self.made, self.syncs, self.foreign = {}, [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        if name == "lift_fresh":
            # torch.tensor(data) / new_tensor: host data, foreign wherever
            # it goes next (its output is not recorded as made)
            return func(*args, **kwargs)
        # fill_ reads its value on the host, as a scalar (x[i] = 0 lifts
        # the 0 and fills with it): no copy from host memory
        inputs = tensors((args[:1] if name == "fill_" else args, kwargs))
        if name in SYNC_OPS or (name in ("index", "index_put") and any(
                t.dtype == torch.bool for t in tensors(args[1:]))):
            self.syncs.append(str(func))
        for t in inputs:
            ref = self.made.get(id(t))
            if ref is None or ref() is not t:
                self.foreign.append((str(func), t))
        out = func(*args, **kwargs)
        for t in tensors(out):
            self.made[id(t)] = weakref.ref(t)
        return out


def refused(call):
    """(syncs, fresh) of call(): the ops that read back to the host, and
    (op, shape) of every tensor built from host data in the call, after
    one call that builds the ops' tables (as graph_step's warm-up does).
    Both empty: nothing a capture would refuse."""
    call()
    runs = []
    for _ in range(2):
        with HostWork() as mode:
            call()
        runs.append(mode)
    outliving = {id(t) for _, t in runs[0].foreign}
    fresh = [(op, tuple(t.shape)) for op, t in runs[1].foreign
             if id(t) not in outliving]
    return runs[1].syncs, fresh


class Recorded:
    """graph_step's stand-in: runs fn eagerly and keeps the arguments of
    each call."""

    def __init__(self, fn, device, log):
        self.fn, self.device, self.calls = fn, device, []
        log.append(self)

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)

    def replay(self, *args):
        self.__call__(*args)

    def rehearse(self):
        """refused(fn(*first call's arguments))."""
        args = self.calls[0]
        return refused(lambda: self.fn(*args))


@contextlib.contextmanager
def recorded_steps(*modules):
    """Within, graph_step in each of `modules` makes a Recorded (eager)
    step; yields the list of them, in the order they were made."""
    log = []
    with contextlib.ExitStack() as stack:
        for module in modules:
            stack.enter_context(mock.patch.object(
                module, "graph_step",
                lambda fn, device: Recorded(fn, device, log)))
        yield log
