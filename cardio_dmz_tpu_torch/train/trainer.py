"""Training for the scan's small models.

Counterpart of the JAX package's train/trainer.py. Parameters are a dict
of tensors, the models their trainable forms (models/zoo.apply_*), the
optimizer train/optim.adam (optax.adam's update, op for op). The train
step is the JAX step, a pure (params, opt_state, inputs, labels) ->
(params, opt_state, loss), and like the JAX step it is compiled: captured
as a CUDA graph by parallel/graphed.graph_step (the port's jax.jit) on
its device.

Over a mesh (parallel/mesh.make_mesh) the step does explicitly what the
JAX package's param_shardings asks XLA to do: the parameters live on the
mesh's first device; each data group steps its slice of the batch on its
device through copies of the parameters (p.to(device)), so that one
gradient reduces the groups' into the parameters; and with more than one
model rank the hidden layer is column-parallel: each rank computes its
block of hidden_w / hidden_b rows, and the hidden activations are
gathered before the logistic layer. One process, no torch.distributed.
"""

import functools
import math

import torch

from ..models.zoo import apply_expiry_conv, apply_mlp, apply_pan_conv
from ..parallel.graphed import graph_step
from ..parallel.mesh import as_device, split_sizes
from .optim import adam, apply_updates


def glorot_uniform(generator, shape, device, scale=1.0):
    """jax.nn.initializers.glorot_uniform()'s draw times `scale`: uniform
    in +-sqrt(6 / (fan_in + fan_out)) with JAX's fans, fan_in = shape[-2]
    and fan_out = shape[-1] times the product of the other dims
    (torch.nn.init.xavier_uniform_ takes dims 1 and 0 and disagrees on
    every conv weight). Drawn on the host from `generator`, a CPU
    torch.Generator, and copied to `device`: one seed gives the same
    parameters on every device."""
    receptive = math.prod(shape) // (shape[-2] * shape[-1])
    limit = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * receptive))
    w = torch.empty(shape).uniform_(-limit, limit, generator=generator)
    return (w * scale).to(device)


def _zeros(n, device):
    return torch.zeros((n,), dtype=torch.float32, device=device)


def init_pan_conv_params(generator, device):
    """Fresh PAN digit conv params (27x19 -> 8@3x3 -> 320 -> 32 -> 10)."""
    return {
        "conv_w": glorot_uniform(generator, (8, 3, 3), device, 3.0),
        "conv_b": _zeros(8, device),
        "hidden_w": glorot_uniform(generator, (32, 320), device),
        "hidden_b": _zeros(32, device),
        "logistic_w": glorot_uniform(generator, (10, 32), device),
        "logistic_b": _zeros(10, device),
    }


def init_mlp_params(generator, n_in, n_hidden, n_out, device):
    """Fresh MLP params (n_in -> n_hidden tanh -> n_out softmax)."""
    return {
        "hidden_w": glorot_uniform(generator, (n_hidden, n_in), device),
        "hidden_b": _zeros(n_hidden, device),
        "logistic_w": glorot_uniform(generator, (n_out, n_hidden), device),
        "logistic_b": _zeros(n_out, device),
    }


def init_expiry_conv_params(generator, device):
    """Fresh expiry digit conv params, the modelc_bf4dd6c8 architecture
    (16x11 mean-sub -> 50@5x5 + 2x2 pool -> 40@5x5 + 2x3 pool -> 176 ReLU
    -> 10 softmax, expiry_categorization.md:82-88)."""
    return {
        "conv1_w": glorot_uniform(generator, (50, 5, 5), device, 2.0),
        "conv1_b": _zeros(50, device),
        "conv2_w": glorot_uniform(generator, (40, 50, 5, 5), device),
        "conv2_b": _zeros(40, device),
        "hidden_w": glorot_uniform(generator, (176, 120), device),
        "hidden_b": _zeros(176, device),
        "logistic_w": glorot_uniform(generator, (10, 176), device),
        "logistic_b": _zeros(10, device),
    }


@functools.lru_cache(maxsize=None)
def _clip_bounds(device, dtype):
    """The clip's bounds 1e-12 and 1 as 0-d tensors, kept on `device`: made
    once, not copied from the host at every step."""
    return (torch.tensor(1e-12, dtype=dtype, device=device),
            torch.tensor(1.0, dtype=dtype, device=device))


def _xent(probs, labels):
    """Mean cross-entropy as the JAX package writes it: the log of the
    softmax clipped to [1e-12, 1]. The clip is a maximum and a minimum
    against tensors, whose gradient at a tie is split in half as
    jnp.clip's is (an f32 softmax saturates to exactly 1.0; torch.clamp
    passes all of it)."""
    low, high = _clip_bounds(probs.device, probs.dtype)
    clipped = torch.minimum(torch.maximum(probs, low), high)
    logp = torch.log(clipped)
    return -logp.gather(1, labels.long()[:, None]).mean()


def pan_conv_loss(params, cells, labels):
    """cells: (B, 27, 19) f32 [0,1]; labels: (B,) integer."""
    return _xent(apply_pan_conv(params, cells), labels)


def mlp_loss(params, x, labels):
    return _xent(apply_mlp(params, x), labels)


def expiry_conv_loss(params, cells, labels):
    """cells: (B, 16, 11) f32 (prep chain applied); labels: (B,) integer."""
    return _xent(apply_expiry_conv(params, cells), labels)


def column_parallel(w, b, row_blocks, devices):
    """The layer x -> x @ w.T + b with its output columns over `devices`:
    rank i holds rows row_blocks[i] of w and b on devices[i] and makes its
    block of the product there; the blocks are gathered on x's device. The
    row copies are differentiable, so backward() carries each block's
    gradient to w and b."""
    blocks = [(w[rows].to(device), b[rows].to(device))
              for rows, device in zip(row_blocks, devices)]

    def product(x):
        return torch.cat([(torch.matmul(x.to(wi.device), wi.T) + bi).to(
            x.device) for wi, bi in blocks], dim=-1)

    return product


def _one_device(mesh, home):
    """Whether every device of the mesh is `home` (the card machine's
    layout, and dryrun_multichip's over one card named n times)."""
    return {as_device(d) for row in mesh.devices for d in row} == {
        as_device(home)}


def make_train_step(loss_fn, optimizer, mesh=None, params_template=None):
    """The JAX package's train step: (params, opt_state, inputs, labels) ->
    (params, opt_state, loss), a pure function. params: a dict of tensors
    on the step's device, `home`: the mesh's first device, or without a
    mesh params_template's device; opt_state: optimizer.init(params);
    inputs, labels:
    tensors on any device. The loss is the batch's mean loss before the
    update (a 0-d tensor); the gradients come from torch.autograd.grad on
    detached copies of the parameters, and optimizer.update (train/optim)
    is applied in the same step.

    The step is graph_step(step, home): captured as one CUDA graph a
    shape on a CUDA device, staged on the CPU. With a mesh whose devices
    are all `home`, the data groups, their (size / n) weights and the
    column-parallel blocks are all in the one graph. A mesh that names
    distinct devices is stepped eagerly: a graph is captured on one
    device. (Graphs of such a step, one a device, are a later item.)

    With a mesh, each data group takes its slice of the batch (as even as
    they go) to its first device, and the loss is the slices' losses
    weighted by their share of the batch. params_template: the parameters
    (or a dict of the same shapes on their device); with model_parallel >
    1 the hidden layer's rows are cut from it into one block a model
    rank."""
    if params_template is None:
        raise ValueError("make_train_step: params_template names the "
                         "parameters' shapes and device")
    if mesh is None:
        groups, row_blocks = None, None
        home = next(iter(params_template.values())).device
    else:
        home = mesh.devices[0][0]
        groups = mesh.devices
        ranks = len(groups[0])
        n_hidden = params_template["hidden_w"].shape[0]
        if ranks > n_hidden:
            raise ValueError(f"{n_hidden} hidden rows do not split over "
                             f"{ranks} model ranks")
        bounds = [0]
        for size in split_sizes(n_hidden, ranks):
            bounds.append(bounds[-1] + size)
        row_blocks = [slice(a, b) for a, b in zip(bounds, bounds[1:])]

    def group_params(params, devices):
        """The copies one data group computes with: every tensor on its
        first device, and with more than one model rank the hidden layer
        column-parallel over them (models/zoo.apply_* call it as
        params["hidden"])."""
        if len(devices) == 1:
            return {k: v.to(devices[0]) for k, v in params.items()}
        out = {k: v.to(devices[0]) for k, v in params.items()
               if k not in ("hidden_w", "hidden_b")}
        out["hidden"] = column_parallel(params["hidden_w"],
                                        params["hidden_b"], row_blocks,
                                        devices)
        return out

    def batch_loss(params, inputs, labels):
        if groups is None:
            return loss_fn(params, inputs.to(home), labels.to(home))
        n, start, loss = len(labels), 0, 0.0
        for devices, size in zip(groups, split_sizes(n, len(groups))):
            part = slice(start, start + size)
            start += size
            if size == 0:
                continue
            part_loss = loss_fn(group_params(params, devices),
                                inputs[part].to(devices[0]),
                                labels[part].to(devices[0]))
            loss = loss + (size / n) * part_loss.to(home)
        return loss

    def step(params, opt_state, inputs, labels):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = batch_loss(leaves, inputs, labels)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        updates, opt_state = optimizer.update(grads, opt_state)
        params = apply_updates({k: v.detach() for k, v in leaves.items()},
                               updates)
        return params, opt_state, loss.detach()

    if mesh is not None and not _one_device(mesh, home):
        return step
    return graph_step(step, home)


def fit(loss_fn, params, data_iter, *, steps=100, learning_rate=1e-3,
        mesh=None, log_every=0):
    """Minimal fit loop, the JAX package's. data_iter yields (inputs,
    labels) numpy batches.

    The optimizer is train/optim.adam(learning_rate), optax.adam's update
    with its defaults (b1 0.9, b2 0.999, eps 1e-8). Trains copies of
    `params` on their device, or on the mesh's first device, through
    make_train_step's graphed step, holding the parameters and the
    optimizer state as values; returns (params, losses): the trained
    parameters as a dict of tensors and each step's loss as a float."""
    home = mesh.devices[0][0] if mesh is not None else next(
        iter(params.values())).device
    params = {k: v.detach().to(home, copy=True) for k, v in params.items()}
    optimizer = adam(learning_rate)
    opt_state = optimizer.init(params)
    step = make_train_step(loss_fn, optimizer, mesh=mesh,
                           params_template=params)
    losses = []
    for i in range(steps):
        inputs, labels = next(data_iter)
        params, opt_state, loss = step(params, opt_state,
                                       torch.as_tensor(inputs),
                                       torch.as_tensor(labels))
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: loss {losses[-1]:.4f}")
    return params, losses
