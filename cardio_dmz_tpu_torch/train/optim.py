"""The part of optax the trainer uses: optax.adam, as a pure update.

Counterpart of optax.adam(learning_rate) in the JAX package's
train/trainer.py: scale_by_adam, then scale_by_learning_rate, op for op,
on dicts of tensors. The state is a value (AdamState) and update returns a
new one: nothing is updated in place and the step count is a tensor on the
parameters' device, so a train step is a pure function that
parallel/graphed.graph_step can capture and replay (torch.optim.Adam keeps
its count as a Python number unless capturable, and capturable refuses
CPU tensors).
"""

import typing

import torch

INT32_MAX = 2 ** 31 - 1


class AdamState(typing.NamedTuple):
    """optax.ScaleByAdamState: count, a 0-d int32 tensor; mu and nu, the
    first and second moments, dicts shaped as the parameters."""
    count: torch.Tensor
    mu: dict
    nu: dict


class Adam(typing.NamedTuple):
    """optax.adam's init and update (see adam)."""
    learning_rate: float
    b1: float
    b2: float
    eps: float

    def init(self, params):
        """Zero moments and a zero count on the parameters' device."""
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads, state):
        """(updates, new state) for the gradients `grads`, in optax's
        order: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count +
        1 (saturating at the int32 maximum, numerics.safe_increment), each
        moment divided by 1 - b**count computed on the device, and the
        update -lr * mu_hat / (sqrt(nu_hat) + eps)."""
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state.nu[k]
              for k, g in grads.items()}
        count = torch.where(state.count < INT32_MAX, state.count + 1,
                            state.count)
        steps = count.to(torch.float32)
        correct1, correct2 = 1 - b1 ** steps, 1 - b2 ** steps
        updates = {k: -self.learning_rate * (
            (mu[k] / correct1) / (torch.sqrt(nu[k] / correct2 + 0.0)
                                  + self.eps)) for k in grads}
        return updates, AdamState(count, mu, nu)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam(learning_rate, b1, b2, eps): init(params) -> AdamState;
    update(grads, state) -> (updates, state)."""
    return Adam(learning_rate, b1, b2, eps)


def apply_updates(params, updates):
    """optax.apply_updates: each parameter plus its update."""
    return {k: p + updates[k] for k, p in params.items()}
