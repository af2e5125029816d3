"""Prefix sums in the JAX package's rounding order.

XLA:CPU lowers jnp.cumsum to a cumulative reduce-window, which its
rewriter turns into a blocked scan: sequential f32 sums within blocks of
16, the same scan over the block totals, and each block's exclusive prefix
added to its entries. vseg and hseg take window sums as differences of such
prefix sums and then an argmax/argmin; on a near-tie (rows whose
probabilities saturate at 1, say) the last bit decides the winner. So the
port sums in that order, on the CPU and the card alike: torch.cumsum
accumulates in float64 on the CPU and in a parallel order on the card, and
neither gives the JAX package's bits.
"""

import torch
import torch.nn.functional as F

BLOCK = 16


def _sequential(x):
    """Inclusive prefix sums along the last dim, one f32 add at a time."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def cumsum(x):
    """Inclusive prefix sums of x along its last dim, bit for bit as the
    JAX package's jnp.cumsum on XLA:CPU."""
    n = x.shape[-1]
    if n <= BLOCK:
        return _sequential(x)
    n_blocks = -(-n // BLOCK)
    blocks = F.pad(x, (0, n_blocks * BLOCK - n)).reshape(
        *x.shape[:-1], n_blocks, BLOCK)
    inner = _sequential(blocks)
    before = F.pad(cumsum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + before[..., None]).reshape(
        *x.shape[:-1], n_blocks * BLOCK)[..., :n]
