"""The port's image ops against the JAX package's, on random, all-zero and
constant u8 input."""

import numpy as np
import pytest
import torch

from cardio_dmz_tpu import ops as jops
from cardio_dmz_tpu_torch import ops as pops
from torch_parity import to_np

KINDS = ("random", "zeros", "constant")


def _u8(kind, shape, seed=0):
    if kind == "random":
        return np.random.RandomState(seed).randint(0, 256, shape).astype(
            np.uint8)
    return np.full(shape, 0 if kind == "zeros" else 77, np.uint8)


# (name, JAX op, port op, input shape)
OPS = (
    ("morph_grad3_1d_u8", jops.morph_grad3_1d_u8, pops.morph_grad3_1d_u8,
     (5, 408)),
    ("morph_grad3_2d_cross_u8", jops.morph_grad3_2d_cross_u8,
     pops.morph_grad3_2d_cross_u8, (3, 27, 428)),
    ("lineardown2_1d_u8", jops.lineardown2_1d_u8, pops.lineardown2_1d_u8,
     (5, 408)),
    ("norm_convert_minmax", jops.norm_convert_minmax,
     pops.norm_convert_minmax, (5, 204)),
    # three image sizes: the JAX package lowers each differently
    ("equalize_hist", jops.equalize_hist, pops.equalize_hist, (4, 27, 19)),
    ("equalize_hist", jops.equalize_hist, pops.equalize_hist, (3, 16, 11)),
    ("equalize_hist", jops.equalize_hist, pops.equalize_hist, (2, 40, 50)),
)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,jax_op,port_op,shape", OPS,
                         ids=[f"{o[0]}-{'x'.join(map(str, o[3]))}"
                              for o in OPS])
def test_op_matches_jax(name, jax_op, port_op, shape, kind):
    x = _u8(kind, shape)
    ref = np.asarray(jax_op(x))
    got = to_np(port_op(torch.from_numpy(x)))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_equalize_hist_maps_zero_to_zero():
    x = _u8("random", (2, 27, 19), seed=3)
    x[:, 0, :] = 0
    got = to_np(pops.equalize_hist(torch.from_numpy(x)))
    assert (got[x == 0] == 0).all()


@pytest.mark.parametrize("n", [1, 16, 17, 271, 428])
def test_prefix_cumsum_matches_jax_bits(n):
    """ops.prefix.cumsum equals the JAX package's jitted jnp.cumsum bit for
    bit (vseg sums windows of [0, p...] of 271, hseg of 428), on random
    values and on saturated rows where every window ties."""
    import jax
    import jax.numpy as jnp
    from cardio_dmz_tpu_torch.ops import prefix
    rng = np.random.RandomState(n)
    x = np.concatenate([rng.rand(5, n), np.full((1, n), 0.99987)]).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
    got = to_np(prefix.cumsum(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
