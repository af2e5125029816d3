"""The digit-prep plain version against the JAX package's Pallas kernel
(interpret mode) and jnp path, and the wrapper's routes and checks. The
CUDA kernel itself is tested on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cardio_dmz_tpu.ops.pallas.digit_prep import prepare_digit_cells_pallas
from cardio_dmz_tpu.scan import categorize as jcat
from cardio_dmz_tpu_torch.ops.cuda import digit_prep
from cardio_dmz_tpu_torch.scan import categorize as pcat
from torch_parity import to_np


def _case(seed):
    rng = np.random.RandomState(seed)
    strip = rng.randint(0, 256, (27, 428)).astype(np.uint8)
    offsets = np.sort(rng.choice(409, 16, replace=False)).astype(np.int32)
    return strip, offsets


def _edge_case():
    strip, _ = _case(0)
    return strip, np.array([0, 409] + [20 * i for i in range(1, 15)],
                           np.int32)


CASES = {"seed0": lambda: _case(0), "seed1": lambda: _case(1),
         "seed2": lambda: _case(2), "edges": _edge_case}


def _assert_same_levels(got, strip, offsets):
    """Equal to the Pallas kernel in interpret mode. Compared as the
    integer levels v = x * 255: in interpret mode the final / 255 can
    differ from a true division by 1 ulp, and the jnp path, the port and
    its CUDA kernel divide."""
    ref = np.asarray(prepare_digit_cells_pallas(
        jnp.asarray(strip), jnp.asarray(offsets), interpret=True))
    np.testing.assert_array_equal(np.rint(got * 255), np.rint(ref * 255))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_and_jnp(case):
    strip, offsets = CASES[case]()
    got = to_np(digit_prep.prepare_digit_cells_reference(
        torch.from_numpy(strip)[None], torch.from_numpy(offsets)[None]))[0]
    _assert_same_levels(got, strip, offsets)
    ref = np.asarray(jcat.prepare_cells(jcat.extract_cells(
        jnp.asarray(strip), jnp.asarray(offsets))))
    np.testing.assert_array_equal(got, ref)
    port = pcat.prepare_cells(pcat.extract_cells(
        torch.from_numpy(strip), torch.from_numpy(offsets)))
    np.testing.assert_array_equal(to_np(port), ref)


def test_batch_of_three_strips_and_clipped_offsets():
    cases = [_case(s) for s in (3, 4, 5)]
    strips = np.stack([c[0] for c in cases])
    offsets = np.stack([c[1] for c in cases])
    offsets[1, 0], offsets[2, 15] = -7, 500     # clipped to 0 and 409
    got = to_np(digit_prep.prepare_digit_cells(
        torch.from_numpy(strips), torch.from_numpy(offsets)))
    assert got.shape == (3, 16, 27, 19) and got.dtype == np.float32
    for s in range(3):
        _assert_same_levels(got[s], strips[s], offsets[s])
        ref = np.asarray(jcat.prepare_cells(jcat.extract_cells(
            jnp.asarray(strips[s]),
            jnp.asarray(np.clip(offsets[s], 0, 409)))))
        np.testing.assert_array_equal(got[s], ref)


def test_cpu_tensor_takes_plain_path_without_building():
    strip, offsets = _case(0)
    before = digit_prep.LAUNCHES
    digit_prep.prepare_digit_cells(torch.from_numpy(strip)[None],
                                   torch.from_numpy(offsets)[None])
    assert digit_prep.LAUNCHES == before
    assert not digit_prep.KERNEL.loaded


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_input(bad):
    strip = torch.zeros(2, 27, 428, dtype=torch.uint8)
    offsets = torch.zeros(2, 16, dtype=torch.int32)
    if bad == "dtype":
        offsets, err = offsets.to(torch.int64), TypeError
    elif bad == "shape":
        strip, err = torch.zeros(2, 428, 27, dtype=torch.uint8), ValueError
    else:
        offsets, err = torch.zeros(16, 2, dtype=torch.int32).T, ValueError
    with pytest.raises(err):
        digit_prep.prepare_digit_cells(strip, offsets)
