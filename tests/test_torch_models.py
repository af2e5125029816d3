"""The port's models against the reference's golden vectors and against
the JAX package's models on seeded random inputs."""

import numpy as np
import pytest
import torch

from cardio_dmz_tpu.models import zoo as jzoo
from cardio_dmz_tpu_torch.models import load_all_params, load_np, zoo
from cardio_dmz_tpu_torch.models.weights import MODEL_NAMES, params_from_numpy
from torch_parity import np_params, port_params, to_np

TOL = 1e-5  # the reference's golden tolerance


@pytest.fixture(autouse=True)
def _full_precision():
    prev = jzoo.set_precision("highest")
    yield
    jzoo.set_precision(prev)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_golden_vectors(name):
    golden = load_np(name, include_test_vectors=True)
    model = load_all_params("cpu")[name]
    out = model(torch.from_numpy(golden["test_input"]))
    np.testing.assert_allclose(to_np(out), golden["test_output"], atol=TOL)


def test_mlp_matches_jax():
    x = np.random.default_rng(0).uniform(0, 1, (7, 204)).astype(np.float32)
    ref = np.asarray(jzoo.apply_mlp(np_params()["vseg_mlp"], x))
    got = to_np(port_params()["vseg_mlp"](torch.from_numpy(x)))
    np.testing.assert_allclose(got, ref, atol=TOL)


@pytest.mark.parametrize("name", ["pan_conv_a", "pan_conv_b", "pan_conv_c"])
def test_pan_conv_matches_jax(name):
    cells = np.random.default_rng(1).uniform(
        0, 1, (9, 27, 19)).astype(np.float32)
    p = np_params()[name]
    np.testing.assert_array_equal(zoo.pan_conv_matrix(p["conv_w"]),
                                  np.asarray(jzoo._pan_conv_matmul(p)))
    ref = np.asarray(jzoo.apply_pan_conv_mm(p, cells))
    got = to_np(port_params()[name](torch.from_numpy(cells)))
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_pan_digit_scores_matches_jax():
    cells = np.random.default_rng(2).uniform(
        0, 1, (3, 16, 27, 19)).astype(np.float32)
    p, m = np_params(), port_params()
    ref = np.asarray(jzoo.pan_digit_scores(
        p["pan_conv_a"], p["pan_conv_b"], p["pan_conv_c"], cells))
    got = zoo.pan_digit_scores(m["pan_conv_a"], m["pan_conv_b"],
                               m["pan_conv_c"], torch.from_numpy(cells))
    assert got.shape == (3, 16, 10)
    np.testing.assert_allclose(to_np(got), ref, atol=TOL)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_params_from_numpy_round_trips(name):
    arrays = np_params()[name]
    model = params_from_numpy(np_params(), "cpu")[name]
    state = model.state_dict()
    assert sorted(state) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(to_np(state[k]), v)


def test_pan_conv_rejects_transposed_cells():
    with pytest.raises(ValueError):
        port_params()["pan_conv_a"](torch.zeros(2, 19, 27))
