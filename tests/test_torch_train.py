"""Training in the port against the JAX package: the scharr ops, the
synthetic generators (without PIL), the initialisers, the losses and
their gradients, Adam, a three-step fit, the fit over a device mesh,
train_models and the parameter files both packages read.

The JAX side is computed once per architecture (tests/torch_fixture.py's
lru_caches: its jitted value_and_grad and its fit), so that the committed
data/train_session.npz and the live JAX package are held to the same
numbers; chip_smoke.py phase 19 holds the port on the card to that file
with the same tolerances (chip_smoke.check_loss_and_grads, check_fit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_fixture as fx
import torch_parity  # noqa: F401  (one intra-op thread)
from cardio_dmz_tpu.ops import sobel as jax_sobel
from cardio_dmz_tpu.session import checkpoint as jax_checkpoint
from cardio_dmz_tpu.synthetic import _digit_mask as jax_digit_mask
from cardio_dmz_tpu_torch.ops import sobel
from cardio_dmz_tpu_torch.parallel import make_mesh
from cardio_dmz_tpu_torch.session import checkpoint
from cardio_dmz_tpu_torch.tools import train_models
from cardio_dmz_tpu_torch.train import fit, glyphs
from chip_smoke import (
    TRAIN_FLOORS, check_fit, check_loss_and_grads, check_train_batches)

MODELS = fx.TRAIN_MODELS


def _run(model):
    """The JAX package's run of `model`, as the fixture names its arrays."""
    return fx.jax_train_run(model)


def _spec(model):
    return train_models._spec(model, "cpu")


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (16, 11), (2, 27, 19)])
@pytest.mark.parametrize("name", ["scharr3_dx_abs", "scharr3_dy_abs"])
def test_scharr_matches_jax(name, shape):
    x = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(
        np.uint8)
    got = getattr(sobel, name)(torch.from_numpy(x))
    want = np.asarray(getattr(jax_sobel, name)(jnp.asarray(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("digit", range(10))
def test_digit_mask_matches_jax(digit):
    np.testing.assert_array_equal(glyphs._digit_mask(digit),
                                  jax_digit_mask(digit))


def test_expiry_glyph_jitter_outside_the_table_raises():
    with pytest.raises(ValueError, match="jitter"):
        glyphs.expiry_digit_mask(3, 0, 1)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("model", MODELS)
def test_generator_matches_jax(model, seed):
    """The same RandomState stream through both generators gives the same
    batch: inputs (f32 after /255, so the u8 cells too) and labels."""
    want = fx.train_spec(model)[3](np.random.RandomState(seed), 64)
    got = _spec(model)[3](np.random.RandomState(seed), 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("model", MODELS)
def test_generator_makes_the_fixture_batches(model):
    """chip_smoke.py's check of the generators, here on the CPU."""
    check_train_batches(_spec(model)[3], _run(model))


def _glorot_limit(shape):
    """JAX's glorot_uniform bound: fans over axes -2 and -1, the other
    dims a receptive field."""
    receptive = int(np.prod(shape)) // (shape[-2] * shape[-1])
    return np.sqrt(6.0 / ((shape[-2] + shape[-1]) * receptive))


@pytest.mark.parametrize("model", MODELS)
def test_init_matches_jax_distribution(model):
    """Same names and shapes as the JAX init; biases zero; each weight
    uniform within JAX's glorot bound (times the 3.0 / 2.0 scales), its
    samples reaching above 90% of it, as the JAX samples do."""
    jax_params = {k.split("/", 1)[1]: v for k, v in _run(model).items()
                  if k.startswith("init/")}
    params = _spec(model)[0]()
    assert sorted(params) == sorted(jax_params)
    scale = {"conv_w": 3.0, "conv1_w": 2.0}
    for k, v in params.items():
        v = v.numpy()
        assert v.shape == jax_params[k].shape and v.dtype == np.float32, k
        if k.endswith("_b"):
            assert not v.any(), k
            continue
        limit = scale.get(k, 1.0) * _glorot_limit(v.shape)
        for sample in (v, jax_params[k]):
            assert np.abs(sample).max() <= limit * (1 + 1e-6), k
            assert np.abs(sample).max() > 0.9 * limit, k


def test_init_is_the_same_on_every_device_and_seeded():
    from cardio_dmz_tpu_torch.train import init_expiry_conv_params
    a = init_expiry_conv_params(torch.Generator().manual_seed(3), "cpu")
    b = init_expiry_conv_params(torch.Generator().manual_seed(3), "cpu")
    c = init_expiry_conv_params(torch.Generator().manual_seed(4), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv2_w"], c["conv2_w"])


@pytest.mark.parametrize("model", MODELS)
def test_loss_and_grads_match_jax(model):
    """From the JAX initial parameters on the JAX batch: the loss within
    1e-5 relative, each gradient within 1e-5 or 1e-4 of its size."""
    check_loss_and_grads(_spec(model)[1], _run(model), "cpu")


def test_xent_splits_a_saturated_softmax_as_jax():
    """A probability of exactly 1.0 sits on the clip's upper bound: jnp.clip
    passes half the gradient there, torch.clamp all of it."""
    from cardio_dmz_tpu.train.trainer import _xent as jax_xent
    from cardio_dmz_tpu_torch.train.trainer import _xent
    probs = np.float32([[1.0, 0.0], [0.25, 0.75]])
    labels = np.int32([0, 1])
    want = np.asarray(jax.grad(jax_xent)(jnp.asarray(probs),
                                         jnp.asarray(labels)))
    p = torch.tensor(probs, requires_grad=True)
    _xent(p, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-6)
    assert p.grad[0, 0] == -0.25        # half of -1/2


@pytest.mark.parametrize("model", ["pan_conv", "expiry_conv"])
def test_pool_and_relu_ties_split_as_jax(model):
    """An all-zero batch ties every max pool (and in the expiry conv every
    ReLU at 0): the gradients of the parameters and of the input still
    equal jax.grad's, which shares a tie evenly (all of it to one input,
    or none through a ReLU, would differ)."""
    from cardio_dmz_tpu.train import trainer as jax_trainer
    loss_fn = _spec(model)[1]
    jax_loss = getattr(jax_trainer, model + "_loss")
    shape = (4, 27, 19) if model == "pan_conv" else (4, 16, 11)
    x, y = np.zeros(shape, np.float32), np.int32([0, 1, 2, 3])
    init = {k.split("/", 1)[1]: v for k, v in _run(model).items()
            if k.startswith("init/")}
    want, want_x = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in init.items()}, jnp.asarray(x),
        jnp.asarray(y))
    params = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    cells = torch.zeros(shape, requires_grad=True)
    loss_fn(params, cells, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(cells.grad.numpy(), np.asarray(want_x),
                               atol=1e-7, rtol=1e-5)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]),
                                   atol=1e-7, rtol=1e-5, err_msg=k)


def test_adam_matches_optax():
    """train/optim.adam, the optimizer of fit's step, against optax.adam,
    fed the same gradients at three scales: parameters, moments and count
    within 1e-6 after each update."""
    from cardio_dmz_tpu_torch.train import adam, apply_updates
    rng = np.random.RandomState(0)
    w0 = rng.randn(64).astype(np.float32)
    grads = [(rng.randn(64) * scale).astype(np.float32)
             for scale in (1.0, 1e-3, 1e-9)]
    opt = optax.adam(3e-3)
    w, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    port = adam(3e-3)
    p = {"w": torch.from_numpy(w0)}
    p_state = port.init(p)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, updates)
        p_updates, p_state = port.update({"w": torch.from_numpy(g)},
                                         p_state)
        p = apply_updates(p, p_updates)
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(w), atol=1e-6)
        for got, want in ((p_state.mu["w"], state[0].mu),
                          (p_state.nu["w"], state[0].nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6)
        assert p_state.count.dtype == torch.int32
        assert int(p_state.count) == int(state[0].count)


@pytest.mark.parametrize("model", MODELS)
def test_fit_matches_jax(model):
    """Three steps of fit at lr 3e-3 from the JAX initial parameters on the
    JAX batches: losses within 1e-5; parameters within 1e-5, or 1e-4 where
    the first gradient is below 2e-7 (chip_smoke.FIT_ATOL)."""
    check_fit(_spec(model)[1], _run(model), "cpu")


def _mesh_fit(model, mesh, steps=2):
    init_fn, loss_fn, _, data_fn = _spec(model)
    inputs, labels = data_fn(np.random.RandomState(1), 16)

    def data():
        while True:
            yield inputs, labels

    return fit(loss_fn, init_fn(), data(), steps=steps, mesh=mesh)


@pytest.mark.parametrize("layout", ["data2", "data2_model2"])
@pytest.mark.parametrize("model", MODELS)
def test_mesh_fit_matches_unsharded(model, layout):
    """The fit over ["cpu", "cpu"] (two data groups) and over ["cpu"] * 4
    with model_parallel=2 (two data groups, the hidden layer's rows on two
    model ranks) against the fit without a mesh, as
    tests/test_parallel_train.py holds the JAX one."""
    mesh = (make_mesh(["cpu", "cpu"]) if layout == "data2"
            else make_mesh(["cpu"] * 4, model_parallel=2))
    p_mesh, l_mesh = _mesh_fit(model, mesh)
    p_plain, l_plain = _mesh_fit(model, None)
    np.testing.assert_allclose(l_mesh, l_plain, rtol=1e-4)
    for k in p_plain:
        np.testing.assert_allclose(p_mesh[k].numpy(), p_plain[k].numpy(),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("x_shape, w_shape", [
    ((3, 1, 27, 19), (8, 1, 3, 3)),        # the PAN conv
    ((3, 1, 24, 18), (50, 1, 5, 5)),       # expiry conv1, padded input
    ((3, 50, 10, 7), (40, 50, 5, 5)),      # expiry conv2
])
def test_patch_gemm_is_the_valid_correlation(x_shape, w_shape):
    """models/zoo._conv2d (a GEMM of strided patches) computes F.conv2d's
    valid correlation, here in float64, values and input gradient."""
    from cardio_dmz_tpu_torch.models.zoo import _conv2d
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(x_shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(w_shape, dtype=torch.float64, generator=gen)
    got = _conv2d(x, w)
    want = torch.nn.functional.conv2d(x, w)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)
    g_got, = torch.autograd.grad(got.sum(), x)
    g_want, = torch.autograd.grad(want.sum(), x)
    torch.testing.assert_close(g_got, g_want, atol=1e-12, rtol=0)


def test_column_parallel_hidden_layer_is_the_same_product():
    """The trainer's column-parallel hidden layer over two row blocks,
    which apply_mlp calls in place of its own product, equals the one
    product (the rows cut as split_sizes cuts them, 25 + 25 here)."""
    from cardio_dmz_tpu_torch.models.zoo import apply_mlp
    from cardio_dmz_tpu_torch.train.trainer import column_parallel
    params = _spec("vseg_mlp")[0]()
    x = torch.from_numpy(np.random.RandomState(2).rand(8, 204).astype(
        np.float32))
    split = {k: v for k, v in params.items()
             if k not in ("hidden_w", "hidden_b")}
    split["hidden"] = column_parallel(
        params["hidden_w"], params["hidden_b"],
        [slice(0, 25), slice(25, 50)], ["cpu", "cpu"])
    torch.testing.assert_close(apply_mlp(split, x), apply_mlp(params, x),
                               atol=1e-6, rtol=0)


def test_make_train_step_with_a_mesh_needs_the_template():
    from cardio_dmz_tpu_torch.train import make_train_step, mlp_loss
    with pytest.raises(ValueError, match="params_template"):
        make_train_step(mlp_loss, None, mesh=make_mesh(["cpu"]))


@pytest.mark.parametrize("model", MODELS)
def test_train_one_clears_the_floor(model):
    """tools/train_models.train_one on the CPU at batch 64 and lr 3e-3
    clears the JAX tests' held-out accuracy floors."""
    steps, floor = TRAIN_FLOORS[model]
    params, acc, golden = train_models.train_one(
        model, steps, 64, 3e-3, None, compare_golden=True, device="cpu")
    assert acc > floor, (model, acc)
    assert 0.0 <= golden <= 1.0


def test_train_models_main_writes_what_both_packages_load(tmp_path):
    out = tmp_path / "retrained.npz"
    assert train_models.main(["--model", "slash_mlp", "--steps", "3",
                              "--device", "cpu", "--out", str(out)]) == 0
    modules = checkpoint.load_params_npz(out, device="cpu")
    assert list(modules) == ["slash_mlp"]
    arrays = jax_checkpoint.load_params_npz(str(out))["slash_mlp"]
    for k, v in arrays.items():
        np.testing.assert_array_equal(
            getattr(modules["slash_mlp"], k).numpy(), np.asarray(v))


def test_train_models_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_models.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_models.train_one("slash_mlp", 1, 8, 3e-3, None)


def _trained_arrays():
    """{model: {key: numpy}} of the four trained names, the fixture's
    three-step fits."""
    return {m: {k.split("/", 1)[1]: v for k, v in _run(m).items()
                if k.startswith("fit/")} for m in MODELS}


def test_jax_trained_params_load_in_the_port(tmp_path):
    """A file the JAX package's save_params writes with the names of its
    tools/train_models.py loads into the port's modules (before the fix:
    KeyError 'pan_conv')."""
    path = tmp_path / "jax.npz"
    trained = _trained_arrays()
    jax_checkpoint.save_params(str(path), trained)
    modules = checkpoint.load_params_npz(path, device="cpu")
    assert sorted(modules) == sorted(MODELS)
    for m, arrays in trained.items():
        for k, v in arrays.items():
            np.testing.assert_array_equal(getattr(modules[m], k).numpy(), v)


def test_port_trained_params_load_in_jax(tmp_path):
    """The port's save_params of a trainer's dicts of tensors, read by the
    JAX package's load_params_npz, array for array."""
    path = tmp_path / "port.npz"
    trained = {m: {k: torch.tensor(v) for k, v in arrays.items()}
               for m, arrays in _trained_arrays().items()}
    checkpoint.save_params(path, trained)
    loaded = jax_checkpoint.load_params_npz(str(path))
    assert sorted(loaded) == sorted(MODELS)
    for m, arrays in trained.items():
        assert sorted(loaded[m]) == sorted(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(np.asarray(loaded[m][k]),
                                          v.numpy())


def test_load_params_npz_names_an_unknown_model(tmp_path):
    path = tmp_path / "odd.npz"
    np.savez(path, **{"mystery_model/hidden_w": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="mystery_model"):
        checkpoint.load_params_npz(path, device="cpu")


def test_train_fixture_is_current():
    """The committed train_glyphs.npz and the training arrays of
    train_session.npz are what the JAX package computes today (the entry's
    are held by tests/test_torch_entry.py)."""
    for path, fresh in ((fx.GLYPH_FIXTURE, fx.glyph_arrays()),
                        (fx.TRAIN_FIXTURE, fx.train_run_arrays())):
        with np.load(path) as committed:
            names = [k for k in committed.files
                     if not k.startswith("entry_")]
            assert sorted(names) == sorted(fresh), path
            for k, v in fresh.items():
                if np.issubdtype(v.dtype, np.floating):
                    np.testing.assert_allclose(committed[k], v, atol=1e-6,
                                               rtol=1e-5, err_msg=k)
                else:
                    np.testing.assert_array_equal(committed[k], v, err_msg=k)
