"""The stages of the port's expiry read against the JAX package's, one
function at a time on the same seeded inputs: integer and bool outputs
exactly, model outputs within the reference's golden tolerance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
from cardio_dmz_tpu.models import zoo as jzoo
from cardio_dmz_tpu.ops import bilateral3x3 as jax_bilateral3x3
from cardio_dmz_tpu.ops import equalize_hist as jax_equalize_hist
from cardio_dmz_tpu.ops import morph_grad3_2d_cross_u8 as jax_morph_grad
from cardio_dmz_tpu.ops.select import coarse_blocks
from cardio_dmz_tpu.ops.select import window_select as jax_window_select
from cardio_dmz_tpu.scan import expiry_device as jx
from cardio_dmz_tpu_torch.models import load_np, zoo
from cardio_dmz_tpu_torch.ops import bilateral3x3, window_select
from cardio_dmz_tpu_torch.scan import expiry_device as tx
from torch_parity import np_params, port_params, to_np

TOL = 1e-5          # the reference's golden tolerance
SLASH_TOL = 2e-4    # XLA's builtin tanh against libm's


@pytest.fixture(autouse=True)
def _full_precision():
    prev = jzoo.set_precision("highest")
    yield
    jzoo.set_precision(prev)


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)).to(dtype)


def _expiry_frame(seed=0):
    return synthetic.render_frame_with_expiry(
        "4111111111111111", "08/28", y0=150, offset=35, expiry_y=212,
        expiry_x=120, noise=1, seed=seed)


# --- ops -------------------------------------------------------------------

def test_bilateral3x3_matches_jax_on_random_cells():
    cells = np.random.RandomState(0).randint(
        0, 256, (64, 16, 11)).astype(np.uint8)
    np.testing.assert_array_equal(
        to_np(bilateral3x3(_t(cells))), np.asarray(jax_bilateral3x3(cells)))


def test_bilateral3x3_matches_jax_on_real_cells():
    """Equalized gradient cells of a rendered expiry line, as
    categorize_windows feeds the filter; a (2, 3, ...) batch."""
    y = _expiry_frame()
    cells = np.stack([y[212:228, x:x + 11] for x in range(118, 178, 10)])
    eq = np.asarray(jax_equalize_hist(jax_morph_grad(cells)))
    eq = eq.reshape(2, 3, 16, 11)
    np.testing.assert_array_equal(
        to_np(bilateral3x3(_t(eq))), np.asarray(jax_bilateral3x3(eq)))


def test_window_select_matches_jax():
    rng = np.random.RandomState(1)
    band = rng.randint(0, 4081, (3, 21, 428)).astype(np.int32)
    lefts = rng.randint(-5, 440, (3, 10)).astype(np.int32)
    lefts[:, 0], lefts[:, 1] = 0, 428 - 18
    ref = np.asarray(jax_window_select(jnp.asarray(band, jnp.float32),
                                       jnp.asarray(lefts), 18))
    got = window_select(_t(band), _t(lefts), 18)
    assert got.shape == (3, 10, 21, 18)
    np.testing.assert_array_equal(to_np(got), ref.astype(np.int32))


# --- models ----------------------------------------------------------------

def test_expiry_conv_golden_intermediates():
    golden = load_np("expiry_conv", include_test_vectors=True)
    probs, a1, a2, hidden = port_params()["expiry_conv"](
        _t(golden["test_input"]), return_intermediates=True)
    np.testing.assert_allclose(to_np(probs), golden["test_output"], atol=TOL)
    np.testing.assert_allclose(to_np(a1).reshape(50, 70),
                               golden["test_conv1_out"], atol=TOL)
    np.testing.assert_allclose(to_np(a2), golden["test_conv2_out"], atol=TOL)
    np.testing.assert_allclose(to_np(hidden), golden["test_hidden_out"],
                               atol=TOL)


def test_expiry_conv_matches_jax_mm():
    cells = np.random.default_rng(3).uniform(
        0, 1, (2, 4, 16, 11)).astype(np.float32)
    ref = np.asarray(jzoo.apply_expiry_conv_mm(np_params()["expiry_conv"],
                                               cells))
    got = port_params()["expiry_conv"](_t(cells))
    assert got.shape == (2, 4, 10)
    np.testing.assert_allclose(to_np(got), ref, atol=TOL)


def test_expiry_conv_rejects_transposed_cells():
    with pytest.raises(ValueError):
        port_params()["expiry_conv"](torch.zeros(2, 11, 16))


def test_slash_mlp_matches_jax():
    x = np.random.default_rng(4).uniform(0, 1, (9, 176)).astype(np.float32)
    ref = np.asarray(jzoo.apply_mlp(np_params()["slash_mlp"], x))
    np.testing.assert_allclose(to_np(port_params()["slash_mlp"](_t(x))), ref,
                               atol=TOL)


# --- segmentation stages ---------------------------------------------------

def _frames_and_starts():
    """Rendered and noise frames with y_start values on both sides of the
    136-row band's top (row 134)."""
    rng = np.random.RandomState(5)
    frames = np.stack([_expiry_frame(0), _expiry_frame(1),
                       rng.randint(0, 256, (270, 428)).astype(np.uint8),
                       rng.randint(0, 256, (270, 428)).astype(np.uint8),
                       np.full((270, 428), 90, np.uint8)])
    return frames, np.asarray([177, 177, 160, 60, 150], np.int32)


def test_scharr_dx_abs_below_matches_jax():
    frames, starts = _frames_and_starts()
    ref = np.asarray(jax.vmap(jx.scharr_dx_abs_below)(frames, starts))
    got = tx.scharr_dx_abs_below(_t(frames), _t(starts))
    np.testing.assert_array_equal(to_np(got), ref)


def test_select_stripes_matches_jax():
    """Noise, rendered and flat frames: the flat one ties every total."""
    frames, starts = _frames_and_starts()
    sobel = jax.vmap(jx.scharr_dx_abs_below)(frames, starts)
    ref = jax.jit(jax.vmap(jx.select_stripes))(sobel, starts)
    got = tx.select_stripes(_t(np.asarray(sobel), torch.int32), _t(starts))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(to_np(g), np.asarray(r))
    # every total of the flat frame is 0: the first base wins each round
    assert to_np(got[0])[4].tolist() == [151, 166, 181]


def _chain_sums(depth):
    """Rect sums rising left to right in steps of 8 positions: the greedy
    chain is `depth` deep, each rect beaten by its right neighbour."""
    sums = np.zeros(tx.N_RECT_POS, np.int32)
    sums[np.arange(depth) * 8] = 1000 + 10 * np.arange(depth)
    return sums


def test_nonoverlap_select_matches_jax():
    rng = np.random.RandomState(6)
    sums = rng.randint(0, 4080 * 9 * 17, (12, tx.N_RECT_POS)).astype(np.int32)
    sums[1] = rng.randint(0, 3, tx.N_RECT_POS)          # many ties
    sums[2], sums[3] = _chain_sums(6), _chain_sums(30)  # 30 > 8 rounds
    cand = rng.rand(12, tx.N_RECT_POS) < 0.7
    cand[2:4] = sums[2:4] > 0
    ref = np.asarray(jax.jit(jax.vmap(jx._nonoverlap_select))(sums, cand))
    got = to_np(tx._nonoverlap_select(_t(sums), _t(cand)))
    np.testing.assert_array_equal(got, ref)
    # the cap truncates the deep chain: plain take-best-first would accept
    # every other rect of it
    assert got[2].sum() == 3 and got[3].sum() < 15


def test_whitespace_strip_matches_jax():
    rng = np.random.RandomState(7)
    n = 200
    sums = rng.randint(0, 60000, (n, 16)).astype(np.int32)
    sums[rng.rand(n, 16) < 0.3] //= 20                   # dim chars
    start = rng.randint(0, 4, n).astype(np.int32)
    count = rng.randint(0, 17, n).astype(np.int32)       # counts < 4 too
    count[:8] = np.arange(8)
    start[:8] = 0
    ref = jax.jit(jax.vmap(jx._whitespace_strip))(sums, start, count)
    got = tx._whitespace_strip(_t(sums), _t(start), _t(count))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(to_np(g), np.asarray(r))


def _regrid_inputs():
    """Column sums of real scharr bands and of noise, with bounds all over
    the card (narrow ones and ones cut at the right edge included)."""
    rng = np.random.RandomState(8)
    sobel = np.asarray(jx.scharr_dx_abs_below(_expiry_frame(), 177))
    real = sobel[211 - 134:228 - 134].sum(0)
    cols = np.stack([real] * 24 + [rng.randint(0, 4080 * 17, 428)
                                   for _ in range(24)]).astype(np.int32)
    left = rng.randint(0, 420, 48).astype(np.int32)
    width = np.minimum(rng.randint(0, 200, 48), 428 - left).astype(np.int32)
    left[0], width[0] = 102, 104                         # the rendered line
    return cols, left, width


def test_regrid_matches_jax_op_by_op():
    """Against the JAX function with every op run on its own: jitted,
    XLA:CPU may fuse `group_sum - avg * min_lines` into one FMA, which the
    TPU and eager PyTorch do not."""
    cols, left, width = _regrid_inputs()
    with jax.disable_jit():
        ref = jax.vmap(jx._regrid)(jnp.asarray(cols), jnp.asarray(left),
                                   jnp.asarray(width))
    got = tx._regrid(_t(cols), _t(left), _t(width))
    for name, r, g in zip(("char_lefts", "char_sums", "n_chars", "spacing"),
                          ref, got):
        np.testing.assert_array_equal(to_np(g), np.asarray(r), err_msg=name)
    assert len(set(to_np(got[3]).tolist())) > 2          # several spacings


def _trim_inputs(n=96):
    """Random chars over real and noise bands, in the JAX function's form
    (the 16-aligned 34-wide window and its remainder) and in the port's
    (the 18 columns from the clipped left)."""
    rng = np.random.RandomState(9)
    sobel = np.asarray(jx.scharr_dx_abs_below(_expiry_frame(), 177))
    bands = [sobel[209 - 134:230 - 134].astype(np.int32),
             rng.randint(0, 4081, (21, 428)).astype(np.int32),
             rng.randint(0, 3, (21, 428)).astype(np.int32),   # ties
             np.zeros((21, 428), np.int32)]
    which = rng.randint(0, len(bands), n)
    char_left = rng.randint(-3, 432, n).astype(np.int32)
    group_top = rng.randint(-2, 256, n).astype(np.int32)
    char_width = rng.randint(10, 15, n).astype(np.int32)
    l0 = np.clip(char_left - 2, 0, 428 - 18)
    wide = np.stack([np.asarray(coarse_blocks(
        jnp.asarray(bands[w]), 34))[:, l // 16] for w, l in zip(which, l0)])
    crops = np.stack([bands[w][:, l:l + 18] for w, l in zip(which, l0)])
    return (wide.astype(np.int16), (l0 % 16).astype(np.int32), crops,
            char_left, group_top, char_width)


def test_trim_char_matches_jax():
    wide, rem, crops, char_left, group_top, char_width = _trim_inputs()
    ref = jax.jit(jax.vmap(jx._trim_char))(wide, rem, char_left, group_top,
                                           char_width)
    got = tx._trim_char(_t(crops), _t(char_left), _t(group_top),
                        _t(char_width))
    for name, r, g in zip(("top", "left", "valid"), ref, got):
        np.testing.assert_array_equal(to_np(g), np.asarray(r), err_msg=name)
    assert to_np(got[2]).any() and not to_np(got[2]).all()


@functools.lru_cache(maxsize=None)
def _slash_inputs():
    rng = np.random.RandomState(10)
    sobel = np.asarray(jx.scharr_dx_abs_below(_expiry_frame(), 177))
    bands = np.stack([sobel[t - 134:t - 134 + 21] for t in (209, 205, 160)])
    bands = np.stack([bands, rng.randint(0, 4081, bands.shape)]).astype(
        np.int32)                                         # (2, 3, 21, 428)
    roffs = rng.randint(-1, 7, (2, 3, 48)).astype(np.int32)
    lefts = rng.randint(-4, 430, (2, 3, 48)).astype(np.int32)
    lefts[0, 0, :6] = (120, 132, 146, 158, 172, 145)      # 146: the slash
    roffs[0, 0, :6] = (4, 4, 3, 4, 4, 3)
    return bands, roffs, lefts


class _NoBfloat16:
    """jax.numpy with bfloat16 read as float32: the JAX package's device
    functions without the bfloat16 rounding of their TPU lowering."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_slash_probs(bands, roffs, lefts):
    slash = {k: jnp.asarray(v) for k, v in np_params()["slash_mlp"].items()}
    return np.asarray(jax.jit(jax.vmap(
        lambda b, r, l: jx.slash_probs_conv(slash, b, r, l)))(
        bands, roffs, lefts))


def test_slash_probs_match_jax(monkeypatch):
    """The device path's slash probabilities against the JAX package's
    slash_probs_conv (its window gather and product) with its bfloat16
    rounding left out: the port computes in float32, as the compiled
    reference does (test_slash_band_weights_are_the_bf16_of_w_over_255)."""
    bands, roffs, lefts = _slash_inputs()
    monkeypatch.setattr(jx, "jnp", _NoBfloat16())
    ref = _jax_slash_probs(bands, roffs, lefts)
    got = to_np(tx.slash_probs_conv(port_params()["slash_mlp"], _t(bands),
                                    _t(roffs), _t(lefts)))
    np.testing.assert_allclose(got, ref, atol=SLASH_TOL)
    assert ref[0, 0, 2] > 0.7 and ref[0, 0, 0] < 0.7
    # no probability of these inputs within the tolerance of the threshold
    np.testing.assert_array_equal(got > 0.7, ref > 0.7)
    assert (np.abs(ref - 0.7) > SLASH_TOL).all()


def test_slash_band_weights_are_the_bf16_of_w_over_255():
    """The one place the port's device path departs from the JAX
    package's on purpose (ROADMAP.md section 3): the JAX slash_probs_conv
    rounds the band and hidden_w / 255 to bfloat16, its TPU's input type,
    and that rounding alone parts it from the port. The port's function
    given the rounded band and the rounded weights (times 255, as it
    divides the crop by 255) equals the JAX device path; given the true
    ones it parts from it by more than the tolerance."""
    bands, roffs, lefts = _slash_inputs()
    ref = _jax_slash_probs(bands, roffs, lefts)
    p = np_params()["slash_mlp"]
    w = np.asarray((jnp.asarray(p["hidden_w"]) / 255.0).astype(
        jnp.bfloat16).astype(jnp.float32))
    rounded = zoo.Mlp(*(_t(v) for v in (w * np.float32(255.0), p["hidden_b"],
                                        p["logistic_w"], p["logistic_b"])))
    bands16 = np.asarray(jnp.asarray(bands).astype(jnp.bfloat16)).astype(
        np.int32)
    got = to_np(tx.slash_probs_conv(rounded, _t(bands16), _t(roffs),
                                    _t(lefts)))
    np.testing.assert_allclose(got, ref, atol=SLASH_TOL)
    ours = to_np(tx.slash_probs_conv(port_params()["slash_mlp"], _t(bands),
                                     _t(roffs), _t(lefts)))
    assert np.abs(ours - ref).max() > SLASH_TOL


def test_device_slash_probs_equal_host():
    """slash_probs_conv (the device path's gather of each window's crop)
    against the host oracle's _slash_probs on the same rects (the crop
    sliced from the band at the clipped position)."""
    from cardio_dmz_tpu_torch.scan import expiry_seg_host as H
    from cardio_dmz_tpu_torch.scan.expiry_types import CharacterRect
    bands, roffs, lefts = _slash_inputs()
    slash = port_params()["slash_mlp"]
    got = to_np(tx.slash_probs_conv(slash, _t(bands), _t(roffs), _t(lefts)))
    tops = np.clip(roffs, 0, bands.shape[-2] - 16)
    left0 = np.clip(lefts, 0, bands.shape[-1] - 11)
    for s, i in np.ndindex(bands.shape[:2]):
        rects = [CharacterRect(int(t), int(l), 0)
                 for t, l in zip(tops[s, i], left0[s, i])]
        np.testing.assert_allclose(
            got[s, i], H._slash_probs(slash, bands[s, i], rects), atol=TOL,
            err_msg=f"{s}, {i}")


def test_expiry_conv_matrices_equal_jax():
    """The folded conv matrices are the ones apply_expiry_conv_mm builds."""
    p = np_params()["expiry_conv"]
    m1, m2 = zoo.expiry_conv_matrices(p["conv1_w"], p["conv2_w"])
    c1_idx, c1_mask = jzoo._exp_c1_tables()
    ref1 = (p["conv1_w"].reshape(50, 25)[:, c1_idx] * c1_mask)[
        :, :, jzoo._pool_perm((20, 14), (2, 2))]
    np.testing.assert_array_equal(
        m1, ref1.transpose(1, 0, 2).reshape(176, 50 * 280))
    c2_idx, c2_mask = jzoo._exp_c2_tables()
    ref2 = (p["conv2_w"].reshape(40, 50, 25)[:, :, c2_idx] * c2_mask)[
        :, :, :, jzoo._pool_perm((6, 3), (2, 3))]
    np.testing.assert_array_equal(
        m2, ref2.transpose(1, 2, 0, 3).reshape(3500, 720))
