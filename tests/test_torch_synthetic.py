"""The port's PIL-free card renderer (cardio_dmz_tpu_torch/synthetic.py)
bit for bit against the JAX package's synthetic.py, and the float warp of
ops/warp.py (calc_persp_transform, warp_perspective, unwarp_card's
"gather" method) against the JAX package's within a stated tolerance.

The port side runs with `import PIL` made to fail. The warp's tolerance:
another LU, inverse and order of sums than XLA's flip a few 1/32
coordinate bins; one flip moves a pixel by at most 255/32 ~ 8 levels on
one axis and ~16 on both, so at most WARP_PIXEL_SHARE of the pixels may
differ, each by at most WARP_MAX_LEVELS.
"""

import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a worker)
from cardio_dmz_tpu import synthetic as jax_synthetic
from cardio_dmz_tpu.ops import warp as jax_warp
from cardio_dmz_tpu_torch import synthetic
from cardio_dmz_tpu_torch.ops import warp

WARP_PIXEL_SHARE = 1e-4
WARP_MAX_LEVELS = 16
# the float branch on a [0, 1] image: a coordinate a few ulps off (~1e-4
# px at 640) moves a bilinear value by about as much
FLOAT_WARP_ATOL = 1e-3
GUIDE = np.float32([[106, 105], [534, 105], [106, 375], [534, 375]])
CARD_SRC = np.float32([[0, 0], [427, 0], [0, 269], [427, 269]])


def without_pil():
    """`import PIL` fails inside the block."""
    return mock.patch.dict(sys.modules, {"PIL": None})


@pytest.mark.parametrize("n", [1, 5, 14, 15])
def test_luhn_check_digit_matches_jax(n):
    rng = np.random.RandomState(n)
    for _ in range(50):
        prefix = [int(d) for d in rng.randint(0, 10, n)]
        assert synthetic.luhn_check_digit(prefix) == \
            jax_synthetic.luhn_check_digit(prefix)


@pytest.mark.parametrize("length,prefix", [(16, (4,)), (15, (3, 4)),
                                           (16, (5, 1))])
def test_safe_pan_matches_jax(length, prefix):
    for seed in range(20):
        ours, theirs = np.random.default_rng(seed), \
            np.random.default_rng(seed)
        with without_pil():
            got = synthetic.safe_pan(ours, length=length, prefix=prefix)
        assert got == jax_synthetic.safe_pan(theirs, length=length,
                                             prefix=prefix)
        assert ours.integers(1 << 30) == theirs.integers(1 << 30)


@pytest.mark.parametrize("style", ["flat", "emboss"])
def test_render_digit_cell_matches_jax(style):
    for digit in range(10):
        for seed, fill, bg in ((0, 60, 140), (7, 30, 180), (123, 90, 100)):
            want = jax_synthetic.render_digit_cell(digit, seed=seed,
                                                   fill=fill, bg=bg,
                                                   style=style)
            with without_pil():
                got = synthetic.render_digit_cell(digit, seed=seed, fill=fill,
                                                  bg=bg, style=style)
            np.testing.assert_array_equal(got, want, err_msg=f"{digit}")


FRAME_CASES = {
    "visa_default": dict(pan="4111111111111111"),
    "amex_default": dict(pan="340000000000009"),
    "visa_emboss": dict(pan="4556737586899855", style="emboss"),
    "amex_emboss": dict(pan="371449635398431", style="emboss", y0=140),
    "narrow_noisy": dict(pan="4012888888881881", width=17.5, offset=25,
                         noise=3, seed=11),
    "wide_quiet": dict(pan="5555555555554444", width=19.3, offset=44, noise=0,
                       seed=5),
    "shaded_dim": dict(pan="4000056655665556", shading=29, brightness=-25,
                       contrast=0.85, seed=997),
    "bright_contrast": dict(pan="378282246310005", brightness=25,
                            contrast=1.15, shading=7, y0=231, seed=4),
    "emboss_photometric": dict(pan="4111111111111111", style="emboss",
                               width=18.5, noise=2, brightness=-20,
                               contrast=1.05, shading=15, seed=7700),
}


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_render_frame_matches_jax(case):
    kwargs = FRAME_CASES[case]
    want = jax_synthetic.render_frame(**kwargs)
    with without_pil():
        got = synthetic.render_frame(**kwargs)
    assert got.dtype == np.uint8 and got.shape == (270, 428)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("style", ["flat", "emboss"])
def test_draw_expiry_slash_matches_jax(style):
    card = jax_synthetic.render_frame("4111111111111111", seed=3)
    for top, left, w, h, thick in ((212, 150, 7, 15, 3), (200, 90, 6, 13, 2)):
        want = jax_synthetic.draw_expiry_slash(card, top, left, w=w, h=h,
                                               thick=thick, style=style)
        with without_pil():
            got = synthetic.draw_expiry_slash(card, top, left, w=w, h=h,
                                              thick=thick, style=style)
        np.testing.assert_array_equal(got, want)
    assert not np.shares_memory(got, card)


def _quads(n, spread=7.5, seed=0):
    rng = np.random.default_rng(seed)
    return GUIDE + rng.uniform(-spread, spread, (n, 4, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_placements():
    """The JAX package's calc_persp_transform + warp_perspective on six
    quads around the guide rect, jitted and vmapped as the camera sweep
    runs them: (cards, quads, homographies, previews)."""
    rng = np.random.default_rng(3)
    cards = np.stack([jax_synthetic.render_frame(
        jax_synthetic.safe_pan(rng), seed=s, noise=2) for s in range(6)])
    quads = _quads(6)

    def place(card, quad):
        h = jax_warp.calc_persp_transform(CARD_SRC, quad)
        return h, jax_warp.warp_perspective(card, h, (480, 640))

    h, previews = jax.jit(jax.vmap(place))(cards, quads)
    return cards, quads, np.array(h), np.array(previews)


def test_calc_persp_transform_matches_jax(jax_placements):
    _, quads, want, _ = jax_placements
    got = warp.calc_persp_transform(torch.from_numpy(CARD_SRC),
                                    torch.from_numpy(quads)).numpy()
    assert got.shape == (6, 3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    # each maps the card's corners onto its quad
    corners = np.concatenate([CARD_SRC, np.ones((4, 1), np.float32)], 1)
    mapped = np.einsum("src,kc->skr", got.astype(np.float64), corners)
    np.testing.assert_allclose(mapped[..., :2] / mapped[..., 2:], quads,
                               atol=1e-2)


def assert_warp_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = np.count_nonzero(diff) / diff.size
    assert share <= WARP_PIXEL_SHARE and diff.max() <= WARP_MAX_LEVELS, \
        (np.count_nonzero(diff), diff.size, diff.max())


def test_warp_perspective_fixed_point_matches_jax(jax_placements):
    cards, quads, h, want = jax_placements
    cards_t = torch.from_numpy(cards)
    fed = warp.warp_perspective(cards_t, torch.from_numpy(h), (480, 640))
    assert fed.dtype == torch.uint8 and fed.shape == (6, 480, 640)
    assert_warp_close(fed.numpy(), want)
    own = warp.warp_perspective(cards_t, warp.calc_persp_transform(
        torch.from_numpy(CARD_SRC), torch.from_numpy(quads)), (480, 640))
    assert_warp_close(own.numpy(), want)
    # one homography for the whole batch, as the JAX function takes it
    one = warp.warp_perspective(cards_t[:2], torch.from_numpy(h[0]),
                                (480, 640))
    assert_warp_close(one.numpy(), np.asarray(jax.vmap(
        lambda c: jax_warp.warp_perspective(c, h[0], (480, 640)))(
            cards[:2])))


def test_warp_perspective_float_branch_matches_jax(jax_placements):
    cards, _, h, _ = jax_placements
    image = cards[0].astype(np.float32) / 255.0
    want = np.asarray(jax.jit(lambda c, m: jax_warp.warp_perspective(
        c, m, (480, 640), fill_value=0.25))(image, h[0]))
    got = warp.warp_perspective(torch.from_numpy(image), torch.from_numpy(
        h[0]), (480, 640), fill_value=0.25).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_WARP_ATOL)
    # an integer image through the float weights, rounded back
    want_u8 = np.asarray(jax_warp.warp_perspective(
        jnp.asarray(cards[0]), h[0], (480, 640), fixed_point=False))
    got_u8 = warp.warp_perspective(torch.from_numpy(cards[0]),
                                   torch.from_numpy(h[0]), (480, 640),
                                   fixed_point=False).numpy()
    assert got_u8.dtype == np.uint8
    assert_warp_close(got_u8, want_u8)


def test_unwarp_card_gather_matches_jax(jax_placements):
    """unwarp_card(method="gather") rectifies a preview's quad as the JAX
    package's does, and the exact method stays the default."""
    _, quads, _, previews = jax_placements
    frames = torch.from_numpy(previews[:3])
    quads = torch.from_numpy(quads[:3])
    want = np.stack([np.asarray(jax_warp.unwarp_card(
        jnp.asarray(f), q, method="gather")) for f, q in zip(
            previews[:3], quads.numpy())])
    got = warp.unwarp_card(frames, quads, method="gather")
    assert got.shape == (3, 270, 428) and got.dtype == torch.uint8
    assert_warp_close(got.numpy(), want)
    assert torch.equal(warp.unwarp_card(frames, quads), warp.unwarp_card(
        frames, quads, method="exact"))
    with pytest.raises(ValueError):
        warp.unwarp_card(frames, quads, method="dense")
    with pytest.raises(ValueError):
        warp.unwarp_card(frames, quads, method="gather", transpose=True)
