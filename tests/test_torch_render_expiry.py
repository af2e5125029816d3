"""The port's PIL-free dated-card renderer (synthetic.render_text_small,
render_frame_with_expiry) bit for bit against the JAX package's, which
draws with PIL; the glyph table it composites (data/expiry_glyphs.npz)
against PIL's own rasterizing here; and utils/debug_images'
dump_expiry_stages against the JAX package's: the same files, with the
same pixels as PIL decodes them. The port side runs with `import PIL` made
to fail."""

import os
import sys
from unittest import mock

import numpy as np
import pytest
from PIL import Image

import torch_fixture as fx
import torch_parity  # noqa: F401  (one torch thread a worker)
from cardio_dmz_tpu import synthetic as jax_synthetic
from cardio_dmz_tpu.models.weights import load_all_params as jax_params
from cardio_dmz_tpu.utils import debug_images as jax_debug_images
from cardio_dmz_tpu_torch import synthetic
from cardio_dmz_tpu_torch.models.weights import load_all_params
from cardio_dmz_tpu_torch.utils import debug_images

# the texts the JAX package's tests draw (tests/test_expiry*.py)
TEXTS = ("08/28", "11/29", "01/29 08/31")


def without_pil():
    """`import PIL` fails inside the block."""
    return mock.patch.dict(sys.modules, {"PIL": None})


@pytest.mark.parametrize("style", ["flat", "emboss"])
@pytest.mark.parametrize("text", TEXTS + ("0123456789",))
def test_render_text_small_matches_jax(text, style):
    for seed in range(6):
        rng = np.random.RandomState(seed)
        y = rng.randint(0, 256, (270, 428)).astype(np.uint8)
        # positions across the card, its borders included
        y0, x0 = int(rng.randint(-4, 262)), int(rng.randint(-8, 420))
        fill, size = int(rng.randint(0, 256)), (15, 20)[seed % 2]
        spacing = (None, 12, 14)[seed % 3]
        want = jax_synthetic.render_text_small(
            y, text, y0, x0, size=size, fill=fill, spacing=spacing,
            style=style)
        with without_pil():
            got = synthetic.render_text_small(
                y, text, y0, x0, size=size, fill=fill, spacing=spacing,
                style=style)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{seed} at ({y0}, {x0})")


@pytest.mark.parametrize("style", ["flat", "emboss"])
def test_render_frame_with_expiry_matches_jax(style):
    cases = [dict(pan="4111111111111111", expiry_text="08/28",
                  **fx.DATED_CARD),
             dict(pan="4530504390541813", expiry_text="11/29", y0=140,
                  expiry_x=100, noise=2, expiry_size=20),
             dict(pan="340000000000009", expiry_text="01/29 08/31",
                  offset=30, expiry_y=210, expiry_spacing=14)]
    for seed, kwargs in enumerate(cases):
        want = jax_synthetic.render_frame_with_expiry(seed=seed, style=style,
                                                      **kwargs)
        with without_pil():
            got = synthetic.render_frame_with_expiry(seed=seed, style=style,
                                                     **kwargs)
        np.testing.assert_array_equal(got, want, err_msg=kwargs["pan"])


def test_the_fixture_dated_cards_render_bit_for_bit():
    """chip_smoke.py phase 22's check here: the expiry fixture's dated
    cards, drawn anew without PIL."""
    frames = fx.expiry_frames()
    with without_pil():
        for k, (pan, text) in enumerate(fx.EXPIRY_STREAMS[:2]):
            for t in range(frames.shape[1]):
                np.testing.assert_array_equal(
                    synthetic.render_frame_with_expiry(
                        pan, text, seed=t, **fx.DATED_CARD), frames[k, t])


def test_other_characters_raise():
    y = np.full((270, 428), 140, np.uint8)
    with pytest.raises(ValueError, match="'-'"):
        synthetic.render_text_small(y, "08-28", 200, 100)


def test_expiry_glyph_table_is_current():
    """The committed expiry_glyphs.npz holds what PIL rasterizes here."""
    with np.load(fx.EXPIRY_GLYPH_FIXTURE) as table:
        stored = {k: table[k] for k in table.files}
    fresh = fx.expiry_glyph_arrays()
    assert stored.keys() == fresh.keys()
    for key, value in fresh.items():
        np.testing.assert_array_equal(stored[key], value, err_msg=key)


def test_dump_expiry_stages_writes_the_jax_files(tmp_path):
    card = fx.expiry_frames()[0, 0]
    want = jax_debug_images.dump_expiry_stages(
        card, 150, jax_params()["slash_mlp"], str(tmp_path / "jax"))
    with without_pil():
        got = debug_images.dump_expiry_stages(
            card, 150, load_all_params("cpu")["slash_mlp"],
            str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        with Image.open(g) as gi, Image.open(w) as wi:
            assert gi.mode == wi.mode == "L"
            np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi),
                                          err_msg=os.path.basename(g))
    with Image.open(got[0]) as original:
        np.testing.assert_array_equal(np.asarray(original), card)


def test_write_png_round_trips_through_pil(tmp_path):
    gray = np.random.RandomState(0).randint(0, 256, (7, 13)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    debug_images.write_png(path, gray)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), gray)
