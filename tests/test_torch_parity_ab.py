"""The port's parity sweep and emboss tuner against the compiled C++
(cardio_dmz_tpu_torch/tools/parity_ab.py, tune_emboss.py): the sweep at a
small size prints the JAX tool's JSON keys with every agreement at 100%,
the tuner prints its BEST line and refuses a font size without glyphs;
the renderer's relief arguments draw what the JAX renderer draws with its
module globals patched; the preview paste lands the card's corners on the
quad; and the camera cases of all four orientations agree with the C++."""

import ast
import functools
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from cardio_dmz_tpu import synthetic as jax_synthetic
from cardio_dmz_tpu_torch import refbridge, synthetic
from cardio_dmz_tpu_torch.tools import parity_ab as ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_reference = pytest.mark.skipif(
    not refbridge.available(),
    reason="compiled reference unavailable: "
           + "; ".join(refbridge.missing()))


def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _jax_report_keys():
    """The keys of the report dict the JAX tool's main() prints."""
    path = os.path.join(REPO, "cardio_dmz_tpu", "tools", "parity_ab.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "report" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no report dict in the JAX tool")


@needs_reference
def test_parity_ab_small_sweep_agrees():
    proc = _run("cardio_dmz_tpu_torch.tools.parity_ab", "--device", "cpu",
                "--frames", "8", "--sessions", "2", "--expiry-sessions", "2",
                "--camera-frames", "4", "--json")
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(report) == _jax_report_keys()
    shares = {k: v for k, v in report.items() if "agreement" in k}
    assert len(shares) == 11
    assert all(v == 100.0 for v in shares.values()), shares
    assert report["camera_corner_exact_pct"] == 100.0
    assert report["camera_warp_close_pct"] == 100.0
    assert (report["frames"], report["pan_sessions"],
            report["expiry_sessions"], report["camera_frames"]) == (8, 2, 2, 4)
    assert report["expiry_sessions_ref_read"] >= 1


def test_parity_ab_defaults_to_the_card():
    proc = _run("cardio_dmz_tpu_torch.tools.parity_ab", "--frames", "1",
                "--sessions", "0", "--expiry-sessions", "0",
                "--camera-frames", "0")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


@needs_reference
def test_tune_emboss_prints_best():
    proc = _run("cardio_dmz_tpu_torch.tools.tune_emboss", "--device", "cpu",
                "--sessions", "1", "--frames", "3", "--av", "40", "--ah", "30",
                "--tint", "0")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("av=40 ah=30 tint=0 fs=18: reads ")
    assert lines[-1].startswith("BEST: ((")
    assert lines[-1].endswith("(40, 30, 0, 18))")


def test_tune_emboss_refuses_a_size_without_glyphs():
    proc = _run("cardio_dmz_tpu_torch.tools.tune_emboss", "--device", "cpu",
                "--fsize", "18,16")
    assert proc.returncode != 0
    assert "[16]" in proc.stderr and "expiry_glyphs.npz" in proc.stderr
    assert "[18]" in proc.stderr


@pytest.mark.parametrize("relief", [(40, 30, 0), (70, 60, -25)])
def test_relief_arguments_match_the_jax_globals(relief):
    """relief=(av, ah, tint) draws what the JAX renderer draws with
    EMBOSS_AV / AH / TINT patched, as its tune_emboss patches them; None
    draws the defaults."""
    av, ah, tint = relief
    with mock.patch.multiple(jax_synthetic, EMBOSS_AV=av, EMBOSS_AH=ah,
                             EMBOSS_TINT=tint):
        want_pan = jax_synthetic.render_frame("4111111111111111", seed=3,
                                              style="emboss")
        want_exp = jax_synthetic.render_frame_with_expiry(
            "4111111111111111", "08/28", seed=3, style="emboss")
    np.testing.assert_array_equal(synthetic.render_frame(
        "4111111111111111", seed=3, style="emboss", relief=relief), want_pan)
    np.testing.assert_array_equal(synthetic.render_frame_with_expiry(
        "4111111111111111", "08/28", seed=3, style="emboss", relief=relief),
        want_exp)
    assert not np.array_equal(synthetic.render_frame(
        "4111111111111111", seed=3, style="emboss"), want_pan)


def test_paste_card_lands_the_corners_on_the_quad():
    card = np.zeros((270, 428), np.uint8)
    card[0, 0], card[0, 427], card[269, 0], card[269, 427] = 200, 201, 202, 203
    quad = np.float64([[100, 110], [530, 100], [110, 380], [540, 370]])
    preview = synthetic.paste_card(card, quad)
    assert preview.shape == (480, 640)
    assert [int(preview[y, x]) for x, y in quad.astype(int)] == \
        [200, 201, 202, 203]
    assert preview[0, 0] == 50          # the background where no card lands
    rect = synthetic.paste_card(
        np.full((270, 428), 7, np.uint8),
        np.float32(ab.GUIDE_QUADS[3]))
    assert (rect[106:374, 107:533] == 7).all() and rect[100, 100] == 50


@functools.lru_cache(maxsize=None)
def _camera_cases():
    return ab.camera_cases(np.random.default_rng(5), 8, (1, 2, 3, 4))


@needs_reference
@pytest.mark.parametrize("orientation", [1, 2, 3, 4])
def test_camera_cases_agree_with_the_reference(orientation):
    """Each orientation's previews: found and corners (1e-2 px) agree, and
    transform_card from the reference's corners is its card bit for bit."""
    oracle = refbridge.RefOracle.shared()
    cases = [c for c in _camera_cases() if c["orientation"] == orientation]
    y, cb = map(np.stack, zip(*[ab.render_camera_case(c) for c in cases]))
    found, corners, _ = ab.port_camera(y, cb, orientation, "cpu")
    for k in range(len(cases)):
        ok, ref_corners, ref_card = ab.ref_camera(oracle, y[k], cb[k],
                                                  orientation)
        assert ok and found[k]
        np.testing.assert_allclose(corners[k], ref_corners, atol=1e-2)
        card = ab.port_cards_from_corners(y[k:k + 1], ref_corners[None],
                                          orientation, "cpu")[0]
        np.testing.assert_array_equal(card, ref_card)
