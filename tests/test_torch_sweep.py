"""The port's tools/accuracy_sweep.py against the JAX package's.

Rectified sweep: the sessions' frames and PANs bit for bit, and at the
JAX test's size (24 sessions of 8 frames, batch 24, seed 7) equal reports
and equal reads, session for session. Camera sweep: the perspective quads
bit for bit, the previews within the float warp's tolerance
(test_torch_synthetic.py), and at 4 sessions of 4 frames no wrong read,
the JAX report's keys and the JAX package's reads. The JAX side runs its
own tool, unchanged, through torch_fixture.recording_sweep (lru_cached).

data/sweep_session.npz holds the JAX sweeps at their default sizes; it
is kept current by holding its first 24 rectified sessions against the
JAX run_sweep at (24, 8, 24) with the fixture's seed: session k of a
batch-64 run is session k of a batch-24 run while k < 24 (each frame is
seeded 997 * s + t, s its index in the batch).
"""

import json
import sys
from unittest import mock

import numpy as np
import torch

import torch_parity  # noqa: F401  (one torch thread a worker)
from test_torch_synthetic import WARP_MAX_LEVELS, WARP_PIXEL_SHARE
from torch_fixture import SWEEP, SWEEP_FIXTURE, jax_camera_sweep, jax_sweep
from cardio_dmz_tpu.tools import accuracy_sweep as jax_tool
from cardio_dmz_tpu_torch.ops import warp as port_warp
from cardio_dmz_tpu_torch.parallel.graphed import WARMUP_CALLS
from cardio_dmz_tpu_torch.tools import accuracy_sweep as tool

CAMERA_RUN = (4, 4, 4, 2026)       # sessions, frames, batch, seed


def assert_previews_close(got, want):
    """The float warp's tolerance (test_torch_synthetic.py), after the
    placement's where(warped > 0, warped, 50): where one side's warp left
    a border pixel at 0 and the other's gave it a value v <= 16, the
    previews read 50 against v."""
    got, want = got.astype(np.int32), want.astype(np.int32)
    differ = got != want
    assert np.count_nonzero(differ) / differ.size <= WARP_PIXEL_SHARE
    a, b = got[differ], want[differ]
    border = ((a == 50) & (b <= WARP_MAX_LEVELS)) | (
        (b == 50) & (a <= WARP_MAX_LEVELS))
    assert np.all((np.abs(a - b) <= WARP_MAX_LEVELS) | border), \
        sorted(set(zip(a.tolist(), b.tolist())))[:20]


def test_render_sessions_match_jax():
    want_frames, want_pans = jax_tool.render_sessions(
        np.random.default_rng(7), 5, 3)
    with mock.patch.dict(sys.modules, {"PIL": None}):
        frames, pans = tool.render_sessions(np.random.default_rng(7), 5, 3)
    assert pans == want_pans
    np.testing.assert_array_equal(frames, want_frames)


def test_run_sweep_matches_jax():
    want, want_pans, want_reads = jax_sweep(24, 8, 24, 7)
    report = tool.run_sweep(24, 8, 24, seed=7, quiet=True, device="cpu")
    assert report == want
    assert report["accepted"] >= 5 and report["accepted_correct_pct"] == \
        100.0, report
    pans, reads = tool.sweep_reads(24, 8, 24, seed=7, quiet=True,
                                   device="cpu")
    assert pans == want_pans
    assert reads == want_reads


def test_sweep_fixture_is_current():
    n, frames, _, seed = SWEEP
    want, want_pans, want_reads = jax_sweep(24, frames, 24, seed)
    with np.load(SWEEP_FIXTURE) as fixture:
        assert list(fixture["rect_pans"][:24]) == want_pans
        assert list(fixture["rect_complete"][:24]) == [
            r is not None for r in want_reads]
        assert list(fixture["rect_reads"][:24]) == [r or ""
                                                    for r in want_reads]
        for prefix in ("rect", "camera"):
            report = json.loads(str(fixture[f"{prefix}_report"]))
            assert report["accepted"] == fixture[f"{prefix}_complete"].sum()
            assert set(report) - {"mode"} == set(want)
        assert json.loads(str(fixture["rect_report"]))["sessions"] == n
    # ... and the port reads those sessions as the JAX package does
    assert tool.sweep_reads(24, frames, 24, seed, quiet=True,
                            device="cpu") == (want_pans, want_reads)


def test_render_camera_sessions_match_jax():
    """The quads bit for bit; the previews, placed with the float warp,
    within its tolerance (assert_previews_close)."""
    n, frames, batch, seed = CAMERA_RUN
    _, want_pans, _, want_previews, want_quads = jax_camera_sweep(
        *CAMERA_RUN)
    seen, solve = [], port_warp.calc_persp_transform

    def record(src, quad):
        seen.append(quad.clone())    # the graph's static input, reused
        return solve(src, quad)

    with mock.patch.object(port_warp, "calc_persp_transform", record):
        previews, pans = tool.render_camera_sessions(
            np.random.default_rng(seed), n, frames, batch, device="cpu")
    # the graphed placement runs its first batch WARMUP_CALLS more times
    assert all(torch.equal(q, seen[0]) for q in seen[:WARMUP_CALLS + 1])
    quads = torch.cat(seen[WARMUP_CALLS:])
    assert pans == want_pans
    np.testing.assert_array_equal(quads.numpy(), want_quads)
    assert previews.shape == (n, frames, 480, 640)
    assert_previews_close(previews, want_previews.reshape(previews.shape))


def test_run_camera_sweep_matches_jax():
    want, want_pans, want_reads, _, _ = jax_camera_sweep(*CAMERA_RUN)
    report = tool.run_camera_sweep(*CAMERA_RUN, quiet=True, device="cpu")
    assert set(report) == set(want) and report["mode"] == "camera"
    assert report["wrong_reads"] == []
    pans, reads = tool.camera_sweep_reads(*CAMERA_RUN, quiet=True,
                                          device="cpu")
    assert pans == want_pans
    assert reads == want_reads
