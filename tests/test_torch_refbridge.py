"""The port's compiled-reference bridge (cardio_dmz_tpu_torch.refbridge):
the build from the objects under native/refshim/build/ (reused, raising
with g++'s output when a link fails, never touching native/), what
missing() reports, the oracle's model self-check, the ctypes layouts
against the JAX package's wrapper, the record adapters,
data/ref_session.npz as the C++ writes it today, and chip_smoke.py phase
23's session and expiry-window replay of it on the CPU."""

import ctypes
import functools
import importlib
import os
import shutil

import numpy as np
import pytest
import torch

import torch_fixture as fx
from cardio_dmz_tpu.refbridge import oracle as jax_oracle
from cardio_dmz_tpu_torch import refbridge
from cardio_dmz_tpu_torch.models import load_all_params
from cardio_dmz_tpu_torch.ops.cuda._build import BUILD_DIR
from cardio_dmz_tpu_torch.refbridge import oracle as port_oracle
from cardio_dmz_tpu_torch.scan import scan_card_image
from cardio_dmz_tpu_torch.scan.expiry_types import (
    CharacterRect, ExpiryPattern, GroupedRects)

# the module, which the package's build() function shadows as an attribute
rbuild = importlib.import_module("cardio_dmz_tpu_torch.refbridge.build")

needs_reference = pytest.mark.skipif(
    not refbridge.available(),
    reason="compiled reference unavailable: "
           + "; ".join(refbridge.missing()))


@functools.lru_cache(maxsize=None)
def _oracle():
    return refbridge.RefOracle.shared()


@needs_reference
def test_build_links_from_objects_and_reuses(tmp_path):
    path = refbridge.build(out_dir=str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("_refdmz_")
    stamp = os.stat(path).st_mtime_ns
    assert refbridge.build(out_dir=str(tmp_path)) == path
    assert os.stat(path).st_mtime_ns == stamp      # reused, not relinked
    assert refbridge.RefOracle(path).models_selfcheck()
    default = refbridge.build()
    assert os.path.dirname(default) == BUILD_DIR
    assert os.path.basename(default) == os.path.basename(path)


@needs_reference
def test_build_without_reference_checkout_links_the_objects(tmp_path,
                                                             monkeypatch):
    """The build reads nothing outside the checkout: a reference tree
    named by CARDIO_REFERENCE_ROOT (the JAX package's setting) and holding
    a unity build changes neither what missing() reports nor the library,
    which still links from the committed objects."""
    root = tmp_path / "reference"
    root.mkdir()
    (root / "dmz_all.cpp").write_text("// a unity build of nothing\n")
    want = refbridge.build(out_dir=str(tmp_path / "before"))
    monkeypatch.setenv("CARDIO_REFERENCE_ROOT", str(root))
    assert refbridge.missing() == []
    path = refbridge.build(out_dir=str(tmp_path / "out"))
    assert os.path.basename(path) == os.path.basename(want)
    assert sorted(os.listdir(tmp_path / "out")) == [os.path.basename(path)]


@needs_reference
@pytest.mark.parametrize("absent", rbuild.OBJECTS)
def test_failed_link_raises_with_gxx_output(tmp_path, absent):
    objects = tmp_path / "objects"
    objects.mkdir()
    for name in rbuild.OBJECTS:
        if name != absent:
            shutil.copy(os.path.join(rbuild.OBJECTS_DIR, name), objects)
    before = sorted(os.listdir(rbuild.OBJECTS_DIR))
    with pytest.raises(RuntimeError, match="refshim build failed") as err:
        refbridge.build(objects_dir=str(objects), out_dir=str(tmp_path))
    assert absent in str(err.value)               # g++'s own complaint
    assert "No such file" in str(err.value)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".so")]
    assert sorted(os.listdir(rbuild.OBJECTS_DIR)) == before


@needs_reference
def test_corrupt_object_raises(tmp_path):
    objects = tmp_path / "objects"
    objects.mkdir()
    for name in rbuild.OBJECTS:
        shutil.copy(os.path.join(rbuild.OBJECTS_DIR, name), objects)
    (objects / "cvbackend.o").write_bytes(b"not an object file")
    with pytest.raises(RuntimeError, match="cvbackend.o"):
        refbridge.build(objects_dir=str(objects), out_dir=str(tmp_path))


def test_missing_names_each_prerequisite(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(rbuild, "OBJECTS_DIR", str(tmp_path / "objects"))
    monkeypatch.setattr(rbuild, "OPENCV_LIBS", ("no_such_opencv_lib",))
    missing = refbridge.missing()
    assert any("no C++ compiler" in m for m in missing)
    assert any("libno_such_opencv_lib" in m for m in missing)
    assert any(all(o in m for o in rbuild.OBJECTS) for m in missing)
    assert not refbridge.available()


@needs_reference
def test_models_selfcheck():
    assert _oracle().models_selfcheck()


@pytest.mark.parametrize("name", ["_RefGroup", "_RefFrame"])
def test_layouts_match_the_jax_wrapper(name):
    """native/refshim/oracle.cpp's RefGroup / RefFrame: the same fields,
    offsets and sizes as the JAX package's wrapper, which the committed
    objects match."""
    ours, theirs = getattr(port_oracle, name), getattr(jax_oracle, name)
    assert ctypes.sizeof(ours) == ctypes.sizeof(theirs)
    assert [f for f, _ in ours._fields_] == [f for f, _ in theirs._fields_]
    for field, ctype in ours._fields_:
        assert getattr(ours, field).offset == getattr(theirs, field).offset
        assert ctypes.sizeof(ctype) == ctypes.sizeof(
            dict(theirs._fields_)[field])
    assert (port_oracle.REF_MAX_GROUPS, port_oracle.REF_MAX_CHARS) == \
        (jax_oracle.REF_MAX_GROUPS, jax_oracle.REF_MAX_CHARS) == (12, 48)


def _group():
    g = GroupedRects(top=212, left=118, width=70, height=16,
                     character_width=11, pattern=ExpiryPattern.MM_S_YY,
                     recently_seen_count=2, total_seen_count=5)
    g.character_rects = [CharacterRect(212 + i % 2, 118 + 13 * i, 900 + i)
                         for i in range(5)]
    g.scores = np.random.RandomState(0).rand(11, 10).astype(np.float32)
    return g


def test_group_adapters_round_trip():
    g = _group()
    ref = refbridge.group_to_ref(g)
    assert (ref.char_tops, ref.char_lefts, ref.char_sums) == (
        [r.top for r in g.character_rects],
        [r.left for r in g.character_rects],
        [r.sum for r in g.character_rects])
    back = refbridge.group_from_ref(ref)
    for field in ("top", "left", "width", "height", "character_width",
                  "pattern", "recently_seen_count", "total_seen_count",
                  "character_rects"):
        assert getattr(back, field) == getattr(g, field), field
    np.testing.assert_array_equal(back.scores, g.scores)
    # and through the C struct the library reads and writes
    via_c = refbridge.group_from_ref(
        refbridge.RefGroupResult.from_c(ref.to_c()))
    assert via_c.character_rects == g.character_rects
    np.testing.assert_array_equal(via_c.scores, g.scores)


def test_corner_adapters_round_trip():
    pts = np.random.RandomState(1).uniform(0, 600, (3, 4, 2)).astype(
        np.float32)
    found = np.array([True, False, True])
    cp = refbridge.corner_points(pts, found)
    got_found, got = refbridge.corner_array(cp)
    np.testing.assert_array_equal(got, pts)
    np.testing.assert_array_equal(got_found, found)
    np.testing.assert_array_equal(cp.bottom_left.numpy(), pts[:, 2])


@needs_reference
def test_frame_records_agree_on_a_rendered_card():
    """The port's FrameResult and the oracle's RefFrameResult meet in one
    record form: equal on a rendered card, and the record's digits are
    the oracle's own."""
    import synthetic
    y = np.asarray(synthetic.render_frame("4111111111111111", seed=2),
                   np.uint8)
    ref = _oracle().scan_card_image(y, scan_expiry=False)
    rec = refbridge.ref_frame_record(ref)
    assert list(rec.digits) == ref.digits
    ours = refbridge.frame_records(scan_card_image(
        load_all_params("cpu"), torch.from_numpy(y[None])))[0]
    assert ours.same_segmentation(rec) and ours.digits == rec.digits
    np.testing.assert_allclose(ours.scores, rec.scores, atol=2e-4)
    offsets = list(rec.hseg_offsets) + [0] * (16 - rec.hseg_n_offsets)
    again = refbridge.make_record(
        rec.usable, rec.vseg_y_offset, rec.vseg_pattern_type,
        rec.hseg_n_offsets, offsets, rec.hseg_number_width, rec.scores)
    assert again[:-1] == rec[:-1]
    np.testing.assert_array_equal(again.scores, rec.scores)


@needs_reference
def test_ref_fixture_is_current():
    """data/ref_session.npz holds what the compiled reference answers
    today to the cases it records, and the SHA-256 of what the renderer
    draws."""
    with np.load(fx.REF_FIXTURE) as f:
        stored = {k: f[k] for k in f.files}
    fresh = fx.ref_fixture_arrays()
    assert stored.keys() == fresh.keys()
    for key, value in fresh.items():
        np.testing.assert_array_equal(stored[key], value, err_msg=key)


def test_reference_sessions_and_windows_replay_on_cpu():
    """chip_smoke.py phase 23's (b) on the CPU, from the fixture alone (no
    oracle): every session's PAN and date on the host and device paths,
    and the device expiry segmentation's windows on every frame of the
    expiry sessions, equal to the C++'s; session 50 of the default sweep
    among them, whose slash a bfloat16 MLP reads above 0.7."""
    import collections
    import chip_smoke
    fixture = chip_smoke.load_npz(fx.REF_FIXTURE)
    _, _, pan_sessions, expiry_sessions, _ = chip_smoke.draw_ref_inputs(
        fixture)
    params = load_all_params("cpu")
    bad, n = chip_smoke.reference_sessions(params, fixture, pan_sessions,
                                           expiry_sessions, "cpu")
    assert bad == [] and n == len(pan_sessions) + len(expiry_sessions)
    counts = collections.Counter()
    assert chip_smoke.reference_expiry_windows(
        params, fixture, expiry_sessions, counts, "cpu") == []
    assert counts["expiry_frames"] == expiry_sessions.shape[0] * 16
    assert counts["expiry_windows"] > 0
    assert list(fixture["expiry_s"][-len(chip_smoke.REF_SWEEP_EXPIRY):]) == \
        list(chip_smoke.REF_SWEEP_EXPIRY)
