"""The port's host runtime: its own ctypes binding of the native frame pump
(the cases of tests/test_runtime.py, and against the JAX package's
binding), Metrics (the case of tests/test_aux.py), the small conversions
and named canny functions, the model self-check, and the serving loop of
tools/serve_demo.py on the CPU."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from cardio_dmz_tpu import ops as jops
from cardio_dmz_tpu import runtime as jruntime
from cardio_dmz_tpu_torch import ops as pops
from cardio_dmz_tpu_torch import runtime
from cardio_dmz_tpu_torch.models import all_models_pass, self_check
from cardio_dmz_tpu_torch.models.weights import MODEL_NAMES
from cardio_dmz_tpu_torch.runtime import ingest
from cardio_dmz_tpu_torch.tools import serve_demo
from torch_parity import to_np

RNG = np.random.RandomState(0)


# --- conversions -----------------------------------------------------------

def test_binding_builds_into_the_ports_build_directory():
    runtime.deinterleave_c2(np.zeros((2, 4), np.uint8))
    assert os.path.exists(ingest._SO)
    assert os.sep + os.path.join("cardio_dmz_tpu_torch", "_build") + os.sep \
        in ingest._SO
    assert ingest._SRC.endswith(os.path.join("cardio_dmz_tpu_torch", "csrc",
                                             "framepump.cpp"))


def test_deinterleave_c2_matches_numpy_and_jax_binding():
    x = RNG.randint(0, 256, (32, 128), dtype=np.uint8)
    c1, c2 = runtime.deinterleave_c2(x)
    np.testing.assert_array_equal(c1, x[:, 0::2])
    np.testing.assert_array_equal(c2, x[:, 1::2])
    r1, r2 = jruntime.deinterleave_c2(x)
    np.testing.assert_array_equal(c1, r1)
    np.testing.assert_array_equal(c2, r2)


def test_rgba_to_r_matches_numpy_and_jax_binding():
    x = RNG.randint(0, 256, (16, 64), dtype=np.uint8)
    r = runtime.rgba_to_r(x)
    np.testing.assert_array_equal(r, x[:, 0::4])
    np.testing.assert_array_equal(r, jruntime.rgba_to_r(x))


def test_ycbcr422_split_matches_numpy_and_jax_binding():
    w, h = 64, 8
    frame = RNG.randint(0, 256, h * w * 2, dtype=np.uint8)
    y, cb, cr = runtime.ycbcr422_split(frame, w, h)
    f = frame.reshape(h, w // 2, 4)
    np.testing.assert_array_equal(cb, f[:, :, 0])
    np.testing.assert_array_equal(y[:, 0::2], f[:, :, 1])
    np.testing.assert_array_equal(cr, f[:, :, 2])
    np.testing.assert_array_equal(y[:, 1::2], f[:, :, 3])
    for got, ref in zip((y, cb, cr), jruntime.ycbcr422_split(frame, w, h)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="bytes"):
        runtime.ycbcr422_split(frame[:-2], w, h)


# --- FramePump -------------------------------------------------------------

def test_framepump_basic():
    pump = runtime.FramePump(4, frame_shape=(8, 8), device="cpu")
    frames = [np.full((8, 8), i + 1, np.uint8) for i in range(4)]
    for i, f in enumerate(frames):
        pump.push(i, f, frame_id=100 + i)
    batch, ids, fresh = pump.acquire_batch()
    assert isinstance(batch, torch.Tensor)
    assert batch.dtype == torch.uint8 and batch.shape == (4, 8, 8)
    assert batch.device.type == "cpu" and not batch.is_pinned()
    assert fresh == 4
    for i in range(4):
        np.testing.assert_array_equal(batch[i].numpy(), frames[i])
        assert ids[i] == 100 + i
    _, _, fresh2 = pump.acquire_batch()
    assert fresh2 == 0
    pump.push(2, np.full((8, 8), 99, np.uint8), frame_id=200)
    batch3, ids3, fresh3 = pump.acquire_batch()
    assert fresh3 == 1
    assert int(batch3[2, 0, 0]) == 99 and ids3[2] == 200
    pump.close()


def test_framepump_matches_jax_binding():
    frames = RNG.randint(0, 256, (5, 3, 6, 10), dtype=np.uint8)
    got_pump = runtime.FramePump(3, frame_shape=(6, 10), device="cpu")
    ref_pump = jruntime.FramePump(3, frame_shape=(6, 10))
    for t in range(5):
        for s in range(3):
            if (s + t) % 2:
                got_pump.push(s, frames[t, s], frame_id=t + 1)
                ref_pump.push(s, frames[t, s], frame_id=t + 1)
        got, got_ids, got_fresh = got_pump.acquire_batch()
        ref, ref_ids, ref_fresh = ref_pump.acquire_batch()
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got_ids, ref_ids)
        assert got_fresh == ref_fresh
    got_pump.close()
    ref_pump.close()


def test_framepump_alternates_two_buffers():
    """A batch stays valid while the next one is acquired: the step's
    upload may still read it."""
    pump = runtime.FramePump(1, frame_shape=(2, 2), device="cpu")
    pump.push(0, np.full((2, 2), 1, np.uint8), 1)
    first, _, _ = pump.acquire_batch()
    pump.fence()                                  # nothing to mark on the CPU
    pump.push(0, np.full((2, 2), 2, np.uint8), 2)
    second, _, _ = pump.acquire_batch()
    assert first.data_ptr() != second.data_ptr()
    assert int(first[0, 0, 0]) == 1 and int(second[0, 0, 0]) == 2
    third, _, _ = pump.acquire_batch()
    assert third.data_ptr() == first.data_ptr()
    pump.close()


def test_framepump_bad_stream_and_shape():
    pump = runtime.FramePump(2, frame_shape=(4, 4), device="cpu")
    with pytest.raises(IndexError):
        pump.push(5, np.zeros((4, 4), np.uint8), 1)
    with pytest.raises(ValueError):
        pump.push(0, np.zeros((4, 5), np.uint8), 1)
    pump.close()


def test_framepump_needs_a_device():
    with pytest.raises(TypeError):
        runtime.FramePump(2, frame_shape=(4, 4))


def test_framepump_concurrent_producers():
    """Camera threads hammer the ring while the consumer acquires batches;
    every acquired frame must be whole (one value throughout)."""
    n_streams, iters = 8, 300
    pump = runtime.FramePump(n_streams, frame_shape=(32, 32), device="cpu")
    stop = threading.Event()

    def producer(sid):
        i = 0
        while not stop.is_set():
            i += 1
            pump.push(sid, np.full((32, 32), (sid * 37 + i) % 256, np.uint8),
                      frame_id=i)

    threads = [threading.Thread(target=producer, args=(s,), daemon=True)
               for s in range(n_streams)]
    for t in threads:
        t.start()
    torn = 0
    for _ in range(iters):
        batch, _, _ = pump.acquire_batch()
        flat = batch.reshape(n_streams, -1)
        torn += int((flat != flat[:, :1]).any(dim=1).sum())
    stop.set()
    for t in threads:
        t.join(timeout=2)
    pump.close()
    assert torn == 0


# --- Metrics ---------------------------------------------------------------

def test_serving_metrics_surface():
    from cardio_dmz_tpu.runtime.metrics import Metrics as JaxMetrics
    both = [runtime.Metrics(), JaxMetrics()]
    for m in both:
        m.inc("frames_scanned", 64)
        m.inc("frames_scanned", 64)
        m.set("streams", 64)
        m.observe("step", 0.25)
        m.set("step_count", -1)
        m.set("label", "abc")
        m.set("ready", True)
    m = both[0]
    with m.time("acquire"):
        time.sleep(0.01)
    snap = m.snapshot()
    assert snap["counter_frames_scanned"] == 128
    assert snap["gauge_streams"] == 64
    assert snap["timer_step_count"] == 1 and snap["gauge_step_count"] == -1
    assert snap["timer_acquire_seconds_total"] >= 0.01
    text = m.render_text()
    assert "cardio_frames_scanned 128" in text
    assert "# TYPE cardio_frames_scanned counter" in text
    assert "cardio_step_seconds_avg" in text
    assert "abc" not in text and "cardio_ready 1" in text

    def stable(metrics):
        return [line for line in metrics.render_text().splitlines()
                if "uptime" not in line and "acquire" not in line]
    assert stable(both[0]) == stable(both[1])


# --- small conversions, canny, self-check ----------------------------------

def test_ycbcr_to_rgb_matches_jax():
    y, cb, cr = (RNG.randint(0, 256, (2, 12, 16), dtype=np.uint8)
                 for _ in range(3))
    for add_alpha in (False, True):
        got = to_np(pops.ycbcr_to_rgb(*map(torch.from_numpy, (y, cb, cr)),
                                      add_alpha=add_alpha))
        ref = np.asarray(jops.convert.ycbcr_to_rgb(y, cb, cr,
                                                   add_alpha=add_alpha))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    extremes = np.array([[[0, 255, 0, 255]]], np.uint8)
    got = to_np(pops.ycbcr_to_rgb(*(torch.from_numpy(a) for a in (
        extremes, extremes[..., ::-1].copy(), extremes))))
    np.testing.assert_array_equal(got, np.asarray(jops.convert.ycbcr_to_rgb(
        extremes, extremes[..., ::-1], extremes)))


def test_split_u8_and_deinterleave_match_jax():
    x = RNG.randint(0, 256, (3, 5, 64), dtype=np.uint8)
    for got, ref in zip(pops.split_u8(torch.from_numpy(x)),
                        jops.convert.split_u8(x)):
        np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    np.testing.assert_array_equal(
        to_np(pops.deinterleave_rgba_to_r(torch.from_numpy(x))),
        np.asarray(jops.convert.deinterleave_rgba_to_r(x)))


def _smooth_edges_image(h, w, line_row=None, line_col=None):
    """The image of tests/test_ops.py: a blurred step edge on soft noise."""
    rng = np.random.RandomState(7)
    img = rng.randint(100, 110, (h, w)).astype(np.float64)
    if line_row is not None:
        img[line_row:] += 80
    if line_col is not None:
        img[:, line_col:] += 80
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape, line", [((54, 300), {"line_row": 25}),
                                         ((40, 60), {"line_col": 33})])
def test_adaptive_canny7_matches_jax(shape, line):
    img = _smooth_edges_image(*shape, **line)
    batch = np.stack([img, img[::-1].copy()])
    edges, dx, dy = pops.adaptive_canny7(torch.from_numpy(batch))
    for i in range(2):
        ref_edges, ref_dx, ref_dy = jops.adaptive_canny7(batch[i])
        np.testing.assert_array_equal(to_np(edges[i]), np.asarray(ref_edges))
        np.testing.assert_array_equal(to_np(dx[i]), np.asarray(ref_dx))
        np.testing.assert_array_equal(to_np(dy[i]), np.asarray(ref_dy))
    one, _, _ = pops.adaptive_canny7(torch.from_numpy(img))
    np.testing.assert_array_equal(to_np(one), to_np(edges[0]))
    assert to_np(edges[0]).any()
    # precomputed derivatives are taken as they are
    again, _, _ = pops.adaptive_canny7(torch.from_numpy(batch), dx=dx, dy=dy)
    assert torch.equal(again, edges)


@pytest.mark.parametrize("low, high", [(20, 60), (5, 400)])
def test_canny7_matches_jax(low, high):
    img = _smooth_edges_image(54, 120, line_row=25)
    got = pops.canny7(torch.from_numpy(img), low, high)
    np.testing.assert_array_equal(to_np(got),
                                  np.asarray(jops.canny7(img, low, high)))


def test_self_check_passes_on_the_cpu(capsys):
    results = self_check("cpu", verbose=True)
    assert sorted(results) == sorted(MODEL_NAMES)
    assert all(results.values())
    assert capsys.readouterr().out.count("OK") == len(MODEL_NAMES)
    assert all_models_pass("cpu")


def test_self_check_fails_on_a_broken_weight(monkeypatch):
    from cardio_dmz_tpu_torch.models import selfcheck
    real = selfcheck.load_np

    def broken(name, include_test_vectors=False):
        arrays = real(name, include_test_vectors)
        if name == "vseg_mlp":
            arrays["hidden_b"] = arrays["hidden_b"] + 0.5
        return arrays
    monkeypatch.setattr(selfcheck, "load_np", broken)
    results = self_check("cpu")
    assert not results["vseg_mlp"] and results["slash_mlp"]
    assert not all_models_pass("cpu")


# --- the serving loop ------------------------------------------------------

@pytest.fixture
def one_thread():
    """One intra-op thread for the serving loop: beside other test workers
    a pool of threads that waits at every operation slows a step of two
    streams many times over, and the loop is held to wall-clock time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("devices", ["cpu", "cpu,cpu"])
def test_serve_demo_reads_the_fixture_pans(devices, one_thread, capsys):
    """Six seconds of cameras at 10 frames/s: a session may need some 30
    steps on frames sampled out of order before it accepts its read (the
    usual case is 3 to 8), and a step here takes 0.01 to 0.1 s."""
    counts = serve_demo.main(["--streams", "2", "--seconds", "6",
                              "--fps", "10", "--devices", devices])
    assert counts["pans"] == counts["truth"] == [
        "4111111111111111", "4530504390541813"]
    assert counts["completed"] == 2
    steps = counts["counter_steps"]
    assert steps >= 4
    assert counts["counter_frames_fresh"] + counts["counter_frames_stale"] \
        == steps * 2 == counts["counter_frames_scanned"]
    assert counts["counter_reads_accepted"] == 2 == \
        counts["counter_reads_correct"]
    assert "counter_reads_mismatched" not in counts
    assert counts["timer_step_count"] == steps
    out = capsys.readouterr().out
    assert "cardio_steps" in out and "stream 0: OK" in out
