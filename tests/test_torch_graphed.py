"""parallel/graphed.graph_step, the port's jax.jit, on the CPU: its staging
(static buffers, warm-up calls, fresh results, one entry a key), a
rehearsal of what a capture refuses, and the graphed serving entry points
(make_sharded_step, HostScanner) against the JAX package's jitted ones.

On the CPU no graph exists: graph_step runs the step on its static input
buffers at every call, so these tests hold the staging and the wiring of
the entry points. tests/test_torch_cuda.py holds the replays against the
eager step bit for bit on the card.

Against the JAX package every discrete field is exact and the floats agree
within 1e-5 (the reference's golden tolerance, as in
tests/test_torch_mesh.py): the port's products and sums run in another
order than XLA's, so its floats are not the JAX package's bits (up to
7.7e-06 from the JAX step run op by op on these frames). Bit for bit is
what the graphed step owes the port's own eager step, and that is held
here too.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

import torch_fixture as fx
from cardio_dmz_tpu_torch.parallel import (
    batched_camera_step, batched_scanner_step, gather_streams,
    init_stream_states, make_sharded_step)
from cardio_dmz_tpu_torch.parallel import graphed
from cardio_dmz_tpu_torch.parallel.graphed import WARMUP_CALLS, graph_step
from cardio_dmz_tpu_torch.session import HostScanner
from torch_parity import assert_same, port_params, to_np
from torch_rehearsal import refused

N_STEPS = 4
HOST_KEYS = ("usable", "vseg_y_offset", "vseg_pattern_type",
             "hseg_n_offsets", "hseg_offsets", "complete", "predictions",
             "expiry_month", "expiry_year", "state_month", "state_year")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _assert_bits(a, b, what):
    """Every leaf of two trees of the same structure: equal dtype, shape
    and bytes (NaN included)."""
    la, lb = _tensors(a), _tensors(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert to_np(x).tobytes() == to_np(y).tobytes(), (what, i)


class _Calls:
    """fn(x) -> (x, x + 1): the first output is the (static) input
    itself; counts its calls."""

    def __init__(self):
        self.n = 0

    def __call__(self, x, pair=None):
        self.n += 1
        return x, x + 1


# --- the staging -----------------------------------------------------------

def test_results_of_a_call_do_not_change_at_the_next():
    """A call returns new tensors, as a jitted function returns new arrays:
    not the static buffers, which the next call overwrites."""
    step = graph_step(_Calls(), "cpu")
    first = step(torch.zeros(3))
    second = step(torch.full((3,), 5.0))
    assert torch.equal(first[0], torch.zeros(3))
    assert torch.equal(first[1], torch.ones(3))
    assert torch.equal(second[0], torch.full((3,), 5.0))
    static = step.entries[graphed._key((torch.zeros(3),))].static_in[0]
    assert all(t.data_ptr() != static.data_ptr()
               for t in (*first, *second))


def test_a_new_key_captures_anew():
    """One entry a structure, shape and dtype, as jit retraces; a key seen
    before reuses its entry."""
    fn = _Calls()
    step = graph_step(fn, "cpu")
    step(torch.zeros(2, 3))
    step(torch.ones(2, 3))
    assert len(step.entries) == 1
    step(torch.zeros(4, 3))
    step(torch.zeros(2, 3, dtype=torch.int32))
    step(torch.zeros(2, 3), (torch.zeros(1), None))
    assert len(step.entries) == 4
    step(torch.zeros(4, 3))
    assert len(step.entries) == 4
    assert fn.n == 4 * (WARMUP_CALLS + 1) + 2


def test_warmup_calls_then_one_call_a_step():
    """A new key runs fn WARMUP_CALLS times eagerly and once more (on the
    card, the call that is captured); each later call runs it once (on the
    card, the replay)."""
    fn = _Calls()
    step = graph_step(fn, torch.device("cpu"))
    step(torch.zeros(2))
    assert fn.n == WARMUP_CALLS + 1
    for k in range(3):
        step(torch.zeros(2))
        assert fn.n == WARMUP_CALLS + 2 + k
    assert WARMUP_CALLS >= 2
    entry, = step.entries.values()
    assert entry.capture_s >= 0.0


def test_cpu_runs_no_graph():
    """On the CPU the staging runs fn on the static inputs; no CUDA graph,
    stream or pool is made, and no launch is counted."""
    graphed.reset_launches()
    with mock.patch.object(torch.cuda, "CUDAGraph",
                           side_effect=AssertionError("a graph on the CPU")), \
            mock.patch.object(torch.cuda, "Stream",
                              side_effect=AssertionError("a stream")):
        step = graph_step(_Calls(), "cpu")
        out = step(torch.arange(4.0))
        out = step(torch.arange(4.0))
    entry, = step.entries.values()
    assert entry.graph is None and entry.static_out is None
    assert entry.launches == {}
    assert torch.equal(out[1], torch.arange(1.0, 5.0))
    assert graphed.launches() == {name: 0 for name in graphed.KERNELS}


def test_python_values_are_refused():
    """A graph would freeze a Python number: an argument or a result that
    is not a tensor, None or a tuple of them raises TypeError."""
    step = graph_step(_Calls(), "cpu")
    with pytest.raises(TypeError, match="float"):
        step(torch.zeros(2), 0.5)
    with pytest.raises(TypeError, match="int"):
        graph_step(lambda x: (x, 3), "cpu")(torch.zeros(2))


def test_launches_count_replays_not_captures():
    """launches(): the wrappers' count, less the calls a capture only
    recorded, plus the replays' launches; reset_launches zeroes all."""
    graphed.reset_launches()
    graphed.KERNELS["digit_prep"].LAUNCHES = 4    # 3 warm-up + 1 recorded
    graphed.CAPTURED.update({"digit_prep": 1})
    graphed.REPLAYED.update({"digit_prep": 5})
    assert graphed.launches() == {"digit_prep": 8, "warp_gather": 0,
                                  "persp_qr": 0}
    graphed.reset_launches()
    assert graphed.launches() == {name: 0 for name in graphed.KERNELS}
    assert not graphed.CAPTURED and not graphed.REPLAYED


# --- what a capture refuses, rehearsed on the CPU ---------------------------

def _small_inputs(n_streams):
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (n_streams, 270, 428)).astype(np.uint8))
    y = torch.from_numpy(
        rng.randint(0, 256, (n_streams, 480, 640)).astype(np.uint8))
    c = torch.from_numpy(
        rng.randint(0, 256, (n_streams, 240, 320)).astype(np.uint8))
    return frames, (y, c, c)


@pytest.mark.parametrize("shape", ["pan", "full", "camera", "camera_full"])
def test_step_holds_nothing_a_capture_refuses(shape):
    """The four serving steps (2 streams) read no value back to the host,
    index with no boolean mask, and build no tensor from host data at a
    call: what a CUDA graph could not capture. (The expiry read built its
    MM/YY index from a tuple at every call until the graphs came.)"""
    params = port_params()
    frames, planes = _small_inputs(2)
    expiry = shape.endswith("full")

    def step(state):
        if shape.startswith("camera"):
            return batched_camera_step(params, state, *planes,
                                       scan_expiry=expiry)
        return batched_scanner_step(params, state, frames, expiry)

    state = init_stream_states(2, "cpu", fx.NOW)
    assert refused(lambda: step(state)) == ([], [])


# --- the slice against the JAX package ---------------------------------------

@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]],
                         ids=["one", "two"])
@pytest.mark.parametrize("fixture,scan_expiry", [
    (fx.FIXTURE, False), (fx.EXPIRY_FIXTURE, True)], ids=["smoke", "expiry"])
def test_sharded_step_matches_jax(fixture, scan_expiry, devices):
    """The port's graphed make_sharded_step over the CPU (once, and
    listed twice) for 4 frames of a fixture session, against the JAX
    make_sharded_step on a one-CPU mesh: every discrete field exact,
    floats within 1e-5; against the port's eager batched step bit for bit,
    states and results; every step's results unchanged after the last
    step; one graph key a shard."""
    data = np.load(fixture)
    frames, now = data["frames"], tuple(data["now"].tolist())
    n_streams = frames.shape[0]
    want = fx.jax_sharded_run(fixture, scan_expiry, N_STEPS)
    step, place, init = make_sharded_step(port_params(), devices,
                                          scan_expiry=scan_expiry)
    states = init(n_streams, now)
    eager = init_stream_states(n_streams, "cpu", now)
    got, ref = [], []
    for t in range(N_STEPS):
        x = torch.from_numpy(frames[:, t])
        states, out = step(states, place(x))
        eager, eager_out = batched_scanner_step(port_params(), eager, x,
                                                scan_expiry)
        got.append((gather_streams(states), out))
        ref.append((eager, eager_out))
    for t, ((state, (frame, result)), (jstate, (jframe, jresult))) in \
            enumerate(zip(got, want)):
        _assert_bits((state, frame, result), ref[t], f"step {t}")
        assert_same(jframe, frame, atol=1e-5, rtol=1e-5, path=f"{t}.frame")
        assert_same(jresult, result, path=f"{t}.result")
        assert_same(jstate, state, atol=1e-5, path=f"{t}.state")
    assert [len(s.entries) for s in step.shard_steps] == [1] * len(devices)


def test_host_scanner_matches_jax():
    """The port's HostScanner, whose PAN step is graphed, over the expiry
    fixture's three cards frame by frame against the JAX HostScanner:
    every frame field, completion, digits and date equal; one graph key
    for all three sessions."""
    want = fx.jax_host_sessions()
    scanner = HostScanner(port_params(), scan_expiry=True, now=fx.NOW)
    for s, stream in enumerate(fx.expiry_frames()):
        scanner.reset()
        for t, y in enumerate(stream):
            frame, result = scanner.add_frame(y)
            got = {
                "usable": bool(frame.usable),
                "vseg_y_offset": int(frame.vseg.y_offset),
                "vseg_pattern_type": int(frame.vseg.pattern_type),
                "hseg_n_offsets": int(frame.hseg.n_offsets),
                "hseg_offsets": to_np(frame.hseg.offsets),
                "complete": bool(result.complete),
                "predictions": result.predictions,
                "expiry_month": result.expiry_month,
                "expiry_year": result.expiry_year,
                "state_month": scanner.expiry_month,
                "state_year": scanner.expiry_year}
            for key in HOST_KEYS:
                np.testing.assert_array_equal(
                    got[key], want[key][s, t], err_msg=f"{s} {t} {key}")
    assert len(scanner._step.entries) == 1
    assert want["complete"][:, -1].tolist() == [True, True, False]
