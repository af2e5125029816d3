"""The port's tools against the JAX package's: the bench (its input makers
and its JSON line for every shape), the bench matrix, the scaling curve,
the debug timers and traces, and models/weights.load_params.

The JAX bench's inputs are taken where its main() places them on the
device (jax.device_put), and the JAX scaling curve's keys from its run()
with its timer stubbed: neither compiles a step.
"""

import json
import os
import subprocess
import sys
import time
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a worker)
from cardio_dmz_tpu.tools import bench_matrix as jax_bench_matrix
from cardio_dmz_tpu_torch.models import weights
from cardio_dmz_tpu_torch.tools import accuracy_sweep, bench, bench_matrix
from cardio_dmz_tpu_torch.tools import scaling_curve
from cardio_dmz_tpu_torch.utils import debug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each shape's metric, as the JAX bench prints it (tools/bench.py)
METRICS = {"full": "scan_pipeline_throughput",
           "pan": "scan_pipeline_throughput",
           "camera": "camera_pipeline_throughput",
           "latency": "scan_frame_latency_p50",
           "camera_latency": "camera_frame_latency_p50"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


class _Placed(Exception):
    """Raised where the JAX bench has made its inputs."""


def jax_bench_inputs(argv):
    """The uint8 arrays the JAX bench's main() places on the device for
    `argv`; it stops at init_stream_states, before any step compiles."""
    from cardio_dmz_tpu.parallel import streams
    from cardio_dmz_tpu.tools import bench as jax_bench
    placed = []

    def put(x, *args, **kwargs):
        placed.append(np.asarray(x))
        return x

    def stop(*args, **kwargs):
        raise _Placed

    with mock.patch.object(jax, "device_put", put), \
            mock.patch.object(streams, "init_stream_states", stop), \
            mock.patch.object(sys, "argv", ["bench"] + argv):
        with pytest.raises(_Placed):
            jax_bench.main()
    return [x for x in placed if x.dtype == np.uint8]


def test_timers():
    t = debug.Timers()
    t.start(3)
    us = t.lap(3)
    assert us >= 0
    assert t.stop(3) >= us
    assert t.print_lap("step", slot=3) >= 0
    assert isinstance(debug.TIMERS, debug.Timers)
    assert debug.Timers.N_SLOTS == 10


def test_debug_logs_and_trace_gate(caplog):
    with caplog.at_level("DEBUG", logger="cardio_dmz_tpu_torch"):
        debug.debug_log("vseg %d", 151)
        debug.error_log("hseg %s", "failed")
        with mock.patch.object(debug, "_TRACE", False):
            debug.trace_log("hidden")
        with mock.patch.object(debug, "_TRACE", True):
            debug.trace_log("shown %d", 2)
    assert [r.getMessage() for r in caplog.records] == [
        "vseg 151", "hseg failed", "TRACE: shown 2"]


def test_profile_trace_writes_the_annotated_regions(tmp_path):
    with debug.profile_trace(str(tmp_path)) as path:
        with debug.annotate("cardio_step"):
            torch.ones(8).sum()
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "cardio_step" for e in trace["traceEvents"])


@pytest.mark.parametrize("name", weights.MODEL_NAMES)
def test_load_params_matches_jax(name):
    from cardio_dmz_tpu.models.weights import load_params
    for vectors in (False, True):
        want = load_params(name, include_test_vectors=vectors)
        got = weights.load_params(name, "cpu", include_test_vectors=vectors)
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.dtype == torch.float32 and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("argv,streams", [
    (["--streams", "7"], 7),
    (["--camera", "--streams", "20"], 20),
    (["--camera", "--noise-frames", "--streams", "3"], 3),
    (["--camera", "--latency"], 1)])
def test_bench_inputs_match_jax(argv, streams):
    want = jax_bench_inputs(argv)
    if "--camera" in argv:
        got = bench.camera_inputs(streams, "--noise-frames" in argv)
    else:
        got = bench.scan_inputs(streams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def test_bench_shapes_are_the_jax_matrix():
    assert bench_matrix.SHAPES == jax_bench_matrix.SHAPES
    assert set(METRICS) == set(bench_matrix.SHAPES)


@pytest.mark.parametrize("shape", list(METRICS))
def test_bench_smoke_prints_the_jax_line(shape, capsys):
    record = bench.main(["--smoke", "--device", "cpu"]
                        + bench_matrix.SHAPES[shape])
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert set(record) == BENCH_KEYS
    assert record["metric"] == METRICS[shape] and record["value"] > 0
    assert record["unit"] == ("ms" if "latency" in shape
                              else "frames/sec/chip")
    assert out.err.startswith("# device=cpu streams=")


def test_bench_matrix_runs_a_shape_in_a_process(tmp_path):
    out = tmp_path / "matrix.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "cardio_dmz_tpu_torch.tools.bench_matrix",
         "--shapes", "latency", "--iters", "3", "--device", "cpu",
         "--out", str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert set(record) == BENCH_KEYS | {"shape"}, record
    assert record["shape"] == "latency"
    assert record["metric"] == METRICS["latency"] and record["value"] > 0
    with open(out) as f:
        assert json.load(f) == {"latency": record}


def test_bench_matrix_exits_nonzero_when_a_shape_fails(capsys):
    """A bench that prints no line (here: a device torch cannot parse)
    becomes an error record, and the console entry point returns 1."""
    assert bench_matrix.cli(["--shapes", "latency", "--iters", "3",
                             "--device", "no-such-device"]) == 1
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["shape"] == "latency" and "error" in record


def test_latency_is_the_median_step(capsys):
    """A latency shape reports the median of its steps, each timed alone:
    ten stalled steps of fifty move the mean, not the value."""
    delays = iter([0.0] + [0.002] * 40 + [0.1] * 10)   # warm-up, 50 timed

    def make_step(params, camera, expiry):
        def step(states, *inputs):
            time.sleep(next(delays))
            return states, None
        return step

    with mock.patch.object(bench, "make_step", make_step):
        record = bench.main(["--smoke", "--latency", "--device", "cpu"])
    assert record["metric"] == METRICS["latency"]
    assert 2.0 <= record["value"] < 20.0, record


def test_scaling_curve_has_the_jax_keys():
    from cardio_dmz_tpu.tools import scaling_curve as jax_curve
    with mock.patch.object(jax_curve, "measure", lambda *a, **k: 0.01):
        want = jax_curve.run(8, 1, camera=True, sizes=(1, 2))
        want_scan = jax_curve.run(8, 1, sizes=(1, 2))
    got_scan = scaling_curve.run(8, 1, sizes=(1, 2), devices=["cpu", "cpu"])
    assert got_scan.keys() == want_scan.keys() == {1, 2}
    for n in (1, 2):
        assert got_scan[n].keys() == want_scan[n].keys()
        assert got_scan[n]["scan_step_ms"] > 0
    assert got_scan[1]["efficiency_vs_1dev"] == 1.0
    got = scaling_curve.run(4, 1, camera=True, sizes=(1, 2, 4),
                            devices=["cpu", "cpu"])
    assert got.keys() == want.keys()
    for n in (1, 2):
        assert got[n].keys() == want[n].keys()


def test_entry_points_need_a_named_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy_sweep.run_sweep(2, 2, 2, quiet=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy_sweep.run_camera_sweep(2, 2, 2, quiet=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling_curve.run(2, 1, sizes=(1,))
