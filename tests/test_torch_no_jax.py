"""The port runs with jax and PIL made unimportable, and never imports the
JAX package: the PAN-only step, the camera step and both full (PAN +
expiry) steps, the host side (HostScanner, a checkpoint saved and loaded,
the frame pump built and used, the step split over a device list),
training (a batch of each generator, a fit step), the tools (the
renderer, the float warp, the bench, both accuracy sweeps, the scaling
curve, the debug timers and trace, load_params), and the profilers' work
counter, a roofline record and stage_bytes on the CPU, the dated-card
renderer and the debug image dump; the compiled-reference bridge with
the tools that use it; and the weights extraction tool."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import sys
sys.modules["jax"] = None                      # any `import jax` now fails
sys.modules["PIL"] = None                      # ... and any `import PIL`
import numpy as np
import torch
import cardio_dmz_tpu_torch as port
torch.set_num_threads(1)       # the suite's other workers share the cores

params = port.load_all_params("cpu")
states = port.init_stream_states(2, "cpu", (2026, 1))
frames = torch.from_numpy(np.random.RandomState(0).randint(
    0, 256, (2, 270, 428)).astype(np.uint8))
states, (frame, result) = port.batched_scanner_step(params, states, frames)
assert frame.scores.shape == (2, 16, 10)
assert result.complete.shape == (2,)
rng = np.random.RandomState(1)
y = torch.from_numpy(rng.randint(0, 256, (2, 480, 640)).astype(np.uint8))
cb, cr = (torch.from_numpy(rng.randint(0, 256, (2, 240, 320)).astype(
    np.uint8)) for _ in range(2))
states, (found, frame, result) = port.batched_camera_step(params, states, y,
                                                          cb, cr)
assert found.shape == (2,) and frame.scores.shape == (2, 16, 10)
states, (frame, result) = port.batched_scanner_step(params, states, frames,
                                                    scan_expiry=True)
assert frame.expiry_groups.valid.shape == (2, 4)
states, (found, frame, result) = port.batched_camera_step(
    params, states, y, cb, cr, config=port.config.ScanConfig())
assert states.scan_expiry.all() and result.expiry_month.shape == (2,)

# the host side of serving
import os, tempfile
scanner = port.HostScanner(params, now=(2026, 1))
frame, result = scanner.add_frame(frames[0].numpy())
assert frame.scores.shape == (16, 10) and result.complete in (False, True)
with tempfile.TemporaryDirectory() as tmp:
    for name in ("state.npz", "state.pt"):
        path = port.save_session(os.path.join(tmp, name), states) \
            if name.endswith(".pt") else os.path.join(tmp, name)
        if name.endswith(".npz"):
            port.session.save_session_npz(path, states)
        loaded = port.load_session(path, device="cpu")
        assert torch.equal(loaded.analytics.vseg_y, states.analytics.vseg_y)
pump = port.FramePump(2, frame_shape=(270, 428), device="cpu")
pump.push(1, frames[1].numpy(), frame_id=7)
batch, ids, fresh = pump.acquire_batch()
assert fresh == 1 and ids[1] == 7 and torch.equal(batch[1], frames[1])
pump.close()
step, place, init = port.make_sharded_step(params, port.make_mesh(
    ["cpu", "cpu"]))
split_states, (frame, result) = step(init(2, (2026, 1)), place(batch))
assert len(split_states) == 2 and result.complete.shape == (2,)
assert all(port.models.self_check("cpu").values())
assert port.blur_card(frames[0].numpy(), split_states[0]).shape == (270, 428)

# training: the generators draw their glyphs from a table, not PIL
from cardio_dmz_tpu_torch import train
rng = np.random.RandomState(0)
for make in (train.synthetic_digit_batch, train.synthetic_vseg_batch,
             train.synthetic_slash_batch, train.synthetic_expiry_digit_batch):
    x, labels = make(rng, 4)
    assert len(x) == len(labels) == 4
params = train.init_pan_conv_params(torch.Generator().manual_seed(0), "cpu")
_, losses = train.fit(train.pan_conv_loss, params,
                      iter([train.synthetic_digit_batch(rng, 8)]), steps=1)
assert np.isfinite(losses[0])

# the tools, the renderer and the float warp
import contextlib, io
from cardio_dmz_tpu_torch import synthetic
from cardio_dmz_tpu_torch.ops.warp import unwarp_card
from cardio_dmz_tpu_torch.tools import (
    accuracy_sweep, bench, bench_matrix, scaling_curve)
from cardio_dmz_tpu_torch.utils import debug
card = synthetic.render_frame(synthetic.safe_pan(np.random.default_rng(0)),
                              style="emboss")
quad = torch.tensor([[[106., 105.], [534., 105.], [106., 375.],
                      [534., 375.]]])
preview = torch.full((1, 480, 640), 50, dtype=torch.uint8)
preview[0, 105:375, 106:534] = torch.from_numpy(card)
assert unwarp_card(preview, quad, method="gather").shape == (1, 270, 428)
assert accuracy_sweep.run_sweep(2, 2, 2, quiet=True,
                                device="cpu")["sessions"] == 2
assert accuracy_sweep.run_camera_sweep(1, 1, 1, quiet=True,
                                       device="cpu")["mode"] == "camera"
with contextlib.redirect_stdout(io.StringIO()):
    assert bench.main(["--smoke", "--no-expiry", "--device", "cpu"])[
        "metric"] == "scan_pipeline_throughput"
assert set(scaling_curve.run(2, 1, sizes=(1, 2), devices=["cpu", "cpu"])) \
    == {1, 2}
assert "full" in bench_matrix.SHAPES
timers = debug.Timers()
timers.start(1)
assert timers.stop(1) >= 0
with tempfile.TemporaryDirectory() as tmp:
    with debug.profile_trace(tmp) as trace, debug.annotate("region"):
        torch.ones(2).sum()
    assert os.path.getsize(trace) > 0
assert port.models.load_params("vseg_mlp", "cpu")["hidden_w"].dtype == \
    torch.float32

# the profilers' counter, a roofline record and stage_bytes on the CPU, the
# dated-card renderer and the debug dump
from cardio_dmz_tpu_torch.tools import roofline, stage_bytes
from cardio_dmz_tpu_torch.tools.profiling import WorkCounter
from cardio_dmz_tpu_torch.utils.debug_images import dump_expiry_stages
serving = port.load_all_params("cpu")
with WorkCounter() as counter:
    port.batched_scanner_step(serving, states, frames)
assert counter.flops > 0 and counter.kernels["digit_prep"][0] == 1
with contextlib.redirect_stdout(io.StringIO()):
    record = roofline.main(["--device", "cpu", "--streams", "2",
                            "--shapes", "pan"])["pan"]
    rows = stage_bytes.main(["--device", "cpu", "--streams", "2"])
assert record["gflops_per_step"] > 0 and record["step_ms"] is None
assert rows["camera_full"]["gb"] > rows["scan_full"]["gb"]
dated = synthetic.render_frame_with_expiry("4111111111111111", "08/28",
                                           style="emboss")
assert dated.shape == (270, 428) and (dated != synthetic.render_frame(
    "4111111111111111", style="emboss", noise=1)).any()
with tempfile.TemporaryDirectory() as tmp:
    assert len(dump_expiry_stages(dated, 150, serving["slash_mlp"],
                                  tmp)) == 4

leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("cardio_dmz_tpu", "jaxlib", "PIL"))
assert not leaked, leaked
print("ok")
"""


_REFBRIDGE_SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["PIL"] = None
import contextlib, io
import numpy as np
import torch
torch.set_num_threads(1)
from cardio_dmz_tpu_torch import refbridge, synthetic
from cardio_dmz_tpu_torch.tools import parity_ab, tune_emboss  # noqa: F401
if refbridge.available():
    from cardio_dmz_tpu_torch.models import load_all_params
    from cardio_dmz_tpu_torch.scan import scan_card_image
    oracle = refbridge.RefOracle.shared()
    y = synthetic.render_frame("4111111111111111", seed=1)
    ref = refbridge.ref_frame_record(oracle.scan_card_image(
        y, scan_expiry=False))
    ours = refbridge.frame_records(scan_card_image(
        load_all_params("cpu"), torch.from_numpy(y[None])))[0]
    assert ours.same_segmentation(ref) and ours.digits == ref.digits
    with contextlib.redirect_stdout(io.StringIO()):
        report = parity_ab.main(["--device", "cpu", "--frames", "1",
                                 "--sessions", "0", "--expiry-sessions", "0",
                                 "--camera-frames", "0"])
    assert report["frames"] == 1 and report["usable_agreement_pct"] == 100.0
    print("linked")
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("cardio_dmz_tpu", "jaxlib", "PIL"))
assert not leaked, leaked
print("ok")
"""


def test_refbridge_runs_without_jax():
    """refbridge imports with jax and PIL unimportable; where the oracle
    links, one scan_card_image comparison and a one-frame parity_ab run
    pass; neither refbridge nor the tools import the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _REFBRIDGE_SCRIPT],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    from cardio_dmz_tpu_torch import refbridge
    want = ["linked", "ok"] if refbridge.available() else ["ok"]
    assert proc.stdout.split() == want


_EXTRACT_SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["PIL"] = None
import contextlib, io, os, tempfile
import numpy as np
from chip_smoke import write_generated_sources
from cardio_dmz_tpu_torch.models.weights import PARAM_DIR
from cardio_dmz_tpu_torch.tools import extract_weights
models = {}
for name in extract_weights.JOBS:
    with np.load(os.path.join(PARAM_DIR, name + ".npz")) as f:
        models[name] = {k: f[k] for k in f.files}
with tempfile.TemporaryDirectory() as tmp:
    paths = write_generated_sources(os.path.join(tmp, "ref"), models)
    blobs = extract_weights.parse_blobs(paths["vseg_mlp"])
    assert [role for _, role, _ in blobs][:2] == ["hidden W", "hidden b"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_weights.main(["--reference", os.path.join(tmp, "ref"),
                                     "--out", os.path.join(tmp, "out")]) == 0
    for name, arrays in models.items():
        with np.load(os.path.join(tmp, "out", name + ".npz")) as f:
            assert all(f[k].tobytes() == a.tobytes()
                       for k, a in arrays.items())
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("cardio_dmz_tpu", "jaxlib", "PIL"))
assert not leaked, leaked
print("ok")
"""


def test_extract_weights_runs_without_jax():
    """tools/extract_weights.py parses a source and writes the six models
    with jax and PIL unimportable, importing nothing of the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _EXTRACT_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
