"""The port's profilers (cardio_dmz_tpu_torch/tools/profile_*.py,
roofline.py, stage_bytes.py, buffer_hogs.py) and their work counter
(tools/profiling.WorkCounter), on the CPU at 2 streams.

The counter on known ops; each CUDA kernel counted once, by its wrapper's
formula, on the plain route, with none of the plain version's ops; each
tool's stage names against the JAX tool's own (read from its source, not
run: the JAX tools compile whole serving graphs); the roofline record's
keys against those of the JAX tool's _analyze, run on a trivial step; the
stage_bytes graphs against their ablations.
"""

import contextlib
import functools
import io
import json
import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a worker)
from cardio_dmz_tpu_torch.ops.cuda import digit_prep, persp_qr, warp_gather
from cardio_dmz_tpu_torch.tools import (
    buffer_hogs, profile_camera, profile_camera_ablate, profile_expiry,
    profile_pan, profile_warp, roofline, stage_bytes)
from cardio_dmz_tpu_torch.tools.profiling import WorkCounter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--streams", "2"]
TOOLS = {"profile_pan": (profile_pan, SMALL + ["--iters", "1"]),
         "profile_expiry": (profile_expiry, SMALL + ["--iters", "1"]),
         "profile_expiry --fine": (profile_expiry,
                                   SMALL + ["--iters", "1", "--fine"]),
         "profile_camera": (profile_camera, SMALL + ["--iters", "1"]),
         "profile_camera_ablate": (profile_camera_ablate,
                                   SMALL + ["--iters", "1"]),
         "profile_warp": (profile_warp, SMALL + ["--iters", "1"]),
         "roofline": (roofline, SMALL + ["--iters", "1"]),
         "stage_bytes": (stage_bytes, SMALL),
         "buffer_hogs": (buffer_hogs, SMALL + ["--graph", "camera",
                                               "--top", "5"])}
# each tool's stage names as the JAX tool writes them in its source (an
# f-string's as its template, filled as the port prints it); the JAX file
# of each tool
STAGE_NAMES = {
    "profile_pan": ("profile_pan", [
        "vseg (270 rows MLP)", "hseg (staged search)",
        "categorize (3-conv x16)", "full PAN-only step"]),
    "profile_expiry": ("profile_expiry", [
        "full step", "pan-only", "expiry seg (all)", "  scharr",
        "  stripes", "categorize", "aggregate"]),
    "profile_expiry --fine": ("profile_expiry", [
        "  process_stripe", "  trim", "  slash conv"]),
    "profile_camera": ("profile_camera", [
        ("sobel7 {edge} band", "sobel7 top band"),
        ("sobel7 {edge} band", "sobel7 left band"),
        ("canny {edge} band", "canny top band"),
        ("canny {edge} band", "canny left band"),
        ("canny+hough {edge} band", "canny+hough top band"),
        ("canny+hough {edge} band", "canny+hough left band"),
        "detect_edges (all 12 bands)", "warp 428x270",
        "preprocess_frame (fused)", "scanner_step (PAN+expiry)"]),
    "profile_camera_ablate": ("profile_camera_ablate", [
        "camera step (full)", "  detect ablated", "  warp ablated",
        "scan only (no camera)", "marginal detect", "marginal warp",
        "camera-side total"]),
    "profile_warp": ("profile_warp", [
        ("qr=v_qr", "qr "), ("coords=v_coords", "coords "),
        ("kernel=v_kernel", "kernel "), ("full=v_full", "full ")]),
    "roofline": ("roofline", ['"full"', '"pan"', '"camera"']),
    "stage_bytes": ("stage_bytes", [
        "camera_full", "camera_no_detect", "camera_no_warp", "scan_full",
        "scan_pan", "detect (marginal)", "warp (marginal)",
        "camera side (total)", "expiry (marginal)", "GFLOP/step",
        "GB/step", "MB/frame"]),
    "buffer_hogs": ("hlo_hogs", ["MB out"]),
}


@functools.lru_cache(maxsize=None)
def run_tool(name):
    """(stdout, return value) of a tool's main at 2 streams on the CPU."""
    module, argv = TOOLS[name]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.main(argv)
    return out.getvalue(), result


def jax_source(tool):
    with open(os.path.join(REPO, "cardio_dmz_tpu", "tools",
                           f"{tool}.py")) as f:
        return f.read()


def test_counter_counts_a_product_an_elementwise_op_and_a_view():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with WorkCounter() as counter:
        a @ b
    assert (counter.flops, counter.bytes, counter.int_ops) == (
        2 * 8 * 16 * 4, (8 * 16 + 16 * 4 + 8 * 4) * 4, 0)
    with WorkCounter() as counter:
        a + 1.0
    assert (counter.flops, counter.bytes) == (8 * 16, 2 * 8 * 16 * 4)
    with WorkCounter() as counter:
        a.view(16, 8)
        a.t()
        a.add_(1.0)                     # writes in place: reads a only
    assert counter.flops == 8 * 16 and counter.bytes == 8 * 16 * 4
    with WorkCounter() as counter:
        (a > 0).sum()                   # bool and integer work
        a.to(torch.int32)
    assert counter.flops == 0
    assert counter.int_ops == 8 * 16 + 1 + 8 * 16
    assert counter.by_op["aten.gt.Scalar"][0] == 1


def _kernel_cases():
    rng = np.random.RandomState(0)
    strips = torch.from_numpy(rng.randint(0, 256, (3, 27, 428)).astype(
        np.uint8))
    offsets = torch.tensor([[0] * 16, [19 * k for k in range(16)],
                            [409] * 16], dtype=torch.int32)
    src = torch.tensor([[[106., 105.], [534., 105.], [106., 375.],
                         [534., 375.]]] * 2) + torch.from_numpy(
        rng.uniform(-5, 5, (2, 4, 2)).astype(np.float32))
    dst = torch.tensor([[0., 0.], [427., 0.], [0., 269.], [427., 269.]])
    frames = torch.from_numpy(rng.randint(0, 256, (2, 480, 640)).astype(
        np.uint8))
    m = persp_qr.persp_transform_reference(src, dst)
    cells = 3 * 16 * 27 * 19
    n_pixels = 2 * 270 * 428
    return {
        # the covered columns: 19, 16 x 19 and 19 of the three strips
        "digit_prep": (digit_prep, digit_prep.prepare_digit_cells,
                       (strips, offsets),
                       (cells, (19 + 16 * 19 + 19) * 27 + 3 * 16 * 4
                        + cells * 4)),
        "persp_qr": (persp_qr, persp_qr.eigen_persp_transform_batched,
                     (src, dst), (2 * 999, (16 + 8 + 18) * 4)),
        "warp_gather": (warp_gather, warp_gather.warp_perspective_exact,
                        (frames, m, (270, 428)),
                        (15 * n_pixels + 2 * 42,
                         warp_gather.tapped_pixels(frames, m, (270, 428))
                         + 2 * 9 * 4 + n_pixels)),
    }


@pytest.mark.parametrize("name", ["digit_prep", "persp_qr", "warp_gather"])
def test_a_kernel_counts_once_by_its_formula(name):
    module, wrapper, args, (flops, n_bytes) = _kernel_cases()[name]
    launches = module.LAUNCHES
    with WorkCounter() as counter:
        wrapper(*args)
    assert dict(counter.kernels) == {name: [1, flops, n_bytes]}
    assert module.work(*args)[:2] == (flops, n_bytes)
    assert (counter.flops, counter.bytes, counter.int_ops) == (
        flops, n_bytes, 0)
    assert not any(row[1] or row[2] or row[3]
                   for row in counter.by_op.values())
    assert module.LAUNCHES == launches          # the plain route ran


def test_warp_tapped_pixels_of_a_transposed_warp():
    """A portrait warp reads the transposed frame's taps: as many pixels as
    the same maps read from the frame itself transposed."""
    _, _, (frames, m, shape), _ = _kernel_cases()["warp_gather"]
    assert warp_gather.tapped_pixels(frames, m, shape) == \
        warp_gather.tapped_pixels(frames.transpose(1, 2).contiguous(), m,
                                  shape, transpose=True)


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_prints_the_jax_tool_stage_names(name):
    out, _ = run_tool(name)
    jax_tool, names = STAGE_NAMES[name]
    source = jax_source(jax_tool)
    for name_ in names:
        template, printed = (name_ if isinstance(name_, tuple)
                             else (name_, name_))
        assert template in source, template
        assert printed in out, (printed, out)
    if name not in ("roofline", "stage_bytes", "buffer_hogs"):
        assert "[cpu host clock]" in out
        header = [line for line in out.splitlines() if line.startswith("#")]
        assert "graphed" in header[0], header
        assert all(ms > 0 for ms in run_tool(name)[1].values())


def jax_record_keys():
    """The keys of the JAX roofline's record, from its _analyze on a
    trivial step."""
    import jax.numpy as jnp

    from cardio_dmz_tpu.tools.roofline import _analyze
    with contextlib.redirect_stdout(io.StringIO()):
        rec = _analyze("trivial", lambda st, x: (st + x.sum(), x),
                       lambda: jnp.zeros(()), (jnp.ones(4),), 1, 1)
    return set(rec)


def test_roofline_record_has_the_jax_keys_and_no_cpu_time():
    import chip_smoke
    out, records = run_tool("roofline")
    jax_keys = jax_record_keys()
    assert set(records) == {"full", "pan", "camera"}
    assert set(chip_smoke.JAX_ROOFLINE_KEYS) == jax_keys
    lines = [json.loads(line) for line in out.splitlines()]
    for rec, line in zip(records.values(), lines):
        assert rec == line
        assert jax_keys <= set(rec)
        assert set(rec) - jax_keys == set(chip_smoke.PORT_ROOFLINE_KEYS)
        assert rec["device"] == "cpu" and rec["streams"] == 2
        for key in ("step_ms", "fps", "mfu_pct", "hbm_util_pct",
                    "mfu_pct_of_device_ms", "hbm_util_pct_of_device_ms",
                    "device_ms", "idle_share", "floor_ms_compute",
                    "floor_ms_hbm", "roofline_fps_ceiling", "bound"):
            assert rec[key] is None, key
        assert rec["gflops_per_step"] > 0 and rec["int_ops"] > 0
        assert rec["hbm_mb_per_step"] > rec["min_mb_per_step"] > 0
    assert records["full"]["gflops_per_step"] > \
        records["pan"]["gflops_per_step"]


def test_stage_bytes_full_graphs_count_more_than_their_ablations():
    _, rows = run_tool("stage_bytes")
    assert set(rows) == set(stage_bytes.GRAPHS)
    for full, ablated in (("camera_full", "camera_no_detect"),
                          ("camera_full", "camera_no_warp"),
                          ("camera_full", "scan_full"),
                          ("scan_full", "scan_pan")):
        assert rows[full]["gb"] > rows[ablated]["gb"], (full, ablated)
        assert rows[full]["int_ops"] > rows[ablated]["int_ops"]
    assert rows["scan_full"]["gflops"] > rows["scan_pan"]["gflops"]


def test_stage_bytes_counts_the_roofline_graphs_alike():
    """The roofline's full and pan shapes are stage_bytes' scan graphs, on
    the same inputs: the same counts."""
    _, records = run_tool("roofline")
    _, rows = run_tool("stage_bytes")
    for shape, graph in (("full", "scan_full"), ("pan", "scan_pan")):
        assert records[shape]["gflops_per_step"] == round(
            rows[graph]["gflops"], 3)
        assert records[shape]["hbm_mb_per_step"] == round(
            rows[graph]["gb"] * 1e3, 2)


def test_buffer_hogs_ranks_outputs_by_their_port_source():
    _, result = run_tool("buffer_hogs")
    sizes = [b for b, _, _ in result["buffers"]]
    assert len(sizes) == 5 and sizes == sorted(sizes, reverse=True)
    assert all(op.startswith("aten.") and ".py:" in frame
               for _, op, frame in result["buffers"])
    with pytest.raises(SystemExit, match="--cycles"):
        buffer_hogs.main(SMALL + ["--cycles"])


def test_source_of_a_profiler_event():
    """--cycles gives a kernel's time to the innermost port function in the
    stack of the op that launched it (or of a parent, or a parent that is
    a Python call), skipping the counter and the kernel plumbing, or to a
    kernel's region."""
    class Event:
        def __init__(self, name, parent=None, stack=()):
            self.name, self.cpu_parent, self.stack = name, parent, stack
    vseg = "/x/cardio_dmz_tpu_torch/scan/vseg.py(60): best_n_vseg"
    plumbing = "cardio_dmz_tpu_torch/ops/cuda/_build.py(9): counted_launch"
    step = "cardio_dmz_tpu_torch/tools/roofline.py(70): camera"
    assert buffer_hogs.source_of(Event("aten::mm", stack=(
        "<built-in method matmul>", plumbing, vseg, step))) == \
        "scan/vseg.py(60): best_n_vseg"
    assert buffer_hogs.source_of(Event("aten::mm", Event(
        "aten::matmul", Event(vseg, Event(step))))) == \
        "scan/vseg.py(60): best_n_vseg"
    assert buffer_hogs.source_of(Event("digit_prep kernel", stack=(
        vseg,))) == "digit_prep kernel"
    assert buffer_hogs.source_of(Event("aten::add", stack=(
        "torch/nn/modules/module.py(1): _call_impl",))) == "?"


def test_profilers_need_a_named_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    for module in (profile_pan, profile_expiry, profile_camera,
                   profile_camera_ablate, profile_warp, roofline,
                   stage_bytes, buffer_hogs):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(["--streams", "2"])
