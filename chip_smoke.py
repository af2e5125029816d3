"""Drive the PyTorch port's two serving paths once on one NVIDIA card: the
PAN-only step on rectified cards and the camera step in front of it.

    python3 chip_smoke.py            (from the repo root, on a CUDA machine)

Phases, in order; a phase that fails raises and the script exits non-zero
without printing its last line:

1. device   the card's name and power limit (nvidia-smi); TF32 off
2. build    nvcc builds the three kernels from csrc/, one process each, all
            started together (-Xptxas -v shown)
3. kernel   digit-prep kernel == its plain PyTorch version, bit for bit, at
            256 streams x 16 cells; median of 50 CUDA-event-timed calls each
4. models   the reference's golden vectors on the card, at 1e-5
5. session  the recorded fixture sessions (cardio_dmz_tpu_torch/data/
            smoke_session.npz, written from the JAX package by
            tests/torch_fixture.py) through scan_frames: every discrete
            output equals the JAX package's, digit scores within 1e-5, both
            PANs read, and the path went through the kernel
6. serving  batched_scanner_step at 256 streams (the fixture frames tiled):
            3 warm-up and 20 timed steps, every stream completes; frames/s,
            step ms and a per-stage split
7. persp    persp-QR kernel == its plain version, bit for bit and NaN
            included, on 256 detector-realistic corner sets and an all-zero
            one; both times
8. warp     warp-gather kernel == its plain version, u8 for u8, at 256
            uniform-noise frames through envelope quads, landscape and
            portrait (transposed); both times
9. camera   the recorded camera sessions (data/camera_session.npz, written
            from the JAX package by tests/torch_fixture.py) through
            batched_camera_step frame by frame: found flags, corners and
            homographies (f32 bits), cards (u8) and every discrete scan
            output equal the JAX package's, digit scores within 1e-5, both
            PANs read, both new kernels launched
10. camera serving
            batched_camera_step at 256 streams (the camera fixture tiled):
            3 warm-up and 20 timed steps, every stream completes; frames/s,
            step ms and a per-stage split (detect / homography and maps /
            warp / scan)

Each serving phase sets every kernel's launch count to 0 just before its
run and reads them just after. The line before the last is a JSON object
with each kernel's launches on the camera serving path (and on the
PAN-only one), its largest difference from the plain version and both
times. The last line is {"ok": true, "device": {...}}. Needs no network
and no JAX; builds into cardio_dmz_tpu_torch/_build/.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_STREAMS = 256          # the serving shape of tools/bench.py
WARMUP, STEPS = 3, 20
KERNEL_REPS = 50
SCORE_ATOL = 1e-5        # the reference's golden tolerance
TELEMETRY_RTOL = 1e-5    # focus/brightness: sums in another order
CARD_SHAPE = (270, 428)
CARD_DEST = [[0.0, 0.0], [427.0, 0.0], [0.0, 269.0], [427.0, 269.0]]
# the guide rect's corners in the warp's corner order (tl, tr, bl, br for
# landscape; bl, tl, br, tr for portrait); detector-realistic quads lie
# within +-12 px of them (tests/test_pallas.py)
GUIDE_LANDSCAPE = [[106, 105], [534, 105], [106, 375], [534, 375]]
GUIDE_PORTRAIT = [[185, 454], [185, 26], [455, 454], [455, 26]]
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "digit_prep": ("cardio_dmz_tpu_torch/csrc/digit_prep.cu",
                   "cardio_dmz_tpu/ops/pallas/digit_prep.py:42"),
    "warp_gather": ("cardio_dmz_tpu_torch/csrc/warp_gather.cu",
                    "cardio_dmz_tpu/ops/pallas/warp_gather.py:70"),
    "persp_qr": ("cardio_dmz_tpu_torch/csrc/persp_qr.cu",
                 "cardio_dmz_tpu/ops/pallas/persp_qr.py:168"),
}


def phase(name):
    print(f"[{name}]", flush=True)


def event_ms(fn, reps):
    """Median device time of `reps` calls of fn, each between two CUDA
    events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_phase():
    phase("1 device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def reset_launches(modules):
    for module in modules.values():
        module.LAUNCHES = 0


def read_launches(modules):
    return {name: module.LAUNCHES for name, module in modules.items()}


def build_phase(modules):
    phase("2 build")
    logs, errors = {}, {}

    def build(name):
        try:
            logs[name] = modules[name].KERNEL.build()
        except Exception as e:  # re-raised below, after every build ends
            errors[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(name,))
               for name in modules]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    print(f"built {len(logs)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(f"{name}: {modules[name].KERNEL.library}")
        for line in log.splitlines():
            if "ptxas" in line:
                print(line)


def kernel_phase(digit_prep, dev):
    phase("3 kernel")
    rng = np.random.RandomState(0)
    strips = torch.from_numpy(rng.randint(
        0, 256, (N_STREAMS, 27, 428)).astype(np.uint8)).to(dev)
    offsets = np.sort(rng.randint(0, 410, (N_STREAMS, 16)), axis=1)
    offsets[:, 0], offsets[:, -1] = 0, 409
    offsets = torch.from_numpy(offsets.astype(np.int32)).to(dev)

    got = digit_prep.prepare_digit_cells(strips, offsets)
    want = digit_prep.prepare_digit_cells_reference(strips, offsets)
    torch.cuda.synchronize()
    max_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"digit-prep kernel != plain version, max abs "
                             f"difference {max_err}")
    ms = event_ms(lambda: digit_prep.prepare_digit_cells(strips, offsets),
                  KERNEL_REPS)
    plain_ms = event_ms(
        lambda: digit_prep.prepare_digit_cells_reference(strips, offsets),
        KERNEL_REPS)
    print(f"digit_prep at {N_STREAMS}x16 cells: equal bit for bit; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of {KERNEL_REPS})")
    return max_err, ms, plain_ms


def models_phase(port, dev):
    phase("4 models")
    models = port.load_all_params(dev)
    for name in port.models.weights.MODEL_NAMES:
        golden = port.models.load_np(name, include_test_vectors=True)
        out = models[name](torch.from_numpy(golden["test_input"]).to(dev))
        err = np.abs(out.cpu().numpy() - golden["test_output"]).max()
        if not err <= SCORE_ATOL:
            raise AssertionError(f"{name}: golden max abs error {err}")
        print(f"{name}: golden max abs error {err:.3g}")
    return models


def _pan(digits):
    return "".join(map(str, digits.tolist()))


def session_phase(port, kernels, params, fixture, dev):
    phase("5 session")
    frames = torch.from_numpy(fixture["frames"]).to(dev)
    reset_launches(kernels)
    state, (fr, _) = port.scan_frames(params, frames,
                                      tuple(fixture["now"].tolist()))
    torch.cuda.synchronize()
    launches = kernels["digit_prep"].LAUNCHES
    got = {"vseg_y_offset": fr.vseg.y_offset,
           "vseg_pattern_type": fr.vseg.pattern_type,
           "hseg_n_offsets": fr.hseg.n_offsets,
           "hseg_offsets": fr.hseg.offsets,
           "hseg_pattern_offset": fr.hseg.pattern_offset,
           "hseg_number_width": fr.hseg.number_width,
           "usable": fr.usable,
           "number_complete": state.number_complete,
           "completed_digits": state.completed_digits,
           "completed_n": state.completed_n}
    for key, value in got.items():
        if not np.array_equal(value.cpu().numpy(), fixture[key]):
            raise AssertionError(f"{key} differs from the JAX package's:\n"
                                 f"{value.cpu().numpy()}\n{fixture[key]}")
    for key, value, rtol in (("scores", fr.scores, 0.0),
                             ("vseg_score", fr.vseg.score, 1e-5),
                             ("hseg_score", fr.hseg.score, 1e-5)):
        np.testing.assert_allclose(value.cpu().numpy(), fixture[key],
                                   atol=SCORE_ATOL, rtol=rtol, err_msg=key)
    pans = [_pan(d[:int(n)]) for d, n in zip(fixture["completed_digits"],
                                             fixture["completed_n"])]
    if not state.number_complete.all() or pans != [
            _pan(d[:int(n)]) for d, n in zip(state.completed_digits.cpu(),
                                             state.completed_n.cpu())]:
        raise AssertionError("a fixture session did not read its PAN")
    if launches == 0:
        raise AssertionError("the session never launched the kernel")
    err = np.abs(fr.scores.cpu().numpy() - fixture["scores"]).max()
    print(f"sessions read {pans}; discrete outputs equal the JAX "
          f"package's; digit scores max abs error {err:.3g}; digit-prep "
          f"launches {launches}")
    return pans


def serving_phase(port, kernels, params, fixture, pans, card, dev):
    phase("6 serving")
    n_src = fixture["frames"].shape[0]
    reps = -(-N_STREAMS // n_src)
    tiled = np.tile(fixture["frames"], (reps, 1, 1, 1))[:N_STREAMS]
    steps = [torch.from_numpy(np.ascontiguousarray(tiled[:, t])).to(dev)
             for t in range(tiled.shape[1])]
    now = tuple(fixture["now"].tolist())

    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    states = port.init_stream_states(N_STREAMS, dev, now)
    for i in range(WARMUP):
        states, _ = port.batched_scanner_step(params, states,
                                              steps[i % len(steps)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + STEPS):
        states, (_, results) = port.batched_scanner_step(
            params, states, steps[i % len(steps)])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches(kernels)

    want = [pans[s % n_src] for s in range(N_STREAMS)]
    got = [_pan(d[:int(n)]) for d, n in zip(states.completed_digits.cpu(),
                                            states.completed_n.cpu())]
    if not (results.complete.all() and got == want):
        raise AssertionError(
            f"{int(results.complete.sum())}/{N_STREAMS} streams completed, "
            f"{sum(g == w for g, w in zip(got, want))} with the right PAN")
    if launches["digit_prep"] != WARMUP + STEPS:
        raise AssertionError(f"digit-prep launched {launches} times in "
                             f"{WARMUP + STEPS} steps")
    step_ms = 1000.0 * elapsed / STEPS
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"scan_pipeline_throughput {N_STREAMS * STEPS / elapsed:.1f} "
          f"frames/s; step {step_ms:.3f} ms at {N_STREAMS} streams, "
          f"PAN-only, {STEPS} steps after {WARMUP} warm-up; all streams "
          f"complete; peak memory {peak_mib:.1f} MiB; card {card}")

    # per-stage split: each stage alone at the serving shape, device time
    frames = steps[0]
    vseg = port.scan.best_n_vseg(params["vseg_mlp"], frames)
    strip = port.scan.frame.pan_strip(frames, vseg.y_offset)
    hseg = port.scan.best_n_hseg(strip, vseg.pattern_type,
                                 vseg.number_length)
    split = {
        "vseg": event_ms(lambda: port.scan.best_n_vseg(
            params["vseg_mlp"], frames), 10),
        "hseg": event_ms(lambda: port.scan.best_n_hseg(
            strip, vseg.pattern_type, vseg.number_length), 10),
        "categorize": event_ms(lambda: port.scan.number_scores(
            params, strip, hseg.offsets, hseg.n_offsets), 10),
        "step": event_ms(lambda: port.batched_scanner_step(
            params, states, frames), 10),
    }
    split["rest (strip, gates, session)"] = split["step"] - sum(
        v for k, v in split.items() if k != "step")
    print("stage split, median device ms of 10: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    print(f"kernel launches on this path: {launches}")
    return launches


def load_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _bits_equal(a, b):
    """Float tensors equal bit for bit (NaN included)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _max_abs_err(a, b):
    """The largest |a - b| over the entries finite in both, 0 if none."""
    both = torch.isfinite(a) & torch.isfinite(b)
    diff = (a - b).abs()[both]
    return diff.max().item() if diff.numel() else 0.0


def _quads(guide, rng, n):
    return torch.from_numpy((np.float32(guide)[None] + rng.uniform(
        -12.0, 12.0, (n, 4, 2))).astype(np.float32))


def persp_phase(persp_qr, dev):
    phase("7 persp")
    rng = np.random.RandomState(1)
    src = torch.cat([_quads(GUIDE_LANDSCAPE, rng, N_STREAMS),
                     torch.zeros((1, 4, 2))]).to(dev)
    dst = torch.tensor(CARD_DEST, dtype=torch.float32, device=dev)
    got = persp_qr.eigen_persp_transform_batched(src, dst)
    want = persp_qr.persp_transform_reference(src, dst)
    torch.cuda.synchronize()
    max_err = _max_abs_err(got, want)
    if not _bits_equal(got, want):
        raise AssertionError(f"persp-QR kernel != plain version, max abs "
                             f"difference {max_err}")
    if not torch.isfinite(got[:N_STREAMS]).all() or \
            torch.isfinite(got[N_STREAMS]).all():
        raise AssertionError("want finite homographies for the quads and a "
                             "non-finite one for the all-zero corners")
    src = src[:N_STREAMS].contiguous()
    ms = event_ms(lambda: persp_qr.eigen_persp_transform_batched(src, dst),
                  KERNEL_REPS)
    plain_ms = event_ms(lambda: persp_qr.persp_transform_reference(src, dst),
                        KERNEL_REPS)
    print(f"persp_qr at {N_STREAMS} streams (+1 all-zero set): equal bit for "
          f"bit, NaN included; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of {KERNEL_REPS})")
    return max_err, ms, plain_ms


def warp_phase(port, warp_gather, dev):
    phase("8 warp")
    rng = np.random.RandomState(2)
    frames = torch.from_numpy(rng.randint(
        0, 256, (N_STREAMS, 480, 640)).astype(np.uint8)).to(dev)
    dst = torch.tensor(CARD_DEST, dtype=torch.float32, device=dev)
    results = {}
    for name, guide, transpose in (("landscape", GUIDE_LANDSCAPE, False),
                                   ("portrait", GUIDE_PORTRAIT, True)):
        m = port.ops.eigen_persp_transform(_quads(guide, rng, N_STREAMS)
                                           .to(dev), dst)
        xq, yq = port.ops.warp_coord_maps(m, CARD_SHAPE)
        image = frames
        if transpose:    # the portrait warp reads the transposed frame
            image, xq, yq = frames.transpose(1, 2).contiguous(), yq, xq
        got = warp_gather.warp_gather_exact(image, xq, yq)
        want = warp_gather.warp_gather_reference(image, xq, yq)
        torch.cuda.synchronize()
        err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"warp-gather kernel != plain version "
                                 f"({name}), max abs difference {err}")
        results[name] = (image, xq, yq, err)
    image, xq, yq, err = results["landscape"]
    max_err = max(r[3] for r in results.values())
    ms = event_ms(lambda: warp_gather.warp_gather_exact(image, xq, yq),
                  KERNEL_REPS)
    plain_ms = event_ms(
        lambda: warp_gather.warp_gather_reference(image, xq, yq), KERNEL_REPS)
    print(f"warp_gather at {N_STREAMS} streams, landscape and portrait: "
          f"equal u8 for u8; landscape kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of {KERNEL_REPS})")
    return float(max_err), ms, plain_ms


def _corners(corner_points):
    return torch.stack([corner_points.top_left, corner_points.top_right,
                        corner_points.bottom_left,
                        corner_points.bottom_right], dim=1)


def camera_session_phase(port, kernels, params, fixture, dev):
    phase("9 camera")
    n_streams, n_frames = fixture["y"].shape[:2]
    dst = torch.tensor(CARD_DEST, dtype=torch.float32, device=dev)
    reset_launches(kernels)
    state = port.init_stream_states(n_streams, dev,
                                    tuple(fixture["now"].tolist()))
    got = {k: [] for k in ("found", "corners", "homography", "card",
                           "vseg_y_offset", "vseg_pattern_type",
                           "hseg_n_offsets", "hseg_offsets", "usable",
                           "scores", "focus_score", "brightness_score")}
    for t in range(n_frames):
        y, cb, cr = (torch.from_numpy(np.ascontiguousarray(
            fixture[k][:, t])).to(dev) for k in ("y", "cb", "cr"))
        _, corner_points = port.api.detect_edges(y, cb, cr)
        corners = _corners(corner_points)
        _, card = port.api.preprocess_frame(y, cb, cr)
        state, (found, fr, _) = port.batched_camera_step(params, state, y,
                                                         cb, cr)
        for key, value in (
                ("found", found), ("corners", corners),
                ("homography", port.ops.eigen_persp_transform(corners, dst)),
                ("card", card), ("vseg_y_offset", fr.vseg.y_offset),
                ("vseg_pattern_type", fr.vseg.pattern_type),
                ("hseg_n_offsets", fr.hseg.n_offsets),
                ("hseg_offsets", fr.hseg.offsets), ("usable", fr.usable),
                ("scores", fr.scores), ("focus_score", fr.focus_score),
                ("brightness_score", fr.brightness_score)):
            got[key].append(value.cpu().numpy())
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    got = {k: np.stack(v, axis=1) for k, v in got.items()}
    got.update(number_complete=state.number_complete.cpu().numpy(),
               completed_digits=state.completed_digits.cpu().numpy(),
               completed_n=state.completed_n.cpu().numpy())

    for key in ("corners", "homography"):
        if not np.array_equal(got[key].view(np.int32),
                              fixture[key].view(np.int32)):
            raise AssertionError(f"{key} differ from the JAX package's in "
                                 f"their f32 bits")
    for key in ("found", "card", "vseg_y_offset", "vseg_pattern_type",
                "hseg_n_offsets", "hseg_offsets", "usable",
                "number_complete", "completed_digits", "completed_n"):
        if not np.array_equal(got[key], fixture[key]):
            raise AssertionError(f"{key} differs from the JAX package's")
    np.testing.assert_allclose(got["scores"], fixture["scores"],
                               atol=SCORE_ATOL, rtol=0, err_msg="scores")
    for key in ("focus_score", "brightness_score"):
        np.testing.assert_allclose(got[key], fixture[key],
                                   rtol=TELEMETRY_RTOL, err_msg=key)
    pans = [_pan(d[:int(n)]) for d, n in zip(got["completed_digits"],
                                             got["completed_n"])]
    if not got["number_complete"].all():
        raise AssertionError(f"a camera session did not read its PAN: {pans}")
    if not (launches["warp_gather"] and launches["persp_qr"]):
        raise AssertionError(f"the camera sessions missed a kernel: "
                             f"{launches}")
    err = np.abs(got["scores"] - fixture["scores"]).max()
    print(f"camera sessions ({n_streams} streams x {n_frames} frames) read "
          f"{pans}; found flags, scan fields and cards equal the JAX "
          f"package's, corners and homographies bit for bit; digit scores "
          f"max abs error {err:.3g}; launches {launches}")
    return pans


def camera_serving_phase(port, kernels, params, fixture, pans, card, dev):
    phase("10 camera serving")
    n_src, n_frames = fixture["y"].shape[:2]
    streams = np.arange(N_STREAMS) % n_src
    steps = [tuple(torch.from_numpy(np.ascontiguousarray(
        fixture[k][streams, t])).to(dev) for k in ("y", "cb", "cr"))
        for t in range(n_frames)]
    now = tuple(fixture["now"].tolist())

    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    states = port.init_stream_states(N_STREAMS, dev, now)
    for i in range(WARMUP):
        states, _ = port.batched_camera_step(params, states,
                                             *steps[i % n_frames])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + STEPS):
        states, (found, _, results) = port.batched_camera_step(
            params, states, *steps[i % n_frames])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches(kernels)

    want = [pans[s] for s in streams]
    got = [_pan(d[:int(n)]) for d, n in zip(states.completed_digits.cpu(),
                                            states.completed_n.cpu())]
    if not (results.complete.all() and found.all() and got == want):
        raise AssertionError(
            f"{int(results.complete.sum())}/{N_STREAMS} streams completed, "
            f"{sum(g == w for g, w in zip(got, want))} with the right PAN")
    if any(n != WARMUP + STEPS for n in launches.values()):
        raise AssertionError(f"want each kernel launched once a step in "
                             f"{WARMUP + STEPS} steps; got {launches}")
    step_ms = 1000.0 * elapsed / STEPS
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"camera_pipeline_throughput {N_STREAMS * STEPS / elapsed:.1f} "
          f"frames/s; step {step_ms:.3f} ms at {N_STREAMS} streams of "
          f"480x640 Y + 240x320 Cb/Cr, PAN-only, exact warp, {STEPS} steps "
          f"after {WARMUP} warm-up; all streams complete; peak memory "
          f"{peak_mib:.1f} MiB; card {card}")

    # per-stage split: each stage alone at the serving shape, device time
    y, cb, cr = steps[0]
    dst = torch.tensor(CARD_DEST, dtype=torch.float32, device=dev)
    _, corner_points = port.api.detect_edges(y, cb, cr)
    corners = _corners(corner_points)
    xq, yq = port.ops.warp_coord_maps(
        port.ops.eigen_persp_transform(corners, dst), CARD_SHAPE)
    cards = kernels["warp_gather"].warp_gather_exact(y, xq, yq)

    def maps():
        return port.ops.warp_coord_maps(
            port.ops.eigen_persp_transform(corners, dst), CARD_SHAPE)

    split = {
        "detect": event_ms(lambda: port.api.detect_edges(y, cb, cr), 10),
        "homography + maps": event_ms(maps, 10),
        "warp": event_ms(lambda: kernels["warp_gather"].warp_gather_exact(
            y, xq, yq), 10),
        "scan": event_ms(lambda: port.batched_scanner_step(
            params, states, cards), 10),
        "step": event_ms(lambda: port.batched_camera_step(
            params, states, y, cb, cr), 10),
    }
    split["rest (telemetry, gating)"] = split["step"] - sum(
        v for k, v in split.items() if k != "step")
    print("camera stage split, median device ms of 10: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    print(f"kernel launches on this path: {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on an NVIDIA card")
    import cardio_dmz_tpu_torch as port
    from cardio_dmz_tpu_torch.ops.cuda import digit_prep, persp_qr, warp_gather

    kernels = {"digit_prep": digit_prep, "warp_gather": warp_gather,
               "persp_qr": persp_qr}
    dev = torch.device("cuda", 0)
    card = device_phase()
    build_phase(kernels)
    measured = {"digit_prep": kernel_phase(digit_prep, dev)}
    params = models_phase(port, dev)
    data = os.path.join(os.path.dirname(port.__file__), "data")
    fixture = load_npz(os.path.join(data, "smoke_session.npz"))
    pans = session_phase(port, kernels, params, fixture, dev)
    scan_launches = serving_phase(port, kernels, params, fixture, pans, card,
                                  dev)
    measured["persp_qr"] = persp_phase(persp_qr, dev)
    measured["warp_gather"] = warp_phase(port, warp_gather, dev)
    camera = load_npz(os.path.join(data, "camera_session.npz"))
    camera_pans = camera_session_phase(port, kernels, params, camera, dev)
    launches = camera_serving_phase(port, kernels, params, camera,
                                    camera_pans, card, dev)

    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], "launches": launches[name],
        "launches_scan_path": scan_launches[name],
        "max_abs_err": measured[name][0], "ms": measured[name][1],
        "plain_ms": measured[name][2]} for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
