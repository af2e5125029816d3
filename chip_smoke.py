"""Drive the PyTorch port's PAN-only serving path once on one NVIDIA card.

    python3 chip_smoke.py            (from the repo root, on a CUDA machine)

Phases, in order; a phase that fails raises and the script exits non-zero
without printing its last line:

1. device   the card's name and power limit (nvidia-smi); TF32 off
2. build    nvcc builds the digit-prep kernel from csrc/ (-Xptxas -v shown)
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

The line before the last is a JSON object with each kernel's launches on
the serving path, its largest difference from the plain version and both
times. The last line is {"ok": true, "device": {...}}. Needs no network and
no JAX; builds into cardio_dmz_tpu_torch/_build/.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_STREAMS = 256          # the serving shape of tools/bench.py
WARMUP, STEPS = 3, 20
KERNEL_REPS = 50
SCORE_ATOL = 1e-5        # the reference's golden tolerance
REPLACES = "cardio_dmz_tpu/ops/pallas/digit_prep.py:42"


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


def build_phase(digit_prep):
    phase("2 build")
    t0 = time.perf_counter()
    log = digit_prep.build()
    print(f"built {digit_prep.LIBRARY} in {time.perf_counter() - t0:.2f} s")
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


def session_phase(port, digit_prep, params, fixture, dev):
    phase("5 session")
    frames = torch.from_numpy(fixture["frames"]).to(dev)
    digit_prep.LAUNCHES = 0
    state, (fr, _) = port.scan_frames(params, frames,
                                      tuple(fixture["now"].tolist()))
    torch.cuda.synchronize()
    launches = digit_prep.LAUNCHES
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


def serving_phase(port, digit_prep, params, fixture, pans, card, dev):
    phase("6 serving")
    n_src = fixture["frames"].shape[0]
    reps = -(-N_STREAMS // n_src)
    tiled = np.tile(fixture["frames"], (reps, 1, 1, 1))[:N_STREAMS]
    steps = [torch.from_numpy(np.ascontiguousarray(tiled[:, t])).to(dev)
             for t in range(tiled.shape[1])]
    now = tuple(fixture["now"].tolist())

    torch.cuda.reset_peak_memory_stats()
    digit_prep.LAUNCHES = 0
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
    launches = digit_prep.LAUNCHES

    want = [pans[s % n_src] for s in range(N_STREAMS)]
    got = [_pan(d[:int(n)]) for d, n in zip(states.completed_digits.cpu(),
                                            states.completed_n.cpu())]
    if not (results.complete.all() and got == want):
        raise AssertionError(
            f"{int(results.complete.sum())}/{N_STREAMS} streams completed, "
            f"{sum(g == w for g, w in zip(got, want))} with the right PAN")
    if launches != WARMUP + STEPS:
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
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on an NVIDIA card")
    import cardio_dmz_tpu_torch as port
    from cardio_dmz_tpu_torch.ops.cuda import digit_prep

    dev = torch.device("cuda", 0)
    card = device_phase()
    build_phase(digit_prep)
    max_err, ms, plain_ms = kernel_phase(digit_prep, dev)
    params = models_phase(port, dev)
    path = os.path.join(os.path.dirname(port.__file__), "data",
                        "smoke_session.npz")
    with np.load(path) as f:
        fixture = {k: f[k] for k in f.files}
    pans = session_phase(port, digit_prep, params, fixture, dev)
    launches = serving_phase(port, digit_prep, params, fixture, pans, card,
                             dev)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "digit_prep", "route": "cuda",
        "source": "cardio_dmz_tpu_torch/csrc/digit_prep.cu",
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
