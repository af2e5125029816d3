"""Drive the PyTorch port's paths once on one NVIDIA card: the PAN-only
step on rectified cards, the camera step in front of it, both with the
in-graph expiry read (the full steps), the host side of serving around
them (the single-stream HostScanner, checkpoints, the step split over a
device list, the serving loop behind the frame pump), training, the
entry hooks (entry, dryrun_multichip), the tools, the profilers, the
compiled reference's recorded answers, the weights extraction tool, the
serving steps captured as CUDA graphs (parallel/graphed.graph_step, the
port's jax.jit), which make_sharded_step, make_sharded_camera_step,
HostScanner and tools/bench.py run, and the JAX package's other jit
sites as graphs: the train step, the accuracy sweeps' steps, the parity
tool's device functions and the stage profilers' timed stages.

    python3 chip_smoke.py            (from the repo root, on a CUDA machine)

Phases, in order; a phase that fails raises and the script exits non-zero
without printing its last line:

1. device   the card's name and power limit (nvidia-smi); TF32 off
2. build    nvcc builds the three kernels from csrc/, one process each, and
            g++ the frame pump, all started together (-Xptxas -v shown)
3. kernel   digit-prep kernel == its plain PyTorch version, bit for bit, at
            256 streams x 16 cells on uniform-noise strips, on the PAN
            strips of the recorded fixture frames (through vseg and hseg)
            and on an all-equal strip (every gradient 0), and on the first
            1, 2, 3, 4, 8, 16, 32, 64, 127 and 129 streams of each
            (STREAM_COUNTS: every stream count at which a later phase
            launches a kernel, phase 21's derived from its sweep and curve
            constants); kernel times on each set at
            256 streams, the plain version's on the real strips
4. models   the reference's golden vectors on the card, at 1e-5
            (models/selfcheck.self_check)
5. session  the recorded fixture sessions (cardio_dmz_tpu_torch/data/
            smoke_session.npz, written from the JAX package by
            tests/torch_fixture.py) through scan_frames: every discrete
            output equals the JAX package's, digit scores within 1e-5, both
            PANs read, and the path went through the kernel
6. serving  batched_scanner_step at 256 streams (the fixture frames tiled):
            3 warm-up and 20 timed steps, every stream completes; frames/s,
            step ms, peak memory and a per-stage split
7. persp    persp-QR kernel == its plain version, bit for bit and NaN
            included, on 256 detector-realistic corner sets and an all-zero
            one, and at STREAM_COUNTS, 255 and 257 streams
            (degenerate sets
            first: all zero, a repeated, an inf and a NaN corner) with the
            card's destination and with a rectangle a stream; kernel, plain
            and torch.linalg.solve_ex times at 256 streams, the bound, the
            solve's dependency chain (persp_qr_ops, each op's latency
            measured by tools/op_latency.cu) at the SM clock, and an empty
            launch timed the same way, on a line of their own
8. warp     the exact-warp kernel (coordinate maps computed in the kernel)
            == its plain route (float64 maps, then the gather), u8 for u8,
            on 256 uniform-noise frames through envelope quads, landscape
            and portrait, and on a NaN homography (all-zero corners), and
            at the first 1, ..., 129 (STREAM_COUNTS) of those streams, the
            NaN one among
            them; kernel times at 256 streams
9. camera   the recorded camera sessions (data/camera_session.npz, written
            from the JAX package by tests/torch_fixture.py) through
            batched_camera_step frame by frame: found flags, corners and
            homographies (f32 bits), cards (u8) and every discrete scan
            output equal the JAX package's, digit scores within 1e-5, both
            PANs read, both camera kernels launched
10. camera serving
            batched_camera_step at 256 streams (the camera fixture tiled):
            3 warm-up and 20 timed steps, every stream completes; frames/s,
            step ms, peak memory, a per-stage split (detect / homography /
            warp / scan), a check that no card-shaped float64 or int32
            tensor is made, and a profile of one step
11. expiry  the expiry conv's golden intermediates at 1e-5 (phase 4 holds
            every model's golden output, the slash MLP's and the expiry
            conv's included); the recorded full sessions
            (data/expiry_session.npz, written from the JAX package by
            tests/torch_fixture.py: two dated cards and an undated one)
            through scan_frames(scan_expiry=True), and the same cards on
            the guide rect of camera previews through
            batched_camera_step(scan_expiry=True): windows, char rects,
            slot tables, months and years equal the JAX package's, window
            and slot scores within 1e-5; the undated card has its number
            and completes only through the grace rule (checked on its
            state); digit prep launched
12. full serving
            batched_scanner_step(scan_expiry=True) at 256 streams (the
            fixture's dated cards tiled): 3 warm-up and 20 timed steps,
            every stream completes with its PAN and its date; frames/s,
            step ms, device ms and operations a step (torch.profiler),
            peak memory, and a split: expiry seg / categorize / aggregate
            and extract / the PAN-only step
13. full camera serving
            the same for batched_camera_step(scan_expiry=True) at 256
            streams of previews; all three kernels launched once a step
14. host scanner
            session.HostScanner on the card over the expiry fixture's three
            cards, frame by frame: usable, vseg/hseg outputs, complete,
            predictions, month and year equal the JAX HostScanner's
            (data/host_session.npz, written from the JAX package by
            tests/torch_fixture.py); both dated cards read PAN and date, the
            undated one completes only through the grace rule; the host
            oracle's expiry groups equal the JAX package's, and equal the
            port's device path on the card; the PAN step one CUDA graph,
            digit prep launched once a frame at one stream (and
            WARMUP_CALLS times more before the capture); ms a frame, the
            eager PAN step and the host expiry apart
15. camera metadata and portrait
            the fixture's oriented camera runs (the cards on the portrait
            and on the landscape-left guide rect, non-zero iso / shutter /
            torch) through batched_camera_step(orientation=...): found
            flags, corners and homographies (f32 bits), cards, scan fields,
            telemetry and every field of the analytics ring equal the JAX
            package's; all three kernels launched once a step
16. checkpoint
            the 256-stream full session of phase 12 stopped midway, saved
            as .npz and with torch.save, loaded to the card and continued:
            every state leaf and result equals the uninterrupted run's bit
            for bit; the fixture's checkpoint, written by the JAX package,
            continues to the recorded reads
17. split step
            make_sharded_step over [cuda:0] and over [cuda:0, cuda:0] as
            129 + 127 streams, PAN-only and full, and
            make_sharded_camera_step (the full camera step a shard) over
            [cuda:0, cuda:0], each shard's step a CUDA graph, against the
            eager unsplit step: over [cuda:0] bit for bit; over the
            uneven two, every integer and bool leaf equal and the float
            leaves within 1e-5 (the GEMM library picks its
            kernel, and with it its summation order, by the call's row
            count); each kernel's launches are the shards times its
            count a step times the steps and the WARMUP_CALLS eager steps
            before each capture (replays counted: read_launches); step ms
            beside the unsplit step's
18. serving loop
            tools/serve_demo.py on the card: 16 camera threads at 30
            frames/s -> FramePump (page-locked batches) -> the split step
            -> Metrics, for 3 s: every stream's accepted read is its
            fixture PAN, fresh + stale frames = steps x streams, digit
            prep launched once a step and WARMUP_CALLS times before the
            warm-up step's capture; the metrics text is printed
19. train   for each of the four architectures of tools/train_models.py,
            against data/train_session.npz (written from the JAX package by
            tests/torch_fixture.py): the port's generators, with `import
            PIL` made to fail, make the JAX generators' three seed-0
            batches bit for bit; from the JAX initial parameters on the
            card, the loss within 1e-5 relative and the gradients within
            1e-5 or 1e-4 of their size; a three-step fit's losses within
            1e-5 and its parameters within 1e-5 (1e-4 where the first
            gradient is below 2e-7: FIT_ATOL), with the elements under
            2e-7 counted a parameter; train_one clears the JAX
            tests' held-out floors (PAN 0.8 after 100 steps, vseg 0.9,
            slash 0.95, expiry 0.9 after 120); the retrained parameters
            saved and loaded into the serving modules give the trainable
            form's outputs within 1e-5; no serving kernel launched. fit
            and train_one run the graphed train step (make_train_step,
            train/optim.adam); its times are phase 26's
20. entry   entry() on the card equals the JAX entry()'s outputs (usable and
            y_offset exact, scores within 1e-5; the fixture); then
            dryrun_multichip(4) over four copies of cuda:0 (a 2 x 2 mesh,
            so the column-parallel hidden layer runs): a finite training
            loss, the serving and the camera step a shard, each a CUDA
            graph; the three kernels' launches in it, exactly digit prep
            twice and the warp and persp QR once a data group for each
            replay and each of the WARMUP_CALLS eager steps before it
21. tools   tools/bench_matrix.py on the card, all five shapes (full, pan,
            camera, latency, camera_latency), each bench in a process of
            its own: every line has its shape's metric name and unit and
            a value above 0; one bench step (a graph replay) of each shape
            in this process, with each kernel's launches in it (digit
            prep once a step on the rectified shapes, all three once on
            the camera shapes),
            its host-clock ms, device ms and operations and the device's
            idle share;
            the detector finds all 16 of the camera shape's rendered
            previews; tools/accuracy_sweep.py's rectified sweep (its
            steps graphed) at
            its defaults (512 sessions of 8 frames), whose reads equal the
            JAX package's (data/sweep_session.npz, written by
            tests/torch_fixture.py) session for session with no wrong
            read, and its camera sweep (128 sessions of 8 frames) with no
            wrong read and at most 2 sessions accepted otherwise than the
            JAX package's (each one printed: the previews come from the
            float warp, not the JAX package's bits); tools/scaling_curve.py
            over 1, 2 and 4 copies of cuda:0, with the camera step
22. profilers
            each stage profiler of cardio_dmz_tpu_torch/tools/ in this
            process at its defaults (64 streams), 3 timed replays of each
            stage's CUDA graph (tools/profiling.event_ms):
            profile_pan, profile_expiry (and --fine), profile_camera,
            profile_camera_ablate, profile_warp; every stage line present
            with a time above 0; roofline.py's three records at 256
            streams, each with every key of the JAX tool's record and the
            port's, every share under 100%; each kernel's launches in one
            roofline step of each shape; stage_bytes.py at 256 streams,
            each full graph counting more bytes than its ablations;
            buffer_hogs.py --cycles on the camera graph, under a tenth of
            its device time tied to no port source; one step of each
            stage_bytes graph and of the roofline's camera shape counted at
            4 streams on cuda:0 and on the CPU: equal, op by op; the
            expiry fixture's two dated cards drawn by the PIL-free
            renderer equal the JAX-rendered frames, and the full step
            reads their PANs and dates
23. reference
            the compiled card.io C++'s recorded answers
            (data/ref_session.npz, written by tests/torch_fixture.py
            through the port's refbridge: the first cases of
            tools/parity_ab.py's sweeps), the inputs drawn anew by the
            port's renderer and held against their SHA-256: 64 rectified
            frames through scan_card_image in one batch (usable and vseg
            equal on every frame, hseg where usable, digits at least
            99.5%, scores within 2e-4); 4 PAN and 13 expiry sessions
            through HostScanner and the device step (every session's PAN
            and date equal the C++'s on both paths), and every frame of
            the expiry sessions through the device expiry segmentation
            (its MM/YY windows equal the C++'s, window for window); 16
            previews over the
            four orientations through detect_edges (found equal, corners
            within 1e-2 px) and transform_card from the C++'s corners
            (its card bit for bit, through persp QR and the warp), each
            card's scan against the C++'s, each through the parity
            tool's graphed device functions; the agreement counts and each
            kernel's launches in the phase on lines of their own. The
            card's machine has no OpenCV, so the oracle is never linked
            here
24. weights
            the committed weights (cardio_dmz_tpu/models/params/*.npz)
            written as the reference's generated sources
            (generated_source_text) and read back by
            tools/extract_weights.py: all 49 arrays equal the committed
            ones bit for bit; each extracted model meets its golden
            output on the card within 1e-5; the smoke fixture's frames
            through scan_card_image with the extracted weights give the
            scores, usable flags and vseg offsets of the committed
            weights' run bit for bit, digit prep launched
25. graphs  each serving shape (pan, full, camera, camera_full: the inputs
            of phases 6, 12, 10 and 13 at 256 streams) through its eager
            step and through its CUDA graph side by side, 3 warm-up and 20
            steps from fresh states: every leaf of the states and results
            bit for bit; each step's ms eager and graphed (median of 20,
            in turns), device ms and idle share (torch.profiler), host
            launches a step (the runtime's launch, copy and graph-launch
            calls), the capture's seconds and the graph pool's MiB; each
            kernel once in the eager step, once in one replay (the
            profiler's count by kernel symbol) and once among the
            launches the capture recorded; HostScanner.add_frame ms
            graphed and eager, and two shards on one card (129 + 127
            streams) graphed and eager, PAN-only and full, beside the
            unsplit eager step
26. jit sites
            the JAX package's other jit sites as graphs: for each model
            of phase 19, 5 train steps at batch 64 from the seed-0
            parameters through the eager step twice (bit for bit: the
            eager step is deterministic) and through its graph (bit for
            bit with them: parameters, mu, nu, count, loss); the step at
            batch 64 (and 4096 for the PAN conv) eager and graphed in
            turns: host-clock ms, device ms and operations, host launches
            a step, the operations of one bare replay, the capture's
            seconds; train_one's seconds graphed and eager; no serving
            kernel launched; the rectified sweep at 128 sessions and the
            camera sweep at 128, eager and graphed (EagerStep in
            graph_step's place): reads equal session for session and to
            phase 21's, seconds of each; every stage profiler's stages
            eager beside phase 22's graphed ms

Kernel times (`ms`, `plain_ms`, `library_ms`) are device times from
kernel_ms: many calls captured in one CUDA graph and replayed, so the
wrappers' Python is not inside them. The stage splits of phases 6, 10, 12
and 13 and their step times are eager and include the host's launches
(event_ms, host clock); the stage profilers (phases 22, 26) time graph
replays.

Each serving phase sets every kernel's launch count to 0 just before its
run and reads them just after, and prints them on a line of its own. A
kernel's launches are those that ran on the card: its wrapper's count, less
the launches a graph capture only recorded, plus those of the replays
(parallel/graphed.launches). The
line before the last is a JSON object with, for each kernel, its launches
on the camera serving path (and on the PAN-only one), its largest
difference from the plain version, its time, the plain version's and one
PyTorch call's where one computes the same function, and its bound: the
larger of the bytes it must move over the card's memory rate and its
operations over the card's peak rate; its launches in phase 20's entry()
and dry run; its launches in one bench step of each shape (phase 21);
its launches in one roofline step of each shape (phase 22); its
launches in phase 23; its launches in phase 24; and its launches in one
replay of each shape's graph, as the profiler counts them (phase 25).
Before
it come a line with every phase's seconds and the total, and
the card's name and power limit. The last line is {"ok": true,
"device": {...}}.
Needs no network, no JAX and no PIL; builds into
cardio_dmz_tpu_torch/_build/.
"""

import collections
import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

from cardio_dmz_tpu_torch.tools.profiling import bound, profile_step

N_STREAMS = 256          # the serving shape of tools/bench.py
# phase 21's launch shapes: the accuracy sweeps at their defaults (sessions,
# frames, batch, seed; every batch, the last one padded, is one launch at
# `batch` streams) and the scaling curve (global batch, timed steps, and the
# split sizes, each shard a launch at global batch / size streams)
SWEEP_ARGS = (512, 8, 64, 2026)          # run_sweep's defaults
CAMERA_SWEEP_ARGS = (128, 8, 32, 2026)   # run_camera_sweep's
CURVE_BATCH, CURVE_ITERS, CURVE_SIZES = 32, 8, (1, 2, 4)
# phase 22's: the stage profilers' default streams and the timed calls a
# stage, the roofline's, stage_bytes' and buffer_hogs' default streams, and
# the streams of the count on the card against the CPU
PROFILE_STREAMS, PROFILE_ITERS = 64, 3
ROOFLINE_STREAMS = 256
COUNT_STREAMS = 4
# phase 23: data/ref_session.npz, the compiled card.io C++'s answers to the
# first cases of tools/parity_ab.py's sweeps (default_rng(2026), in order),
# written by tests/torch_fixture.py from the port's refbridge (sessions of
# the tool's lengths: 10 frames a PAN session, 16 an expiry one); the bars
# are tests/test_cpp_parity.py's. The 13th expiry session of that draw
# meets the device path's 16-rect cap (ROADMAP.md section 3), so the
# sessions in order stop at 12; session 50 of the tool's default expiry
# sweep follows them: its frame 9 holds a slash at 0.69296 in the C++,
# which a bfloat16 slash MLP reads above 0.7
REF_FRAMES, REF_PAN_SESSIONS, REF_EXPIRY_SESSIONS, REF_CAMERA = 64, 4, 12, 16
REF_SWEEP_EXPIRY = (50,)
REF_ORIENTATIONS = (1, 2, 3, 4)
REF_DIGIT_AGREEMENT = 0.995   # test_frame_digit_parity_on_synthetic_frames
REF_SCORE_ATOL = 2e-4         # test_digit_parity_given_reference_hseg
REF_CORNER_ATOL = 1e-2        # test_detect_edges_and_transform_parity
# the render parameters of each kind of case, as the fixture stores them
REF_CASE_KEYS = (
    ("frame", ("pan", "y0", "width", "offset", "noise", "seed", "style")),
    ("pan_session", ("pan", "s")),
    ("expiry", ("text", "pan", "y0", "ex", "ey", "spacing", "noise",
                "style", "s")),
    ("camera", ("pan", "y0", "offset", "noise", "seed", "quad",
                "orientation")))
# every stream count at which a later phase launches a kernel: HostScanner
# and the bench's latency shapes (1), the fixture sessions (2, 3), entry()
# and the dry run's shards (4), the serving loop and the detector on the
# bench's 16 previews (16), the uneven split (127, 129), the serving shape,
# the sweeps' batches, the scaling curve's shards, phase 22's counts and
# phase 23's (its frames in one batch, its sessions as one batch each, an
# orientation's previews and, 1 to 4 of them, its found cards); each
# kernel is held against its plain version at each of them
STREAM_COUNTS = tuple(sorted({
    1, 2, 3, 4, 16, 127, 129, N_STREAMS, SWEEP_ARGS[2], CAMERA_SWEEP_ARGS[2],
    *(CURVE_BATCH // n for n in CURVE_SIZES), PROFILE_STREAMS,
    ROOFLINE_STREAMS, COUNT_STREAMS, REF_FRAMES, REF_PAN_SESSIONS,
    REF_EXPIRY_SESSIONS + len(REF_SWEEP_EXPIRY),
    *range(1, REF_CAMERA // len(REF_ORIENTATIONS) + 1)}))
WARMUP, STEPS = 3, 20
KERNEL_REPS = 50
SCORE_ATOL = 1e-5        # the reference's golden tolerance
TELEMETRY_RTOL = 1e-5    # focus/brightness: sums in another order
CARD_SHAPE = (270, 428)
FRAME_SHAPE = (480, 640)
CARD_DEST = [[0.0, 0.0], [427.0, 0.0], [0.0, 269.0], [427.0, 269.0]]
# where render_frame_with_expiry puts the fixture's dated cards' lines
# (tests/torch_fixture.py draws them so)
DATED_CARD = dict(y0=150, offset=35, expiry_y=212, expiry_x=120, noise=1)
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


PHASE_STARTS = []   # (name, perf_counter) of each phase, in order


def phase(name):
    PHASE_STARTS.append((name, time.perf_counter()))
    print(f"[{name}]", flush=True)


def phase_seconds():
    """({phase: seconds}, total): each phase from its start to the next
    one's, the last to now."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
    seconds = {name: round(end - start, 3)
               for (name, start), end in zip(PHASE_STARTS, ends)}
    return seconds, round(ends[-1] - PHASE_STARTS[0][1], 3)


def event_ms(fn, reps):
    """Median time of `reps` calls of fn, each between two CUDA events,
    after 3 warm-up calls. The span includes the host's launches, which
    is what a stage split of a launch-bound step wants; kernel times come
    from kernel_ms."""
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


def profiler_ms(fn, reps):
    """Device ms of one call of fn: the device time of every kernel and
    copy of `reps` calls under torch.profiler, over reps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if us <= 0:
        raise RuntimeError("torch.profiler saw no device time")
    return us / 1000.0 / reps


def kernel_ms(fn, reps=KERNEL_REPS):
    """Device ms of one call of fn. `reps` calls are captured back to back
    in one CUDA graph, which is replayed between two events (median of 5
    replays); the graph holds only device work, so the Python of a wrapper
    (checks, torch.empty, the ctypes call) is not timed. Where fn cannot be
    captured, the device time of its kernels under torch.profiler.
    Returns (ms, method)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"graph capture failed ({str(e).splitlines()[0]}); timing with "
              f"torch.profiler")
        return profiler_ms(fn, reps), "profiler"
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times), "graph"


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
    """Every kernel's launch count to 0: each wrapper's LAUNCHES and the
    graphs' tallies (parallel/graphed.CAPTURED, REPLAYED)."""
    from cardio_dmz_tpu_torch.parallel import graphed
    for module in modules.values():
        module.LAUNCHES = 0
    graphed.reset_launches()


def read_launches(modules):
    """Each kernel's launches that ran on the card since reset_launches:
    its wrapper's count (every eager launch, and every launch a graph
    capture recorded), less the captures' recorded launches, plus the
    launches of the graphs' replays (parallel/graphed.launches)."""
    from cardio_dmz_tpu_torch.parallel import graphed
    counted = graphed.launches()
    return {name: counted[name] for name in modules}


def build_phase(modules, ingest):
    phase("2 build")
    logs, errors = {}, {}

    def build(name):
        try:
            if name == "framepump":
                logs[name] = ingest.build()
            else:
                logs[name] = modules[name].KERNEL.build()
        except Exception as e:  # re-raised below, after every build ends
            errors[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(name,))
               for name in list(modules) + ["framepump"]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    print(f"built {len(modules)} kernels and the frame pump "
          f"({logs.pop('framepump')}) in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(f"{name}: {modules[name].KERNEL.library}")
        for line in log.splitlines():
            if "ptxas" in line:
                print(line)


def load_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def fixture_path(port, name):
    return os.path.join(os.path.dirname(port.__file__), "data", name)


def digit_strips(port, fixture, dev):
    """Three (strips, offsets) sets at N_STREAMS: uniform noise with sorted
    random offsets; the PAN strips of the recorded fixture frames (all 12
    frames tiled) with their vseg row and hseg offsets, as the serving path
    hands them to the kernel; and an all-equal strip, whose gradients are
    all 0 (every histogram increment on one bin)."""
    rng = np.random.RandomState(0)
    noise = torch.from_numpy(rng.randint(
        0, 256, (N_STREAMS, 27, 428)).astype(np.uint8)).to(dev)
    offsets = np.sort(rng.randint(0, 410, (N_STREAMS, 16)), axis=1)
    offsets[:, 0], offsets[:, -1] = 0, 409
    offsets = torch.from_numpy(offsets.astype(np.int32)).to(dev)

    frames = fixture["frames"].reshape((-1,) + CARD_SHAPE)
    frames = np.tile(frames, (-(-N_STREAMS // len(frames)), 1, 1))
    frames = torch.from_numpy(frames[:N_STREAMS]).to(dev)
    params = port.load_all_params(dev)
    vseg = port.scan.best_n_vseg(params["vseg_mlp"], frames)
    strip = port.scan.frame.pan_strip(frames, vseg.y_offset).contiguous()
    hseg = port.scan.best_n_hseg(strip, vseg.pattern_type,
                                 vseg.number_length)
    return {"noise": (noise, offsets),
            "real": (strip, hseg.offsets.to(torch.int32).contiguous()),
            "equal": (torch.full_like(noise, 77), offsets)}


def kernel_phase(port, digit_prep, fixture, dev):
    phase("3 kernel")
    inputs = digit_strips(port, fixture, dev)
    max_err, times = 0.0, {}
    for name, (strips, offsets) in inputs.items():
        got = digit_prep.prepare_digit_cells(strips, offsets)
        want = digit_prep.prepare_digit_cells_reference(strips, offsets)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"digit-prep kernel != plain version on "
                                 f"{name} strips, max abs difference {err}")
        max_err = max(max_err, err)
        for n in STREAM_COUNTS[:-1]:
            part = strips[:n].contiguous(), offsets[:n].contiguous()
            if not torch.equal(
                    digit_prep.prepare_digit_cells(*part),
                    digit_prep.prepare_digit_cells_reference(*part)):
                raise AssertionError(f"digit-prep kernel != plain version "
                                     f"on {name} strips at {n} streams")
        times[name] = kernel_ms(
            lambda: digit_prep.prepare_digit_cells(strips, offsets))[0]
    strips, offsets = inputs["real"]
    plain_ms, method = kernel_ms(
        lambda: digit_prep.prepare_digit_cells_reference(strips, offsets))
    bound_ms, bound_by = bound(*digit_prep.work(strips, offsets))
    print(f"digit_prep at {N_STREAMS}x16 cells: equal bit for bit on noise, "
          f"real and all-equal strips, and at {STREAM_COUNTS[:-1]} streams "
          f"of each; kernel ms " + ", ".join(
              f"{k} {v:.5f}" for k, v in times.items())
          + f"; plain {plain_ms:.5f} ms ({method}) on the real strips; "
          f"bound {bound_ms:.5f} ms ({bound_by})")
    return {"max_abs_err": max_err, "ms": times["real"],
            "ms_by_strips": times, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def models_phase(port, dev):
    phase("4 models")
    results = port.models.self_check(dev, verbose=True)
    if not all(results.values()):
        raise AssertionError(f"golden self-check failed: {results}")
    return port.load_all_params(dev)


def _pan(digits):
    return "".join(map(str, digits.tolist()))


def fixture_pans(fixture):
    return [_pan(d[:int(n)]) for d, n in zip(fixture["completed_digits"],
                                             fixture["completed_n"])]


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
    pans = fixture_pans(fixture)
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


def timed_steps(kernels, step, states, inputs):
    """The loop of the serving phases: every kernel's launch count set to
    0, WARMUP steps, then STEPS steps timed on the host clock up to a
    synchronize; step(states, inputs[i % len(inputs)]) -> (states,
    outputs). Returns (states, the last outputs, seconds, launches, peak
    device memory in MiB, the phase's inputs included)."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    for i in range(WARMUP):
        states, _ = step(states, inputs[i % len(inputs)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP, WARMUP + STEPS):
        states, out = step(states, inputs[i % len(inputs)])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return (states, out, elapsed, read_launches(kernels),
            torch.cuda.max_memory_allocated() / 2**20)


def serving_phase(port, kernels, params, fixture, pans, card, dev):
    phase("6 serving")
    n_src = fixture["frames"].shape[0]
    reps = -(-N_STREAMS // n_src)
    tiled = np.tile(fixture["frames"], (reps, 1, 1, 1))[:N_STREAMS]
    steps = [torch.from_numpy(np.ascontiguousarray(tiled[:, t])).to(dev)
             for t in range(tiled.shape[1])]
    now = tuple(fixture["now"].tolist())

    states, (_, results), elapsed, launches, peak_mib = timed_steps(
        kernels, lambda st, fr: port.batched_scanner_step(params, st, fr),
        port.init_stream_states(N_STREAMS, dev, now), steps)

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
    print(f"scan_pipeline_throughput {N_STREAMS * STEPS / elapsed:.1f} "
          f"frames/s; step {step_ms:.3f} ms at {N_STREAMS} streams, "
          f"PAN-only, {STEPS} steps after {WARMUP} warm-up; all streams "
          f"complete; peak memory {peak_mib:.1f} MiB; card {card}")

    # per-stage split: each stage alone at the serving shape, host launches
    # included
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
    print("stage split, median ms of 10 event-timed calls: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    print(f"kernel launches on this path: {launches}")
    return {"launches": launches, "step_ms": step_ms,
            "frames_per_s": N_STREAMS * STEPS / elapsed,
            "peak_mib": peak_mib, "split": split}


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


def persp_systems(src, dst):
    """The 8x8 systems A h = b of llcv_calc_persp_transform (cv/warp.cpp:
    46-67) for src (S, 4, 2) and dst (4, 2) or (S, 4, 2): the library
    call's input."""
    s = src.shape[0]
    dst = dst.expand(s, 4, 2)
    sx, sy = src[:, :, 0], src[:, :, 1]
    dx, dy = dst[:, :, 0], dst[:, :, 1]
    zero, one = torch.zeros_like(sx), torch.ones_like(sx)
    top = torch.stack([sx, sy, one, zero, zero, zero, -sx * dx, -sy * dx], 2)
    bot = torch.stack([zero, zero, zero, sx, sy, one, -sx * dy, -sy * dy], 2)
    return torch.cat([top, bot], 1), torch.cat([dx, dy], 1)[:, :, None]


def op_cycles(dev):
    """Cycles of one dependent add, multiply, IEEE division, IEEE square
    root and warp shuffle on the card, and one warp's cycles an add on
    eight independent chains ("add_issue"), from tools/op_latency.cu,
    built here by ops/cuda/_build.py with the kernels' flags."""
    import ctypes
    from cardio_dmz_tpu_torch.ops.cuda import _build
    probe = _build.CudaKernel("op_latency", "op_latency_launch",
                              [ctypes.c_void_p] * 4, flags=("--fmad=false",))
    probe.source = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tools", "op_latency.cu")
    x = torch.tensor([1.5, 1.0 + 2.0**-10], device=dev)
    sink = torch.empty(32, device=dev)
    out = torch.zeros(6, dtype=torch.int64, device=dev)
    probe.launch(x.data_ptr(), sink.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    reps = 512                              # op_latency.cu's kReps
    return dict(zip(("add", "mul", "div", "sqrt", "shfl", "add_issue"),
                    (v / reps for v in out.tolist())))


def sm_clock_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])


PERSP_COUNTS = tuple(sorted({*STREAM_COUNTS, 255, 257}))


def dest_rects(rng, n):
    """n distinct destination rectangles in the warp's corner order (tl,
    tr, bl, br), corners at fractional positions: (n, 4, 2) float32."""
    x0, y0 = rng.uniform(-20.0, 20.0, (2, n))
    w, h = rng.uniform(200.0, 500.0, (2, n))
    return np.stack(
        [np.stack([x0, y0], 1), np.stack([x0 + w, y0], 1),
         np.stack([x0, y0 + h], 1), np.stack([x0 + w, y0 + h], 1)],
        1).astype(np.float32)


def persp_cases(persp_qr, dev):
    """The kernel against its plain version, bit for bit, at each of
    PERSP_COUNTS streams, the last block (eight streams, two a warp) part
    full but at the multiples of 8: the degenerate sets (all zero, a
    repeated corner, an inf and a NaN corner) first, then
    detector-realistic quads; with the card's destination for every
    stream and with a rectangle a stream."""
    rng = np.random.RandomState(3)
    guide = np.float32(GUIDE_LANDSCAPE)
    rep, inf, nan = guide.copy(), guide.copy(), guide.copy()
    rep[1] = rep[0]
    inf[3, 0], nan[0, 1] = np.inf, np.nan
    pool = torch.cat([torch.from_numpy(np.stack(
        [np.zeros_like(guide), rep, inf, nan])), _quads(
            GUIDE_LANDSCAPE, rng, max(PERSP_COUNTS))]).to(dev)
    rects = torch.from_numpy(dest_rects(rng, len(pool))).to(dev)
    card = torch.tensor(CARD_DEST, dtype=torch.float32, device=dev)
    for n in PERSP_COUNTS:
        for name, dst in (("shared", card), ("per-stream", rects[:n])):
            src = pool[:n]
            got = persp_qr.eigen_persp_transform_batched(src, dst)
            want = persp_qr.persp_transform_reference(src, dst)
            torch.cuda.synchronize()
            if not _bits_equal(got, want):
                raise AssertionError(
                    f"persp-QR kernel != plain version at {n} streams, "
                    f"{name} dest, max abs difference "
                    f"{_max_abs_err(got, want)}")
    print(f"persp_qr == plain bit for bit at {PERSP_COUNTS} streams, "
          f"degenerate sets (all zero, repeated, inf, NaN corner) first, "
          f"shared and per-stream dest")


def persp_phase(persp_qr, dev):
    """Phase 7's check and times at N_STREAMS: the kernels line's keys."""
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
    ms, method = kernel_ms(
        lambda: persp_qr.eigen_persp_transform_batched(src, dst))
    plain_ms, plain_method = kernel_ms(
        lambda: persp_qr.persp_transform_reference(src, dst))
    a, b = persp_systems(src, dst)
    library_ms, library_method = kernel_ms(
        lambda: torch.linalg.solve_ex(a, b))
    solved = torch.linalg.solve_ex(a, b)[0][:, :, 0]
    lib_err = (solved - got[:N_STREAMS].reshape(-1, 9)[:, :8]).abs().max()
    flops, n_bytes, kind = persp_qr.work(src, dst)
    n_ops = flops // N_STREAMS
    bound_ms, bound_by = bound(flops, n_bytes, kind)
    print(f"persp_qr at {N_STREAMS} streams (+1 all-zero set): equal bit for "
          f"bit, NaN included; kernel {ms:.5f} ms ({method}), plain "
          f"{plain_ms:.5f} ms ({plain_method}), torch.linalg.solve_ex "
          f"{library_ms:.5f} ms ({library_method}; max abs difference from "
          f"the kernel {lib_err.item():.3g}); bound {bound_ms:.7f} ms "
          f"({bound_by}: {n_bytes} B, {n_ops} f32 operations a stream)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def persp_floors(persp_qr, dev):
    """Phase 7's floors beside the kernel's time, printed on their own
    line: the solve's dependency chain (persp_qr_ops at the latencies of
    op_cycles) at the SM clock, and an empty launch (a fill of one
    element) timed as kernel_ms times the kernels."""
    one = torch.zeros(1, device=dev)
    empty_ms, _ = kernel_ms(lambda: one.fill_(0.0))
    mhz = sm_clock_mhz()
    cycles = op_cycles(dev)
    _, n_chain, on_chain = persp_qr.persp_qr_ops()
    chain_cycles = persp_qr.persp_qr_ops(cycles)[1]
    chain_ms = chain_cycles / mhz / 1e3
    print(f"persp_qr chain: {n_chain} dependent operations ({on_chain}); "
          f"cycles an op on the card {cycles}; {chain_cycles:.0f} cycles, "
          f"{chain_ms:.5f} ms at the SM clock of {mhz:.0f} MHz; empty "
          f"launch (fill_ of one element) {empty_ms:.5f} ms")
    return {"chain_floor_ms": chain_ms, "chain_cycles": chain_cycles,
            "chain_ops": on_chain, "op_cycles": cycles, "sm_clock_mhz": mhz,
            "empty_launch_ms": empty_ms}


def warp_phase(port, warp, dev):
    phase("8 warp")
    rng = np.random.RandomState(2)
    frames = torch.from_numpy(rng.randint(
        0, 256, (N_STREAMS + 1,) + FRAME_SHAPE).astype(np.uint8)).to(dev)
    dst = torch.tensor(CARD_DEST, dtype=torch.float32, device=dev)
    max_err, timed, times = 0, None, {}
    for name, guide, transpose in (("landscape", GUIDE_LANDSCAPE, False),
                                   ("portrait", GUIDE_PORTRAIT, True)):
        # the last stream's corners are all zero: a NaN homography
        quads = torch.cat([_quads(guide, rng, N_STREAMS),
                           torch.zeros((1, 4, 2))]).to(dev)
        m = port.ops.eigen_persp_transform(quads, dst)
        got = warp.warp_perspective_exact(frames, m, CARD_SHAPE, transpose)
        want = warp.warp_perspective_reference(frames, m, CARD_SHAPE,
                                               transpose)
        torch.cuda.synchronize()
        err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"warp kernel != plain route ({name}), max "
                                 f"abs difference {err}")
        if torch.isfinite(m[-1]).all() or got[-1].any():
            raise AssertionError("want a NaN homography for the all-zero "
                                 "corners and a zero card from it")
        max_err = max(max_err, err)
        for n in STREAM_COUNTS[:-1]:
            # n - 1 streams and the NaN one; at one stream each alone
            for rows in ([0], [N_STREAMS]) if n == 1 else (
                    list(range(n - 1)) + [N_STREAMS],):
                part = frames[rows], m[rows], CARD_SHAPE, transpose
                if not torch.equal(
                        warp.warp_perspective_exact(*part),
                        warp.warp_perspective_reference(*part)):
                    raise AssertionError(f"warp kernel != plain route "
                                         f"({name}) at {n} streams")
        args = (frames[:N_STREAMS].contiguous(), m[:N_STREAMS].contiguous(),
                CARD_SHAPE, transpose)
        times[name], method = kernel_ms(
            lambda: warp.warp_perspective_exact(*args))
        timed = timed or args           # the serving path's: landscape
    frames, m, _, transpose = timed
    ms = times["landscape"]
    plain_ms, plain_method = kernel_ms(
        lambda: warp.warp_perspective_reference(*timed))
    flops, n_bytes, kind = warp.work(*timed)
    bound_ms, bound_by = bound(flops, n_bytes, kind)
    print(f"warp at {N_STREAMS} streams (+1 NaN homography) and at "
          f"{STREAM_COUNTS[:-1]} streams (the NaN one among them), landscape "
          f"and portrait: kernel == plain route u8 for u8; kernel landscape "
          f"{ms:.5f} ms, portrait {times['portrait']:.5f} ms ({method}), "
          f"plain landscape {plain_ms:.5f} ms ({plain_method});"
          f" bound {bound_ms:.5f} ms ({bound_by}: {n_bytes} B, {flops} f64 "
          f"operations)")
    return {"max_abs_err": float(max_err), "ms": ms,
            "ms_by_orientation": times, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


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


def card_maps(fn):
    """The ops of one call of fn whose output is a float64 or int32 tensor
    of the card's shape (S, 270, 428): the coordinate maps and their
    temporaries, where they go through device memory."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.found = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor)
                        and tuple(t.shape[-2:]) == CARD_SHAPE
                        and t.dtype in (torch.float64, torch.int32)):
                    self.found.append(f"{func}:{t.dtype}")
            return out

    with Record() as record:
        fn()
    torch.cuda.synchronize()
    return record.found


def camera_serving_phase(port, kernels, params, fixture, pans, card, dev):
    phase("10 camera serving")
    n_src, n_frames = fixture["y"].shape[:2]
    streams = np.arange(N_STREAMS) % n_src
    steps = [tuple(torch.from_numpy(np.ascontiguousarray(
        fixture[k][streams, t])).to(dev) for k in ("y", "cb", "cr"))
        for t in range(n_frames)]
    now = tuple(fixture["now"].tolist())

    states, (found, _, results), elapsed, launches, peak_mib = timed_steps(
        kernels,
        lambda st, planes: port.batched_camera_step(params, st, *planes),
        port.init_stream_states(N_STREAMS, dev, now), steps)

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
    print(f"camera_pipeline_throughput {N_STREAMS * STEPS / elapsed:.1f} "
          f"frames/s; step {step_ms:.3f} ms at {N_STREAMS} streams of "
          f"480x640 Y + 240x320 Cb/Cr, PAN-only, exact warp, {STEPS} steps "
          f"after {WARMUP} warm-up; all streams complete; peak memory "
          f"{peak_mib:.1f} MiB; card {card}")

    # per-stage split: each stage alone at the serving shape, host launches
    # included
    y, cb, cr = steps[0]
    dst = torch.tensor(CARD_DEST, dtype=torch.float32, device=dev)
    _, corner_points = port.api.detect_edges(y, cb, cr)
    corners = _corners(corner_points)
    m = port.ops.eigen_persp_transform(corners, dst)
    cards = port.ops.warp_perspective_exact(y, m, CARD_SHAPE)

    def step():
        return port.batched_camera_step(params, states, y, cb, cr)

    split = {
        "detect": event_ms(lambda: port.api.detect_edges(y, cb, cr), 10),
        "homography": event_ms(
            lambda: port.ops.eigen_persp_transform(corners, dst), 10),
        "warp": event_ms(lambda: port.ops.warp_perspective_exact(
            y, m, CARD_SHAPE), 10),
        "scan": event_ms(lambda: port.batched_scanner_step(
            params, states, cards), 10),
        "step": event_ms(step, 10),
    }
    split["rest (telemetry, gating)"] = split["step"] - sum(
        v for k, v in split.items() if k != "step")
    print("camera stage split, median ms of 10 event-timed calls: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    maps = card_maps(step)
    profile = profile_step(step)
    print(f"one step: {len(maps)} card-shaped float64/int32 tensors made "
          f"({sorted(set(maps))}); profile: {profile['device_ms']:.3f} ms "
          f"of device time over {profile['device_ops']} device operations, "
          f"{profile['f64_ops']} of them on float64 "
          f"({profile['f64_ms']:.3f} ms)")
    print(f"kernel launches on this path: {launches}")
    return {"launches": launches, "step_ms": step_ms,
            "frames_per_s": N_STREAMS * STEPS / elapsed,
            "peak_mib": peak_mib, "split": split, "card_maps": maps,
            "profile": profile}


# dmz's FrameOrientation values (constants.py), by name
ORIENTATIONS = {"portrait": 1, "portrait_upside_down": 2,
                "landscape_right": 3, "landscape_left": 4}


def paste_previews(cards, bg=50, orientation="landscape_right",
                   shift=(0, 0)):
    """Cards (..., 270, 428) u8 on an orientation's guide rect of 480x640 Y
    previews with flat 128 half-size chroma, as tests/torch_fixture.py
    places them: (y, cb, cr) numpy. A landscape_left card stands on its
    head in the landscape rect; a portrait card lies on its side in the
    portrait rect, its top edge to the left (portrait) or to the right
    (portrait_upside_down). shift = (dx, dy) moves the card off the rect
    by whole pixels."""
    y = np.full(cards.shape[:-2] + FRAME_SHAPE, bg, np.uint8)
    dx, dy = shift
    if orientation.startswith("landscape"):
        (x0, y0), _, _, (x1, y1) = GUIDE_LANDSCAPE + np.array([dx, dy])
        turned = cards if orientation == "landscape_right" \
            else cards[..., ::-1, ::-1]
        y[..., y0:y1, x0:x1] = turned
    else:
        (x0, y1), (_, y0), (x1, _), _ = GUIDE_PORTRAIT + np.array([dx, dy])
        turned = np.rot90(cards, 1 if orientation == "portrait" else -1,
                          axes=(-2, -1))
        y[..., y0 + 1:y1 + 1, x0:x1] = turned
    cbcr = np.full(cards.shape[:-2] + (240, 320), 128, np.uint8)
    return y, cbcr, cbcr.copy()


def _compare_expiry_run(port, params, fixture, prefix, run, cards):
    """One replayed session, a (state, FrameResult, ScannerResult) per
    frame, against the fixture's arrays under `prefix`. cards: per frame
    the (S, 270, 428) cards that were scanned, or None to leave the window
    scores out. Returns the largest score difference."""
    def per_frame(get):
        return np.stack([get(r).cpu().numpy() for r in run], axis=1)

    got = {f"window_{k}": per_frame(lambda r: getattr(r[1].expiry_groups, k))
           for k in ("valid", "top", "left", "char_tops", "char_lefts")}
    got.update({f"expiry_{k}": per_frame(lambda r: getattr(r[0].expiry, k))
                for k in ("active", "top", "left", "scores", "recently_seen",
                          "total_seen")})
    got.update(
        vseg_y_offset=per_frame(lambda r: r[1].vseg.y_offset),
        usable=per_frame(lambda r: r[1].usable),
        expiry_month=per_frame(lambda r: r[0].expiry_month),
        expiry_year=per_frame(lambda r: r[0].expiry_year),
        complete=per_frame(lambda r: r[2].complete),
        result_month=per_frame(lambda r: r[2].expiry_month),
        result_year=per_frame(lambda r: r[2].expiry_year))
    final = run[-1][0]
    got.update({k: getattr(final, k).cpu().numpy() for k in (
        "frames_since_complete", "number_complete", "completed_digits",
        "completed_n")})
    if cards is not None:
        got["window_scores"] = np.stack([
            port.scan.expiry_device.categorize_windows(
                params["expiry_conv"], c, r[1].expiry_groups).cpu().numpy()
            for c, r in zip(cards, run)], axis=1)
    err = 0.0
    for key, value in got.items():
        want = fixture[prefix + key]
        if np.issubdtype(value.dtype, np.floating):
            np.testing.assert_allclose(value, want, atol=SCORE_ATOL, rtol=0,
                                       err_msg=prefix + key)
            err = max(err, float(np.abs(value - want).max()))
        elif not np.array_equal(value, want):
            raise AssertionError(f"{prefix}{key} differs from the JAX "
                                 f"package's:\n{value}\n{want}")
    return err


def _dates(months, years):
    return [f"{int(m):02d}/{int(y)}" for m, y in zip(months, years)]


def fixture_dates(fixture):
    """The date each session of the expiry fixture ends with, "00/0" for
    none."""
    return _dates(fixture["expiry_month"][:, -1],
                  fixture["expiry_year"][:, -1])


def expiry_phase(port, kernels, params, fixture, dev):
    phase("11 expiry")
    golden = port.models.load_np("expiry_conv", include_test_vectors=True)
    _, a1, a2, hidden = params["expiry_conv"](
        torch.from_numpy(golden["test_input"]).to(dev),
        return_intermediates=True)
    for key, value in (("test_conv1_out", a1.reshape(50, 70)),
                       ("test_conv2_out", a2), ("test_hidden_out", hidden)):
        err = np.abs(value.cpu().numpy() - golden[key]).max()
        if not err <= SCORE_ATOL:
            raise AssertionError(f"expiry_conv {key}: max abs error {err}")
        print(f"expiry_conv {key}: golden max abs error {err:.3g}")

    now = tuple(fixture["now"].tolist())
    n_streams, n_frames = fixture["frames"].shape[:2]
    frames = torch.from_numpy(fixture["frames"]).to(dev)
    reset_launches(kernels)
    state = port.init_stream_states(n_streams, dev, now)
    run = []
    for t in range(n_frames):
        state, (fr, res) = port.batched_scanner_step(
            params, state, frames[:, t], scan_expiry=True)
        run.append((state, fr, res))
    final, (_, results) = port.scan_frames(params, frames, now,
                                           scan_expiry=True)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    err = _compare_expiry_run(port, params, fixture, "", run,
                              [frames[:, t] for t in range(n_frames)])
    for a, b in ((final.expiry_month, state.expiry_month),
                 (final.expiry_year, state.expiry_year),
                 (results.complete[:, -1], run[-1][2].complete)):
        if not torch.equal(a, b):
            raise AssertionError("scan_frames and the stepped sessions "
                                 "disagree")
    if launches["digit_prep"] != 2 * n_frames:
        raise AssertionError(f"want digit prep launched once a step; got "
                             f"{launches}")

    y, cb, cr = (torch.from_numpy(p).to(dev)
                 for p in paste_previews(fixture["frames"]))
    reset_launches(kernels)
    cam_state = port.init_stream_states(n_streams, dev, now)
    cam_run, found = [], []
    for t in range(n_frames):
        cam_state, (fnd, fr, res) = port.batched_camera_step(
            params, cam_state, y[:, t], cb[:, t], cr[:, t], scan_expiry=True)
        cam_run.append((cam_state, fr, res))
        found.append(fnd.cpu().numpy())
    torch.cuda.synchronize()
    cam_launches = read_launches(kernels)
    if not np.array_equal(np.stack(found, axis=1), fixture["camera_found"]):
        raise AssertionError("camera found flags differ from the JAX "
                             "package's")
    cam_err = _compare_expiry_run(port, params, fixture, "camera_", cam_run,
                                  None)
    if any(n != n_frames for n in cam_launches.values()):
        raise AssertionError(f"want each kernel launched once a camera "
                             f"step; got {cam_launches}")

    # the fixture's last stream has no expiry line: it holds its number,
    # has no date, and completes only once the grace period is over
    dates = _dates(state.expiry_month.cpu(), state.expiry_year.cpu())
    complete = run[-1][2].complete.cpu().tolist()
    if (dates != fixture_dates(fixture) or dates[-1] != "00/0"
            or complete != [True] * (n_streams - 1) + [False]
            or not state.number_complete.all()):
        raise AssertionError(f"want every dated session complete and the "
                             f"undated one waiting; got {dates} {complete}")
    grace = port.session.state.EXPIRY_GRACE_FRAMES
    for since, want in ((grace, False), (grace + 1, True)):
        _, res = port.session.scanner_result(state._replace(
            frames_since_complete=torch.full_like(
                state.frames_since_complete, since)))
        if bool(res.complete[-1]) != want or int(res.expiry_month[-1]):
            raise AssertionError(
                f"grace rule: {since} frames after the number the undated "
                f"session reads complete={bool(res.complete[-1])}")
    print(f"full sessions ({n_streams} streams x {n_frames} frames) read "
          f"{dates} with the PANs {fixture_pans(fixture)}, through the "
          f"scanner step and the camera step; windows, char rects, slot "
          f"tables and dates equal the JAX package's; window and slot "
          f"scores max abs error {max(err, cam_err):.3g}; the undated "
          f"session completes after {grace + 1} frames of grace, not after "
          f"{grace}; launches scan {launches}, camera {cam_launches}")
    return dates


def full_split(port, params, frames, states):
    """The full step's stages alone at the serving shape, each a median of
    10 event-timed calls, host launches included."""
    expiry = port.scan.expiry_device
    fr = port.scan.scan_card_image(params, frames, scan_expiry=True)
    enabled = torch.ones_like(fr.usable)
    windows = expiry.best_expiry_seg_device(
        params["slash_mlp"], frames, fr.vseg.y_offset, enabled)
    scores = expiry.categorize_windows(params["expiry_conv"], frames, windows)

    def aggregate():
        merged = expiry.aggregate_windows(states.expiry, windows, scores)
        return expiry.extract_expiry(merged, states.expiry_month,
                                     states.expiry_year, states.now_year,
                                     states.now_month)

    return {
        "expiry seg": event_ms(lambda: expiry.best_expiry_seg_device(
            params["slash_mlp"], frames, fr.vseg.y_offset, enabled), 10),
        "expiry categorize": event_ms(lambda: expiry.categorize_windows(
            params["expiry_conv"], frames, windows), 10),
        "aggregate + extract": event_ms(aggregate, 10),
        "PAN-only step": event_ms(lambda: port.batched_scanner_step(
            params, states, frames), 10),
        "full step": event_ms(lambda: port.batched_scanner_step(
            params, states, frames, scan_expiry=True), 10),
    }


def _check_full(fixture, dates, streams, states, results, launches, want):
    pans = fixture_pans(fixture)
    got = [(_pan(d[:int(n)]), date) for d, n, date in zip(
        states.completed_digits.cpu(), states.completed_n.cpu(),
        _dates(results.expiry_month.cpu(), results.expiry_year.cpu()))]
    expected = [(pans[s], dates[s]) for s in streams]
    if not (results.complete.all() and got == expected):
        raise AssertionError(
            f"{int(results.complete.sum())}/{N_STREAMS} streams completed, "
            f"{sum(g == w for g, w in zip(got, expected))} with the right "
            f"PAN and date")
    if want is not None and launches != want:
        raise AssertionError(f"want kernel launches {want} in "
                             f"{WARMUP + STEPS} steps; got {launches}")


def full_serving_phase(port, kernels, params, fixture, dates, card, dev):
    phase("12 full serving")
    n_dated = sum(d != "00/0" for d in dates)
    streams = np.arange(N_STREAMS) % n_dated
    n_frames = fixture["frames"].shape[1]
    steps = [torch.from_numpy(np.ascontiguousarray(
        fixture["frames"][streams, t])).to(dev) for t in range(n_frames)]
    now = tuple(fixture["now"].tolist())

    def step(states, frames):
        return port.batched_scanner_step(params, states, frames,
                                         scan_expiry=True)

    states, (_, results), elapsed, launches, peak_mib = timed_steps(
        kernels, step, port.init_stream_states(N_STREAMS, dev, now), steps)
    _check_full(fixture, dates, streams, states, results, launches,
                {"digit_prep": WARMUP + STEPS, "warp_gather": 0,
                 "persp_qr": 0})
    step_ms = 1000.0 * elapsed / STEPS
    profile = profile_step(lambda: step(states, steps[0]))
    print(f"full_scan_pipeline_throughput {N_STREAMS * STEPS / elapsed:.1f} "
          f"frames/s; step {step_ms:.3f} ms at {N_STREAMS} streams, PAN + "
          f"expiry, {STEPS} steps after {WARMUP} warm-up; all streams "
          f"complete with PAN and date; {profile['device_ms']:.3f} ms of "
          f"device time over {profile['device_ops']} device operations a "
          f"step; peak memory {peak_mib:.1f} MiB; card {card}")
    print("most device time: " + "; ".join(
        f"{name} {ms:.3f} ms in {n}" for name, ms, n in profile["top"]))
    split = full_split(port, params, steps[0], states)
    print("full stage split, median ms of 10 event-timed calls: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    print(f"kernel launches on this path: {launches}")
    return {"launches": launches, "step_ms": step_ms,
            "frames_per_s": N_STREAMS * STEPS / elapsed,
            "peak_mib": peak_mib, "split": split, "profile": profile}


def full_camera_serving_phase(port, kernels, params, fixture, dates, card,
                              dev):
    phase("13 full camera serving")
    n_dated = sum(d != "00/0" for d in dates)
    streams = np.arange(N_STREAMS) % n_dated
    n_frames = fixture["frames"].shape[1]
    steps = [tuple(torch.from_numpy(p).to(dev) for p in paste_previews(
        fixture["frames"][streams, t])) for t in range(n_frames)]
    now = tuple(fixture["now"].tolist())

    def step(states, planes, scan_expiry=True):
        return port.batched_camera_step(params, states, *planes,
                                        scan_expiry=scan_expiry)

    states, (found, _, results), elapsed, launches, peak_mib = timed_steps(
        kernels, step, port.init_stream_states(N_STREAMS, dev, now), steps)
    if not found.all():
        raise AssertionError(f"{int(found.sum())}/{N_STREAMS} cards found")
    _check_full(fixture, dates, streams, states, results, launches,
                {name: WARMUP + STEPS for name in kernels})
    step_ms = 1000.0 * elapsed / STEPS
    profile = profile_step(lambda: step(states, steps[0]))
    print(f"full_camera_pipeline_throughput "
          f"{N_STREAMS * STEPS / elapsed:.1f} frames/s; step {step_ms:.3f} "
          f"ms at {N_STREAMS} streams of 480x640 Y + 240x320 Cb/Cr, PAN + "
          f"expiry, exact warp, {STEPS} steps after {WARMUP} warm-up; all "
          f"streams complete with PAN and date; "
          f"{profile['device_ms']:.3f} ms of device time over "
          f"{profile['device_ops']} device operations a step; peak memory "
          f"{peak_mib:.1f} MiB; card {card}")
    _, cards = port.api.preprocess_frame(*steps[0])
    split = {
        "camera PAN-only step": event_ms(
            lambda: step(states, steps[0], scan_expiry=False), 10),
        "full scan of the cards": event_ms(
            lambda: port.batched_scanner_step(params, states, cards,
                                              scan_expiry=True), 10),
        "full camera step": event_ms(lambda: step(states, steps[0]), 10),
    }
    print("full camera stage split, median ms of 10 event-timed calls: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    print(f"kernel launches on this path: {launches}")
    return {"launches": launches, "step_ms": step_ms,
            "frames_per_s": N_STREAMS * STEPS / elapsed,
            "peak_mib": peak_mib, "split": split, "profile": profile}


def _host_groups(groups):
    """Host expiry groups as the set the device's windows compare with."""
    return {(g.top, g.left, tuple(r.top for r in g.character_rects),
             tuple(r.left for r in g.character_rects)) for g in groups}


HOST_MAX_GROUPS = 4       # expiry groups a frame kept in the host fixture


def group_rects(groups):
    """Host expiry groups as the host fixture keeps them: (count, tops
    (4, 5), lefts (4, 5)) of the groups' char rects, -1 where there is no
    group."""
    tops = np.full((HOST_MAX_GROUPS, 5), -1, np.int32)
    lefts = np.full((HOST_MAX_GROUPS, 5), -1, np.int32)
    for i, g in enumerate(groups[:HOST_MAX_GROUPS]):
        tops[i] = [r.top for r in g.character_rects]
        lefts[i] = [r.left for r in g.character_rects]
    return np.int32(len(groups)), tops, lefts


def host_device_windows_agree(port, params, frames, vseg_y):
    """The port's host oracle against its device path on (N, 270, 428)
    frames at their vseg rows: every valid window of
    best_expiry_seg_device is a group of best_expiry_seg, with equal char
    rects, and the other way round. Returns the number of windows."""
    dev = frames.device
    windows = port.scan.expiry_device.best_expiry_seg_device(
        params["slash_mlp"], frames, vseg_y,
        torch.ones(len(frames), dtype=torch.bool, device=dev))
    valid, top, left, tops, lefts = (getattr(windows, k).cpu().numpy()
                                     for k in windows._fields)
    n_windows = 0
    for i, y in enumerate(frames.cpu().numpy()):
        host = _host_groups(port.scan.best_expiry_seg(
            y, int(vseg_y[i]), params["slash_mlp"])[0])
        device = {(int(top[i, w]), int(left[i, w]), tuple(tops[i, w]),
                   tuple(lefts[i, w])) for w in np.nonzero(valid[i])[0]}
        if host != device:
            raise AssertionError(f"frame {i}: host oracle {sorted(host)} != "
                                 f"device path {sorted(device)}")
        n_windows += len(device)
    return n_windows


def host_ms(fn, reps):
    """Median host-clock ms of `reps` calls of fn, each ended by a
    synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def host_scanner_phase(port, kernels, params, expiry, host, card, dev):
    phase("14 host scanner")
    frames = expiry["frames"]                        # (3, T, 270, 428)
    n_frames = frames.shape[1]
    scanner = port.HostScanner(params, now=tuple(host["now"].tolist()))
    if scanner.device != dev:
        raise AssertionError(f"HostScanner runs on {scanner.device}")
    reads, frame_ms = [], []
    for s, stream in enumerate(frames):
        scanner.reset()
        reset_launches(kernels)
        for t, y in enumerate(stream):
            t0 = time.perf_counter()
            frame, result = scanner.add_frame(y)
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            n_groups, tops, lefts = group_rects(port.scan.best_expiry_seg(
                y, int(frame.vseg.y_offset), params["slash_mlp"])[0])
            got = {
                "usable": bool(frame.usable),
                "vseg_y_offset": int(frame.vseg.y_offset),
                "vseg_pattern_type": int(frame.vseg.pattern_type),
                "hseg_n_offsets": int(frame.hseg.n_offsets),
                "hseg_offsets": frame.hseg.offsets.cpu().numpy(),
                "complete": bool(result.complete),
                "predictions": result.predictions,
                "expiry_month": result.expiry_month,
                "expiry_year": result.expiry_year,
                "state_month": scanner.expiry_month,
                "state_year": scanner.expiry_year,
                "n_groups": n_groups, "group_tops": tops,
                "group_lefts": lefts}
            for key, value in got.items():
                if not np.array_equal(value, host[f"host_{key}"][s, t]):
                    raise AssertionError(
                        f"HostScanner stream {s} frame {t}: {key} = {value}; "
                        f"the JAX package's {host[f'host_{key}'][s, t]}")
        launches = read_launches(kernels)
        # the first frame of the first session captures the PAN step's
        # graph after WARMUP_CALLS eager steps; every frame replays it
        want = n_frames + (port.parallel.graphed.WARMUP_CALLS if s == 0
                           else 0)
        if launches != {"digit_prep": want, "warp_gather": 0,
                        "persp_qr": 0}:
            raise AssertionError(f"want digit prep launched {want} times "
                                 f"at one stream; got {launches}")
        reads.append((scanner.card_number, result.complete,
                      f"{result.expiry_month:02d}/{result.expiry_year}"))
    pans = fixture_pans(expiry)
    dates = fixture_dates(expiry)
    if reads != [(pans[0], True, dates[0]), (pans[1], True, dates[1]),
                 (pans[2], False, "00/0")]:
        raise AssertionError(f"HostScanner read {reads}")
    graphs = list(scanner._step.entries.values())
    if len(graphs) != 1 or (dev.type == "cuda" and graphs[0].graph is None):
        raise AssertionError(f"HostScanner's PAN step: {len(graphs)} graph "
                             f"keys, want one CUDA graph for one shape")
    # the undated card is the last session: it completes through grace only
    grace = port.session.state.EXPIRY_GRACE_FRAMES
    for since, want in ((grace, False), (grace + 1, True)):
        scanner.state = scanner.state._replace(
            frames_since_complete=torch.full_like(
                scanner.state.frames_since_complete, since))
        if scanner.result().complete != want or scanner.result().expiry_month:
            raise AssertionError(f"grace rule: {since} frames after the "
                                 f"number complete={not want}")

    flat = torch.from_numpy(frames.reshape((-1,) + CARD_SHAPE)).to(dev)
    vseg_y = torch.from_numpy(
        host["host_vseg_y_offset"].reshape(-1).astype(np.int32)).to(dev)
    n_windows = host_device_windows_agree(port, params, flat, vseg_y)

    # one frame's parts: the PAN step at one stream, and the host expiry
    y = frames[0, 0]
    state = port.init_stream_states(1, dev, (2026, 1))
    y_dev = torch.from_numpy(y).to(dev)[None]
    pan_ms = host_ms(lambda: port.session.scanner_step(
        params, state, y_dev, scan_expiry=False), 20)

    def host_expiry():
        groups, _ = port.scan.best_expiry_seg(y, 150, params["slash_mlp"])
        port.scan.expiry_extract(y, [], groups, params["expiry_conv"],
                                 now=(2026, 1))
    expiry_ms = host_ms(host_expiry, 20)
    print(f"HostScanner on {dev}: {len(frames)} sessions x {n_frames} frames "
          f"equal the JAX HostScanner's frame by frame; reads {reads}; the "
          f"undated card completes after {grace + 1} frames of grace; host "
          f"oracle == device path on {len(flat)} frames ({n_windows} "
          f"windows); launches a session {launches}; add_frame median "
          f"{statistics.median(frame_ms):.3f} ms (PAN step at 1 stream "
          f"{pan_ms:.3f} ms, host expiry {expiry_ms:.3f} ms); card {card}")
    return {"launches": launches,
            "frame_ms": statistics.median(frame_ms), "pan_step_ms": pan_ms,
            "host_expiry_ms": expiry_ms}


ORIENTED = ("portrait", "landscape_left")    # the host fixture's camera runs
_CORNER_NAMES = ("tl", "tr", "bl", "br")


def _oriented_inputs(expiry, host, orientation, dev):
    """The host fixture's camera run at an orientation: per frame the
    (y, cb, cr) planes and the (iso, shutter, torch) metadata, on dev."""
    n_streams, n_frames = host["iso_speed"].shape
    planes = paste_previews(expiry["frames"][:n_streams, :n_frames],
                            orientation=orientation)
    return [(tuple(torch.from_numpy(np.ascontiguousarray(p[:, t])).to(dev)
                   for p in planes),
             tuple(torch.from_numpy(np.ascontiguousarray(host[k][:, t])).to(
                 dev) for k in ("iso_speed", "shutter_speed", "torch_is_on")))
            for t in range(n_frames)]


def _oriented_step(port, params, state, orientation, planes, meta):
    return port.batched_camera_step(
        params, state, *planes, orientation=ORIENTATIONS[orientation],
        iso_speed=meta[0], shutter_speed=meta[1], torch_is_on=meta[2])


def _compare(got, want, name, rtol=0.0, atol=0.0):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    if np.issubdtype(np.asarray(want).dtype, np.floating) and (rtol or atol):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)
    elif not np.array_equal(got, want):
        raise AssertionError(f"{name} differs from the JAX package's:\n"
                             f"{got}\n{want}")


def _compare_final(state, host, prefix):
    """A camera run's final reads and every field of its analytics ring
    against the host fixture's."""
    for key in ("number_complete", "completed_digits", "completed_n"):
        _compare(getattr(state, key), host[prefix + key], prefix + key)
    for key in state.analytics._fields:
        _compare(getattr(state.analytics, key),
                 host[f"{prefix}analytics_{key}"], f"{prefix}analytics_{key}",
                 rtol=TELEMETRY_RTOL, atol=SCORE_ATOL)


def oriented_camera_phase(port, kernels, params, expiry, host, dev):
    phase("15 camera metadata and portrait")
    dst = torch.tensor(CARD_DEST, dtype=torch.float32, device=dev)
    now = tuple(host["now"].tolist())
    out = {}
    for orientation in ORIENTED:
        prefix = f"{orientation}_"
        inputs = _oriented_inputs(expiry, host, orientation, dev)
        n_streams = inputs[0][0][0].shape[0]
        state = port.init_stream_states(n_streams, dev, now)
        reset_launches(kernels)
        run = []
        for planes, meta in inputs:
            state, (found, fr, _) = _oriented_step(port, params, state,
                                                   orientation, planes, meta)
            run.append((found, fr))
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        if any(n != len(inputs) for n in launches.values()):
            raise AssertionError(f"want each kernel launched once a step; "
                                 f"got {launches}")

        def per_frame(get):
            return np.stack([get(*r).cpu().numpy() for r in run], axis=1)

        for key, get, rtol, atol in (
                ("found", lambda f, fr: f, 0, 0),
                ("vseg_y_offset", lambda f, fr: fr.vseg.y_offset, 0, 0),
                ("hseg_n_offsets", lambda f, fr: fr.hseg.n_offsets, 0, 0),
                ("hseg_offsets", lambda f, fr: fr.hseg.offsets, 0, 0),
                ("usable", lambda f, fr: fr.usable, 0, 0),
                ("scores", lambda f, fr: fr.scores, 0, SCORE_ATOL),
                ("focus_score", lambda f, fr: fr.focus_score,
                 TELEMETRY_RTOL, 0),
                ("brightness_score", lambda f, fr: fr.brightness_score,
                 TELEMETRY_RTOL, 0),
                ("frame_iso_speed", lambda f, fr: fr.iso_speed, 0, 0),
                ("frame_shutter_speed", lambda f, fr: fr.shutter_speed, 0, 0),
                ("frame_torch_is_on", lambda f, fr: fr.torch_is_on, 0, 0)):
            _compare(per_frame(get), host[prefix + key], prefix + key, rtol,
                     atol)
        _compare_final(state, host, prefix)
        if not host[prefix + "analytics_iso_speed"].any():
            raise AssertionError("the fixture's metadata is all zero")

        order = [_CORNER_NAMES.index(k) for k in
                 port.api._CORNER_ORDER[ORIENTATIONS[orientation]]]
        corners, homography, cards = [], [], []
        for t, (planes, _) in enumerate(inputs):
            _, points = port.api.detect_edges(*planes,
                                              ORIENTATIONS[orientation])
            c = _corners(points)
            corners.append(c.cpu().numpy())
            homography.append(port.ops.eigen_persp_transform(
                c[:, order], dst).cpu().numpy())
            if t in (0, len(inputs) - 1):
                cards.append(port.api.preprocess_frame(
                    *planes, ORIENTATIONS[orientation])[1].cpu().numpy())
        for key, value in (("corners", np.stack(corners, 1)),
                           ("homography", np.stack(homography, 1))):
            if not np.array_equal(value.view(np.int32),
                                  host[prefix + key].view(np.int32)):
                raise AssertionError(f"{prefix}{key} differ from the JAX "
                                     f"package's in their f32 bits")
        _compare(np.stack(cards, 1), host[prefix + "card"], prefix + "card")
        out[orientation] = launches
        print(f"{orientation}: {n_streams} streams x {len(inputs)} frames "
              f"through batched_camera_step with iso / shutter / torch: "
              f"found, scan fields, telemetry and the analytics ring equal "
              f"the JAX package's, corners and homographies bit for bit, "
              f"cards u8 for u8; complete "
              f"{state.number_complete.cpu().tolist()}; launches {launches}")
    return out


def _leaves(port, state):
    return port.session.checkpoint.state_leaves(state)


def _assert_trees_equal(a, b, what, float_atol=0.0):
    """Two (nested) tuples of tensors equal leaf by leaf: dtype, shape and
    every bit (NaN included). With float_atol the float leaves may differ
    by that much; integer and bool leaves stay exact. Returns the largest
    float difference seen."""
    if isinstance(a, tuple):
        if len(a) != len(b):
            raise AssertionError(f"{what}: {len(a)} fields against {len(b)}")
        worst = 0.0
        for i, (x, y) in enumerate(zip(a, b)):
            name = a._fields[i] if hasattr(a, "_fields") else i
            worst = max(worst, _assert_trees_equal(x, y, f"{what}.{name}",
                                                   float_atol))
        return worst
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype} {tuple(a.shape)} against "
                             f"{b.dtype} {tuple(b.shape)}")
    b = b.to(a.device)
    if not a.is_floating_point():
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
        return 0.0
    if _bits_equal(a, b):
        return 0.0
    err = _max_abs_err(a, b)
    if not err <= float_atol or not torch.equal(torch.isfinite(a),
                                                torch.isfinite(b)):
        raise AssertionError(f"{what} differs by {err}")
    return err


def _full_steps(expiry, dates, dev):
    """Phase 12's inputs: the fixture's dated cards tiled to N_STREAMS,
    one (N_STREAMS, 270, 428) tensor a frame."""
    n_dated = sum(d != "00/0" for d in dates)
    streams = np.arange(N_STREAMS) % n_dated
    return streams, [torch.from_numpy(np.ascontiguousarray(
        expiry["frames"][streams, t])).to(dev)
        for t in range(expiry["frames"].shape[1])]


def checkpoint_phase(port, kernels, params, expiry, host, dates, dev):
    phase("16 checkpoint")
    import tempfile
    ckpt = port.session.checkpoint
    streams, steps = _full_steps(expiry, dates, dev)
    now = tuple(expiry["now"].tolist())
    mid = len(steps) // 2

    def run(state, t0, t1):
        results = None
        for t in range(t0, t1):
            state, (_, results) = port.batched_scanner_step(
                params, state, steps[t], scan_expiry=True)
        return state, results

    mid_state, _ = run(port.init_stream_states(N_STREAMS, dev, now), 0, mid)
    final, results = run(mid_state, mid, len(steps))
    _check_full(expiry, dates, streams, final, results, None, None)
    sizes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, save, load in (
                ("npz", ckpt.save_session_npz, ckpt.load_session_npz),
                ("torch.save", ckpt.save_session, ckpt.load_session)):
            path = os.path.join(tmp, "mid.npz" if fmt == "npz" else "mid.pt")
            save(path, mid_state)
            sizes[fmt] = os.path.getsize(path)
            loaded = load(path, device=dev)
            if any(leaf.device != dev for leaf in _leaves(port, loaded)):
                raise AssertionError(f"{fmt}: loaded off {dev}")
            _assert_trees_equal(loaded, mid_state, f"{fmt} loaded state")
            resumed, resumed_results = run(loaded, mid, len(steps))
            _assert_trees_equal(resumed, final, f"{fmt} resumed state")
            _assert_trees_equal(resumed_results, results,
                                f"{fmt} resumed results")

        # the JAX package's checkpoint of the portrait camera run
        path = os.path.join(tmp, "jax_mid.npz")
        with open(path, "wb") as f:
            f.write(host["checkpoint_npz"].tobytes())
        state = ckpt.load_session_npz(path, device=dev)
    inputs = _oriented_inputs(expiry, host, ORIENTED[0], dev)
    after = len(inputs) - int(state.analytics.n_recorded.max())
    if not 0 < after < len(inputs):
        raise AssertionError(f"the fixture's checkpoint holds "
                             f"{len(inputs) - after} of {len(inputs)} frames")
    for planes, meta in inputs[-after:]:
        state, _ = _oriented_step(port, params, state, ORIENTED[0], planes,
                                  meta)
    _compare_final(state, host, f"{ORIENTED[0]}_")
    print(f"checkpoint: the {N_STREAMS}-stream full session stopped after "
          f"{mid} of {len(steps)} frames, saved as .npz ({sizes['npz']} B) "
          f"and with torch.save ({sizes['torch.save']} B), loaded to {dev} "
          f"and continued: {len(_leaves(port, final))} state leaves and the "
          f"results equal the uninterrupted run's bit for bit; the JAX "
          f"package's checkpoint of the {ORIENTED[0]} camera run continues "
          f"{after} frames to the recorded reads and analytics ring")


def graphed_launches(unsplit, n_calls, n_shards):
    """A graphed split's launches against an eager unsplit run of n_calls
    steps: each shard's step is a graph, whose capture runs WARMUP_CALLS
    eager steps first, so every kernel launches n_shards x (n_calls +
    WARMUP_CALLS) times its count a step."""
    from cardio_dmz_tpu_torch.parallel.graphed import WARMUP_CALLS
    if any(v % n_calls for v in unsplit.values()):
        raise AssertionError(f"unsplit launches {unsplit} over {n_calls} "
                             f"steps")
    return {k: v // n_calls * (n_calls + WARMUP_CALLS) * n_shards
            for k, v in unsplit.items()}


def split_step_phase(port, kernels, params, expiry, dates, card, dev):
    phase("17 split step")
    from cardio_dmz_tpu_torch.parallel.mesh import gather_streams
    streams, steps = _full_steps(expiry, dates, dev)
    now = tuple(expiry["now"].tolist())
    uneven = [N_STREAMS // 2 + 1, N_STREAMS - N_STREAMS // 2 - 1]  # 129 + 127
    n_camera = 3
    planes = [tuple(torch.from_numpy(p).to(dev) for p in paste_previews(
        expiry["frames"][streams, t])) for t in range(n_camera)]
    out = {}

    def unsplit_run(step_fn, inputs):
        reset_launches(kernels)
        state = port.init_stream_states(N_STREAMS, dev, now)
        ref = []
        for x in inputs:
            state, res = step_fn(state, x)
            ref.append((state, res))
        torch.cuda.synchronize()
        return ref, read_launches(kernels)

    def split_run(name, label, devices, sizes, scan_expiry, ref, unsplit,
                  float_atol):
        """make_sharded_step over `devices` against the unsplit run `ref`;
        returns (largest float difference, step, states, place)."""
        step, place, init = port.make_sharded_step(
            params, devices, scan_expiry=scan_expiry, sizes=sizes)
        reset_launches(kernels)
        states = init(N_STREAMS, now)
        worst = 0.0
        for t, frames in enumerate(steps):
            states, res = step(states, place(frames))
            worst = max(worst, _assert_trees_equal(
                gather_streams(states), ref[t][0],
                f"{name} {label} step {t} state", float_atol),
                _assert_trees_equal(res, ref[t][1],
                                    f"{name} {label} step {t} results",
                                    float_atol))
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        want = graphed_launches(unsplit, len(steps), len(devices))
        if launches != want:
            raise AssertionError(f"{name} {label}: launches {launches}; "
                                 f"want {want}")
        out[f"{name} {label}"] = launches
        return worst, step, states, place

    for name, scan_expiry in (("PAN-only", False), ("full", True)):
        def step_fn(state, frames):
            return port.batched_scanner_step(params, state, frames,
                                             scan_expiry=scan_expiry)

        # the serving default: one product a call
        ref, unsplit = unsplit_run(step_fn, steps)
        ms = {"unsplit": host_ms(lambda: step_fn(ref[-1][0], steps[0]), 10)}
        _, step, states, place = split_run(name, "[cuda:0]", [dev], None,
                                           scan_expiry, ref, unsplit, 0.0)
        placed = place(steps[0])
        ms["[cuda:0]"] = host_ms(lambda: step(states, placed), 10)
        drift, step, states, place = split_run(
            name, "[cuda:0, cuda:0]", [dev, dev], uneven, scan_expiry, ref,
            unsplit, SCORE_ATOL)
        placed = place(steps[0])
        ms["[cuda:0, cuda:0]"] = host_ms(lambda: step(states, placed), 10)
        print(f"{name} step at {N_STREAMS} streams over {len(steps)} frames: "
              f"the split over [cuda:0] equals the unsplit step bit for "
              f"bit, states and results; over [cuda:0, cuda:0] as "
              f"{uneven[0]} + {uneven[1]} every integer and bool leaf is "
              f"equal and the float leaves differ by at most {drift:.3g} "
              f"(the GEMMs pick their kernels by row count); launches "
              f"unsplit {unsplit}, "
              f"two shards {out[name + ' [cuda:0, cuda:0]']}; step ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f"; card {card}")
        out[f"{name} drift"] = drift

    def camera_fn(state, frame):
        return port.batched_camera_step(params, state, *frame,
                                        scan_expiry=True)

    ref, unsplit = unsplit_run(camera_fn, planes)
    step, place, init = port.make_sharded_camera_step(
        params, [dev, dev], scan_expiry=True, sizes=uneven)
    reset_launches(kernels)
    states = init(N_STREAMS, now)
    drift = 0.0
    for t, frame in enumerate(planes):
        states, res = step(states, *(place(p) for p in frame))
        drift = max(drift, _assert_trees_equal(
            gather_streams(states), ref[t][0], f"camera step {t} state",
            SCORE_ATOL), _assert_trees_equal(
                res, ref[t][1], f"camera step {t} results", SCORE_ATOL))
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    if launches != graphed_launches(unsplit, n_camera, 2) or not all(
            unsplit.values()):
        raise AssertionError(f"camera step a shard: launches {launches}; "
                             f"unsplit {unsplit}")
    out["camera-full [cuda:0, cuda:0]"] = launches
    out["camera-full drift"] = drift
    print(f"make_sharded_camera_step ({uneven[0]} + {uneven[1]} streams, "
          f"{n_camera} frames): integer and bool leaves equal the unsplit "
          f"step's, float leaves within {drift:.3g}; launches unsplit "
          f"{unsplit}, two shards {launches}")
    return out


def serving_loop_phase(port, kernels, card, dev):
    phase("18 serving loop")
    from cardio_dmz_tpu_torch.tools import serve_demo
    n_streams = 16
    reset_launches(kernels)
    counts = serve_demo.main(["--streams", str(n_streams), "--seconds", "3",
                              "--fps", "30", "--devices", "cuda:0"])
    launches = read_launches(kernels)
    steps = counts.get("counter_steps", 0)
    if counts["pans"] != counts["truth"]:
        raise AssertionError(f"the serving loop read {counts['pans']}; the "
                             f"cards are {counts['truth']}")
    if (counts["counter_frames_fresh"] + counts.get("counter_frames_stale", 0)
            != steps * n_streams or counts.get("counter_reads_mismatched")):
        raise AssertionError(f"serving loop counters: {counts}")
    # + the warm-up step, which captures the graph after WARMUP_CALLS
    # eager steps
    want = steps + 1 + port.parallel.graphed.WARMUP_CALLS
    if launches["digit_prep"] != want:
        raise AssertionError(f"{steps} serving steps launched {launches}; "
                             f"want digit prep {want}")
    print(f"serving loop on {dev}: {steps} steps in 3 s at {n_streams} "
          f"streams of 30 frames/s, {counts['counter_frames_fresh']} fresh "
          f"and {counts.get('counter_frames_stale', 0)} stale frames, "
          f"{counts['completed']}/{n_streams} streams read their fixture "
          f"PAN; step avg {1e3 * counts['timer_step_seconds_avg']:.3f} ms, "
          f"acquire avg {1e3 * counts['timer_acquire_seconds_avg']:.3f} ms; "
          f"launches {launches}; card {card}")
    return {"launches": launches, "steps": steps}


# --- 19 train -------------------------------------------------------------

TRAIN_MODELS = ("pan_conv", "vseg_mlp", "slash_mlp", "expiry_conv")
TRAIN_LR = 3e-3            # the fixture's fit, tools/train_models.py's default
TRAIN_BATCH = 64
# steps and held-out accuracy floor of each architecture
# (tests/test_parallel_train.py:117-132)
TRAIN_FLOORS = {"pan_conv": (100, 0.8), "vseg_mlp": (120, 0.9),
                "slash_mlp": (120, 0.95), "expiry_conv": (120, 0.9)}
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# A three-step Adam fit: a parameter moves by up to lr a step whatever its
# gradient's size, as m / (sqrt(v) + eps); where the gradient is near 0 its
# rounding noise (another summation order than XLA's) is a larger share of
# it and moves the update, so the fit is held to FIT_ATOL where the first
# step's gradient is at least FIT_SMALL_GRAD and to FIT_SMALL_GRAD_ATOL
# elsewhere. On an H100 an element of the expiry conv's conv2_w whose first
# gradient is 1.08e-07 ends 1.01e-05 from the JAX fit, and every element
# with a first gradient of at least 2e-7 within 1.51e-06; of the fixture's
# elements under 2e-7, 4,933 of 4,965 have a gradient of exactly 0 (the
# expiry conv's dead ReLU units).
FIT_ATOL, FIT_SMALL_GRAD_ATOL, FIT_SMALL_GRAD = 1e-5, 1e-4, 2e-7
SERVING_BATCH = N_STREAMS * 16      # the PAN conv's cells at 256 streams
TRAIN_GRAPH_STEPS = 5      # phase 26: graphed train steps against eager


def train_run(fixture, model):
    """One architecture's arrays of data/train_session.npz, "<model>/"
    stripped from their names."""
    prefix = model + "/"
    return {k[len(prefix):]: v for k, v in fixture.items()
            if k.startswith(prefix)}


def run_params(run, prefix, dev):
    """{key: tensor on dev} of the run's "<prefix>/<key>" arrays."""
    return {k.split("/", 1)[1]: torch.tensor(v, device=dev)
            for k, v in run.items() if k.startswith(prefix + "/")}


def check_train_batches(port_data_fn, run):
    """The port's generator at seed 0 makes the fixture's three batches
    (the JAX package's), bit for bit, with PIL made unimportable."""
    rng = np.random.RandomState(0)
    n_batches = len(run["labels"])
    with mock.patch.dict(sys.modules, {"PIL": None}):  # `import PIL` fails
        batches = [port_data_fn(rng, TRAIN_BATCH) for _ in range(n_batches)]
    for i, (x, y) in enumerate(batches):
        if not (np.array_equal(x, run["inputs"][i])
                and np.array_equal(y, run["labels"][i])):
            raise AssertionError(f"batch {i} differs from the JAX "
                                 f"generator's")


def check_loss_and_grads(loss_fn, run, dev):
    """loss_fn's loss and gradients from the fixture's initial parameters
    on its first batch, on dev, against jax.value_and_grad's: the loss
    within LOSS_RTOL, each gradient within GRAD_ATOL or GRAD_RTOL of its
    size. Returns (loss's relative error, largest gradient error, its share
    of the tolerance)."""
    params = {k: v.requires_grad_(True)
              for k, v in run_params(run, "init", dev).items()}
    loss = loss_fn(params, torch.from_numpy(run["inputs"][0]).to(dev),
                   torch.from_numpy(run["labels"][0]).to(dev))
    loss.backward()
    loss_rel = abs(loss.item() - float(run["loss"])) / abs(float(run["loss"]))
    worst, share = 0.0, 0.0
    for k, p in params.items():
        want = run["grad/" + k]
        err = np.abs(p.grad.cpu().numpy() - want)
        tol = np.maximum(GRAD_ATOL, GRAD_RTOL * np.abs(want))
        worst, share = max(worst, float(err.max())), max(
            share, float((err / tol).max()))
    if loss_rel > LOSS_RTOL or share > 1.0:
        raise AssertionError(f"loss {loss.item()} against {run['loss']} "
                             f"(relative {loss_rel:.3g}); gradients off by "
                             f"up to {worst:.3g}, {share:.3g} of the "
                             f"tolerance")
    return loss_rel, worst, share


def check_fit(loss_fn, run, dev):
    """A fit of the fixture's steps at TRAIN_LR from its initial parameters
    on its batches, on dev, against the JAX fit: losses within FIT_ATOL,
    parameters as FIT_ATOL says. Returns (largest loss difference, largest
    parameter difference, its parameter, the first gradient's size there,
    elements beyond FIT_ATOL, {parameter: (elements whose first gradient is
    under FIT_SMALL_GRAD, those of them whose gradient is 0)} for each
    parameter that has any)."""
    from cardio_dmz_tpu_torch.train import fit
    batches = iter(zip(run["inputs"], run["labels"]))
    trained, losses = fit(loss_fn, run_params(run, "init", dev), batches,
                          steps=len(run["labels"]), learning_rate=TRAIN_LR)
    loss_err = float(np.abs(np.float32(losses) - run["fit_losses"]).max())
    worst, where, grad_there, beyond, small = 0.0, None, 0.0, 0, {}
    for k, p in trained.items():
        diff = np.abs(p.cpu().numpy() - run["fit/" + k])
        grad = np.abs(run["grad/" + k])
        tol = np.where(grad >= FIT_SMALL_GRAD, FIT_ATOL, FIT_SMALL_GRAD_ATOL)
        if (diff > tol).any():
            raise AssertionError(f"fit: {k} off by up to {diff.max():.3g}")
        beyond += int((diff > FIT_ATOL).sum())
        if (grad < FIT_SMALL_GRAD).any():
            small[k] = (int((grad < FIT_SMALL_GRAD).sum()),
                        int((grad == 0).sum()))
        i = int(diff.argmax())
        if diff.flat[i] >= worst:
            worst, where, grad_there = float(diff.flat[i]), k, float(
                grad.flat[i])
    if loss_err > FIT_ATOL:
        raise AssertionError(f"fit losses {losses} against "
                             f"{run['fit_losses']}")
    return loss_err, worst, where, grad_there, beyond, small


def train_batches(model, batch, n, dev, seed=1):
    """(init_fn, loss_fn, n batches of `batch` on dev): `model`'s seed-0
    parameters' maker, its loss and RandomState(seed) batches."""
    from cardio_dmz_tpu_torch.tools.train_models import _spec
    init_fn, loss_fn, _, data_fn = _spec(model, dev)
    rng = np.random.RandomState(seed)
    return init_fn, loss_fn, [
        tuple(torch.from_numpy(a).to(dev) for a in data_fn(rng, batch))
        for _ in range(n)]


def train_graph_bits(model, dev):
    """The graphed train step (make_train_step, train/optim.adam) against
    its eager form over TRAIN_GRAPH_STEPS steps at TRAIN_BATCH from the
    seed-0 parameters: the eager step twice first (the same bits, or the
    eager step itself is not deterministic), then the graph; every leaf
    of the parameters, mu, nu, count and loss bit for bit at every step.
    Returns the leaves a step and the graph's capture seconds."""
    from cardio_dmz_tpu_torch.train import adam, make_train_step
    init_fn, loss_fn, batches = train_batches(model, TRAIN_BATCH,
                                              TRAIN_GRAPH_STEPS, dev)
    optimizer = adam(TRAIN_LR)
    step = make_train_step(loss_fn, optimizer, params_template=init_fn())

    def run(fn):
        params = init_fn()
        state, out = optimizer.init(params), []
        for x, y in batches:
            params, state, loss = fn(params, state, x, y)
            out.append((params, state, loss))
        return out

    first, second, graphed = run(step.fn), run(step.fn), run(step)
    for what, other in (("eager against eager", second),
                        ("graphed against eager", graphed)):
        for i, (a, b) in enumerate(zip(first, other)):
            leaves = assert_bits(a, b, f"{model} train step {i}, {what}")
    entry, = step.entries.values()
    return leaves, entry.capture_s


def train_step_timing(model, batch, dev, reps=20):
    """The train step at `batch`, graphed and eager (step.fn), in turns:
    host-clock ms (median, in_turns), device ms and device operations of
    one step (torch.profiler; None: not measured), host launches a step,
    the device operations of one bare replay (the graph's nodes and the
    argument copies) and the capture's seconds."""
    from cardio_dmz_tpu_torch.train import adam, make_train_step
    init_fn, loss_fn, ((x, y),) = train_batches(model, batch, 1, dev)
    optimizer = adam(TRAIN_LR)
    params = init_fn()
    state = optimizer.init(params)
    step = make_train_step(loss_fn, optimizer, params_template=params)
    step(params, state, x, y)
    entry, = step.entries.values()
    eager_ms, graph_ms = in_turns(lambda: step.fn(params, state, x, y),
                                  lambda: step(params, state, x, y), reps)
    out = {"eager_ms": eager_ms, "graph_ms": graph_ms,
           "capture_s": entry.capture_s}
    for form, fn in (("eager", lambda: step.fn(params, state, x, y)),
                     ("graph", lambda: step(params, state, x, y))):
        prof = profile_step(fn)
        out[f"{form}_device_ms"] = prof["device_ms"]
        out[f"{form}_device_ops"] = prof["device_ops"]
        out[f"{form}_host_launches"] = host_launches(fn)[0]
    out["replay_device_ops"] = profile_step(
        lambda: step.replay(params, state, x, y))["device_ops"]
    return out


def train_phase(port, kernels, card, dev):
    phase("19 train")
    import tempfile
    from cardio_dmz_tpu_torch.session.checkpoint import (
        load_params_npz, save_params)
    from cardio_dmz_tpu_torch.tools.train_models import _spec, train_one
    fixture = load_npz(fixture_path(port, "train_session.npz"))
    out = {}
    reset_launches(kernels)
    for model in TRAIN_MODELS:
        run = train_run(fixture, model)
        _, loss_fn, apply_fn, data_fn = _spec(model, dev)
        check_train_batches(data_fn, run)
        loss_rel, grad_err, grad_share = check_loss_and_grads(loss_fn, run,
                                                              dev)
        loss_err, worst, where, grad_there, beyond, small = check_fit(
            loss_fn, run, dev)
        print(f"{model}: 3 seed-0 batches of {TRAIN_BATCH} equal the JAX "
              f"generator's bit for bit without PIL; loss relative error "
              f"{loss_rel:.3g}, gradients within {grad_err:.3g} "
              f"({grad_share:.3g} of the tolerance); 3-step fit: losses "
              f"within {loss_err:.3g}, parameters within {worst:.3g} (in "
              f"{where}, first gradient {grad_there:.3g} there; {beyond} "
              f"elements beyond {FIT_ATOL}); held to {FIT_SMALL_GRAD_ATOL} "
              f"where the first gradient is under {FIT_SMALL_GRAD}: "
              + (", ".join(f"{k} {n} ({z} of them 0)"
                           for k, (n, z) in small.items()) or "none"))

        steps, floor = TRAIN_FLOORS[model]
        t0 = time.perf_counter()
        params, acc, _ = train_one(model, steps, TRAIN_BATCH, TRAIN_LR, None,
                                   device=dev)
        seconds = time.perf_counter() - t0
        if not acc > floor:
            raise AssertionError(f"{model}: held-out accuracy {acc} after "
                                 f"{steps} steps; the floor is {floor}")
        inputs, _ = data_fn(np.random.RandomState(99), 512)
        inputs = torch.from_numpy(inputs).to(dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "retrained.npz")
            save_params(path, {model: params})
            module = load_params_npz(path, device=dev)[model]
        with torch.no_grad():
            served = float((module(inputs) - apply_fn(params, inputs)).abs(
                ).max())
        if not served <= SCORE_ATOL:
            raise AssertionError(f"{model}: the serving module differs from "
                                 f"the trainable form by {served}")
        print(f"{model}: {steps} steps of the graphed step in "
              f"{seconds:.3f} s (batches made on the host), held-out "
              f"accuracy {acc:.4f} > {floor}; saved and loaded into the "
              f"serving module: outputs within {served:.3g} (the train "
              f"step's times: phase 26); card {card}")
        out[model] = {"accuracy": acc, "train_one_s": seconds}
    launches = read_launches(kernels)
    if any(launches.values()):
        raise AssertionError(f"training launched a serving kernel: "
                             f"{launches}")
    return out


# --- 20 entry ---------------------------------------------------------------

def entry_phase(port, kernels, card, dev):
    phase("20 entry")
    from cardio_dmz_tpu_torch import entry as entry_module
    fixture = load_npz(fixture_path(port, "train_session.npz"))
    fn, (frames,) = entry_module.entry(dev)
    reset_launches(kernels)
    scores, usable, y_offset = fn(frames)
    torch.cuda.synchronize()
    at_entry = read_launches(kernels)
    err = _max_abs_err(scores, torch.from_numpy(fixture["entry_scores"]).to(
        dev))
    if not (np.array_equal(usable.cpu().numpy(), fixture["entry_usable"])
            and np.array_equal(y_offset.cpu().numpy(),
                               fixture["entry_y_offset"])
            and err <= SCORE_ATOL and at_entry["digit_prep"] == 1):
        raise AssertionError(f"entry(): usable {usable}, y_offset "
                             f"{y_offset}, scores off by {err}; the JAX "
                             f"entry's {fixture['entry_usable']}, "
                             f"{fixture['entry_y_offset']}; launches "
                             f"{at_entry}")
    reset_launches(kernels)
    t0 = time.perf_counter()
    summary = entry_module.dryrun_multichip(4, [dev] * 4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dryrun = read_launches(kernels)
    # a data group's shard: one serving step (digit prep) and one full
    # camera step (all three kernels once), each a graph captured after
    # WARMUP_CALLS eager steps and replayed once
    groups = summary["mesh"]["data"]
    calls = groups * (1 + port.parallel.graphed.WARMUP_CALLS)
    want = {"digit_prep": 2 * calls, "warp_gather": calls,
            "persp_qr": calls}
    if dryrun != want:
        raise AssertionError(f"the dry run launched {dryrun}; its "
                             f"{groups} data groups should launch {want}")
    print(f"entry() on {dev}: usable and y_offset equal the JAX entry's, "
          f"scores within {err:.3g}; launches {at_entry}. "
          f"dryrun_multichip(4) over 4 x {dev}: mesh {summary['mesh']}, "
          f"train loss {summary['train_loss']:.6f}, "
          f"{summary['streams']} streams, {seconds:.3f} s; launches "
          f"{dryrun}; card {card}")
    return {"entry": at_entry, "dryrun": dryrun}


# --- 21 tools ---------------------------------------------------------------

# each bench shape's metric and unit, as the JAX package's bench prints them
BENCH_METRICS = {"full": ("scan_pipeline_throughput", "frames/sec/chip"),
                 "pan": ("scan_pipeline_throughput", "frames/sec/chip"),
                 "camera": ("camera_pipeline_throughput", "frames/sec/chip"),
                 "latency": ("scan_frame_latency_p50", "ms"),
                 "camera_latency": ("camera_frame_latency_p50", "ms")}
# camera sessions that may be accepted otherwise than in the JAX package's
# sweep: its previews come from the float warp, whose pixels differ from
# the JAX package's in a few 1/32 coordinate bins
CAMERA_SWEEP_DIFFERENCES = 2


def bench_step_launches(port, kernels, params, dev):
    """Each kernel's launches in one bench step of each shape (after one
    warm-up step); each shape's step in this process: median host-clock
    ms of 10, device ms and device operations of one (torch.profiler, up
    to three tries; None: not measured) and the device's idle share; and
    the detector's found flags on the camera shape's 16 distinct
    previews."""
    from cardio_dmz_tpu_torch.tools import bench, bench_matrix
    launches, split = {}, {}
    for shape, argv in bench_matrix.SHAPES.items():
        args = bench.parse_args(argv)
        inputs = tuple(torch.from_numpy(a).to(dev)
                       for a in bench.make_inputs(args)[0])
        step = bench.make_step(params, args.camera, args.expiry)
        states, _ = step(port.init_stream_states(
            args.streams, dev, time.localtime()[:2]), *inputs)
        torch.cuda.synchronize()
        reset_launches(kernels)
        step(states, *inputs)
        torch.cuda.synchronize()
        launches[shape] = read_launches(kernels)
        want = {"digit_prep": 1, "warp_gather": int(args.camera),
                "persp_qr": int(args.camera)}
        if launches[shape] != want:
            raise AssertionError(f"a {shape} bench step launched "
                                 f"{launches[shape]}; want {want}")
        host = host_ms(lambda: step(states, *inputs), 10)
        prof = profile_step(lambda: step(states, *inputs))
        split[shape] = {"host_ms": host, "device_ms": prof["device_ms"],
                        "device_ops": prof["device_ops"],
                        "idle": prof["device_ms"] and round(
                            1 - prof["device_ms"] / host, 3)}
    y, cb, cr = (torch.from_numpy(a[:16]).to(dev)
                 for a in bench.camera_inputs(N_STREAMS))
    _, (found, _, _) = port.batched_camera_step(
        params, port.init_stream_states(16, dev, time.localtime()[:2]), y,
        cb, cr)
    return launches, split, found.cpu().numpy()


def _fixture_reads(fixture, prefix):
    return [r if c else None for r, c in zip(fixture[f"{prefix}_reads"],
                                             fixture[f"{prefix}_complete"])]


def sweeps(port, dev):
    """Both accuracy sweeps at their defaults against the JAX package's
    reads; returns their reports, seconds and the camera sessions accepted
    otherwise than in the JAX package's."""
    from cardio_dmz_tpu_torch.tools import accuracy_sweep
    fixture = load_npz(fixture_path(port, "sweep_session.npz"))
    t0 = time.perf_counter()
    rect_reads = pans, reads = accuracy_sweep.sweep_reads(
        *SWEEP_ARGS, quiet=True, device=dev)
    rect_s = time.perf_counter() - t0
    rect = accuracy_sweep.report(pans, reads, SWEEP_ARGS[1])
    want = _fixture_reads(fixture, "rect")
    differ = [(k, pans[k], reads[k], want[k]) for k in range(len(pans))
              if reads[k] != want[k]]
    if pans != list(fixture["rect_pans"]) or differ or rect["wrong_reads"]:
        raise AssertionError(f"rectified sweep: sessions read otherwise "
                             f"than the JAX package's (session, pan, read, "
                             f"JAX read): {differ[:10]}; report {rect}")
    if rect != json.loads(str(fixture["rect_report"])):
        raise AssertionError(f"rectified sweep report {rect}; the JAX "
                             f"package's {fixture['rect_report']}")
    t0 = time.perf_counter()
    pans, reads = accuracy_sweep.camera_sweep_reads(*CAMERA_SWEEP_ARGS,
                                                    quiet=True, device=dev)
    camera_s = time.perf_counter() - t0
    camera = {"mode": "camera", **accuracy_sweep.report(
        pans, reads, CAMERA_SWEEP_ARGS[1])}
    want = _fixture_reads(fixture, "camera")
    differ = [(k, pans[k], reads[k], want[k]) for k in range(len(pans))
              if (reads[k] is None) != (want[k] is None)]
    if (pans != list(fixture["camera_pans"]) or camera["wrong_reads"]
            or len(differ) > CAMERA_SWEEP_DIFFERENCES):
        raise AssertionError(f"camera sweep: {camera}; sessions accepted "
                             f"otherwise than the JAX package's (session, "
                             f"pan, read, JAX read): {differ}")
    return {"rect": rect, "rect_s": rect_s, "camera": camera,
            "camera_s": camera_s, "camera_differ": differ,
            "jax_camera": json.loads(str(fixture["camera_report"])),
            "reads": {"rect": rect_reads, "camera": (pans, reads)}}


def tools_phase(port, kernels, params, card, dev):
    phase("21 tools")
    from cardio_dmz_tpu_torch.tools import bench_matrix, scaling_curve
    t0 = time.perf_counter()
    matrix = bench_matrix.main(["--device", str(dev), "--timeout", "300"])
    matrix_s = time.perf_counter() - t0
    for shape, (metric, unit) in BENCH_METRICS.items():
        rec = matrix[shape]
        if (rec.get("metric"), rec.get("unit")) != (metric, unit) or not \
                rec.get("value", 0) > 0:
            raise AssertionError(f"bench {shape}: {rec}; want {metric} in "
                                 f"{unit} above 0")
    print(f"bench_matrix, five processes one after another, "
          f"{matrix_s:.3f} s; card {card}")
    launches, split, found = bench_step_launches(port, kernels, params, dev)
    if not found.all():
        raise AssertionError(f"the detector finds {int(found.sum())} of the "
                             f"camera shape's 16 rendered previews (found "
                             f"{found.astype(int).tolist()})")
    print(f"one bench step a shape launches {launches}; a step in this "
          f"process, host ms / device ms / device operations / idle share: "
          f"{json.dumps(split)}; the detector finds {int(found.sum())} of "
          f"the camera shape's 16 rendered previews (found "
          f"{found.astype(int).tolist()}); card {card}")
    swept = sweeps(port, dev)
    print(f"rectified sweep, {SWEEP_ARGS[0]} sessions of {SWEEP_ARGS[1]} "
          f"frames in {swept['rect_s']:.3f} s: every session reads as the "
          f"JAX package's; {json.dumps(swept['rect'])}")
    print(f"camera sweep, {CAMERA_SWEEP_ARGS[0]} sessions of "
          f"{CAMERA_SWEEP_ARGS[1]} frames in {swept['camera_s']:.3f} s: "
          f"{json.dumps(swept['camera'])}; the JAX package's "
          f"{json.dumps(swept['jax_camera'])}; accepted otherwise than the "
          f"JAX package's (session, pan, read, JAX read): "
          f"{swept['camera_differ']}")
    t0 = time.perf_counter()
    curve = scaling_curve.run(CURVE_BATCH, CURVE_ITERS, camera=True,
                              sizes=CURVE_SIZES)
    print(f"scaling_curve over {CURVE_SIZES} x {dev} at {CURVE_BATCH} "
          f"streams "
          f"({time.perf_counter() - t0:.3f} s): {json.dumps(curve)}; "
          f"card {card}")
    return {"launches": launches, "reads": swept["reads"]}


# --- 22 profilers -----------------------------------------------------------

# the record keys of the JAX package's tools/roofline.py (_analyze), and the
# port's own (tests/test_torch_profile_tools.py holds both against the
# tools)
JAX_ROOFLINE_KEYS = (
    "shape", "streams", "step_ms", "fps", "gflops_per_step",
    "mflops_per_frame", "hbm_mb_per_step", "hbm_kb_per_frame", "mfu_pct",
    "hbm_util_pct", "floor_ms_compute", "floor_ms_hbm",
    "roofline_fps_ceiling", "bound")
PORT_ROOFLINE_KEYS = (
    "min_mb_per_step", "int_ops", "mfu_pct_of_device_ms",
    "hbm_util_pct_of_device_ms", "device_ms", "idle_share", "peak", "device")
ROOFLINE_SHARES = ("mfu_pct", "hbm_util_pct", "mfu_pct_of_device_ms",
                   "hbm_util_pct_of_device_ms")
# what counts_on_both prints of each graph's count
COUNT_KEYS = ("flops", "bytes", "int_ops", "min_bytes", "kernels")


def run_profilers(dev):
    """Each stage profiler in this process at its defaults (PROFILE_STREAMS
    streams), PROFILE_ITERS timed calls a stage: every stage line present
    with a time above 0. Returns {tool: {stage: ms}}."""
    from cardio_dmz_tpu_torch.tools import (
        profile_camera, profile_camera_ablate, profile_expiry, profile_pan,
        profile_warp)
    argv = ["--device", str(dev), "--iters", str(PROFILE_ITERS)]
    runs = {"profile_pan": (profile_pan, [], profile_pan.STAGES),
            "profile_expiry": (profile_expiry, [], profile_expiry.STAGES),
            "profile_expiry --fine": (profile_expiry, ["--fine"],
                                      profile_expiry.FINE_STAGES),
            "profile_camera": (profile_camera, [], None),
            "profile_camera_ablate": (profile_camera_ablate, [],
                                      profile_camera_ablate.STAGES),
            "profile_warp": (profile_warp, [], profile_warp.STAGES)}
    out = {}
    for name, (tool, extra, stages) in runs.items():
        times = tool.main(argv + extra)
        if stages is None:           # profile_camera's names hold band shapes
            stages = [k for k in times if k.split()[0] in (
                "sobel7", "canny", "canny+hough")] + [
                "detect_edges (all 12 bands)", "warp 428x270",
                "preprocess_frame (fused)", "scanner_step (PAN+expiry)"]
            if len(stages) != 10:
                raise AssertionError(f"profile_camera stages {list(times)}")
        if list(times) != list(stages) or not all(
                ms > 0 for ms in times.values()):
            raise AssertionError(f"{name}: stages {times}; want {stages} "
                                 f"each above 0 ms")
        out[name] = times
    return out


def check_roofline(records):
    """Every key of the JAX record and the port's, and every share below
    100% (the idle share below 1)."""
    for shape, rec in records.items():
        missing = set(JAX_ROOFLINE_KEYS + PORT_ROOFLINE_KEYS) - set(rec)
        shares = [rec[k] for k in ROOFLINE_SHARES]
        if (missing or any(v is None or not 0 < v < 100 for v in shares)
                or not 0 <= rec["idle_share"] < 1):
            raise AssertionError(f"roofline {shape}: missing {missing}, "
                                 f"record {rec}")


def roofline_launches(port, kernels, params, dev):
    """Each kernel's launches inside one roofline step of each shape, at
    ROOFLINE_STREAMS streams."""
    from cardio_dmz_tpu_torch.tools import roofline
    out = {}
    for shape, (step, inputs) in roofline.shape_steps(
            params, ROOFLINE_STREAMS, dev).items():
        states = port.init_stream_states(ROOFLINE_STREAMS, dev, (2026, 1))
        states, _ = step(states, *inputs)
        torch.cuda.synchronize()
        reset_launches(kernels)
        step(states, *inputs)
        torch.cuda.synchronize()
        out[shape] = read_launches(kernels)
        want = {"digit_prep": 1, "warp_gather": int(shape == "camera"),
                "persp_qr": int(shape == "camera")}
        if out[shape] != want:
            raise AssertionError(f"a roofline {shape} step launched "
                                 f"{out[shape]}; want {want}")
    return out


def counts_on_both(port, params, dev):
    """One step of each of stage_bytes' graphs and of the roofline's camera
    shape counted at COUNT_STREAMS streams on the card and on the CPU, in
    this process: the totals, the kernels' tally, the minimum bytes and
    every aten op's count equal. Returns {graph: card's count}."""
    from cardio_dmz_tpu_torch.tools import roofline, stage_bytes
    from cardio_dmz_tpu_torch.tools.profiling import count_step
    cpu = torch.device("cpu")

    def count(on, on_params):
        rows = stage_bytes.count_graphs(on_params, COUNT_STREAMS, on)
        step, inputs = roofline.shape_steps(on_params, COUNT_STREAMS,
                                            on)["camera"]
        states = port.init_stream_states(COUNT_STREAMS, on, (2026, 1))
        states, _ = step(states, *inputs)
        counter, min_bytes = count_step(step, on_params, states, *inputs)
        rows["roofline camera"] = {**counter.summary(),
                                   "min_bytes": min_bytes}
        return rows

    card_rows = count(dev, params)
    cpu_rows = count(cpu, port.load_all_params(cpu))
    for graph, row in card_rows.items():
        if row != cpu_rows[graph]:
            ops = sorted(set(row["by_op"]) | set(cpu_rows[graph]["by_op"]))
            differ = {op: (row["by_op"].get(op), cpu_rows[graph]["by_op"].get(
                op)) for op in ops
                if row["by_op"].get(op) != cpu_rows[graph]["by_op"].get(op)}
            raise AssertionError(
                f"{graph} at {COUNT_STREAMS} streams counts otherwise on the "
                f"card and on the CPU: card {[row[k] for k in COUNT_KEYS]}, "
                f"cpu {[cpu_rows[graph][k] for k in COUNT_KEYS]}; ops (card, "
                f"cpu) [calls, flops, bytes, int_ops]: {differ}")
    return card_rows



def rendered_cards_phase(port, params, expiry, dev):
    """The fixture's two dated cards drawn by the port's renderer: equal to
    the JAX-rendered frames bit for bit, and the full step reads their
    PANs and dates."""
    from cardio_dmz_tpu_torch import synthetic
    pans, dates = fixture_pans(expiry), fixture_dates(expiry)
    n_frames = expiry["frames"].shape[1]
    dated = [k for k, d in enumerate(dates) if d != "00/0"]
    cards = np.stack([np.stack([synthetic.render_frame_with_expiry(
        pans[k], f"{int(expiry['expiry_month'][k, -1]):02d}/"
                 f"{int(expiry['expiry_year'][k, -1]) % 100:02d}",
        seed=t, **DATED_CARD) for t in range(n_frames)]) for k in dated])
    if not np.array_equal(cards, expiry["frames"][dated]):
        raise AssertionError("the port's renderer draws other dated cards "
                             "than the JAX package's")
    state, _ = port.scan_frames(params, torch.from_numpy(cards).to(dev),
                                tuple(expiry["now"].tolist()),
                                scan_expiry=True)
    read = list(zip([_pan(d[:int(n)]) for d, n in zip(
        state.completed_digits.cpu(), state.completed_n.cpu())],
        _dates(state.expiry_month.cpu(), state.expiry_year.cpu())))
    want = [(pans[k], dates[k]) for k in dated]
    if read != want:
        raise AssertionError(f"rendered cards read {read}; want {want}")
    return read


def profilers_phase(port, kernels, params, expiry, card, dev):
    phase("22 profilers")
    from cardio_dmz_tpu_torch.tools import buffer_hogs, roofline, stage_bytes
    t0 = time.perf_counter()
    times = run_profilers(dev)
    profilers_s = time.perf_counter() - t0
    print(f"profilers at {PROFILE_STREAMS} streams, {PROFILE_ITERS} timed "
          f"calls a stage ({profilers_s:.3f} s): {json.dumps(times)}; "
          f"card {card}")
    records = roofline.main(["--device", str(dev), "--iters",
                             str(PROFILE_ITERS)])
    check_roofline(records)
    launches = roofline_launches(port, kernels, params, dev)
    print(f"roofline at {ROOFLINE_STREAMS} streams: every JAX key and the "
          f"port's present, every share under 100%; kernel launches in one "
          f"step of each shape {launches}; card {card}")
    gb = stage_bytes.main(["--device", str(dev)])
    for full, ablated in (("camera_full", "camera_no_detect"),
                          ("camera_full", "camera_no_warp"),
                          ("scan_full", "scan_pan")):
        if not gb[full]["gb"] > gb[ablated]["gb"]:
            raise AssertionError(f"stage_bytes: {full} {gb[full]} against "
                                 f"{ablated} {gb[ablated]}")
    hogs = buffer_hogs.main(["--device", str(dev), "--graph", "camera",
                             "--cycles", "--top", "20"])
    unattributed = hogs["by_source"].get("?", (0.0, 0))[0]
    if not (hogs["buffers"] and hogs["device_ms"] > 0
            and unattributed < 0.1 * hogs["device_ms"]):
        raise AssertionError(f"buffer_hogs: {hogs}")
    counts = counts_on_both(port, params, dev)
    print(f"counts at {COUNT_STREAMS} streams equal on {dev} and the CPU "
          f"(flops, bytes, int_ops, min_bytes, kernels): " + json.dumps(
              {g: [r[k] for k in COUNT_KEYS] for g, r in counts.items()}))
    read = rendered_cards_phase(port, params, expiry, dev)
    print(f"the port's renderer draws the fixture's dated cards bit for bit "
          f"without PIL; the full step reads {read}")
    return {"launches": launches, "times": times}


def sha256(images):
    """The SHA-256 of a stack of u8 images' bytes, as hex."""
    return hashlib.sha256(np.ascontiguousarray(
        np.stack(images), np.uint8).tobytes()).hexdigest()


def _strs(a):
    return [str(x) for x in a.tolist()]


def ref_cases(fixture):
    """The fixture's render parameters as tools/parity_ab.py's cases:
    (frames, PAN sessions, expiry sessions, camera previews), a list of
    dicts each (REF_CASE_KEYS)."""
    def rows(prefix, keys):
        cols = [fixture[f"{prefix}_{k}"] for k in keys]
        return [{k: v.item() if v.ndim == 0 else v
                 for k, v in zip(keys, row)} for row in zip(*cols)]
    return tuple(rows(prefix, keys) for prefix, keys in REF_CASE_KEYS)


def ref_records(fixture, prefix):
    """The reference's FrameRecords stored under `prefix`."""
    from cardio_dmz_tpu_torch.refbridge import make_record
    f = fixture
    return [make_record(*row) for row in zip(
        f[f"{prefix}_usable"], f[f"{prefix}_vseg_y"],
        f[f"{prefix}_vseg_pattern"], f[f"{prefix}_hseg_n"],
        f[f"{prefix}_hseg_offsets"], f[f"{prefix}_hseg_width"],
        f[f"{prefix}_scores"])]


def window_arrays(windows):
    """Per-frame MM/YY windows (tools/parity_ab.py's ref_expiry_windows
    form) as the fixture stores them: their count a frame and (frames, most
    windows, 12) int32 rows of top, left, 5 char tops, 5 char lefts."""
    rows = [[(top, left, *tops, *lefts) for top, left, tops, lefts in w]
            for w in windows]
    assert all(len(r) == 12 for w in rows for r in w)
    width = max(1, max(map(len, rows)))
    out = np.zeros((len(rows), width, 12), np.int32)
    for t, w in enumerate(rows):
        out[t, :len(w)] = np.int32(w).reshape(-1, 12)
    return {"expiry_window_n": np.int32(list(map(len, rows))),
            "expiry_windows": out}


def window_lists(fixture):
    """window_arrays read back."""
    return [[(int(r[0]), int(r[1]), tuple(r[2:7].tolist()),
              tuple(r[7:].tolist())) for r in w[:n]]
            for w, n in zip(fixture["expiry_windows"],
                            fixture["expiry_window_n"])]


def draw_ref_inputs(fixture):
    """The fixture's frames, sessions and previews drawn anew by the port's
    renderer (host numpy), each batch held against its stored SHA-256:
    (cases, frames, PAN sessions, expiry sessions, (y, cb) previews)."""
    from cardio_dmz_tpu_torch.tools import parity_ab as ab
    cases = ref_cases(fixture)
    frame_cases, pan_cases, expiry_cases, camera_cases = cases
    frames = np.stack([ab.render_frame_case(c) for c in frame_cases])
    pan_sessions = np.stack([ab.render_pan_session(c) for c in pan_cases])
    expiry_sessions = np.stack([ab.render_expiry_session(c)
                                for c in expiry_cases])
    y, cb = map(np.stack, zip(*[ab.render_camera_case(c)
                                for c in camera_cases]))
    for name, drawn in (("frame", frames), ("pan_session", pan_sessions),
                        ("expiry", expiry_sessions), ("camera", y)):
        want = str(fixture[f"{name}_sha256"])
        if sha256(drawn) != want:
            raise AssertionError(f"the renderer drew other {name} inputs "
                                 f"than ref_session.npz records "
                                 f"({sha256(drawn)} != {want})")
    return cases, frames, pan_sessions, expiry_sessions, (y, cb)


def _segmentation_agrees(ours, ref):
    """usable and vseg equal, and where usable the hseg too."""
    return (ours.usable == ref.usable
            and ours.vseg_y_offset == ref.vseg_y_offset
            and ours.vseg_pattern_type == ref.vseg_pattern_type
            and (not ref.usable or ours.same_segmentation(ref)))


def compare_records(ours, refs, counts, prefix):
    """Add one record list's agreement to counts; returns the indices that
    disagree on segmentation or on a score beyond REF_SCORE_ATOL."""
    bad = []
    for i, (o, r) in enumerate(zip(ours, refs)):
        counts[f"{prefix}_frames"] += 1
        if not _segmentation_agrees(o, r):
            bad.append(i)
            continue
        counts[f"{prefix}_segmentation_agree"] += 1
        if not r.usable:
            continue
        n = r.hseg_n_offsets
        counts["digits"] += n
        counts["digit_agree"] += sum(a == b for a, b in zip(o.digits,
                                                            r.digits))
        err = float(np.abs(o.scores[:n] - r.scores[:n]).max(initial=0.0))
        counts["score_max_abs_err"] = max(counts["score_max_abs_err"], err)
        if err > REF_SCORE_ATOL:
            bad.append(i)
    return bad


def reference_sessions(params, fixture, pan_sessions, expiry_sessions, dev):
    """(b): each session through HostScanner and through the device step;
    [(path, session, got, want)] of every disagreement."""
    from cardio_dmz_tpu_torch.tools import parity_ab as ab
    ref_pans = _strs(fixture["pan_session_ref_pan"])
    ref_exp_pans = _strs(fixture["expiry_ref_pan"])
    ref_dates = [(int(m), int(y)) if m else None for m, y in zip(
        fixture["expiry_ref_month"], fixture["expiry_ref_year"])]
    want = [(p or None, None) for p in ref_pans] + [
        (p or None, d) for p, d in zip(ref_exp_pans, ref_dates)]
    host = [ab.host_session(params, s, scan_expiry=False)
            for s in pan_sessions]
    host += [ab.host_session(params, s, scan_expiry=True)
             for s in expiry_sessions]
    device = ab.device_sessions(params, pan_sessions, False, dev)
    device += ab.device_sessions(params, expiry_sessions, True, dev)
    bad = []
    for path, reads in (("host", host), ("device", device)):
        bad += [(path, k, got, w) for k, (got, w) in
                enumerate(zip(reads, want)) if got != w]
    return bad, len(want)


def reference_expiry_windows(params, fixture, expiry_sessions, counts,
                             dev):
    """(b): the device expiry segmentation on every frame of the expiry
    sessions (a session's frames as one batch of streams) against the
    C++'s groups, window for window; the (session, frame) that differ."""
    from cardio_dmz_tpu_torch.tools import parity_ab as ab
    want = window_lists(fixture)
    t_n = expiry_sessions.shape[1]
    bad = []
    for k, frames in enumerate(expiry_sessions):
        for t, ours in enumerate(ab.port_expiry_windows(params, frames, dev)):
            ref = want[k * t_n + t]
            counts["expiry_frames"] += 1
            counts["expiry_windows"] += len(ref)
            if ours == ref:
                counts["expiry_frame_windows_agree"] += 1
            else:
                bad.append((k, t))
    return bad


def reference_camera(params, fixture, cases, previews, counts, dev):
    """(c): found, corners, the kernels' card from the reference's corners
    (its SHA-256 against the reference card's) and the digits read from
    it; the indices that disagree."""
    from cardio_dmz_tpu_torch.tools import parity_ab as ab
    y, cb = previews
    found_ref = fixture["camera_found"]
    corners_ref = fixture["camera_corners"]
    card_sha = _strs(fixture["camera_card_sha256"])
    refs = ref_records(fixture, "camera")
    bad = []
    for orientation in REF_ORIENTATIONS:
        idx = [i for i, c in enumerate(cases)
               if c["orientation"] == orientation]
        found, corners, _ = ab.port_camera(y[idx], cb[idx], orientation, dev)
        both = []
        for k, i in enumerate(idx):
            counts["camera_frames"] += 1
            if bool(found[k]) != bool(found_ref[i]) or (
                    found_ref[i] and np.abs(corners[k] - corners_ref[i]).max()
                    > REF_CORNER_ATOL):
                bad.append((i, "corners"))
                continue
            counts["camera_found_and_corners_agree"] += 1
            if found_ref[i]:
                both.append(i)
        if not both:
            continue
        cards = ab.port_cards_from_corners(y[both], corners_ref[both],
                                           orientation, dev)
        for i, c in zip(both, cards):
            counts["camera_cards"] += 1
            if sha256([c]) == card_sha[i]:
                counts["camera_card_bit_exact"] += 1
            else:
                bad.append((i, "card"))
        ours = ab.port_frames(params, cards, dev)
        bad += [(both[k], "scan") for k in compare_records(
            ours, [refs[i] for i in both], counts, "camera_card")]
    return bad


def reference_phase(port, kernels, params, dev):
    """Phase 23: the compiled card.io C++'s recorded answers
    (data/ref_session.npz) replayed through the port's serving routes:
    (a) the rectified frames through scan_card_image (digit prep) in one
    batch of streams, (b) the sessions through HostScanner and the device
    step, and every frame of the expiry sessions through the device
    expiry segmentation, (c) the previews through detect_edges and
    transform_card (persp QR, warp), and the reference's corners through
    transform_card."""
    phase("23 reference")
    t0 = time.perf_counter()
    from cardio_dmz_tpu_torch.tools import parity_ab as ab
    fixture = load_npz(fixture_path(port, "ref_session.npz"))
    cases, frames, pan_sessions, expiry_sessions, previews = \
        draw_ref_inputs(fixture)
    counts = collections.defaultdict(int, score_max_abs_err=0.0)
    reset_launches(kernels)
    bad = {"frames": compare_records(
        ab.port_frames(params, frames, dev), ref_records(fixture, "frame"),
        counts, "frame")}
    bad["sessions"], counts["sessions"] = reference_sessions(
        params, fixture, pan_sessions, expiry_sessions, dev)
    bad["expiry_windows"] = reference_expiry_windows(
        params, fixture, expiry_sessions, counts, dev)
    bad["camera"] = reference_camera(params, fixture, cases[3], previews,
                                     counts, dev)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    counts["sessions_agree"] = counts["sessions"] - len(
        {k for _, k, _, _ in bad["sessions"]})
    share = counts["digit_agree"] / max(counts["digits"], 1)
    print("reference agreement: " + json.dumps(dict(counts)))
    print(f"reference launches: {json.dumps(launches)}; "
          f"{time.perf_counter() - t0:.3f} s")
    if any(bad.values()) or share < REF_DIGIT_AGREEMENT:
        raise AssertionError(f"the port disagrees with the compiled "
                             f"reference: {bad}; digits {share:.4f}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched in phase 23: "
                             f"{launches}")
    return {"launches": launches, "counts": dict(counts)}


# phase 24: each array of a model's .npz and the role comment of its blob in
# the reference's generated source, in the order the source holds them (the
# expiry conv's two "conv W" and two "conv b" blobs by layer)
SOURCE_ROLES = {
    "conv_w": "conv W", "conv_b": "conv b",
    "conv1_w": "conv W", "conv1_b": "conv b",
    "conv2_w": "conv W", "conv2_b": "conv b",
    "hidden_w": "hidden W", "hidden_b": "hidden b",
    "logistic_w": "logistic W", "logistic_b": "logistic b",
    "test_input": "test input", "test_output": "test output",
    "test_conv1_out": "test output layer 1",
    "test_conv2_out": "test output layer 2",
    "test_hidden_out": "test output layer 3",
}


def generated_source_text(arrays):
    """A model source in the format of the reference's generated C++: each
    array of `arrays` ({name: float32 array}, keys of SOURCE_ROLES) as a
    `static uint8_t data_<8 hex>[<n>] = { // <role>` blob of 16
    little-endian bytes a line closed by `};`, in SOURCE_ROLES' order, with
    code lines and a static array without a role comment between them."""
    lines = ["// generated model source", "#include <stdint.h>", ""]
    for i, key in enumerate(k for k in SOURCE_ROLES if k in arrays):
        raw = np.ascontiguousarray(arrays[key], "<f4").tobytes()
        tag = hashlib.sha256(key.encode() + raw).hexdigest()[:8]
        lines.append(f"static uint8_t data_{tag}[{len(raw)}] = {{ // "
                     f"{SOURCE_ROLES[key]}")
        lines += ["  " + " ".join(f"0x{b:02X}," for b in raw[j:j + 16])
                  for j in range(0, len(raw), 16)]
        lines += ["};", "", f"static float layer_{i}(const float* in) {{",
                  f"  return in[{i}];", "}", ""]
        if i == 1:
            lines += ["static uint8_t data_00000000[4] = {",
                      "  0x00, 0x00, 0x80, 0x3F,", "};", ""]
    return "\n".join(lines) + "\n"


def write_generated_sources(root, models):
    """Write each model of `models` ({model: {name: array}}) under `root`
    at the path of tools/extract_weights.JOBS; returns {model: path}."""
    from cardio_dmz_tpu_torch.tools.extract_weights import JOBS
    paths = {}
    for name, arrays in models.items():
        paths[name] = os.path.join(root, JOBS[name][1])
        os.makedirs(os.path.dirname(paths[name]), exist_ok=True)
        with open(paths[name], "w") as f:
            f.write(generated_source_text(arrays))
    return paths


def weights_phase(port, kernels, params, fixture, dev):
    """Phase 24: the committed weights written as the reference's generated
    sources and extracted again by tools/extract_weights.py, then held
    bit for bit against the committed ones, against their golden vectors
    on the card and through scan_card_image."""
    phase("24 weights")
    import contextlib
    import io
    import tempfile
    from cardio_dmz_tpu_torch.models.selfcheck import TOLERANCE
    from cardio_dmz_tpu_torch.models.weights import PARAM_DIR
    from cardio_dmz_tpu_torch.tools import extract_weights
    t0 = time.perf_counter()
    committed = {name: load_npz(os.path.join(PARAM_DIR, f"{name}.npz"))
                 for name in extract_weights.JOBS}
    with tempfile.TemporaryDirectory() as tmp:
        write_generated_sources(os.path.join(tmp, "reference"), committed)
        out = os.path.join(tmp, "params")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = extract_weights.main(["--reference",
                                       os.path.join(tmp, "reference"),
                                       "--out", out])
        extracted = {name: load_npz(os.path.join(out, f"{name}.npz"))
                     for name in committed}
    if rc != 0:
        raise AssertionError(f"extract_weights.main returned {rc}")
    arrays = [(name, key) for name, a in committed.items() for key in a]
    differ = [f"{name}.{key}" for name, key in arrays
              if key not in extracted[name]
              or extracted[name][key].dtype != np.dtype("<f4")
              or extracted[name][key].shape != committed[name][key].shape
              or extracted[name][key].tobytes()
              != committed[name][key].tobytes()]
    extra = [f"{name}.{key}" for name, a in extracted.items() for key in a
             if key not in committed[name]]
    print(f"extracted arrays equal to the committed ones bit for bit: "
          f"{len(arrays) - len(differ)} of {len(arrays)}")
    if differ or extra:
        raise AssertionError(f"extracted weights differ: {differ}; "
                             f"extra {extra}")
    golden = {}
    for name, a in extracted.items():
        module = port.models.module_from_numpy(name, a, dev)
        out = module(torch.from_numpy(a["test_input"]).to(dev))
        golden[name] = float((out.cpu() - torch.from_numpy(
            a["test_output"])).abs().max())
    print(f"golden max abs err on {dev}: " + json.dumps(golden))
    if max(golden.values()) > TOLERANCE:
        raise AssertionError(f"an extracted model misses its golden output "
                             f"by more than {TOLERANCE}: {golden}")
    extracted_params = port.models.params_from_numpy(extracted, dev)
    frames = torch.from_numpy(fixture["frames"]).to(dev)
    reset_launches(kernels)
    ours = [port.scan.scan_card_image(extracted_params, frames[:, t])
            for t in range(frames.shape[1])]
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    want = [port.scan.scan_card_image(params, frames[:, t])
            for t in range(frames.shape[1])]
    for t, (a, b) in enumerate(zip(ours, want)):
        for key, x, y in (("scores", a.scores, b.scores),
                          ("usable", a.usable, b.usable),
                          ("vseg y_offset", a.vseg.y_offset,
                           b.vseg.y_offset)):
            if not torch.equal(x, y):
                raise AssertionError(f"frame {t}: {key} with the extracted "
                                     f"weights differs from the committed "
                                     f"weights' run")
    print(f"weights launches: {json.dumps(launches)}; "
          f"{frames.shape[0] * frames.shape[1]} frames scanned with the "
          f"extracted weights equal the committed weights' run; "
          f"{time.perf_counter() - t0:.3f} s")
    if launches["digit_prep"] == 0:
        raise AssertionError("phase 24 never launched digit prep")
    return {"launches": launches}


# --- 25 graphs --------------------------------------------------------------

GRAPH_SHAPES = ("pan", "full", "camera", "camera_full")
# each kernel's symbol in csrc/, as the profiler names its launches
KERNEL_SYMBOLS = {"digit_prep": "digit_prep_kernel",
                  "warp_gather": "warp_exact_kernel",
                  "persp_qr": "persp_qr_kernel"}
# the runtime and driver calls that put work on a stream: a step's host
# launches
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")


def graph_shape(port, params, shape, fixtures, dates, dev):
    """(step(states, *inputs), [inputs of each frame], now) of a serving
    shape at N_STREAMS streams on the cards of phases 6 (pan), 12 (full),
    10 (camera) and 13 (camera_full)."""
    smoke, camera, expiry = fixtures
    scan_expiry = shape in ("full", "camera_full")
    if shape == "pan":
        streams = np.arange(N_STREAMS) % smoke["frames"].shape[0]
        inputs = [(torch.from_numpy(np.ascontiguousarray(
            smoke["frames"][streams, t])).to(dev),)
            for t in range(smoke["frames"].shape[1])]
        now = smoke["now"]
    elif shape == "full":
        inputs = [(f,) for f in _full_steps(expiry, dates, dev)[1]]
        now = expiry["now"]
    elif shape == "camera":
        streams = np.arange(N_STREAMS) % camera["y"].shape[0]
        inputs = [tuple(torch.from_numpy(np.ascontiguousarray(
            camera[k][streams, t])).to(dev) for k in ("y", "cb", "cr"))
            for t in range(camera["y"].shape[1])]
        now = camera["now"]
    else:
        streams = np.arange(N_STREAMS) % sum(d != "00/0" for d in dates)
        inputs = [tuple(torch.from_numpy(p).to(dev) for p in paste_previews(
            expiry["frames"][streams, t]))
            for t in range(expiry["frames"].shape[1])]
        now = expiry["now"]
    if shape.startswith("camera"):
        def step(states, y, cb, cr):
            return port.batched_camera_step(params, states, y, cb, cr,
                                            scan_expiry=scan_expiry)
    else:
        def step(states, frames):
            return port.batched_scanner_step(params, states, frames,
                                             scan_expiry=scan_expiry)
    return step, inputs, tuple(now.tolist())


def assert_bits(a, b, what):
    """Every leaf of two trees: the same dtype, shape and bytes."""
    from torch.utils._pytree import tree_flatten
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    if len(la) != len(lb):
        raise AssertionError(f"{what}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.contiguous().reshape(-1).view(torch.uint8),
                y.contiguous().reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{what}: leaf {i} ({x.dtype} "
                                 f"{tuple(x.shape)}) differs")
    return len(la)


def host_launches(fn):
    """The calls of LAUNCH_CALLS one call of fn makes, counted by
    torch.profiler on the host (after one call to warm up), and each
    kernel's launches on the device in it ({name: n} by KERNEL_SYMBOLS;
    up to three tries, as profile_step, for a trace without device
    work)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        if any(e.self_device_time_total > 0 for e in rows):
            break
    else:
        raise RuntimeError("torch.profiler saw no device work")
    calls = sum(e.count for e in rows if e.key in LAUNCH_CALLS)
    kernels = {name: sum(e.count for e in rows if symbol in e.key
                         and e.self_device_time_total > 0)
               for name, symbol in KERNEL_SYMBOLS.items()}
    return calls, kernels


def in_turns(a, b, reps=10):
    """host_ms of fn a and fn b in turns (a, b, b, a), `reps` calls each
    time: the median ms of each over its 2 x reps calls."""
    times = {"a": [], "b": []}
    for key in ("a", "b", "b", "a"):
        fn = a if key == "a" else b
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[key].append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times["a"]), statistics.median(times["b"])


def check_replay_kernels(shape, eager, replay, recorded):
    """Each kernel once a step: in the eager step and in one replay (the
    profiler's counts), and among the launches the capture recorded."""
    camera = shape.startswith("camera")
    want = {"digit_prep": 1, "warp_gather": int(camera),
            "persp_qr": int(camera)}
    if not (replay == eager == want
            and {k: recorded.get(k, 0) for k in want} == want):
        raise AssertionError(
            f"{shape}: kernels a step eager {eager}, in one replay {replay}, "
            f"recorded at capture {recorded}; want {want}")


def graph_shape_run(port, params, shape, fixtures, dates, dev):
    """One shape's graph against its eager step: WARMUP + STEPS steps side
    by side from fresh states, bit for bit; then both timed in turns,
    profiled, and the graph's capture seconds, pool and launches."""
    import gc
    from cardio_dmz_tpu_torch.parallel import graphed
    step, inputs, now = graph_shape(port, params, shape, fixtures, dates,
                                    dev)
    gc.collect()
    torch.cuda.empty_cache()
    pool_before = graphed.pool_bytes(dev)
    graph = graphed.graph_step(step, dev)
    eager_states = graph_states = port.init_stream_states(N_STREAMS, dev,
                                                          now)
    leaves = 0
    for i in range(WARMUP + STEPS):
        x = inputs[i % len(inputs)]
        eager_states, eager_out = step(eager_states, *x)
        graph_states, graph_out = graph(graph_states, *x)
        leaves = assert_bits((eager_states, eager_out),
                             (graph_states, graph_out),
                             f"{shape} step {i}")
    entry, = graph.entries.values()
    pool_mib = graphed.pool_bytes(dev) / 2**20
    x = inputs[0]
    eager_ms, graph_ms = in_turns(lambda: step(eager_states, *x),
                                  lambda: graph(graph_states, *x))
    eager_prof = profile_step(lambda: step(eager_states, *x))
    graph_prof = profile_step(lambda: graph(graph_states, *x))
    eager_calls, eager_kernels = host_launches(lambda: step(eager_states,
                                                            *x))
    graph_calls, graph_kernels = host_launches(lambda: graph(graph_states,
                                                             *x))
    check_replay_kernels(shape, eager_kernels, graph_kernels,
                         entry.launches)
    return {"leaves": leaves, "eager_ms": eager_ms, "graph_ms": graph_ms,
            "eager_device_ms": eager_prof["device_ms"],
            "graph_device_ms": graph_prof["device_ms"],
            "eager_idle": eager_prof["idle_share"],
            "graph_idle": graph_prof["idle_share"],
            "eager_host_launches": eager_calls,
            "graph_host_launches": graph_calls,
            "capture_s": entry.capture_s, "pool_mib": pool_mib,
            "pool_mib_before": pool_before / 2**20,
            "replay_launches": graph_kernels}


def add_frame_ms(port, params, frames, now, dev):
    """Median ms of HostScanner.add_frame over the frames of a session,
    graphed (as it ships) and with the eager PAN step put in the graph's
    place, in turns (graphed, eager, eager, graphed) after one session of
    each to warm up."""
    graphed_scanner = port.HostScanner(params, now=now)
    eager_scanner = port.HostScanner(params, now=now)
    eager_scanner._step = lambda state, y: port.session.scanner_step(
        params, state, y.to(dev), scan_expiry=False)
    times = {"graphed": [], "eager": []}
    for name, scanner in (("graphed", graphed_scanner),
                          ("eager", eager_scanner)):
        for y in frames:
            scanner.add_frame(y)
    for name in ("graphed", "eager", "eager", "graphed"):
        scanner = graphed_scanner if name == "graphed" else eager_scanner
        scanner.reset()
        for y in frames:
            t0 = time.perf_counter()
            scanner.add_frame(y)
            times[name].append(1e3 * (time.perf_counter() - t0))
    return {k: statistics.median(v) for k, v in times.items()}


def two_shards_ms(port, params, expiry, dates, scan_expiry, dev):
    """Host ms of a step split as 129 + 127 streams over [cuda:0, cuda:0]:
    the graphed make_sharded_step against the same shards stepped eagerly
    one after another, in turns; the unsplit eager step beside them."""
    now = tuple(expiry["now"].tolist())
    _, steps = _full_steps(expiry, dates, dev)
    sizes = [N_STREAMS // 2 + 1, N_STREAMS - N_STREAMS // 2 - 1]
    step, place, init = port.make_sharded_step(
        params, [dev, dev], scan_expiry=scan_expiry, sizes=sizes)
    states, shards = init(N_STREAMS, now), place(steps[0])
    states, _ = step(states, shards)

    def eager():
        outs = [port.batched_scanner_step(params, st, fr, scan_expiry)
                for st, fr in zip(states, shards)]
        return port.parallel.gather_streams([o[1] for o in outs], dev)

    eager_ms, graph_ms = in_turns(eager, lambda: step(states, shards))
    unsplit = port.init_stream_states(N_STREAMS, dev, now)
    unsplit_ms = host_ms(lambda: port.batched_scanner_step(
        params, unsplit, steps[0], scan_expiry), 10)
    return {"eager_ms": eager_ms, "graph_ms": graph_ms,
            "unsplit_eager_ms": unsplit_ms}


def graphs_phase(port, params, fixtures, dates, card, dev):
    """Phase 25: each serving shape's graph (parallel/graphed.graph_step)
    against its eager step, bit for bit, with the two steps' times; the
    graphed HostScanner and split step against their eager forms."""
    phase("25 graphs")
    t0 = time.perf_counter()
    from cardio_dmz_tpu_torch.parallel.graphed import WARMUP_CALLS
    runs = {}
    for shape in GRAPH_SHAPES:
        runs[shape] = run = graph_shape_run(port, params, shape, fixtures,
                                            dates, dev)
        print(f"graph {shape} at {N_STREAMS} streams: {WARMUP + STEPS} "
              f"steps bit for bit with the eager step ({run['leaves']} "
              f"leaves of states and results each); step ms eager "
              f"{run['eager_ms']:.3f}, graphed {run['graph_ms']:.3f} (median "
              f"of 20, in turns); device ms {run['eager_device_ms']}, "
              f"{run['graph_device_ms']}; idle share {run['eager_idle']}, "
              f"{run['graph_idle']}; host launches a step "
              f"{run['eager_host_launches']}, {run['graph_host_launches']}; "
              f"capture {run['capture_s']:.3f} s with {WARMUP_CALLS} eager "
              f"warm-up calls; pool {run['pool_mib']:.1f} MiB (before "
              f"{run['pool_mib_before']:.1f}); kernels in one replay "
              f"{run['replay_launches']}; card {card}")
    expiry = fixtures[2]
    frames = expiry["frames"][0]
    add_frame = add_frame_ms(port, params, frames,
                             tuple(expiry["now"].tolist()), dev)
    print(f"HostScanner.add_frame over {len(frames)} frames, median ms: "
          f"graphed {add_frame['graphed']:.3f}, eager {add_frame['eager']:.3f}"
          f"; card {card}")
    shards = {name: two_shards_ms(port, params, expiry, dates, scan_expiry,
                                  dev)
              for name, scan_expiry in (("pan", False), ("full", True))}
    print(f"two shards on {dev} ({N_STREAMS // 2 + 1} + "
          f"{N_STREAMS - N_STREAMS // 2 - 1} streams), host ms: "
          + json.dumps(shards) + f"; card {card}")
    print(f"graphs: {time.perf_counter() - t0:.3f} s")
    return {"runs": runs, "add_frame": add_frame, "shards": shards,
            "launches": {shape: run["replay_launches"]
                         for shape, run in runs.items()}}


# --- 26 jit sites -------------------------------------------------------------

# phase 26's rectified sweep, eager and graphed: the first two batches of
# phase 21's (sweep_session.npz's first 128 sessions)
JIT_SWEEP_ARGS = (128,) + SWEEP_ARGS[1:]


class EagerStep:
    """graph_step's stand-in for the eager form of a graphed site: fn
    called as it is, for comparison with the graph."""

    def __init__(self, fn, device):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def replay(self, *args):
        self.fn(*args)


@contextlib.contextmanager
def eager_sites(*modules):
    """Within, each module's graph_step makes an EagerStep."""
    with contextlib.ExitStack() as stack:
        for module in modules:
            stack.enter_context(mock.patch.object(module, "graph_step",
                                                  EagerStep))
        yield


def train_one_seconds(model, dev):
    """train_one's seconds (TRAIN_FLOORS' steps at TRAIN_BATCH, batches
    made on the host) graphed and eager, in turns (graphed, eager), and
    the held-out accuracies."""
    from cardio_dmz_tpu_torch.tools.train_models import train_one
    from cardio_dmz_tpu_torch.train import trainer
    steps = TRAIN_FLOORS[model][0]
    out = {}
    for form in ("graphed", "eager"):
        with (eager_sites(trainer) if form == "eager"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            _, acc, _ = train_one(model, steps, TRAIN_BATCH, TRAIN_LR, None,
                                  device=dev)
            torch.cuda.synchronize()
            out[form] = (time.perf_counter() - t0, acc)
    return out


def jit_sweeps(port, dev, graphed_reads):
    """The rectified sweep at JIT_SWEEP_ARGS and the camera sweep at
    CAMERA_SWEEP_ARGS, eager then graphed: reads equal session for
    session, and equal to phase 21's graphed reads (graphed_reads) and
    the fixture's; seconds of each."""
    from cardio_dmz_tpu_torch.tools import accuracy_sweep
    runs = {}
    for name, fn, args in (
            ("rect", accuracy_sweep.sweep_reads, JIT_SWEEP_ARGS),
            ("camera", accuracy_sweep.camera_sweep_reads,
             CAMERA_SWEEP_ARGS)):
        for form in ("eager", "graphed"):
            with (eager_sites(accuracy_sweep) if form == "eager"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                reads = fn(*args, quiet=True, device=dev)
                runs[name, form] = (reads, time.perf_counter() - t0)
        (eager, _), (graphed, _) = runs[name, "eager"], runs[name, "graphed"]
        n = args[0]
        want = tuple(r[:n] for r in graphed_reads[name])
        if eager != graphed or graphed != want:
            raise AssertionError(f"{name} sweep: eager and graphed reads "
                                 f"differ, or differ from phase 21's")
    return {f"{name} {form}": (round(sec, 3), sum(
        r is not None for r in reads[1])) for (name, form), (reads, sec)
        in runs.items()}


def eager_profilers(dev):
    """run_profilers with every stage eager (EagerStep in event_ms); the
    tools' own lines, whose header says graphed, are not printed."""
    import io
    from cardio_dmz_tpu_torch.tools import profiling
    with eager_sites(profiling), contextlib.redirect_stdout(io.StringIO()):
        return run_profilers(dev)


def jit_sites_phase(port, kernels, card, dev, graphed_reads, profiled):
    """Phase 26: the JAX package's other jit sites as graphs: the train
    step of each model against its eager form bit for bit, both timed in
    turns; train_one, the sweeps and the stage profilers graphed and
    eager."""
    phase("26 jit sites")
    t0 = time.perf_counter()
    reset_launches(kernels)
    for model in TRAIN_MODELS:
        leaves, capture_s = train_graph_bits(model, dev)
        timings = {b: train_step_timing(model, b, dev)
                   for b in ((TRAIN_BATCH, SERVING_BATCH)
                             if model == "pan_conv" else (TRAIN_BATCH,))}
        seconds = train_one_seconds(model, dev)
        print(f"{model}: {TRAIN_GRAPH_STEPS} train steps at batch "
              f"{TRAIN_BATCH}, eager twice and graphed, bit for bit "
              f"({leaves} leaves a step: parameters, mu, nu, count, loss); "
              f"capture {capture_s:.3f} s; "
              + "; ".join(f"at batch {b}: " + json.dumps(t)
                          for b, t in timings.items())
              + "; train_one s and accuracy " + json.dumps(seconds)
              + f"; card {card}")
    launches = read_launches(kernels)
    if any(launches.values()):
        raise AssertionError(f"a train step launched a serving kernel: "
                             f"{launches}")
    sweeps_seen = jit_sweeps(port, dev, graphed_reads)
    print(f"sweeps eager and graphed, reads equal session for session and "
          f"to phase 21's (seconds, sessions accepted): "
          f"{json.dumps(sweeps_seen)}; card {card}")
    eager = eager_profilers(dev)
    print("profilers at {} streams, ms a stage graphed / eager: {}; card {}"
          .format(PROFILE_STREAMS, json.dumps(
              {tool: {stage: [round(ms, 4), round(eager[tool][stage], 4)]
                      for stage, ms in times.items()}
               for tool, times in profiled.items()}), card))
    print(f"jit sites: {time.perf_counter() - t0:.3f} s")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on an NVIDIA card")
    import cardio_dmz_tpu_torch as port
    from cardio_dmz_tpu_torch.ops.cuda import digit_prep, persp_qr, warp_gather
    from cardio_dmz_tpu_torch.runtime import ingest

    kernels = {"digit_prep": digit_prep, "warp_gather": warp_gather,
               "persp_qr": persp_qr}
    dev = torch.device("cuda", 0)
    card = device_phase()
    build_phase(kernels, ingest)
    fixture = load_npz(fixture_path(port, "smoke_session.npz"))
    measured = {"digit_prep": kernel_phase(port, digit_prep, fixture, dev)}
    params = models_phase(port, dev)
    pans = session_phase(port, kernels, params, fixture, dev)
    scan = serving_phase(port, kernels, params, fixture, pans, card, dev)
    measured["persp_qr"] = persp_phase(persp_qr, dev)
    persp_cases(persp_qr, dev)
    persp_floors(persp_qr, dev)
    measured["warp_gather"] = warp_phase(port, warp_gather, dev)
    camera = load_npz(fixture_path(port, "camera_session.npz"))
    camera_pans = camera_session_phase(port, kernels, params, camera, dev)
    serving = camera_serving_phase(port, kernels, params, camera,
                                   camera_pans, card, dev)
    if serving["card_maps"]:
        raise AssertionError(f"the camera step made card-shaped float64 or "
                             f"int32 tensors: {serving['card_maps']}")
    expiry = load_npz(fixture_path(port, "expiry_session.npz"))
    dates = expiry_phase(port, kernels, params, expiry, dev)
    full_serving_phase(port, kernels, params, expiry, dates, card, dev)
    full_camera_serving_phase(port, kernels, params, expiry, dates, card,
                              dev)
    host = load_npz(fixture_path(port, "host_session.npz"))
    host_scan = host_scanner_phase(port, kernels, params, expiry, host, card,
                                   dev)
    oriented = oriented_camera_phase(port, kernels, params, expiry, host, dev)
    checkpoint_phase(port, kernels, params, expiry, host, dates, dev)
    split = split_step_phase(port, kernels, params, expiry, dates, card, dev)
    loop = serving_loop_phase(port, kernels, card, dev)
    train_phase(port, kernels, card, dev)
    hooks = entry_phase(port, kernels, card, dev)
    tools = tools_phase(port, kernels, params, card, dev)
    profilers = profilers_phase(port, kernels, params, expiry, card, dev)
    reference = reference_phase(port, kernels, params, dev)
    weights = weights_phase(port, kernels, params, fixture, dev)
    graphs = graphs_phase(port, params, (fixture, camera, expiry), dates,
                          card, dev)
    jit_sites_phase(port, kernels, card, dev, tools["reads"],
                    profilers["times"])

    seconds, total = phase_seconds()
    print(f"phase seconds {json.dumps(seconds)}; total {total:.3f} s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1],
        "launches": serving["launches"][name],
        "launches_scan_path": scan["launches"][name],
        "launches_host_scanner_session": host_scan["launches"][name],
        "launches_portrait_run": oriented["portrait"][name],
        "launches_split_full_camera_run":
            split["camera-full [cuda:0, cuda:0]"][name],
        "launches_serving_loop": loop["launches"][name],
        "launches_entry": hooks["entry"][name],
        "launches_dryrun_multichip": hooks["dryrun"][name],
        "launches_bench_step": {shape: n[name] for shape, n in
                                tools["launches"].items()},
        "launches_roofline_step": {shape: n[name] for shape, n in
                                   profilers["launches"].items()},
        "launches_reference_phase": reference["launches"][name],
        "launches_weights_phase": weights["launches"][name],
        "launches_graph_replay": {shape: n[name] for shape, n in
                                  graphs["launches"].items()},
        **measured[name]} for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
