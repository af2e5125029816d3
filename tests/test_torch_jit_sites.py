"""The JAX package's other jit sites in the port, on the CPU: the train
step (train/trainer.make_train_step, a pure step through
parallel/graphed.graph_step with train/optim.adam), the accuracy sweeps'
three steps, the parity tool's device functions and the stage profilers'
timed stages (tools/profiling.event_ms).

On the CPU no graph exists: graph_step stages each step on its static
buffers, WARMUP_CALLS eager calls first. These tests hold the staging
against the eager step bit for bit (a pure step's warm-up calls change
nothing), the train step against the JAX fit at the tolerances of
tests/test_torch_train.py (chip_smoke.check_fit), dicts as graph_step's
arguments, calc_persp_transform's solve_ex against solve bit for bit, and
every graphed step against tests/torch_rehearsal.py: nothing in it that a
capture on the card would refuse. tests/test_torch_cuda.py holds the
train step's graph against its eager step on the card.
"""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

import torch_fixture as fx
from torch_parity import port_params
from torch_rehearsal import recorded_steps, refused, tensors
from cardio_dmz_tpu_torch import entry as port_entry
from cardio_dmz_tpu_torch.ops import warp as port_warp
from cardio_dmz_tpu_torch.parallel import graphed, make_mesh
from cardio_dmz_tpu_torch.parallel.graphed import WARMUP_CALLS, graph_step
from cardio_dmz_tpu_torch.parallel.mesh import Mesh, _map
from cardio_dmz_tpu_torch.tools import (
    accuracy_sweep, parity_ab, profile_camera, profile_camera_ablate,
    profile_expiry, profile_pan, profile_warp, profiling, train_models)
from cardio_dmz_tpu_torch.train import AdamState, adam, make_train_step
from cardio_dmz_tpu_torch.train import trainer
from chip_smoke import check_fit

MODELS = fx.TRAIN_MODELS
LR = 3e-3
N_STEPS = 3


def _bits(tree):
    """Every tensor leaf of a tree as (dtype, shape, bytes)."""
    return [(t.dtype, tuple(t.shape), t.detach().numpy().tobytes())
            for t in tensors(tree)]


def _plain(x):
    """x with each numpy array as (dtype, shape, bytes): comparable."""
    if isinstance(x, np.ndarray):
        return x.dtype.str, x.shape, x.tobytes()
    if isinstance(x, (list, tuple)):
        return type(x).__name__, tuple(_plain(v) for v in x)
    return x


# --- graph_step takes dicts ---------------------------------------------------

def test_dicts_are_arguments_and_results():
    """A dict argument keys by its sorted keys (insertion order does not
    make a new entry; other keys do); a dict result comes back as a dict
    of new tensors; dicts nest in a NamedTuple (the optimizer's state)."""
    def fn(params, state):
        return {"sum": params["a"] + params["b"]}, state._replace(
            count=state.count + 1)

    step = graph_step(fn, "cpu")
    state = AdamState(torch.zeros((), dtype=torch.int32),
                      {"a": torch.ones(2)}, {"a": torch.zeros(2)})
    out, new = step({"a": torch.ones(3), "b": torch.full((3,), 2.0)}, state)
    assert isinstance(out, dict) and torch.equal(out["sum"],
                                                 torch.full((3,), 3.0))
    assert isinstance(new, AdamState) and isinstance(new.mu, dict)
    assert int(new.count) == 1
    out2, _ = step({"b": torch.zeros(3), "a": torch.ones(3)}, state)
    assert torch.equal(out2["sum"], torch.ones(3))
    assert torch.equal(out["sum"], torch.full((3,), 3.0))   # not overwritten
    assert len(step.entries) == 1
    entry, = step.entries.values()
    assert out2["sum"].data_ptr() != entry.static_in[0]["a"].data_ptr()
    step({"a": torch.ones(3), "c": torch.ones(3)} | {"b": torch.ones(3)},
         state)
    assert len(step.entries) == 2
    assert graphed._key(({"b": torch.ones(1), "a": torch.ones(1)},)) == \
        graphed._key(({"a": torch.ones(1), "b": torch.ones(1)},))
    doubled = _map(lambda t: None if t is None else t * 2,
                   {"x": (torch.ones(1), None)})
    assert doubled["x"][0] == 2 and doubled["x"][1] is None


def test_a_python_number_in_a_dict_is_refused():
    with pytest.raises(TypeError, match="float"):
        graph_step(lambda d: d["a"], "cpu")({"a": 0.5})


# --- the train step ------------------------------------------------------------

def _train_inputs(model, batch=16, seed=1):
    init_fn, loss_fn, _, data_fn = train_models._spec(model, "cpu")
    rng = np.random.RandomState(seed)
    batches = [tuple(torch.from_numpy(a) for a in data_fn(rng, batch))
               for _ in range(N_STEPS)]
    return init_fn(), loss_fn, batches


@pytest.mark.parametrize("model", MODELS)
def test_graphed_train_step_equals_eager(model):
    """N_STEPS steps through make_train_step's graphed step and through
    its eager form (step.fn), each from the same parameters: parameters,
    mu, nu, count and loss bit for bit at every step. The graphed step's
    first call ran WARMUP_CALLS steps before it on the same buffers, so a
    step that kept any state would differ here. The arguments come back
    unchanged (the step is pure); one graph key."""
    params, loss_fn, batches = _train_inputs(model)
    optimizer = adam(LR)
    step = make_train_step(loss_fn, optimizer, params_template=params)
    assert isinstance(step, graphed.GraphedStep)
    before = _bits(params)
    runs = []
    for fn in (step, step.fn):
        p, s, out = params, optimizer.init(params), []
        for x, y in batches:
            p, s, loss = fn(p, s, x, y)
            out.append(_bits((p, s, loss)))
        runs.append(out)
    assert runs[0] == runs[1]
    assert _bits(params) == before
    assert len(step.entries) == 1
    assert int(s.count) == N_STEPS


@pytest.mark.parametrize("model", MODELS)
def test_train_step_holds_nothing_a_capture_refuses(model):
    """The train step of each model (forward, autograd.grad, the Adam
    update), and over a one-device mesh with two data groups and two
    model ranks, reads nothing back to the host and builds no tensor
    from host data at a call (the clip's bounds were built with
    new_tensor at every step until the graphs came)."""
    params, loss_fn, batches = _train_inputs(model)
    optimizer = adam(LR)
    state = optimizer.init(params)
    x, y = batches[0]
    for mesh in (None, make_mesh(["cpu"] * 4, model_parallel=2)):
        step = make_train_step(loss_fn, optimizer, mesh=mesh,
                               params_template=params)
        assert isinstance(step, graphed.GraphedStep)
        assert refused(lambda: step.fn(params, state, x, y)) == ([], [])


def test_rehearsal_sees_the_host_scalars_of_the_old_clip():
    """The rehearsal fails on the clip as it was written before the
    graphs (probs.new_tensor(1e-12) and new_tensor(1.0) at every call)
    and passes the cached bounds of trainer._xent."""
    def old_xent(probs, labels):
        clipped = torch.minimum(torch.maximum(
            probs, probs.new_tensor(1e-12)), probs.new_tensor(1.0))
        return -torch.log(clipped).gather(1, labels.long()[:, None]).mean()

    probs = torch.softmax(torch.randn(4, 10, generator=torch.Generator(
        ).manual_seed(0)), -1)
    labels = torch.arange(4)
    assert refused(lambda: old_xent(probs, labels)) == (
        [], [("aten.maximum.default", ()), ("aten.minimum.default", ())])
    assert refused(lambda: trainer._xent(probs, labels)) == ([], [])


def test_a_mesh_of_distinct_devices_steps_eagerly():
    """A mesh over distinct devices is stepped eagerly (a graph is
    captured on one device); one that names one device n times is one
    graph."""
    params, loss_fn, _ = _train_inputs("vseg_mlp")
    distinct = Mesh(((torch.device("cpu"),), (torch.device("cuda", 1),)))
    step = make_train_step(loss_fn, adam(LR), mesh=distinct,
                           params_template=params)
    assert not isinstance(step, graphed.GraphedStep) and callable(step)
    assert not trainer._one_device(distinct, "cpu")
    assert trainer._one_device(make_mesh(["cpu"] * 4, model_parallel=2),
                               "cpu")


@pytest.mark.parametrize("model", MODELS)
def test_graphed_fit_matches_jax(model):
    """fit through its graphed step (one GraphedStep, one key) from the JAX
    initial parameters on the JAX batches: chip_smoke.check_fit's
    tolerances against the JAX fit."""
    made = []

    def recording(fn, device):
        made.append(graph_step(fn, device))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "graph_step", recording)
        check_fit(train_models._spec(model, "cpu")[1],
                  fx.jax_train_run(model), "cpu")
    assert len(made) == 1 and len(made[0].entries) == 1


def test_dryrun_multichip_fit_step_is_one_graph(capsys):
    """dryrun_multichip over four copies of one device: its fit step is a
    graph of the whole 2 x 2 mesh step."""
    made = []

    def recording(fn, device):
        made.append(graph_step(fn, device))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "graph_step", recording)
        summary = port_entry.dryrun_multichip(4, ["cpu"] * 4)
    assert np.isfinite(summary["train_loss"])
    assert len(made) == 1 and len(made[0].entries) == 1


# --- calc_persp_transform: solve_ex ------------------------------------------

@pytest.mark.parametrize("batch", [(), (7,), (3, 5)])
def test_solve_ex_gives_solve_bits(batch):
    """calc_persp_transform solves with torch.linalg.solve_ex, which reads
    nothing back; its homographies are the bits of torch.linalg.solve's."""
    rng = np.random.RandomState(len(batch))
    quads = torch.from_numpy((np.float32(accuracy_sweep.GUIDE_QUAD)
                              + rng.uniform(-8, 8, batch + (4, 2))).astype(
        np.float32))
    src = torch.tensor(accuracy_sweep.CARD_SRC, dtype=torch.float32)
    got = port_warp.calc_persp_transform(src, quads)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.linalg, "solve_ex",
                   lambda a, b: (torch.linalg.solve(a, b), None))
        want = port_warp.calc_persp_transform(src, quads)
    assert got.shape == batch + (3, 3)
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_rehearsal_sees_the_linalg_checks():
    """torch.linalg.solve and inv read their LU's info back to check it
    (the capture on the card refuses that); the _ex forms that
    calc_persp_transform and warp_perspective use do not."""
    a = torch.eye(3).expand(2, 3, 3).contiguous()
    check = ["aten._linalg_check_errors.default"]
    assert refused(lambda: torch.linalg.inv(a)) == (check, [])
    assert refused(lambda: torch.linalg.solve(a, a[..., 0])) == (check, [])
    quad = torch.tensor(accuracy_sweep.GUIDE_QUAD, dtype=torch.float32)
    src = torch.tensor(accuracy_sweep.CARD_SRC, dtype=torch.float32)
    card = torch.zeros((1, 270, 428), dtype=torch.uint8)
    assert refused(lambda: port_warp.warp_perspective(
        card, port_warp.calc_persp_transform(src, quad[None]),
        (48, 64))) == ([], [])


# --- the accuracy sweeps -------------------------------------------------------

SWEEP_SMALL = (6, 3, 4, 11)          # sessions, frames, batch, seed
CAMERA_SMALL = (3, 2, 2, 5)


@pytest.mark.parametrize("sweep", ["rect", "camera"])
def test_sweep_graphed_reads_equal_eager(sweep):
    """Each sweep's graphed reads equal its eager reads session for
    session (the last batch padded); each of its steps (the placement
    warp, the session scan, the camera step) holds nothing a capture
    refuses."""
    fn, args = ((accuracy_sweep.sweep_reads, SWEEP_SMALL) if sweep == "rect"
                else (accuracy_sweep.camera_sweep_reads, CAMERA_SMALL))
    got = fn(*args, quiet=True, device="cpu")
    with recorded_steps(accuracy_sweep) as steps:
        want = fn(*args, quiet=True, device="cpu")
    assert got == want
    assert len(steps) == (1 if sweep == "rect" else 3)
    for step in steps:
        assert step.rehearse() == ([], [])


# --- the parity tool's device functions ---------------------------------------

@functools.lru_cache(maxsize=None)
def _parity_inputs():
    """Frames, an expiry session and landscape previews drawn by the
    parity tool's own case generators."""
    rng = np.random.default_rng(2026)
    frames = np.stack([parity_ab.render_frame_case(c)
                       for c in parity_ab.frame_cases(rng, 3)])
    parity_ab.pan_session_cases(rng, 1)
    case = parity_ab.expiry_session_cases(rng, 1)[0]
    session = parity_ab.render_expiry_session(case)[:3]
    y, cb = map(np.stack, zip(*[parity_ab.render_camera_case(c)
                                for c in parity_ab.camera_cases(rng, 2)]))
    corners = parity_ab.port_camera(y, cb, 3, "cpu")[1]
    return frames, session, y, cb, corners


PARITY_CALLS = {
    "port_frames": lambda p, i: parity_ab.port_frames(p, i[0], "cpu"),
    "port_expiry_windows": lambda p, i: parity_ab.port_expiry_windows(
        p, i[1], "cpu"),
    "device_sessions": lambda p, i: parity_ab.device_sessions(
        p, np.stack([i[1], i[1][::-1]]), True, "cpu"),
    "port_camera": lambda p, i: parity_ab.port_camera(i[2], i[3], 3, "cpu"),
    "port_cards_from_corners": lambda p, i: parity_ab.port_cards_from_corners(
        i[2], i[4], 3, "cpu"),
    "float_cards": lambda p, i: parity_ab.float_cards(i[2], i[4], "cpu"),
}


@pytest.mark.parametrize("name", sorted(PARITY_CALLS))
def test_parity_device_function_graphed_equals_eager(name):
    """The parity tool's device function through its graphed step and
    eagerly: the same records, windows, reads, corners and cards; its
    graphed step holds nothing a capture refuses (the host conversions
    run on a replay's results)."""
    call, inputs = PARITY_CALLS[name], _parity_inputs()
    got = call(port_params(), inputs)
    with recorded_steps(parity_ab) as steps:
        want = call(port_params(), inputs)
    assert _plain(got) == _plain(want)
    assert len(steps) == 1
    assert steps[0].rehearse() == ([], [])


# --- the stage profilers -------------------------------------------------------

PROFILERS = {"profile_pan": (profile_pan, []),
             "profile_expiry": (profile_expiry, []),
             "profile_expiry --fine": (profile_expiry, ["--fine"]),
             "profile_camera": (profile_camera, []),
             "profile_camera_ablate": (profile_camera_ablate, []),
             "profile_warp": (profile_warp, [])}


def test_event_ms_times_replays_of_a_graph():
    """event_ms captures fn (WARMUP_CALLS eager calls and the capture at
    the first replay), replays it `warmup` times, then times `iters`
    replays."""
    calls = []
    ms = profiling.event_ms(lambda: calls.append(1), "cpu", iters=4,
                            warmup=2)
    assert ms >= 0.0 and len(calls) == WARMUP_CALLS + 1 + 2 + 4


@pytest.mark.parametrize("name", sorted(PROFILERS))
def test_profiler_stages_hold_nothing_a_capture_refuses(name):
    """Every timed stage of each stage profiler, rehearsed at 2 streams
    on the arguments the tool gave it."""
    module, extra = PROFILERS[name]
    with recorded_steps(profiling) as steps, \
            contextlib.redirect_stdout(io.StringIO()):
        times = module.main(["--device", "cpu", "--streams", "2",
                             "--iters", "1"] + extra)
    assert len(steps) == len(times)
    for stage, step in zip(times, steps):
        assert step.rehearse() == ([], []), stage
