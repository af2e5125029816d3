"""The stream axis split over a device list: make_mesh, shard_streams,
make_sharded_step and batched_scan_frames. A split over ["cpu", "cpu"]
must equal the unsplit batched step bit for bit, states and results, and
the JAX package's sharded step in every discrete field; a session moves
between splits through a checkpoint (the case of
tests/test_parallel_train.py::test_session_migration_across_mesh_shapes)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
import torch_fixture as fx
from cardio_dmz_tpu_torch.parallel import (
    Mesh, batched_camera_step, batched_scan_frames, batched_scanner_step,
    gather_streams, init_stream_states, make_mesh, make_sharded_step,
    shard_streams, split_sizes)
from cardio_dmz_tpu_torch.parallel.mesh import as_device, data_devices
from cardio_dmz_tpu_torch.parallel.streams import replicate_params
from cardio_dmz_tpu_torch.session import (
    load_session_npz, save_session_npz, scan_frames)
from cardio_dmz_tpu_torch.session.checkpoint import leaf_names, state_leaves
from torch_parity import assert_same, port_params, to_np

PANS = ["4111111111111111", "4539578763621486"]
N_FRAMES = 6


@functools.lru_cache(maxsize=None)
def _frames(n_streams=8):
    """The frames of the reference's migration test: (S, 6, 270, 428)."""
    return np.stack([
        np.stack([synthetic.render_frame(PANS[s % 2], seed=3 * s + t,
                                         noise=1, y0=150, offset=35)
                  for t in range(N_FRAMES)])
        for s in range(n_streams)])


def _trees_equal(a, b):
    if isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


# --- the mesh --------------------------------------------------------------

def test_make_mesh_shapes_and_devices():
    mesh = make_mesh(["cpu"] * 4, model_parallel=2)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.data_devices == [torch.device("cpu")] * 2
    assert make_mesh(["cpu"]).shape == {"data": 1, "model": 1}
    assert data_devices(["cpu", torch.device("cpu")]) == \
        [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 3, model_parallel=2)
    assert as_device("cpu") == torch.device("cpu")


def test_make_mesh_has_no_cpu_default():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh().data_devices)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


@pytest.mark.parametrize("n, k, want", [(8, 2, [4, 4]), (5, 2, [3, 2]),
                                        (256, 3, [86, 85, 85]),
                                        (1, 2, [1, 0])])
def test_split_sizes(n, k, want):
    assert split_sizes(n, k) == want


def test_shard_and_gather_round_trip():
    states = init_stream_states(5, "cpu", fx.NOW)
    states.count15[:] = torch.arange(5, dtype=torch.int32)
    shards = shard_streams(["cpu", "cpu"], states)
    assert [s.count15.tolist() for s in shards] == [[0, 1, 2], [3, 4]]
    assert shards[1].expiry.scores.shape == (2, 4, 5, 10)
    _trees_equal(gather_streams(shards), states)
    uneven = shard_streams(make_mesh(["cpu", "cpu"]), states, sizes=[1, 4])
    assert [len(s.count15) for s in uneven] == [1, 4]
    _trees_equal(gather_streams(uneven, "cpu"), states)
    frames = torch.arange(10).reshape(5, 2)
    assert [t.tolist() for t in shard_streams(["cpu", "cpu"], frames)] == [
        [[0, 1], [2, 3], [4, 5]], [[6, 7], [8, 9]]]
    with pytest.raises(ValueError, match="shard sizes"):
        shard_streams(["cpu", "cpu"], frames, sizes=[2, 2])


def test_replicate_params_shares_a_copy_per_device():
    copies = replicate_params(port_params(), data_devices(["cpu", "cpu"]))
    assert list(copies) == [torch.device("cpu")]
    assert copies[torch.device("cpu")] is port_params()


# --- the split step --------------------------------------------------------

def _unsplit_run(frames, scan_expiry):
    state = init_stream_states(len(frames), "cpu", fx.NOW)
    out = []
    for t in range(frames.shape[1]):
        state, res = batched_scanner_step(
            port_params(), state, torch.from_numpy(frames[:, t]),
            scan_expiry=scan_expiry)
        out.append((state, res))
    return out


@pytest.mark.parametrize("n_streams, devices, sizes, scan_expiry", [
    (8, ["cpu", "cpu"], None, False),
    (5, ["cpu", "cpu"], None, False),
    (8, ["cpu", "cpu", "cpu"], [1, 5, 2], False),
    (8, ["cpu"], None, False),
    (3, ["cpu", "cpu"], None, True),
], ids=["8-even", "5-uneven", "8-three-ways", "8-one-way", "3-expiry"])
def test_sharded_step_equals_unsplit(n_streams, devices, sizes, scan_expiry):
    frames = fx.expiry_frames()[:, :4] if scan_expiry \
        else _frames()[:n_streams, :4]
    step, place, init = make_sharded_step(port_params(), devices,
                                          scan_expiry=scan_expiry,
                                          sizes=sizes)
    states = init(n_streams, fx.NOW)
    assert len(states) == len(devices)
    for t, (ref_state, ref_out) in enumerate(_unsplit_run(frames,
                                                          scan_expiry)):
        states, out = step(states, place(torch.from_numpy(frames[:, t])))
        _trees_equal(gather_streams(states), ref_state)
        _trees_equal(out, ref_out)
    assert out[1].complete.shape == (n_streams,)


def test_sharded_step_matches_jax_sharded_step():
    """The reference's make_sharded_step over its 8-device CPU mesh and the
    port's over two devices, on the same 8 streams: every discrete field
    equal, scores within 1e-5."""
    from cardio_dmz_tpu.models.weights import load_all_params
    from cardio_dmz_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from cardio_dmz_tpu.parallel.streams import (
        make_sharded_step as jax_make_sharded_step)
    frames = _frames()
    jstep, jplace, jinit = jax_make_sharded_step(
        load_all_params(), jax_make_mesh(jax.devices()[:8]))
    jstates = jinit(8)
    jstates = jstates._replace(
        now_year=jnp.full_like(jstates.now_year, fx.NOW[0]),
        now_month=jnp.full_like(jstates.now_month, fx.NOW[1]))
    step, place, init = make_sharded_step(port_params(), ["cpu", "cpu"])
    states = init(8, fx.NOW)
    for t in range(4):
        jstates, (jframe, jresult) = jstep(jstates, jplace(frames[:, t]))
        states, (frame, result) = step(states, place(
            torch.from_numpy(frames[:, t])))
        assert_same(fx._np(jframe), frame, atol=1e-5, rtol=1e-5)
        assert_same(fx._np(jresult), result)
        assert_same(fx._np(jstates), gather_streams(states), atol=1e-5)
    assert to_np(result.complete).any()


def test_place_and_camera_step_per_shard_equal_unsplit():
    """The camera step has no sharded form of its own, as in the JAX
    package: place the inputs and step each shard."""
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, 0]))
              for a in fx.camera_frames()]
    planes = [torch.cat([p, p.flip(0)[:1]]) for p in planes]     # 3 streams
    _, place, init = make_sharded_step(port_params(), ["cpu", "cpu"])
    shards = [place(p) for p in planes]
    outs, new_states = [], []
    for k, state in enumerate(init(3, fx.NOW)):
        state, out = batched_camera_step(port_params(), state,
                                         *(s[k] for s in shards))
        new_states.append(state)
        outs.append(out)
    ref_state, ref_out = batched_camera_step(
        port_params(), init_stream_states(3, "cpu", fx.NOW), *planes)
    _trees_equal(gather_streams(new_states), ref_state)
    _trees_equal(gather_streams(outs), ref_out)
    assert to_np(ref_out[0]).all()


def test_batched_scan_frames_is_scan_frames():
    frames = torch.from_numpy(_frames()[:2])
    state, (fr, res) = batched_scan_frames(port_params(), frames, fx.NOW)
    ref_state, (ref_fr, ref_res) = scan_frames(port_params(), frames, fx.NOW)
    _trees_equal(state, ref_state)
    _trees_equal(fr, ref_fr)
    _trees_equal(res, ref_res)
    assert res.complete.shape == (2, N_FRAMES)
    assert to_np(res.complete[:, -1]).all()


# --- migration -------------------------------------------------------------

def test_session_migration_across_splits(tmp_path):
    """Checkpoint a split session midway, restore it onto another split
    (2 devices -> 1), continue, and read what the never-migrated run
    reads."""
    frames = _frames()

    def run(step, place, states, t0, t1):
        res = None
        for t in range(t0, t1):
            states, (_, res) = step(states, place(
                torch.from_numpy(frames[:, t])))
        return states, res

    step2, place2, init2 = make_sharded_step(port_params(), ["cpu", "cpu"])
    straight, res_straight = run(step2, place2, init2(8, fx.NOW), 0,
                                 N_FRAMES)

    states, _ = run(step2, place2, init2(8, fx.NOW), 0, 3)
    path = str(tmp_path / "mid.npz")
    save_session_npz(path, gather_streams(states))

    step1, place1, _ = make_sharded_step(port_params(), make_mesh(["cpu"]))
    restored = place1(load_session_npz(path, device="cpu"))
    assert len(restored) == 1
    migrated, res_migrated = run(step1, place1, restored, 3, N_FRAMES)

    _trees_equal(res_migrated, res_straight)
    a, b = gather_streams(migrated), gather_streams(straight)
    for name, x, y in zip(leaf_names(a), state_leaves(a), state_leaves(b)):
        assert torch.equal(x, y), name
    assert to_np(res_migrated.complete).any()
    got = ["".join(map(str, d[:16])) for d, c in zip(
        to_np(res_migrated.predictions), to_np(res_migrated.complete)) if c]
    assert set(got) <= set(PANS) and got
