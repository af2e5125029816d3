"""The port on an NVIDIA card: each CUDA kernel (digit prep, persp QR, the
exact warp) against its plain version, the scan, camera and expiry paths
on the card against the same paths on the CPU, and each serving step and
each model's train step replayed as a CUDA graph
(parallel/graphed.graph_step) against the eager step, bit for bit.

These tests skip without a card. They import neither jax nor the JAX
package, so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The stream counts 1, 127 and 129 are the launch shapes of the single-stream
HostScanner and of a 256-stream step split unevenly over two shards.
"""

import os

import numpy as np
import pytest
import torch

import cardio_dmz_tpu_torch
from cardio_dmz_tpu_torch.api import preprocess_frame
from cardio_dmz_tpu_torch.models import load_all_params
from cardio_dmz_tpu_torch.ops.cuda import digit_prep, persp_qr, warp_gather
from cardio_dmz_tpu_torch.parallel import (
    batched_camera_step, batched_scanner_step, init_stream_states)
from cardio_dmz_tpu_torch.parallel.graphed import (
    WARMUP_CALLS, CaptureError, graph_step)
from cardio_dmz_tpu_torch.scan import (
    best_n_hseg, best_n_vseg, scan_card_image)
from cardio_dmz_tpu_torch.scan.frame import pan_strip
from cardio_dmz_tpu_torch.session import scan_frames
from chip_smoke import dest_rects, paste_previews
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(cardio_dmz_tpu_torch.__file__), "data")
CARD_DEST = torch.tensor([[0.0, 0.0], [427.0, 0.0], [0.0, 269.0],
                          [427.0, 269.0]])
# the guide rect in each warp corner order: landscape tl, tr, bl, br;
# portrait bl, tl, br, tr
GUIDE = {"landscape": [[106, 105], [534, 105], [106, 375], [534, 375]],
         "portrait": [[185, 454], [185, 26], [455, 454], [455, 26]]}


def _quads(orientation, n, seed):
    """n detector-realistic quads, the guide rect +-12 px per corner."""
    rng = np.random.RandomState(seed)
    quads = np.float32(GUIDE[orientation])[None] + rng.uniform(
        -12.0, 12.0, (n, 4, 2))
    return torch.from_numpy(quads.astype(np.float32))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _strips(kind, n_streams, device):
    """(strips, offsets) at n_streams: uniform noise with sorted random
    offsets; the recorded fixture frames' PAN strips with their vseg row
    and hseg offsets, as the serving path hands them to the kernel; or an
    all-equal strip (every gradient 0, all increments on one bin)."""
    rng = np.random.RandomState(n_streams)
    strips = torch.from_numpy(rng.randint(
        0, 256, (n_streams, 27, 428)).astype(np.uint8)).to(device)
    offsets = np.sort(rng.randint(0, 410, (n_streams, 16)), axis=1)
    offsets[:, 0], offsets[:, -1] = 0, 409
    offsets = torch.from_numpy(offsets.astype(np.int32)).to(device)
    if kind == "equal":
        strips = torch.full_like(strips, 77)
    if kind == "real":
        with np.load(os.path.join(DATA, "smoke_session.npz")) as f:
            frames = f["frames"].reshape(-1, 270, 428)
        frames = np.tile(frames, (-(-n_streams // len(frames)), 1, 1))
        frames = torch.from_numpy(frames[:n_streams]).to(device)
        params = load_all_params(device)
        vseg = best_n_vseg(params["vseg_mlp"], frames)
        strips = pan_strip(frames, vseg.y_offset).contiguous()
        offsets = best_n_hseg(strips, vseg.pattern_type,
                              vseg.number_length).offsets.to(torch.int32)
    return strips, offsets.contiguous()


@pytest.mark.parametrize("kind", ["noise", "real", "equal"])
@pytest.mark.parametrize("n_streams", [1, 127, 129, 256])
def test_kernel_matches_plain(cuda_device, n_streams, kind):  # noqa: F811
    strips, offsets = _strips(kind, n_streams, cuda_device)
    before = digit_prep.LAUNCHES
    got = digit_prep.prepare_digit_cells(strips, offsets)
    torch.cuda.synchronize()
    assert digit_prep.LAUNCHES == before + 1
    assert torch.equal(got, digit_prep.prepare_digit_cells_reference(
        strips, offsets))
    assert torch.equal(got.cpu(), digit_prep.prepare_digit_cells_reference(
        strips.cpu(), offsets.cpu()))


@pytest.mark.parametrize("dest", ["shared", "per_stream"])
@pytest.mark.parametrize("n_streams", [1, 3, 16, 127, 129, 255, 256, 257])
def test_persp_kernel_matches_plain(cuda_device, n_streams,  # noqa: F811
                                    dest):
    """Bit for bit against the plain version on the card, NaN and inf
    included: the quads, then degenerate sets (all zero, a repeated
    corner, an inf and a NaN corner), with the card's destination for
    every stream or a rectangle a stream. With the degenerate sets the
    kernel sees n_streams + 4 streams: each count leaves the last block
    (eight streams, two a warp) part full."""
    quads = _quads("landscape", n_streams, n_streams)
    rep = quads[0].clone()
    rep[1] = rep[0]
    inf, nan = quads[0].clone(), quads[0].clone()
    inf[3, 0], nan[0, 1] = float("inf"), float("nan")
    src = torch.cat([quads, torch.stack([torch.zeros(4, 2), rep, inf, nan])])
    dst = CARD_DEST if dest == "shared" else torch.from_numpy(
        dest_rects(np.random.RandomState(n_streams), len(src)))
    src, dst = src.to(cuda_device), dst.to(cuda_device)
    before = persp_qr.LAUNCHES
    got = persp_qr.eigen_persp_transform_batched(src, dst)
    torch.cuda.synchronize()
    assert persp_qr.LAUNCHES == before + 1
    want = persp_qr.persp_transform_reference(src, dst)
    assert torch.equal(_bits(got), _bits(want))
    # against the CPU: the same bits except in a NaN's payload (x86 makes
    # its default NaN negative, the card positive)
    cpu = persp_qr.persp_transform_reference(src.cpu(), dst.cpu())
    got = got.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(cpu))
    not_nan = ~torch.isnan(got)
    assert torch.equal(_bits(got)[not_nan], _bits(cpu)[not_nan])
    assert torch.isfinite(got[:n_streams]).all()


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
@pytest.mark.parametrize("n_streams", [1, 127, 129, 256])
def test_warp_kernel_matches_plain(cuda_device, n_streams,  # noqa: F811
                                   orientation):
    """The warp kernel, which computes the coordinate maps itself, u8 for
    u8 against its plain route (float64 maps, then the gather) on uniform
    noise through envelope quads, and a NaN homography from all-zero
    corners, whose card is 0; the portrait warp resamples the transposed
    frame."""
    rng = np.random.RandomState(n_streams)
    image = torch.from_numpy(rng.randint(1, 256, (n_streams + 1, 480, 640))
                             .astype(np.uint8)).to(cuda_device)
    quads = torch.cat([_quads(orientation, n_streams, 7),
                       torch.zeros((1, 4, 2))])
    m = persp_qr.eigen_persp_transform_batched(quads.to(cuda_device),
                                               CARD_DEST.to(cuda_device))
    transpose = orientation == "portrait"
    before = warp_gather.LAUNCHES
    got = warp_gather.warp_perspective_exact(image, m, (270, 428), transpose)
    torch.cuda.synchronize()
    assert warp_gather.LAUNCHES == before + 1
    assert torch.equal(got, warp_gather.warp_perspective_reference(
        image, m, (270, 428), transpose))
    assert torch.equal(got.cpu(), warp_gather.warp_perspective_reference(
        image.cpu(), m.cpu(), (270, 428), transpose))
    assert not got[-1].any() and got[:-1].any()


def test_camera_step_on_card_matches_cpu(cuda_device):  # noqa: F811
    """The camera fixture's first frames through the camera step on the
    card and on the CPU: found flags and cards equal, scan fields equal,
    digit scores within 1e-5, and both camera kernels launched."""
    with np.load(os.path.join(DATA, "camera_session.npz")) as f:
        planes = [torch.from_numpy(f[k][:, :3]) for k in ("y", "cb", "cr")]
        now = tuple(f["now"].tolist())
    runs = {}
    launches = (warp_gather.LAUNCHES, persp_qr.LAUNCHES)
    for dev in ("cpu", cuda_device):
        params = load_all_params(dev)
        state = init_stream_states(planes[0].shape[0], dev, now)
        out = []
        for t in range(3):
            frame = [p[:, t].contiguous().to(dev) for p in planes]
            found, card = preprocess_frame(*frame)
            state, (found_step, fr, _) = batched_camera_step(params, state,
                                                             *frame)
            assert torch.equal(found, found_step)
            out.append((found.cpu(), card.cpu(), fr))
        runs[str(dev)] = out
    torch.cuda.synchronize()
    # the card's run: preprocess_frame and the step, 3 frames each
    assert warp_gather.LAUNCHES == launches[0] + 6
    assert persp_qr.LAUNCHES == launches[1] + 6
    for (found, card, fr), (found_c, card_c, fr_c) in zip(
            runs[str(cuda_device)], runs["cpu"]):
        assert torch.equal(found, found_c) and found.all()
        assert torch.equal(card, card_c)
        for a, b in ((fr.vseg.y_offset, fr_c.vseg.y_offset),
                     (fr.hseg.offsets, fr_c.hseg.offsets),
                     (fr.usable, fr_c.usable)):
            assert torch.equal(a.cpu(), b)
        torch.testing.assert_close(fr.scores.cpu(), fr_c.scores, atol=1e-5,
                                   rtol=0)


def test_scan_on_card_matches_cpu(cuda_device):  # noqa: F811
    with np.load(os.path.join(DATA, "smoke_session.npz")) as f:
        frames = torch.from_numpy(f["frames"][:, 0])
    cpu = scan_card_image(load_all_params("cpu"), frames)
    card = scan_card_image(load_all_params(cuda_device),
                           frames.to(cuda_device))
    for name in ("y_offset", "pattern_type"):
        assert torch.equal(getattr(card.vseg, name).cpu(),
                           getattr(cpu.vseg, name))
    assert torch.equal(card.hseg.offsets.cpu(), cpu.hseg.offsets)
    assert torch.equal(card.usable.cpu(), cpu.usable)
    torch.testing.assert_close(card.scores.cpu(), cpu.scores, atol=1e-5,
                               rtol=0)


def test_expiry_session_on_card_matches_cpu(cuda_device):  # noqa: F811
    """The expiry fixture's sessions through scan_frames(scan_expiry=True)
    on the card and on the CPU: windows, char rects, slot tables and dates
    equal, slot scores within 1e-5."""
    with np.load(os.path.join(DATA, "expiry_session.npz")) as f:
        frames = torch.from_numpy(f["frames"])
        now = tuple(f["now"].tolist())
    state_c, (fr_c, res_c) = scan_frames(load_all_params("cpu"), frames, now,
                                         scan_expiry=True)
    state, (fr, res) = scan_frames(load_all_params(cuda_device),
                                   frames.to(cuda_device), now,
                                   scan_expiry=True)
    for a, b in zip(fr.expiry_groups, fr_c.expiry_groups):
        assert torch.equal(a.cpu(), b)
    for name in ("active", "top", "left", "recently_seen", "total_seen"):
        assert torch.equal(getattr(state.expiry, name).cpu(),
                           getattr(state_c.expiry, name)), name
    torch.testing.assert_close(state.expiry.scores.cpu(),
                               state_c.expiry.scores, atol=1e-5, rtol=0)
    for a, b in ((res.complete, res_c.complete),
                 (res.expiry_month, res_c.expiry_month),
                 (res.expiry_year, res_c.expiry_year),
                 (state.completed_digits, state_c.completed_digits)):
        assert torch.equal(a.cpu(), b)
    assert res.expiry_month[:, -1].tolist() == [8, 11, 0]


@pytest.mark.parametrize("stage", ["nonoverlap", "regrid", "trim"])
def test_expiry_stage_on_card_matches_cpu(cuda_device, stage):  # noqa: F811
    """The integer stages on seeded random inputs, card against CPU."""
    from cardio_dmz_tpu_torch.scan import expiry_device as tx
    rng = np.random.RandomState(11)
    if stage == "nonoverlap":
        fn = tx._nonoverlap_select
        args = (rng.randint(0, 4080 * 9 * 17, (64, 420)).astype(np.int32),
                rng.rand(64, 420) < 0.7)
    elif stage == "regrid":
        fn = tx._regrid
        left = rng.randint(0, 420, 64)
        args = (rng.randint(0, 4080 * 17, (64, 428)).astype(np.int32),
                left.astype(np.int32),
                np.minimum(rng.randint(0, 200, 64), 428 - left).astype(
                    np.int32))
    else:
        fn = tx._trim_char
        args = (rng.randint(0, 4081, (64, 21, 18)).astype(np.int32),
                rng.randint(-3, 432, 64).astype(np.int32),
                rng.randint(-2, 256, 64).astype(np.int32),
                rng.randint(10, 15, 64).astype(np.int32))
    args = [torch.from_numpy(a) for a in args]
    for got, want in zip(fn(*(a.to(cuda_device) for a in args)), fn(*args)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("model", ["pan_conv_a", "expiry_conv", "vseg_mlp"])
def test_products_on_card_across_batch_sizes(cuda_device, model):  # noqa: F811
    """A row's scores in a batch of 4,096 rows, in the 2,064 and 2,032 rows
    of an uneven split of 256 streams, and alone: within 1e-5 of each
    other. They need not be the same bits, because the GEMM library picks
    its kernel, and with it its summation order, by the call's row count."""
    shape = {"pan_conv_a": (4096, 27, 19), "expiry_conv": (4096, 16, 11),
             "vseg_mlp": (4096, 204)}[model]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.rand(shape, device=cuda_device, generator=gen)
    module = load_all_params(cuda_device)[model]
    whole = module(x)
    for n in (1, 16, 2032, 2064):
        torch.testing.assert_close(module(x[:n].contiguous()), whole[:n],
                                   atol=1e-5, rtol=0)


def _train_run(model):
    from chip_smoke import load_npz, train_run
    return train_run(load_npz(os.path.join(DATA, "train_session.npz")),
                     model)


@pytest.mark.parametrize("model", ["pan_conv", "vseg_mlp", "slash_mlp",
                                   "expiry_conv"])
def test_train_step_on_card_matches_jax(cuda_device, model):  # noqa: F811
    """chip_smoke.py phase 19's checks: from the JAX initial parameters on
    the JAX batch, the loss and gradients on the card, and a three-step
    fit, against data/train_session.npz (the JAX package's)."""
    from chip_smoke import check_fit, check_loss_and_grads
    from cardio_dmz_tpu_torch.tools.train_models import _spec
    run = _train_run(model)
    loss_fn = _spec(model, cuda_device)[1]
    check_loss_and_grads(loss_fn, run, cuda_device)
    check_fit(loss_fn, run, cuda_device)


@pytest.mark.parametrize("model", ["pan_conv", "vseg_mlp", "slash_mlp",
                                   "expiry_conv"])
def test_generators_without_pil(cuda_device, model):  # noqa: F811
    """The generators, with `import PIL` made to fail, make the fixture's
    seed-0 batches bit for bit on the card's machine."""
    from chip_smoke import check_train_batches
    from cardio_dmz_tpu_torch.tools.train_models import _spec
    check_train_batches(_spec(model, cuda_device)[3], _train_run(model))


def _tile(a, n_streams):
    """The first axis (streams) of a fixture array tiled to n_streams."""
    return np.ascontiguousarray(
        np.tile(a, (-(-n_streams // len(a)),) + (1,) * (a.ndim - 1))
        [:n_streams])


def _graph_inputs(shape, n_streams, n_steps, device):
    """(step(params, states, *inputs), [inputs of each step], now) of a
    serving shape on the fixtures' cards: pan on smoke_session.npz, full
    on expiry_session.npz, camera on camera_session.npz's previews,
    camera_full on the expiry cards pasted on previews."""
    name = {"pan": "smoke", "full": "expiry", "camera": "camera",
            "camera_full": "expiry"}[shape]
    with np.load(os.path.join(DATA, f"{name}_session.npz")) as f:
        now = tuple(f["now"].tolist())
        if shape == "camera":
            planes = [[_tile(f[k][:, t], n_streams) for k in ("y", "cb",
                                                              "cr")]
                      for t in range(n_steps)]
        else:
            cards = [_tile(f["frames"][:, t], n_streams)
                     for t in range(n_steps)]
            planes = [paste_previews(c) for c in cards] \
                if shape == "camera_full" else [[c] for c in cards]
    inputs = [[torch.from_numpy(np.ascontiguousarray(p)).to(device)
               for p in step_planes] for step_planes in planes]
    expiry = shape in ("full", "camera_full")
    if shape.startswith("camera"):
        def step(params, states, y, cb, cr):
            return batched_camera_step(params, states, y, cb, cr,
                                       scan_expiry=expiry)
    else:
        def step(params, states, frames):
            return batched_scanner_step(params, states, frames, expiry)
    return step, inputs, now


def _leaf_bits(tree):
    from torch.utils._pytree import tree_flatten
    return [t.contiguous().reshape(-1).view(torch.uint8).cpu()
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("n_streams", [4, 32])
@pytest.mark.parametrize("shape", ["pan", "full", "camera", "camera_full"])
def test_graphed_step_equals_eager_step(cuda_device, shape,  # noqa: F811
                                        n_streams):
    """Three steps of the fixture cards through the eager step and through
    its graph (captured at the first step, replayed at each): states and
    results bit for bit, every leaf; the replays launch the kernels the
    eager step launches, once a step each."""
    params = load_all_params(cuda_device)
    step, inputs, now = _graph_inputs(shape, n_streams, 3, cuda_device)
    graphed = graph_step(lambda st, *x: step(params, st, *x), cuda_device)
    eager_state = init_stream_states(n_streams, cuda_device, now)
    graph_state = init_stream_states(n_streams, cuda_device, now)
    for t, x in enumerate(inputs):
        eager_state, eager_out = step(params, eager_state, *x)
        graph_state, graph_out = graphed(graph_state, *x)
        for i, (a, b) in enumerate(zip(_leaf_bits((eager_state, eager_out)),
                                       _leaf_bits((graph_state, graph_out)))):
            assert torch.equal(a, b), (shape, t, i)
    entry, = graphed.entries.values()
    camera = shape.startswith("camera")
    assert entry.launches == {"digit_prep": 1, **(
        {"warp_gather": 1, "persp_qr": 1} if camera else {})}


def test_capture_of_a_host_sync_raises(cuda_device):  # noqa: F811
    """A step that reads a value back (.item()) runs its warm-up calls,
    then fails at capture: CaptureError names the line, no result comes
    back and no eager call stands in. The device stays usable: another
    step captures and replays after it."""
    calls = []

    def reads_back(x):
        calls.append(1)
        scale = x.sum().item()
        return x * scale

    step = graph_step(reads_back, cuda_device)
    with pytest.raises(CaptureError, match="reads_back") as info:
        step(torch.ones(4, device=cuda_device))
    assert "test_torch_cuda.py" in str(info.value)
    assert len(calls) == WARMUP_CALLS + 1 and step.entries == {}
    doubled = graph_step(lambda x: x * 2, cuda_device)
    out = doubled(torch.ones(4, device=cuda_device))
    out = doubled(torch.full((4,), 3.0, device=cuda_device))
    assert out.tolist() == [6.0] * 4


TRAIN_MODELS = ("pan_conv", "vseg_mlp", "slash_mlp", "expiry_conv")


@pytest.mark.parametrize("model", TRAIN_MODELS)
def test_graphed_train_step_equals_eager_step(cuda_device,  # noqa: F811
                                              model):
    """Five train steps at batch 64 from the seed-0 parameters through
    make_train_step's eager form (step.fn) twice, then through its CUDA
    graph: the two eager runs bit for bit first (the step's own ops are
    deterministic: unfold's backward, the pools' ties, the label gather's
    scatter), then the graph against them; parameters, mu, nu, count and
    loss, every leaf, at every step. Training launches no serving
    kernel."""
    from cardio_dmz_tpu_torch.tools.train_models import _spec
    from cardio_dmz_tpu_torch.train import adam, make_train_step
    init_fn, loss_fn, _, data_fn = _spec(model, cuda_device)
    rng = np.random.RandomState(1)
    batches = [tuple(torch.from_numpy(a).to(cuda_device)
                     for a in data_fn(rng, 64)) for _ in range(5)]
    optimizer = adam(3e-3)
    step = make_train_step(loss_fn, optimizer, params_template=init_fn())

    def run(fn):
        params = init_fn()
        state, out = optimizer.init(params), []
        for x, y in batches:
            params, state, loss = fn(params, state, x, y)
            out.append(_leaf_bits((params, state, loss)))
        return out

    first, second, graph = run(step.fn), run(step.fn), run(step)
    for t, (a, b, g) in enumerate(zip(first, second, graph)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (model, t)
        assert all(torch.equal(x, y) for x, y in zip(a, g)), (model, t)
    entry, = step.entries.values()
    assert entry.launches == {}


def test_capture_of_an_item_in_a_train_step_raises(cuda_device):  # noqa: F811
    """A loss that reads a value back (.item()) inside a train step: the
    capture raises CaptureError naming the line, and the card stays
    usable: the same model's step captures and replays after it."""
    from cardio_dmz_tpu_torch.train import (
        adam, init_mlp_params, make_train_step, mlp_loss)

    def reads_back(params, x, labels):
        loss = mlp_loss(params, x, labels)
        return loss * (loss.item() > 0)

    params = init_mlp_params(torch.Generator().manual_seed(0), 8, 4, 2,
                             cuda_device)
    optimizer = adam(3e-3)
    x = torch.rand(16, 8, device=cuda_device)
    y = torch.randint(0, 2, (16,), dtype=torch.int32, device=cuda_device)
    step = make_train_step(reads_back, optimizer, params_template=params)
    with pytest.raises(CaptureError, match="test_torch_cuda.py"):
        step(params, optimizer.init(params), x, y)
    assert step.entries == {}
    good = make_train_step(mlp_loss, optimizer, params_template=params)
    state = optimizer.init(params)
    for _ in range(2):
        params, state, loss = good(params, state, x, y)
    assert torch.isfinite(loss) and int(state.count) == 2
