"""The port on an NVIDIA card: the digit-prep CUDA kernel against its plain
version, and the scan path on the card against the same path on the CPU.

These tests skip without a card. They import neither jax nor the JAX
package, so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

import cardio_dmz_tpu_torch
from cardio_dmz_tpu_torch.models import load_all_params
from cardio_dmz_tpu_torch.ops.cuda import digit_prep
from cardio_dmz_tpu_torch.scan import scan_card_image
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("n_streams", [1, 256])
def test_kernel_matches_plain(cuda_device, n_streams):  # noqa: F811
    rng = np.random.RandomState(n_streams)
    strips = torch.from_numpy(rng.randint(
        0, 256, (n_streams, 27, 428)).astype(np.uint8)).to(cuda_device)
    offsets = np.sort(rng.randint(0, 410, (n_streams, 16)), axis=1)
    offsets[:, 0], offsets[:, -1] = 0, 409
    offsets = torch.from_numpy(offsets.astype(np.int32)).to(cuda_device)
    before = digit_prep.LAUNCHES
    got = digit_prep.prepare_digit_cells(strips, offsets)
    torch.cuda.synchronize()
    assert digit_prep.LAUNCHES == before + 1
    assert torch.equal(got, digit_prep.prepare_digit_cells_reference(
        strips, offsets))


def test_scan_on_card_matches_cpu(cuda_device):  # noqa: F811
    fixture = os.path.join(os.path.dirname(cardio_dmz_tpu_torch.__file__),
                           "data", "smoke_session.npz")
    with np.load(fixture) as f:
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
