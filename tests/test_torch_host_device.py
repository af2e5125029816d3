"""The port's host expiry oracle against its own device path, on the
recorded cards of data/expiry_session.npz: every valid window of
best_expiry_seg_device is a group of best_expiry_seg with equal char rects,
and the other way round (tests/test_expiry_device.py holds the JAX pair to
the same). HostScanner on a device reads what the batched full step reads.

This file imports neither jax nor the JAX package, so it runs on the CPU
here and also on the card:

    python -m pytest tests/test_torch_host_device.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

import cardio_dmz_tpu_torch as port
from chip_smoke import host_device_windows_agree

DATA = os.path.join(os.path.dirname(port.__file__), "data")
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); run on the chip")
    return torch.device(request.param, 0) if request.param == "cuda" \
        else torch.device("cpu")


def _fixture():
    with np.load(os.path.join(DATA, "expiry_session.npz")) as f:
        return {k: f[k] for k in ("frames", "vseg_y_offset", "now",
                                  "expiry_month", "expiry_year",
                                  "completed_digits")}


@pytest.mark.parametrize("stream", range(3))
def test_host_oracle_equals_device_path(device, stream):
    fixture = _fixture()
    params = port.load_all_params(device)
    frames = torch.from_numpy(fixture["frames"][stream]).to(device)
    vseg_y = torch.from_numpy(fixture["vseg_y_offset"][stream].astype(
        np.int32)).to(device)
    n_windows = host_device_windows_agree(port, params, frames, vseg_y)
    assert (n_windows >= len(frames) // 2) == (stream < 2)   # 2 is undated


def test_host_scanner_reads_what_the_full_step_reads(device):
    fixture = _fixture()
    scanner = port.HostScanner(port.load_all_params(device),
                               now=tuple(fixture["now"].tolist()))
    assert scanner.device == device
    for stream in range(3):
        scanner.reset()
        for y in fixture["frames"][stream]:
            _, result = scanner.add_frame(y)
        assert scanner.card_number == "".join(
            map(str, fixture["completed_digits"][stream]))
        assert (scanner.expiry_month, scanner.expiry_year) == (
            fixture["expiry_month"][stream, -1],
            fixture["expiry_year"][stream, -1])
        assert result.complete == (stream < 2)
