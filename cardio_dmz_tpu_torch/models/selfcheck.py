"""Run-time model self-checks (the reference's TestGeneratedModels).

Every reference model ships a baked test input with its known-good output
and a pass*() function comparing at 1e-5 (models/TestGeneratedModels.mm:
35-70). self_check() runs the same verification on the port's modules on a
device: call it when a service starts, to catch corrupt weights or a
numerically broken backend (TF32 left on, say) before serving traffic.
"""

import numpy as np
import torch

from .weights import MODEL_NAMES, load_np, module_from_numpy

TOLERANCE = 1e-5


def golden_errors(device):
    """{model name: largest |output - golden output|} with every model on
    `device`."""
    errors = {}
    for name in MODEL_NAMES:
        golden = load_np(name, include_test_vectors=True)
        out = module_from_numpy(name, golden, device)(
            torch.from_numpy(golden["test_input"]).to(device))
        errors[name] = float(np.abs(out.cpu().numpy()
                                    - golden["test_output"]).max())
    return errors


def self_check(device, verbose=False):
    """Every model's golden self-check on `device`: {name: passed}."""
    results = {}
    for name, err in golden_errors(device).items():
        results[name] = err <= TOLERANCE
        if verbose:
            print(f"{name}: max abs err {err:.2e} "
                  f"{'OK' if results[name] else 'FAIL'}")
    return results


def all_models_pass(device):
    """True iff every model reproduces its golden output on `device`."""
    return all(self_check(device).values())
