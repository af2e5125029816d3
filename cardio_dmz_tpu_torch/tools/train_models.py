"""Retrain the scan's models with the port: init -> Adam (fit's train step,
a CUDA graph on one card) over a device mesh
(data parallel, with a column-parallel hidden layer when the mesh has model
ranks) -> held-out eval -> a parameter file in the JAX package's layout,
which session/checkpoint.load_params_npz of either package reads.

Counterpart of the JAX package's tools/train_models.py, with its flags and
--device in place of --cpu:

    python -m cardio_dmz_tpu_torch.tools.train_models --model pan_conv \\
        --steps 300 --out pan_conv_retrained.npz
    python -m cardio_dmz_tpu_torch.tools.train_models --model all --steps 200

runs on the CUDA device; --device cpu trains on the CPU.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

MODELS = ("pan_conv", "vseg_mlp", "slash_mlp", "expiry_conv")
# the golden weights playing each architecture's role
_GOLDEN = {"pan_conv": "pan_conv_a", "vseg_mlp": "vseg_mlp",
           "slash_mlp": "slash_mlp", "expiry_conv": "expiry_conv"}
EVAL_BATCH = 512


def _spec(model, device):
    """(init_fn, loss_fn, apply_fn, data_fn) of one architecture; init_fn()
    draws the initial parameters on `device` from seed 0."""
    from ..models.zoo import apply_expiry_conv, apply_mlp, apply_pan_conv
    from ..train import (
        expiry_conv_loss, init_expiry_conv_params, init_mlp_params,
        init_pan_conv_params, mlp_loss, pan_conv_loss,
        synthetic_digit_batch, synthetic_expiry_digit_batch,
        synthetic_slash_batch, synthetic_vseg_batch)

    def gen():
        return torch.Generator().manual_seed(0)

    return {
        # PAN digit conv ensemble member (modelc_* arch)
        "pan_conv": (lambda: init_pan_conv_params(gen(), device),
                     pan_conv_loss, apply_pan_conv, synthetic_digit_batch),
        # vseg strip MLP 204->50->3 (modelm_befe75da arch)
        "vseg_mlp": (lambda: init_mlp_params(gen(), 204, 50, 3, device),
                     mlp_loss, apply_mlp, synthetic_vseg_batch),
        # slash MLP 176->80->2 (modelm_730c4cbd arch)
        "slash_mlp": (lambda: init_mlp_params(gen(), 176, 80, 2, device),
                      mlp_loss, apply_mlp, synthetic_slash_batch),
        # expiry digit conv (modelc_bf4dd6c8 arch)
        "expiry_conv": (lambda: init_expiry_conv_params(gen(), device),
                        expiry_conv_loss, apply_expiry_conv,
                        synthetic_expiry_digit_batch),
    }[model]


def train_one(model, steps, batch, lr, mesh, seed=0, compare_golden=False,
              device="cuda"):
    """Train one architecture from seed-0 initial parameters on batches
    from np.random.RandomState(seed), made on the host, on `device` (the
    mesh's first device when a mesh is given) through fit's graphed train
    step, and evaluate it on EVAL_BATCH held-out samples
    from seed + 99. Returns (params, accuracy, the golden weights' accuracy
    on the same eval or None)."""
    from ..models.weights import load_np, module_from_numpy
    from ..parallel.mesh import named_device
    from ..train import fit

    device = mesh.devices[0][0] if mesh is not None else named_device(
        device, "train_models")
    init_fn, loss_fn, apply_fn, data_fn = _spec(model, device)
    rng = np.random.RandomState(seed)

    def data():
        while True:
            yield data_fn(rng, batch)

    params, losses = fit(loss_fn, init_fn(), data(), steps=steps,
                         learning_rate=lr, mesh=mesh,
                         log_every=max(steps // 10, 1))

    inputs, labels = data_fn(np.random.RandomState(seed + 99), EVAL_BATCH)
    inputs = torch.from_numpy(inputs).to(device)
    with torch.no_grad():
        pred = apply_fn(params, inputs).argmax(-1).cpu().numpy()
    acc = float((pred == labels).mean())
    golden_acc = None
    if compare_golden:
        # the golden weights on the same held-out eval: trained on real
        # embossed crops, a strong but beatable bar on this distribution
        golden = module_from_numpy(_GOLDEN[model], load_np(_GOLDEN[model]),
                                   device)
        with torch.no_grad():
            gpred = golden(inputs).argmax(-1).cpu().numpy()
        golden_acc = float((gpred == labels).mean())
    msg = (f"[{model}] retrained eval accuracy: {acc:.3f} (final loss "
           f"{losses[-1]:.4f})")
    if golden_acc is not None:
        msg += f" | golden weights on same eval: {golden_acc:.3f}"
    print(msg)
    return params, acc, golden_acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=MODELS + ("all",), default="pan_conv")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "retrained.npz"))
    ap.add_argument("--mesh", action="store_true",
                    help="split the train step over every CUDA device "
                         "(over --device alone when it is not cuda)")
    ap.add_argument("--compare-golden", action="store_true",
                    help="also evaluate the golden weights on the same "
                         "held-out eval")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default cuda)")
    args = ap.parse_args(argv)

    from ..parallel.mesh import make_mesh, named_device
    from ..session.checkpoint import save_params

    device = named_device(args.device, "train_models")
    mesh = None
    if args.mesh:
        mesh = make_mesh(None if args.device == "cuda" else [device])

    models = list(MODELS) if args.model == "all" else [args.model]
    out, table = {}, {}
    for m in models:
        params, acc, gacc = train_one(m, args.steps, args.batch, args.lr,
                                      mesh, compare_golden=args.compare_golden,
                                      device=device)
        out[m] = params
        table[m] = {"retrained_acc": acc, "golden_acc": gacc,
                    "steps": args.steps, "batch": args.batch}

    save_params(args.out, out)
    print(f"saved: {args.out}")
    if args.json:
        import json
        print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
