"""Extract the baked neural-net weights from the reference's generated C++.

Counterpart of the JAX package's tools/extract_weights.py, numpy only. The
reference ships its five tiny models as generated C++ with the weights
baked in as hex-dumped little-endian float32 byte arrays, each opened by
a line such as `static uint8_t data_b3289e07[40800] = { // hidden W` and
closed by `};`. This tool parses those data blobs (no code is copied) and
writes one .npz per model, with each model's golden test input and output
(and the expiry conv's intermediate goldens), keyed and shaped as the JAX
tool writes them.

It never writes the JAX package's weights, cardio_dmz_tpu/models/params/,
which are the reference the port reads (models/weights.PARAM_DIR): its
output goes under the port's build directory unless --out names another
place. A source that is missing, a blob whose byte count is not its
declared size, or a role that a model needs and its file lacks raises an
error that names it, and no .npz is written then.

Usage: python -m cardio_dmz_tpu_torch.tools.extract_weights
       --reference <reference checkout> [--out <directory>]
"""

import argparse
import os
import re
import sys

import numpy as np

# the port's build directory, and the JAX package's weights (never written)
from ..models.weights import PARAM_DIR
from ..ops.cuda._build import BUILD_DIR

DEFAULT_OUT = os.path.join(BUILD_DIR, "params")

START_RE = re.compile(
    r"static uint8_t (data_\w+)\[(\d+)\][^=]*=\s*\{\s*//\s*(.+?)\s*$"
)
BYTE_RE = re.compile(r"0x([0-9A-Fa-f]{2})")


def parse_blobs(path):
    """Return list of (name, role, float32 array) in file order. A blob
    whose bytes differ in number from its declared size, or one the file
    never closes, raises ValueError."""
    blobs = []
    name = role = None
    nbytes = 0
    buf = []
    with open(path, "r") as f:
        for line in f:
            if name is None:
                m = START_RE.search(line)
                if m:
                    name, role = m.group(1), m.group(3)
                    nbytes = int(m.group(2))
                    buf = []
                continue
            if line.lstrip().startswith("};"):
                if len(buf) != nbytes:
                    raise ValueError(
                        f"{path}: blob {name} ({role}) declares {nbytes} "
                        f"bytes and holds {len(buf)}")
                raw = bytes(int(b, 16) for b in buf)
                blobs.append((name, role,
                              np.frombuffer(raw, dtype="<f4").copy()))
                name = None
                continue
            buf.extend(BYTE_RE.findall(line))
    if name is not None:
        raise ValueError(f"{path}: blob {name} ({role}) is not closed by "
                         f"'}};' before the end of the file")
    return blobs


def role_map(blobs):
    """Map role-comment -> list of arrays (file order)."""
    out = {}
    for _, role, arr in blobs:
        out.setdefault(role, []).append(arr)
    return out


def _take(roles, path, role, shape, index=0):
    """The `index`-th blob of `role`, reshaped; KeyError naming the role and
    the roles found when the file has too few, ValueError naming the blob
    when its size is not the shape's."""
    arrays = roles.get(role, [])
    if len(arrays) <= index:
        raise KeyError(f"{path}: needs {index + 1} blob(s) with role "
                       f"{role!r} and has {len(arrays)}; roles found: "
                       f"{sorted(roles)}")
    arr = arrays[index]
    if arr.size != int(np.prod(shape)):
        raise ValueError(f"{path}: blob {index + 1} of role {role!r} holds "
                         f"{arr.size} floats, not the {shape} the model "
                         f"needs")
    return arr.reshape(shape)


def extract_mlp(path, n_in, n_hidden, n_out):
    r = role_map(parse_blobs(path))
    return {
        "hidden_w": _take(r, path, "hidden W", (n_hidden, n_in)),
        "hidden_b": _take(r, path, "hidden b", (n_hidden,)),
        "logistic_w": _take(r, path, "logistic W", (n_out, n_hidden)),
        "logistic_b": _take(r, path, "logistic b", (n_out,)),
        "test_input": _take(r, path, "test input", (n_in,)),
        "test_output": _take(r, path, "test output", (n_out,)),
    }


def extract_pan_conv(path):
    r = role_map(parse_blobs(path))
    return {
        "conv_w": _take(r, path, "conv W", (8, 3, 3)),
        "conv_b": _take(r, path, "conv b", (8,)),
        "hidden_w": _take(r, path, "hidden W", (32, 320)),
        "hidden_b": _take(r, path, "hidden b", (32,)),
        "logistic_w": _take(r, path, "logistic W", (10, 32)),
        "logistic_b": _take(r, path, "logistic b", (10,)),
        "test_input": _take(r, path, "test input", (27, 19)),
        "test_output": _take(r, path, "test output", (10,)),
    }


def extract_expiry_conv(path):
    r = role_map(parse_blobs(path))
    out = {
        # the two conv layers' blobs share their roles, in file order
        "conv1_w": _take(r, path, "conv W", (50, 5, 5)),
        "conv1_b": _take(r, path, "conv b", (50,)),
        "conv2_w": _take(r, path, "conv W", (40, 50, 5, 5), index=1),
        "conv2_b": _take(r, path, "conv b", (40,), index=1),
        "hidden_w": _take(r, path, "hidden W", (176, 120)),
        "hidden_b": _take(r, path, "hidden b", (176,)),
        "logistic_w": _take(r, path, "logistic W", (10, 176)),
        "logistic_b": _take(r, path, "logistic b", (10,)),
        "test_input": _take(r, path, "test input", (16, 11)),
        "test_output": _take(r, path, "test output", (10,)),
    }
    # intermediate goldens (modelc_bf4dd6c8.cpp:13466-13489)
    for key, layer, shape in (("test_conv1_out", 1, (50, 70)),
                              ("test_conv2_out", 2, (40, 3)),
                              ("test_hidden_out", 3, (176,))):
        role = f"test output layer {layer}"
        if role in r:
            out[key] = _take(r, path, role, shape)
    return out


# model -> (extractor, its source relative to the reference checkout, the
# extractor's sizes), as the JAX tool's main lists them
JOBS = {
    # vseg strip MLP: 204 -> 50 tanh -> 3 softmax
    # (modelm_befe75da.cpp:1764-1786)
    "vseg_mlp": (extract_mlp, "models/generated/modelm_befe75da.cpp",
                 (204, 50, 3)),
    # slash MLP: 176 -> 80 tanh -> 2 softmax (modelm_730c4cbd.cpp:2386-2429)
    "slash_mlp": (extract_mlp, "models/expiry/modelm_730c4cbd.cpp",
                  (176, 80, 2)),
    # PAN digit conv ensemble (modelc_*.cpp:1824-1938)
    "pan_conv_a": (extract_pan_conv, "models/generated/modelc_5c241121.cpp",
                   ()),
    "pan_conv_b": (extract_pan_conv, "models/generated/modelc_01266c1b.cpp",
                   ()),
    "pan_conv_c": (extract_pan_conv, "models/generated/modelc_b00bf70c.cpp",
                   ()),
    # expiry digit conv net (modelc_bf4dd6c8.cpp)
    "expiry_conv": (extract_expiry_conv, "models/expiry/modelc_bf4dd6c8.cpp",
                    ()),
}


def extract_all(reference):
    """{model: {array name: float32 array}} for every model of JOBS, read
    from the reference checkout `reference`. Raises FileNotFoundError,
    ValueError or KeyError naming the model and what is wrong."""
    models = {}
    for name, (fn, rel, sizes) in JOBS.items():
        path = os.path.join(reference, rel)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{name}: no generated source at {path}")
        try:
            models[name] = fn(path, *sizes)
        except KeyError as e:
            raise KeyError(f"{name}: {e.args[0]}") from e
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from e
    return models


def _out_dir(out):
    """`out` made absolute; ValueError when it is, or lies inside, the JAX
    package's weights directory."""
    out_dir = os.path.realpath(out)
    params = os.path.realpath(PARAM_DIR)
    if os.path.commonpath([out_dir, params]) == params:
        raise ValueError(f"--out {out} resolves to {out_dir}, inside the JAX "
                         f"package's weights {params}, which this tool "
                         f"never writes")
    return out_dir


def write_npz(path, arrays):
    """np.savez_compressed to a temporary name beside `path`, then renamed
    onto it, so that a failure leaves no partial file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", required=True,
                    help="the reference checkout that holds models/generated/"
                         " and models/expiry/")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"where the .npz files go (default {DEFAULT_OUT})")
    args = ap.parse_args(argv)
    out_dir = _out_dir(args.out)
    models = extract_all(args.reference)   # every source parsed first
    os.makedirs(out_dir, exist_ok=True)
    for name, params in models.items():
        path = os.path.join(out_dir, f"{name}.npz")
        write_npz(path, params)
        print(f"{name}: {path}")
        for k, v in params.items():
            print(f"    {k}: {v.shape}")
    return 0


def cli(argv=None):
    """Console entry point: exits with main's code."""
    sys.exit(main(argv))


if __name__ == "__main__":
    cli()
