"""The port is complete, and it reads nothing of the JAX package but its
weights.

* Every public name of every module of cardio_dmz_tpu/ (its top-level
  functions, classes and UPPER_CASE constants, read with ast, without
  importing the module) exists in the port's counterpart module, or where
  MOVED names it, or stands in LEFT_OUT with its reason: the ROADMAP's
  "Do not port these". One case per JAX module; an entry of either table
  that no longer describes the two packages fails too.
* No source of the port (*.py, *.cu, *.cpp) constructs a path into
  cardio_dmz_tpu/, except models/weights.PARAM_DIR, the read of the JAX
  package's weights. Docstrings and comments that cite a JAX file as the
  reference are prose, not paths, and do not count.
"""

import ast
import importlib
import importlib.util
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "cardio_dmz_tpu")
PORT_ROOT = os.path.join(REPO, "cardio_dmz_tpu_torch")

# the reasons, as ROADMAP.md's "Do not port these" gives them
_SWITCH = ("an execution switch of the JAX package (Pallas, precision, "
           "environment): the port has one route a device")
_LOWERING = ("a TPU lowering (one-hot or dense forms, source windows, the "
             "unbounded flood): the port copies results, not lowerings")
_DOUBLE_FLOAT = ("double-float and correctly rounded f32 helpers that stand "
                 "in for f64 and IEEE division on the TPU: the card has both")
_SHARDING = ("a JAX sharding spec: the port splits the stream axis over a "
             "device list (parallel/mesh.shard_streams)")
_PIL_FONT = ("a PIL font: the port draws its glyphs from "
             "data/train_glyphs.npz and data/expiry_glyphs.npz")
_HLO = ("reads XLA's HLO text, which PyTorch has not: buffer_hogs ranks "
        "aten outputs")
_CHECKOUT = ("a reference checkout outside the repository: refbridge links "
             "only the committed objects of native/refshim/build/")
_HOST_ORACLE = ("the numpy oracle of the homography and the warp: the "
                "port's oracle is the JAX package, and ops/cuda/*.py hold "
                "the plain versions")
_PLATFORM = "the TPU platform probe and its Pallas-disable latch"

# JAX module -> its counterpart's module, where the path differs
MOVED_MODULES = {
    "ops.pallas": "ops.cuda",
    "ops.pallas.digit_prep": "ops.cuda.digit_prep",
    "ops.pallas.persp_qr": "ops.cuda.persp_qr",
    "ops.pallas.warp_gather": "ops.cuda.warp_gather",
    "tools.hlo_hogs": "tools.buffer_hogs",
}
# (JAX module, name) -> (port module, name) of a name the port keeps
# elsewhere or under another name
MOVED = {
    ("ops.pallas.digit_prep", "prepare_digit_cells_pallas"):
        ("ops.cuda.digit_prep", "prepare_digit_cells"),
    # the kernel computes its float64 maps itself
    ("ops.pallas.warp_gather", "warp_gather_exact"):
        ("ops.cuda.warp_gather", "warp_perspective_exact"),
    # the same recurrences without the 32-column bit packing
    ("ops.canny", "hysteresis_bounded_unpacked"):
        ("ops.canny", "hysteresis_bounded"),
    ("synthetic", "EMBOSS_AV"): ("train.glyphs", "EMBOSS_AV"),
    ("synthetic", "EMBOSS_AH"): ("train.glyphs", "EMBOSS_AH"),
    ("synthetic", "EMBOSS_TINT"): ("train.glyphs", "EMBOSS_TINT"),
    ("tools.hlo_hogs", "rank_hlo"): ("tools.buffer_hogs", "rank_buffers"),
    ("tools.hlo_hogs", "rank_cycles"):
        ("tools.buffer_hogs", "rank_device_time"),
    # the JAX tools' host-clock timers; the port times with CUDA events
    ("tools.profile_camera", "bench"): ("tools.profiling", "event_ms"),
    ("tools.profile_expiry", "bench"): ("tools.profiling", "event_ms"),
    ("tools.profile_pan", "bench_chain"): ("tools.profiling", "event_ms"),
    ("tools.profile_expiry", "fine"): ("tools.profile_expiry", "fine_stages"),
    ("tools.roofline", "PEAK_HBM"): ("tools.profiling", "HBM_BYTES_PER_S"),
    # the tensor forms of utils/, named for torch
    ("utils.geometry", "parametric_intersect_jax"):
        ("utils.geometry", "parametric_intersect_torch"),
    ("utils.geometry", "line_by_shifting_origin_jax"):
        ("utils.geometry", "line_by_shifting_origin_torch"),
    ("utils.olm", "luhn_checksum_jax"): ("utils.olm", "luhn_checksum"),
    ("utils.olm", "card_type_valid_jax"): ("utils.olm", "card_type_valid"),
}
# JAX modules the port leaves out whole
LEFT_OUT_MODULES = {
    "ops.persp_host": _HOST_ORACLE,
    "utils.platform": _PLATFORM,
}
# (JAX module, name) -> why the port has no counterpart
LEFT_OUT = {
    ("api", "warp_src_bounds"): _LOWERING,
    ("config", "config_from_env"): _SWITCH,
    ("models.zoo", "set_precision"): _SWITCH,
    ("models.zoo", "apply_pan_conv_mm"): _LOWERING,
    ("models.zoo", "apply_expiry_conv_mm"): _LOWERING,
    ("ops.canny", "hysteresis"): _LOWERING,
    **{("ops.persp", name): _DOUBLE_FLOAT for name in (
        "div_cr", "sqrt_cr", "dd", "dd_add", "dd_neg", "dd_mul",
        "dd_mul_f32", "dd_div")},
    ("ops.select", "coarse_blocks"): _LOWERING,
    ("ops.warp", "rect_to_quad_map"): _LOWERING,
    ("ops.warp", "warp_perspective_dense"): _LOWERING,
    ("parallel.mesh", "stream_sharding"): _SHARDING,
    ("parallel.mesh", "replicated"): _SHARDING,
    ("refbridge.build", "reference_root"): _CHECKOUT,
    # the dense template search and its table sizes
    ("scan.hseg", "N_WIDTHS"): _LOWERING,
    ("scan.hseg", "N_OFFSETS"): _LOWERING,
    ("scan.hseg", "best_n_hseg_dense"): _LOWERING,
    ("synthetic", "FONT_PATH"): _PIL_FONT,
    ("synthetic", "FONT_BOLD_PATH"): _PIL_FONT,
    ("synthetic", "FONT_SIZE"): _PIL_FONT,
    ("tools.hlo_hogs", "shape_bytes"): _HLO,
    ("train.trainer", "param_shardings"): _SHARDING,
}


def _module_name(path):
    rel = os.path.splitext(os.path.relpath(path, JAX_ROOT))[0]
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _jax_modules():
    """{dotted name relative to the package ("" for the package): file} of
    every module of cardio_dmz_tpu/."""
    modules = {}
    for dirpath, dirnames, files in os.walk(JAX_ROOT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                modules[_module_name(path)] = path
    return dict(sorted(modules.items()))


JAX_MODULES = _jax_modules()


def public_names(path):
    """The public top-level functions, classes and UPPER_CASE constants of
    a module's source, in order."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names += [n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name) and n.id.isupper()]
    return [n for n in names if not n.startswith("_")]


def _port(module):
    return "cardio_dmz_tpu_torch" + (f".{module}" if module else "")


@pytest.mark.parametrize("module", list(JAX_MODULES),
                         ids=lambda m: m or "__init__")
def test_every_public_name_is_ported_or_left_out(module):
    names = public_names(JAX_MODULES[module])
    if module in LEFT_OUT_MODULES:
        assert importlib.util.find_spec(_port(module)) is None
        assert not any(m == module for m, _ in {**MOVED, **LEFT_OUT})
        return
    port = importlib.import_module(_port(MOVED_MODULES.get(module, module)))
    missing = []
    for name in names:
        if (module, name) in MOVED:
            where, new_name = MOVED[module, name]
            assert hasattr(importlib.import_module(_port(where)), new_name), \
                (module, name, where, new_name)
        elif (module, name) in LEFT_OUT:
            # an entry for a name the port now has is stale
            assert not hasattr(port, name), (module, name)
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{module}: not in {port.__name__}: {missing}"


def test_tables_name_only_public_jax_names():
    for module, name in {**MOVED, **LEFT_OUT}:
        assert name in public_names(JAX_MODULES[module]), (module, name)
    for module in {**MOVED_MODULES, **LEFT_OUT_MODULES}:
        assert module in JAX_MODULES, module
    for reason in {**LEFT_OUT, **LEFT_OUT_MODULES}.values():
        assert reason and "\n" not in reason


def test_extract_weights_is_ported():
    """The last module to port: every public name of the JAX tool is the
    port's, and neither table lists any."""
    from cardio_dmz_tpu_torch.tools import extract_weights
    names = public_names(JAX_MODULES["tools.extract_weights"])
    assert {"parse_blobs", "role_map", "extract_mlp", "extract_pan_conv",
            "extract_expiry_conv", "main"} <= set(names)
    assert all(hasattr(extract_weights, n) for n in names)
    assert "tools.extract_weights" not in LEFT_OUT_MODULES
    assert not any(m == "tools.extract_weights"
                   for m, _ in {**MOVED, **LEFT_OUT})


# --- no path into the JAX package but its weights --------------------------

# "cardio_dmz_tpu" as a path component (not cardio_dmz_tpu_torch, not a
# dotted module name)
_JAX_PATH = re.compile(r"(^|[\\/])cardio_dmz_tpu([\\/]|$)")
_C_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_C_STRING = re.compile(r'"(?:[^"\\\n]|\\.)*"')


def _docstrings(tree):
    nodes = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                nodes.add(id(first.value))
    return nodes


def python_path_hits(text):
    """[the top-level statement's assigned name, or its line] for each
    string of a Python source, docstrings aside, that names cardio_dmz_tpu
    as a path component."""
    tree = ast.parse(text)
    docs = _docstrings(tree)
    hits = []
    for stmt in tree.body:
        label = stmt.targets[0].id if isinstance(stmt, ast.Assign) and \
            isinstance(stmt.targets[0], ast.Name) else f"line {stmt.lineno}"
        hits += [label for node in ast.walk(stmt)
                 if isinstance(node, ast.Constant)
                 and isinstance(node.value, str) and id(node) not in docs
                 and _JAX_PATH.search(node.value)]
    return hits


def c_path_hits(text):
    """The string literals of a C++/CUDA source, comments aside, that name
    cardio_dmz_tpu as a path component."""
    return [s for s in _C_STRING.findall(_C_COMMENT.sub("", text))
            if _JAX_PATH.search(s[1:-1])]


def test_path_scan_finds_a_constructed_path():
    text = ('"""Built from cardio_dmz_tpu/native/framepump.cpp."""\n'
            'import os\n'
            '# cardio_dmz_tpu/native/framepump.cpp\n'
            '_SRC = os.path.join(ROOT, "cardio_dmz_tpu", "native", "f.cpp")\n'
            'OTHER = f"{ROOT}/cardio_dmz_tpu/models"\n'
            'NAME = "cardio_dmz_tpu.models"\n'
            'PORT = "cardio_dmz_tpu_torch/_build"\n')
    assert python_path_hits(text) == ["_SRC", "OTHER"]
    assert c_path_hits('// cardio_dmz_tpu/x.h\n#include "cardio_dmz_tpu/x.h"\n'
                       '/* "cardio_dmz_tpu/y" */ const char* p = "a";\n') \
        == ['"cardio_dmz_tpu/x.h"']


def test_port_reads_only_the_jax_packages_weights():
    hits = []
    for dirpath, dirnames, files in os.walk(PORT_ROOT):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(dirpath, f), PORT_ROOT)
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as src:
                    hits += [(rel, h) for h in python_path_hits(src.read())]
            elif f.endswith((".cu", ".cpp")):
                with open(os.path.join(dirpath, f)) as src:
                    hits += [(rel, h) for h in c_path_hits(src.read())]
    assert hits == [(os.path.join("models", "weights.py"), "PARAM_DIR")]
