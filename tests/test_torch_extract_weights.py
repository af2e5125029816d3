"""The port's weights extraction tool (cardio_dmz_tpu_torch/tools/
extract_weights.py) against the JAX package's, and the committed weights
against the compiled card.io C++.

The reference's generated model sources are not in the repository, so
chip_smoke.generated_source_text writes sources in their format from the
committed cardio_dmz_tpu/models/params/*.npz (code lines and an array
without a role comment between the blobs). On them:

* each extractor of the port and of the JAX tool (loaded by path) return
  the same keys, shapes and <f4 bytes, equal to the committed arrays;
* the port's main writes the six files the JAX tool's main writes, file
  for file and key for key, and prints the same lines; each extracted
  model reproduces its golden output on the CPU within 1e-5;
* what breaks raises and names it: no --reference, an --out in the JAX
  package's weights, a wrong byte count, a missing role, a missing
  source, an unclosed blob; no .npz is left behind;
* native/refshim/build/oracle.o, read as ELF64 in pure Python, holds 48
  of the 49 committed arrays as the bytes of its `data_*` symbols in
  .data; the one it does not is slash_mlp.logistic_b, which the compiler
  folded out of .data.
"""

import contextlib
import functools
import importlib.util
import io
import os
import re
import struct
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import SOURCE_ROLES, write_generated_sources
from cardio_dmz_tpu_torch.models.selfcheck import TOLERANCE
from cardio_dmz_tpu_torch.models.weights import PARAM_DIR, module_from_numpy
from cardio_dmz_tpu_torch.tools import extract_weights as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "cardio_dmz_tpu", "tools", "extract_weights.py")
ORACLE_OBJECT = os.path.join(REPO, "native", "refshim", "build", "oracle.o")
MODELS = tuple(tool.JOBS)
# the one committed array the compiled reference holds nowhere in .data
FOLDED = "slash_mlp.logistic_b"


def committed(name):
    """One model's committed arrays as the .npz holds them."""
    with np.load(os.path.join(PARAM_DIR, f"{name}.npz")) as f:
        return {k: f[k] for k in f.files}


@functools.lru_cache(maxsize=None)
def jax_tool():
    """The JAX package's tool, loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_extract_weights",
                                                  JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_sources(root, drop=None):
    """The six models' sources under `root`; `drop` = (model, array key)
    leaves that array's blob out."""
    models = {name: committed(name) for name in MODELS}
    if drop is not None:
        del models[drop[0]][drop[1]]
    return write_generated_sources(str(root), models)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    write_sources(root)
    return str(root)


def assert_same_arrays(got, want):
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == np.dtype("<f4"), key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def run_main(argv):
    """The port's main with its printed lines."""
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = tool.main(argv)
    return rc, printed.getvalue()


def assert_nothing_written(out):
    assert not os.path.exists(out) or os.listdir(out) == []


# --- the parser and the extractors against the JAX tool ------------------

@pytest.mark.parametrize("name", MODELS)
def test_parse_blobs_matches_jax_tool(reference, name):
    """Every blob with a role, in file order, as the JAX tool reads it; the
    array without a role comment and the code lines between are skipped."""
    path = os.path.join(reference, tool.JOBS[name][1])
    ours, theirs = tool.parse_blobs(path), jax_tool().parse_blobs(path)
    assert [(n, r) for n, r, _ in ours] == [(n, r) for n, r, _ in theirs]
    assert [r for _, r, _ in ours] == [SOURCE_ROLES[k]
                                       for k in committed(name)]
    for (_, _, a), (_, _, b) in zip(ours, theirs):
        assert a.dtype == b.dtype == np.dtype("<f4")
        assert a.tobytes() == b.tobytes()
    with open(path) as f:
        text = f.read()
    assert "data_00000000[4] = {\n" in text and "static float layer_" in text
    assert tool.role_map(ours).keys() == jax_tool().role_map(theirs).keys()


@pytest.mark.parametrize("name", MODELS)
def test_extract_matches_jax_tool_and_committed_weights(reference, name):
    fn, rel, sizes = tool.JOBS[name]
    path = os.path.join(reference, rel)
    ours = fn(path, *sizes)
    theirs = getattr(jax_tool(), fn.__name__)(path, *sizes)
    assert_same_arrays(ours, theirs)
    assert_same_arrays(ours, committed(name))


def test_all_49_committed_arrays_are_extracted(reference):
    models = tool.extract_all(reference)
    assert list(models) == list(MODELS)
    assert sum(len(a) for a in models.values()) == 49
    for name in MODELS:
        assert_same_arrays(models[name], committed(name))


# --- the command line ------------------------------------------------------

def test_main_matches_jax_tool_main(reference, tmp_path):
    out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    rc, printed = run_main(["--reference", reference, "--out", out])
    assert rc == 0
    argv = ["extract_weights.py", "--reference", reference, "--out", jax_out]
    with mock.patch.object(sys, "argv", argv), \
            contextlib.redirect_stdout(io.StringIO()) as jax_printed:
        assert jax_tool().main() == 0
    files = sorted(f"{name}.npz" for name in MODELS)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out)) == files
    for name in MODELS:
        with np.load(os.path.join(out, f"{name}.npz")) as a, \
                np.load(os.path.join(jax_out, f"{name}.npz")) as b:
            ours, theirs = {k: a[k] for k in a.files}, \
                {k: b[k] for k in b.files}
        assert_same_arrays(ours, theirs)
        assert_same_arrays(ours, committed(name))
    assert printed.replace(os.path.realpath(out), "OUT") == \
        jax_printed.getvalue().replace(os.path.abspath(jax_out), "OUT")


def test_extracted_models_meet_their_golden_outputs(reference, tmp_path):
    """module_from_numpy loads each written file on the CPU, and the model
    maps its extracted test_input to its extracted test_output within the
    reference's 1e-5 (models/selfcheck.TOLERANCE)."""
    out = str(tmp_path / "params")
    assert run_main(["--reference", reference, "--out", out])[0] == 0
    for name in MODELS:
        with np.load(os.path.join(out, f"{name}.npz")) as f:
            arrays = {k: f[k] for k in f.files}
        model = module_from_numpy(name, arrays, "cpu")
        got = model(torch.from_numpy(arrays["test_input"])).detach().numpy()
        err = np.abs(got - arrays["test_output"]).max()
        assert err <= TOLERANCE, (name, err)


def test_default_out_is_the_ports_build_directory():
    build = os.path.join(REPO, "cardio_dmz_tpu_torch", "_build")
    assert os.path.dirname(tool.DEFAULT_OUT) == build
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "cardio_dmz_tpu_torch/_build/" in f.read().split()


def test_reference_is_required(capsys):
    with pytest.raises(SystemExit) as e:
        tool.main([])
    assert e.value.code == 2
    assert "--reference" in capsys.readouterr().err


def test_cli_exits_with_mains_code(reference, tmp_path):
    argv = ["--reference", reference, "--out", str(tmp_path / "out")]
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(SystemExit) as e:
        tool.cli(argv)
    assert e.value.code == 0
    assert len(os.listdir(tmp_path / "out")) == len(MODELS)


def _param_dir_state():
    return {f: os.stat(os.path.join(PARAM_DIR, f)).st_mtime_ns
            for f in sorted(os.listdir(PARAM_DIR))}


@pytest.mark.parametrize("form", ["itself", "dotted", "symlink", "inside"])
def test_refuses_to_write_the_jax_weights(reference, tmp_path, form):
    if form == "symlink":
        out = str(tmp_path / "link")
        os.symlink(PARAM_DIR, out)
    else:
        out = {"itself": PARAM_DIR,
               "dotted": os.path.join(PARAM_DIR, "..", "params"),
               "inside": os.path.join(PARAM_DIR, "sub")}[form]
    before = _param_dir_state()
    with pytest.raises(ValueError, match="never writes") as e:
        run_main(["--reference", reference, "--out", out])
    assert os.path.realpath(PARAM_DIR) in str(e.value)
    assert _param_dir_state() == before
    assert not os.path.exists(os.path.join(PARAM_DIR, "sub"))


# --- errors that name what broke -------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_wrong_byte_count_names_the_blob(tmp_path, name):
    path = write_sources(tmp_path / "ref")[name]
    with open(path) as f:
        text = f.read()
    m = re.search(r"static uint8_t (data_\w+)\[(\d+)\] = \{ //", text)
    blob, n = m.group(1), int(m.group(2))
    with open(path, "w") as f:
        f.write(text.replace(f"{blob}[{n}]", f"{blob}[{n + 4}]", 1))
    out = str(tmp_path / "out")
    with pytest.raises(ValueError) as e:
        run_main(["--reference", str(tmp_path / "ref"), "--out", out])
    for word in (name, path, blob, str(n + 4), str(n)):
        assert word in str(e.value)
    with pytest.raises(ValueError, match=blob):
        tool.parse_blobs(path)
    assert_nothing_written(out)


def test_blob_of_another_size_than_the_model_names_its_role(tmp_path):
    models = {name: committed(name) for name in MODELS}
    models["pan_conv_b"]["hidden_b"] = models["pan_conv_b"]["hidden_b"][:31]
    write_generated_sources(str(tmp_path / "ref"), models)
    out = str(tmp_path / "out")
    with pytest.raises(ValueError) as e:
        run_main(["--reference", str(tmp_path / "ref"), "--out", out])
    for word in ("pan_conv_b: ", "'hidden b'", "31 floats", "(32,)"):
        assert word in str(e.value)
    assert_nothing_written(out)


@pytest.mark.parametrize("drop", [(name, "hidden_b") for name in MODELS]
                         + [("expiry_conv", "conv2_w"),
                            ("vseg_mlp", "test_output")])
def test_missing_role_names_it(tmp_path, drop):
    name, key = drop
    write_sources(tmp_path / "ref", drop=drop)
    out = str(tmp_path / "out")
    with pytest.raises(KeyError) as e:
        run_main(["--reference", str(tmp_path / "ref"), "--out", out])
    message = e.value.args[0]
    assert message.startswith(f"{name}: ")
    assert repr(SOURCE_ROLES[key]) in message
    assert "roles found: " in message and "'hidden W'" in message
    assert_nothing_written(out)


@pytest.mark.parametrize("name", [MODELS[0], MODELS[-1]])
def test_missing_source_names_model_and_path(tmp_path, name):
    paths = write_sources(tmp_path / "ref")
    os.remove(paths[name])
    out = str(tmp_path / "out")
    with pytest.raises(FileNotFoundError) as e:
        run_main(["--reference", str(tmp_path / "ref"), "--out", out])
    assert name in str(e.value) and paths[name] in str(e.value)
    assert_nothing_written(out)


def test_unclosed_blob_raises(tmp_path):
    path = write_sources(tmp_path / "ref")["vseg_mlp"]
    with open(path) as f:
        lines = f.read().splitlines()
    last = max(i for i, line in enumerate(lines) if line == "};")
    with open(path, "w") as f:
        f.write("\n".join(lines[:last]) + "\n")
    with pytest.raises(ValueError, match="not closed"):
        tool.parse_blobs(path)


def test_a_failed_write_leaves_no_file(tmp_path):
    path = str(tmp_path / "model.npz")
    with mock.patch.object(tool.os, "replace",
                           side_effect=OSError("no space left")), \
            pytest.raises(OSError, match="no space left"):
        tool.write_npz(path, {"a": np.ones(3, np.float32)})
    assert os.listdir(tmp_path) == []
    tool.write_npz(path, {"a": np.ones(3, np.float32)})
    assert os.listdir(tmp_path) == ["model.npz"]


# --- the committed weights against the compiled C++ -----------------------

# a generated blob's symbol, mangled as a static (`_ZL13data_0b9a8510`),
# with its model's hash where two sources share a name
# (`_ZL22data_31c0cc47_01266c1b`)
_DATA_SYMBOL = re.compile(r"data_[0-9a-f]{8}(_[0-9a-f]{8})?$")


def elf_data_symbols(path):
    """{symbol name: its bytes} of every `data_*` symbol that lies in the
    .data section of a little-endian ELF64 relocatable object."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"\x7fELF" or raw[4] != 2 or raw[5] != 1:
        raise ValueError(f"{path} is not a little-endian ELF64 object")
    shoff, = struct.unpack_from("<Q", raw, 0x28)
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", raw, 0x3A)
    # (name, type, flags, addr, offset, size, link, info, align, entsize)
    sections = [struct.unpack_from("<IIQQQQIIQQ", raw, shoff + i * shentsize)
                for i in range(shnum)]

    def string(table, offset):
        start = sections[table][4] + offset
        return raw[start:raw.index(b"\0", start)].decode()

    names = [string(shstrndx, s[0]) for s in sections]
    symtab = sections[names.index(".symtab")]
    data = names.index(".data")
    symbols = {}
    for i in range(symtab[5] // symtab[9]):
        name, _, _, shndx, value, size = struct.unpack_from(
            "<IBBHQQ", raw, symtab[4] + i * symtab[9])
        name = string(symtab[6], name)
        if shndx == data and _DATA_SYMBOL.search(name):
            start = sections[data][4] + value
            symbols[name] = raw[start:start + size]
    return symbols


def test_committed_weights_are_the_compiled_references_data():
    """48 of the 49 committed arrays are, bit for bit, the bytes of a
    `data_*` symbol of the compiled reference (local symbols, as the
    generated sources declare them static); slash_mlp.logistic_b is the one
    exception: its 8 bytes appear nowhere in the object."""
    symbols = elf_data_symbols(ORACLE_OBJECT)
    assert len(symbols) == 48
    blobs = set(symbols.values())
    arrays = {f"{name}.{key}": np.ascontiguousarray(a, "<f4").tobytes()
              for name in MODELS for key, a in committed(name).items()}
    assert len(arrays) == 49
    missing = sorted(k for k, raw in arrays.items() if raw not in blobs)
    assert missing == [FOLDED]
    assert len(arrays) - len(missing) == 48
    with open(ORACLE_OBJECT, "rb") as f:
        assert f.read().find(arrays[FOLDED]) == -1


def test_elf_reader_refuses_another_file(tmp_path):
    path = tmp_path / "not.o"
    path.write_bytes(b"\x7fELF\x01\x01" + bytes(58))
    with pytest.raises(ValueError, match="ELF64"):
        elf_data_symbols(str(path))
