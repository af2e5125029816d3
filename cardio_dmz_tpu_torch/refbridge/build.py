"""Link the compiled card.io C++ oracle, _refdmz_<tag>.so.

The port's own build of native/refshim/ (see the sources there for what
each file does), read by path as runtime/ingest.py reads the frame pump:
the objects the repository carries, native/refshim/build/{oracle,cv24abi,
cvbackend}.o (the reference's unity build dmz_all.cpp with CYTHON_DMZ=1
SCAN_EXPIRY=1 TEST_GENERATED_MODELS=1 -Dcv=cv24, wrapped by oracle.cpp;
the 2.4-era cv:: symbols it needs; the bridge into the system OpenCV),
linked with g++ against the system libopencv_core and libopencv_imgproc,
which still ship the legacy C API the reference calls.

The library lands in cardio_dmz_tpu_torch/_build/, named by a hash of the
objects and the link line, and is reused while that file exists. A failed
link raises with g++'s output. Nothing is built at import.
"""

import ctypes.util
import hashlib
import os
import shutil
import subprocess

from ..ops.cuda._build import BUILD_DIR

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SHIM_DIR = os.path.join(_REPO, "native", "refshim")
OBJECTS_DIR = os.path.join(SHIM_DIR, "build")
OBJECTS = ("oracle.o", "cv24abi.o", "cvbackend.o")
OPENCV_LIBS = ("opencv_core", "opencv_imgproc")


def _cxx():
    return os.environ.get("CXX", "g++")


def _opencv_found(lib):
    if ctypes.util.find_library(lib):
        return True
    proc = subprocess.run(["pkg-config", "--libs", "opencv4"],
                          capture_output=True, text=True) \
        if shutil.which("pkg-config") else None
    return proc is not None and f"-l{lib}" in proc.stdout.split()


def missing():
    """What the build lacks, as a list of short phrases; empty when g++,
    the two OpenCV libraries and the objects are all there. It builds
    nothing."""
    out = []
    if shutil.which(_cxx()) is None:
        out.append(f"no C++ compiler ({_cxx()})")
    out += [f"no lib{lib} (ldconfig or pkg-config opencv4)"
            for lib in OPENCV_LIBS if not _opencv_found(lib)]
    absent = [o for o in OBJECTS
              if not os.path.isfile(os.path.join(OBJECTS_DIR, o))]
    if absent:
        out.append(f"no {', '.join(absent)} under {OBJECTS_DIR}")
    return out


def available():
    """True when the prerequisites of build() are there (see missing())."""
    return not missing()


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"refshim build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def _link_line(objects, out):
    return [_cxx(), "-shared", *objects, "-o", out,
            *(f"-l{lib}" for lib in OPENCV_LIBS)]


def _tag(parts):
    h = hashlib.sha256()
    for part in parts:
        h.update(part if isinstance(part, bytes) else part.encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def build(objects_dir=None, out_dir=None):
    """The oracle library's path, linked now unless a library of the same
    tag is already in out_dir.

    objects_dir: where the three objects are (native/refshim/build/ when
    None); out_dir: where the library goes (cardio_dmz_tpu_torch/_build/
    when None). Raises RuntimeError with g++'s output when the link
    fails."""
    out_dir = out_dir or BUILD_DIR
    os.makedirs(out_dir, exist_ok=True)
    objects = [os.path.join(objects_dir or OBJECTS_DIR, o) for o in OBJECTS]
    parts = [" ".join(_link_line(OBJECTS, "_refdmz.so"))]
    for path in objects:
        parts.append(os.path.basename(path))
        if os.path.isfile(path):
            with open(path, "rb") as f:
                parts.append(f.read())
    so = os.path.join(out_dir, f"_refdmz_{_tag(parts)}.so")
    if os.path.isfile(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    _run(_link_line(objects, tmp))
    os.replace(tmp, so)
    return so
