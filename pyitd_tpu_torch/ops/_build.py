"""Build ``csrc/*.cu`` with ``nvcc`` at first use and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so one build
takes seconds: one ``nvcc -c`` per source, all started together, then one
link.  Its file name carries a hash of the sources and the flags, so an
edit rebuilds and a stale library is never loaded.  The build writes to a
temporary name and renames it into place, so parallel processes that race
to build the same library each end with a complete file.

Flags: ``-fmad=false`` keeps every ``a*b+c`` in the kernels as a rounded
multiply and a rounded add, as PyTorch's eager elementwise kernels compute
it, which makes the kernels bit-comparable with their plain versions on the
card.  No fast-math: the two-sum residuals and the NaN tests depend on
IEEE arithmetic.

The native real-time tier (``native/itd_native.cpp``, bound by
``runtime.py``) is host code: :func:`load_host_library` builds it with the
host C++ compiler (``$CXX``, else ``g++`` or ``c++``) and the flags of the
JAX package's ``pyitd_tpu/native/Makefile`` (:data:`HOST_FLAGS`), into the
same directory, under a name that hashes its source and flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["NVCC_FLAGS", "HOST_FLAGS", "build", "load_library",
           "build_host", "load_host_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# PYITD_NVCC_FLAGS adds flags for an experiment (-Xptxas -v, a -D of a
# kernel's shape); the library's name hashes them like the rest
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", *shlex.split(os.environ.get("PYITD_NVCC_FLAGS", "")))

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C entry points of csrc/*.cu: (name, argtypes); each launcher returns the
# launch's cudaGetLastError() as an int
_SIGNATURES = {
    "pyitd_tile_size": (),
    "pyitd_level_summaries": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P),
    "pyitd_tile_scan": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                        _P, _P, _P),
    "pyitd_sift_level": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "pyitd_error_string": (_I,),
    "pyitd_scan_tile_size": (),
    "pyitd_scan_run_length": (),
    "pyitd_scan_threads": (),
    "pyitd_scan_header_bytes": (),
    "pyitd_scan_desc_bytes": (),
    "pyitd_fill2": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "pyitd_linear_fill2": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "pyitd_fillv": (_P, _P, _I, _I, _I, _P, _P, _P),
    "pyitd_segsum": (_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "pyitd_bwd_knots": (_P, _I, _I, _P, _P, _P),
    "pyitd_bwd_pre": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P),
    "pyitd_bwd_post": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "pyitd_cubic_ksite": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    "pyitd_cubic_neighbors": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P),
    "pyitd_spike_block": (),
    "pyitd_spike_run": (),
    "pyitd_spike_factors": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "pyitd_spike_interface": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    "pyitd_spike_backsub_eval": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P),
    "pyitd_walk_stats": (_P, _I, _I, _I, _D, _P, _P),
}

# the native tier: the Makefile's CXXFLAGS, then -shared and -lpthread
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
NATIVE_SRC = _PKG / "native" / "itd_native.cpp"

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for f in NVCC_FLAGS:
        h.update(f.encode() + b"\0")
    for src in _sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libpyitd_sift_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    return proc


def build() -> tuple[Path, str]:
    """Compile the kernels if no library for these sources and flags
    exists; returns ``(path, nvcc output)``.  Raises with nvcc's stderr on
    failure."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [s for s in _sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in cu]
        with ThreadPoolExecutor(len(cu)) as pool:
            procs = list(pool.map(_run, (
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", o]
                for s, o in zip(cu, objs))))
        lib = os.path.join(tmp, so.name)
        procs.append(_run([_nvcc(), *_ARCH, "-shared", "-o", lib, *objs]))
        os.replace(lib, so)
    return so, "".join(p.stdout + p.stderr for p in procs)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built and loaded once per process, its
    build constants unchecked (``cuda_fill._lib`` checks them)."""
    if "lib" not in _loaded:
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_char_p if name == "pyitd_error_string" \
                else ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")


def host_library_path() -> Path:
    h = hashlib.sha256()
    for f in HOST_FLAGS:
        h.update(f.encode() + b"\0")
    h.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libpyitd_native_{h.hexdigest()[:16]}.so"


def build_host() -> Path:
    """Compile the native tier if no library for this source and these
    flags exists; returns its path.  Raises with the compiler's stderr on
    failure."""
    so = host_library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, so.name)
        _run([_cxx(), *HOST_FLAGS, "-shared", "-o", lib, str(NATIVE_SRC),
              "-lpthread"])
        os.replace(lib, so)
    return so


def load_host_library() -> ctypes.CDLL:
    """The native tier's shared library, built and loaded once per process
    (its bindings are ``runtime.py``'s)."""
    if "host" not in _loaded:
        _loaded["host"] = ctypes.CDLL(str(build_host()))
    return _loaded["host"]
