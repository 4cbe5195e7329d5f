"""The kernel wrappers' one launch path on the CPU: ``ops/cuda_fill.py::
_lib`` (the library, its build constants checked at the first load) and
``_launch`` (the device guard, the current stream, the call, the error
check, the count), with a stand-in for the loaded library.  No CPU test
reaches a wrapper's CUDA branch, so these hold the path that every launch
of ``cuda_fill``'s and ``cuda_cubic``'s fourteen wrappers takes.
"""
import contextlib

import pytest
import torch

from pyitd_tpu_torch.ops import _build, cuda_cubic
from pyitd_tpu_torch.ops import cuda_fill as cf

# the library's constant entries and what the modules expect of them
CONSTANTS = {
    "pyitd_tile_size": cf.TILE,
    "pyitd_scan_tile_size": cf.TILE,
    "pyitd_scan_threads": cf.SCAN_THREADS,
    "pyitd_scan_run_length": cf.SCAN_RUN,
    "pyitd_spike_block": cuda_cubic.SPIKE_BLK,
    "pyitd_spike_run": cuda_cubic.SPIKE_RUN,
    "pyitd_scan_header_bytes": 64,
    "pyitd_scan_desc_bytes": 16,
}
# each checked entry and the source whose constant it reports
SOURCES = {
    "pyitd_tile_size": "sift_level",
    "pyitd_scan_tile_size": "fill_segsum",
    "pyitd_scan_threads": "fill_segsum",
    "pyitd_scan_run_length": "fill_segsum",
    "pyitd_spike_block": "spike",
    "pyitd_spike_run": "spike",
}


class FakeLibrary:
    """Answers the constant entries from ``values``, counting each call;
    every other ``pyitd_<kernel>`` entry records its arguments and returns
    ``code``."""

    def __init__(self, values: dict, code: int = 0):
        self.values, self.code = dict(values), code
        self.asked = dict.fromkeys(values, 0)
        self.launched = []

    def __getattr__(self, name):
        if name in self.values:
            def constant():
                self.asked[name] += 1
                return self.values[name]
            return constant
        if name == "pyitd_error_string":
            return lambda code: f"stand-in error {code}".encode()

        def launch(*args):
            self.launched.append((name, args))
            return self.code
        return launch


@pytest.fixture
def library(monkeypatch):
    """Installs a :class:`FakeLibrary` as the library not yet loaded; the
    device guard and the current stream are stand-ins that record the
    device."""
    guarded = []

    @contextlib.contextmanager
    def device(d):
        guarded.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(cf, "_stream", lambda d: 1000 + d.index)
    monkeypatch.setattr(cf, "_LIB", None)
    monkeypatch.setattr(cf, "_SCAN_BYTES", (0, 0))

    def install(values=CONSTANTS, code=0):
        lib = FakeLibrary(values, code)
        monkeypatch.setattr(_build, "load_library", lambda: lib)
        lib.guarded = guarded
        return lib

    return install


@pytest.mark.parametrize("entry", sorted(SOURCES))
def test_library_with_other_constants_is_refused(library, entry):
    library({**CONSTANTS, entry: CONSTANTS[entry] * 2})
    for _ in range(2):  # refused at every load, never kept
        with pytest.raises(RuntimeError,
                           match=f"csrc/{SOURCES[entry]}\\.cu"):
            cf._lib()
        assert cf._LIB is None


def test_constants_are_asked_once(library):
    lib = library()
    dev = torch.device("cuda", 0)
    assert cf._lib() is lib
    counts = {"fill2": 0, "spike_factors": 0}
    for _ in range(5):
        assert cf._lib() is lib
        cf._launch("fill2", dev, 1, 2, counts=counts)
        cf._launch("spike_factors", dev, 3, counts=counts)
    assert lib.asked == dict.fromkeys(CONSTANTS, 1)
    assert cf._SCAN_BYTES == (64, 16)
    assert counts == {"fill2": 5, "spike_factors": 5}
    assert lib.launched[:2] == [("pyitd_fill2", (1, 2, 1000)),
                                ("pyitd_spike_factors", (3, 1000))]
    assert lib.guarded == [dev] * 10


def test_launch_counts_in_the_module_launches(library, monkeypatch):
    library()
    monkeypatch.setitem(cf.LAUNCHES, "segsum", 0)
    cf._launch("segsum", torch.device("cuda", 1), 7)
    assert cf.LAUNCHES["segsum"] == 1


def test_launch_error_raises_the_library_string(library):
    lib = library(code=700)
    counts = {"bwd_post": 0}
    with pytest.raises(RuntimeError, match=r"^bwd_post launch failed: CUDA "
                                           r"error 700 \(stand-in error "
                                           r"700\)$"):
        cf._launch("bwd_post", torch.device("cuda", 0), 5, counts=counts)
    assert lib.launched == [("pyitd_bwd_post", (5, 1000))]
    assert counts == {"bwd_post": 0}
