"""The benchmark's plain EFD reference (``benchmark/reference/efd.py``)
against the numpy oracle and against the port, and the port's EFD spans
and counters, on the CPU.

* the reference against ``tests/reference/efd_ref.py`` in f64: the same
  band counts, the same bounds, bands to 1e-9;
* the port's ``efd`` against the reference in f64 (bands to 1e-9) and in
  f32 (bands to 1e-5 of max|x|, the tolerance ``tests/test_torch_efd.py``
  holds the port to JAX with), counts and integer bounds exact on these
  seeded signals;
* the reference in its bfloat16 form (the check's control) parts from the
  f32 port on the cell's signal;
* the reference imports nothing of the port, the JAX package or JAX;
* one traced ``efd`` records ``pyitd.efd`` with ``pyitd.efd_segments`` and
  ``pyitd.efd_bands`` inside it, one each, and ``decomp.efd.COUNTS``
  counts its call, rows and three transforms; untraced, no span is
  entered and the outputs are the traced ones bit for bit.
"""
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import efd as ref
from pyitd_tpu_torch import efd
from pyitd_tpu_torch.decomp import efd as port_efd
from reference.efd_ref import efd as oracle

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_BANDS = 12


def _cell_signal(seed, rows=3, n=3000):
    """The cell's signal (BASELINE config 5a's tones and noise)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n)
    return (np.sin(40 * t) + 0.7 * np.sin(250 * t) + 0.4 * np.sin(1200 * t)
            + 0.1 * rng.normal(size=(rows, n)))


def _cases():
    """(name, signals (rows, n), n_bands)."""
    rng = np.random.default_rng(3)
    t = np.arange(1024) / 1024
    cosines = (np.cos(2 * np.pi * 30 * t) + 0.7 * np.cos(2 * np.pi * 90 * t)
               + 0.4 * np.cos(2 * np.pi * 200 * t))
    yield "cell-signal", _cell_signal(0), N_BANDS
    yield "cell-signal-4096", _cell_signal(1, 2, 4096), N_BANDS
    yield "noisy-cosines", cosines + 0.05 * rng.normal(size=(2, 1024)), 5
    # more bands than the spectrum has maxima (at most 3 in 8 bins):
    # trailing rows stay zero
    yield "few-maxima", rng.normal(size=(3, 32)), 6
    # plateaus in the spectrum: a quantised tone
    yield "plateaus", np.round(4 * np.stack([cosines, cosines[::-1]])) / 4, 8


CASES = list(_cases())
IDS = [c[0] for c in CASES]


def _bins(bounds, n):
    half1 = round((n // 2 + 1) / 2)
    return torch.round(bounds.double() * half1 / math.pi).long()


@pytest.mark.parametrize("name,x,nb", CASES, ids=IDS)
def test_efd_reference_matches_oracle(name, x, nb):
    got = ref.efd(torch.from_numpy(x), nb)
    for i, row in enumerate(x):
        bands, _, bn, m = oracle(row, nb)
        assert int(got["count"][i]) == m + 2 == bands.shape[0]
        np.testing.assert_array_equal(
            _bins(got["bounds"][i, :m + 3], x.shape[-1]).numpy(),
            np.round(bn * round((x.shape[-1] // 2 + 1) / 2) / np.pi))
        np.testing.assert_allclose(got["bands"][i, :m + 2].numpy(), bands,
                                   rtol=0, atol=1e-9)
        assert not got["bands"][i, m + 2:].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_efd_reference_passes_through_fewer_than_two_maxima(dtype):
    """A geometric decay, whose spectrum falls from bin 0 on and has no
    local maximum: EFD.py returns the input, as the port does."""
    x = 0.5 ** np.arange(64.0)
    assert oracle(x, 4)[0].shape[0] == 1
    xt = torch.from_numpy(x).to(dtype)[None]
    got = ref.efd(xt, 4)
    assert got["count"].tolist() == [1]
    assert torch.equal(got["bands"][0, 0], xt[0])
    assert not got["bands"][0, 1:].any()
    port = efd(xt, 4, device="cpu")
    assert torch.equal(port.count, got["count"])
    assert torch.equal(port.bands, got["bands"])


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-9),
                                        (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name,x,nb", CASES, ids=IDS)
def test_port_efd_matches_reference(name, x, nb, dtype, atol):
    xt = torch.from_numpy(x).to(dtype)
    got = efd(xt, nb, device="cpu")
    want = ref.efd(xt, nb)
    assert got.bands.dtype == want["bands"].dtype == dtype
    assert torch.equal(got.count, want["count"])
    assert torch.equal(_bins(got.bounds, x.shape[-1]),
                       _bins(want["bounds"], x.shape[-1]))
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(got.bands.numpy(), want["bands"].numpy(),
                               rtol=0, atol=atol * scale)


def test_bf16_reference_parts_from_the_port():
    xt = torch.from_numpy(_cell_signal(2, 4)).float()
    got = efd(xt, N_BANDS, device="cpu")
    low = ref.efd(xt, N_BANDS, torch.bfloat16)
    assert low["bands"].dtype == torch.float32
    parted = (_bins(got.bounds, xt.shape[-1])
              != _bins(low["bounds"], xt.shape[-1])).any(-1)
    gap = float((got.bands - low["bands"]).abs().max() / xt.abs().max())
    assert parted.any() or gap > 1e-3, (parted, gap)


def test_efd_reference_takes_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", "import benchmark.reference.efd, sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    top = set(out.stdout.split())
    assert "torch" in top
    assert not top & {"pyitd_tpu_torch", "pyitd_tpu", "jax"}, top


@pytest.fixture(scope="module")
def traced():
    x = torch.from_numpy(_cell_signal(4, 2, 4096)).float()
    port_efd.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = efd(x, N_BANDS, device="cpu")
    counts = dict(port_efd.COUNTS)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.is_user_annotation
                    and e.name.startswith("pyitd.")),
                   key=lambda s: (s[1], -s[2]))
    return x, out, counts, spans


def test_efd_counts(traced):
    _, _, counts, _ = traced
    assert counts == {"calls": 1, "rows": 2, "transforms": 3}


def test_efd_spans_nest(traced):
    _, _, _, spans = traced
    assert [s[0] for s in spans] == ["pyitd.efd", "pyitd.efd_segments",
                                     "pyitd.efd_bands"]
    (_, a, b), (_, sa, sb), (_, ba, bb) = spans
    assert a <= sa <= sb <= ba <= bb <= b


def test_efd_untraced_enters_no_span_and_gives_the_same_bits(traced,
                                                             monkeypatch):
    x, out, _, _ = traced
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    port_efd.reset_counts()
    again = efd(x, N_BANDS, device="cpu")
    assert entered == []
    assert port_efd.COUNTS == {"calls": 1, "rows": 2, "transforms": 3}
    for a, b in zip(out, again):
        assert torch.equal(a, b)
