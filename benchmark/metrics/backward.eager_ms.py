"""Device ms per call in kernels launched inside the ``backward`` span that
are none of the port's own (``pyitd_tpu_torch/csrc``): the eager glue of
the backward replay (``decomp/itd.py::_KernelSift.backward``,
``ops/linear_baseline.py::structural_level_bwd``).  The port's kernels are
known by the names of the ``__global__`` functions in its sources, so a
kernel that a later change adds there counts as the port's."""
import re
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[2] / "pyitd_tpu_torch" / "csrc"


def port_kernels() -> set[str]:
    names = set()
    for src in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        text = re.sub(r"__launch_bounds__\s*\([^)]*\)", "", src.read_text())
        for decl in re.findall(r"__global__([^(]*)\(", text):
            names.add(re.findall(r"\w+", decl)[-1])
    return names


def read(trace, ctx):
    spans = trace.spans("backward")
    if not spans:
        return None
    ours = port_kernels()
    ms = sum(e.dur for e in trace.kernels_launched_in("backward")
             if not any(k in e.name for k in ours)) / 1e3
    return ms / len(spans)
