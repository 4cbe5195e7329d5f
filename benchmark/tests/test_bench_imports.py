"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program."""
import subprocess
import sys

from benchmark import run

# every module of the harness (the metrics' readers are loaded by name)
MODULES = sorted(
    ".".join(p.relative_to(run.ROOT).with_suffix("").parts)
    for d in ("", "calls", "reference")
    for p in (run.ROOT / "benchmark" / d).glob("*.py")
    if p.name != "__init__.py")


def loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_bench_no_jax_loaded():
    code = "\n".join(f"import {m}" for m in MODULES) + (
        "\nfrom benchmark import run\n"
        "for m in run.load_spec()['per_layer']: run.load_metric(m['name'])")
    top = loaded_after(code)
    assert "pyitd_tpu_torch" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_bench_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyitd_tpu_torch_x", sys)
    assert "pyitd_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pyitd_tpu.ops", sys)
    assert "pyitd_tpu" in run.forbidden_modules()


def test_bench_reference_takes_nothing_of_the_program():
    top = loaded_after("import benchmark.reference.itd, "
                       "benchmark.reference.itd_oracle")
    assert not top & {"pyitd_tpu_torch", "pyitd_tpu", "jax"}
