"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names are
compared whole (dindel_tpu_torch begins with dindel_tpu)."""

import ast
import subprocess
import sys

import pytest

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dindel_tpu"}
NOT_IN_REFERENCE = FORBIDDEN | {"dindel_tpu_torch", "chip_smoke", "tools",
                                "bench_torch", "bench"}


def top_level_imports(path):
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _files(root):
    return [p for p in root.rglob("*.py") if "tests" not in p.parts]


def test_whole_names_are_compared():
    assert "dindel_tpu" not in {"dindel_tpu_torch"}
    assert top_level_imports.__doc__


@pytest.mark.parametrize("root", ["benchmark", "dindel_tpu_torch"])
def test_no_jax_in_what_the_benchmark_runs(root):
    for p in _files(spec.ROOT / root):
        assert not top_level_imports(p) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_program():
    for p in _files(spec.HERE / "reference"):
        assert not top_level_imports(p) & NOT_IN_REFERENCE, p


def test_nothing_outside_the_benchmark_and_the_program():
    allowed = {"benchmark", "dindel_tpu_torch"}
    local = {p.stem for p in spec.ROOT.glob("*.py")} | {
        p.name for p in spec.ROOT.iterdir() if p.is_dir()}
    for p in _files(spec.HERE):
        assert not (top_level_imports(p) & local) - allowed, p


def test_loaded_modules_at_run_time():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.drive, benchmark.check, "
        "benchmark.tracing, benchmark.control, benchmark.gen\n"
        "import benchmark.reference.caller\n"
        "import dindel_tpu_torch.engine.batched, "
        "dindel_tpu_torch.engine.window, dindel_tpu_torch.cli\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
