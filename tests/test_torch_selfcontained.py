"""dindel_tpu_torch is self-contained: it imports nothing of the JAX
package ``dindel_tpu`` and nothing of ``jax``.

An AST scan of every module of the port, of chip_smoke.py and of the
port's measurement harness (bench_torch.py, tools/bench_windows_torch.py,
tools/profile_host_torch.py, tools/epilogue_phases_torch.py) rejects any
such import, at top level or inside a function; a subprocess with both
blocked by a ``sys.meta_path`` finder drives every verb of the port's CLI
on a small sim, the diploid, pooled, full-decode and dense insert-prior
``indels`` paths of the batched engine, its ``--mesh`` and
``--stageProcs`` runs, the default streaming engine and ``--faster`` on
the CPU included (the staging processes ``--stageProcs`` spawns start
without the blocking finder; the AST scan covers their code)."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "dindel_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "bench_torch.py",
    REPO / "tools" / "bench_windows_torch.py",
    REPO / "tools" / "profile_host_torch.py",
    REPO / "tools" / "epilogue_phases_torch.py"]


def _blocked(name: str) -> bool:
    return (name in ("jax", "jaxlib", "dindel_tpu")
            or name.startswith(("jax.", "jaxlib.", "dindel_tpu.")))


def _imports(path: Path):
    """(line, module) of every import in `path`: import statements,
    absolute `from` imports, and importlib.import_module / __import__
    calls on a literal name."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            if fname in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_scan_sees_every_kind_of_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(textwrap.dedent("""
        import jax.numpy as jnp
        from dindel_tpu.config import Parameters
        from dindel_tpu_torch import cli
        def f():
            import dindel_tpu
            import importlib
            importlib.import_module("jaxlib")
    """))
    assert [m for _, m in _imports(src) if _blocked(m)] == [
        "jax.numpy", "dindel_tpu.config", "dindel_tpu", "jaxlib"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_module_imports_no_jax_package(path):
    bad = [(line, m) for line, m in _imports(path) if _blocked(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


_BLOCKED_RUN = textwrap.dedent("""
    import glob
    import sys

    class Block:
        '''Refuses jax, jaxlib and dindel_tpu (not dindel_tpu_torch).'''
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "dindel_tpu"):
                raise ImportError(f"blocked: {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)  # the test runs beside other workers
    from dindel_tpu_torch import cli
    from dindel_tpu_torch.engine import window
    _close = window.WindowEngine.close

    def _checked(eng):  # every engine must close with no slab rescued
        _close(eng)
        assert not eng.stats.counts.get("slab.rescues"), "rescue"
    window.WindowEngine.close = _checked
    from dindel_tpu_torch.sim import PlantedVariant, SimConfig, simulate

    fa, bam = simulate("sim", [PlantedVariant(pos=500, var="-AC",
                                              genotype=1),
                               PlantedVariant(pos=1300, var="+TG",
                                              genotype=2)],
                       SimConfig(ref_len=2000, coverage=10, read_len=50),
                       seed=2)

    def run(*argv):
        assert cli.main([str(a) for a in argv]) == 0, argv

    def indels(out, *extra):
        run("--analysis", "indels", "--engine", "batched", "--device", "cpu",
            "--hmmBackend", "pallas", "--bamFile", bam, "--ref", fa,
            "--varFile", "win.1.txt", "--outputFile", out, *extra)
        return open(out + ".glf.txt").read()

    run("--analysis", "getCIGARindels", "--bamFile", bam, "--ref", fa,
        "--outputFile", "cand")
    run("--analysis", "realignCandidates", "--varFile", "cand.variants.txt",
        "--ref", fa, "--outputFile", "realigned")
    run("--analysis", "selectCandidates", "--inputVarFile",
        "cand.variants.txt", "--outputFile", "selected.txt")
    run("--analysis", "makeWindows", "--inputVarFile", "cand.variants.txt",
        "--windowFilePrefix", "win")
    glf = indels("dip", "--doDiploid")
    assert "dip.map" in glf, glf
    # the batched engine sharded over a 2x2 mesh of the CPU, and fed by two
    # staging processes over the window file cut in two
    assert indels("mesh", "--doDiploid", "--mesh", "2x2") == glf
    lines = open("win.1.txt").read().splitlines(keepends=True)
    open("half1.txt", "w").writelines(lines[:len(lines) // 2])
    open("half2.txt", "w").writelines(lines[len(lines) // 2:])
    run("--analysis", "indels", "--engine", "batched", "--device", "cpu",
        "--hmmBackend", "pallas", "--bamFile", bam, "--ref", fa,
        "--varFile", "half1.txt,half2.txt", "--outputFile", "staged",
        "--doDiploid", "--stageProcs", 2)
    assert "dip.map" in open("staged.glf.txt").read()
    open("dip_glfs.txt", "w").write("dip.glf.txt\\n")
    run("--analysis", "mergeOutputDiploid", "--inputFiles", "dip_glfs.txt",
        "--ref", fa, "--outputFile", "calls.vcf")
    assert [l for l in open("calls.vcf") if not l.startswith("#")]
    run("--analysis", "convertVCFToDindel", "--inputVarFile", "calls.vcf",
        "--ref", fa, "--outputFile", "conv.txt")
    # the full-decode route: host decode, host callers, realigned BAMs
    glf = indels("ra", "--doDiploid", "--outputRealignedBAM")
    assert "dip.map" in glf and glob.glob("ra.ra.*.bam"), glf
    # the dense insert-prior slabs (the libraries file of getCIGARindels)
    glf = indels("ip", "--doDiploid", "--insertPrior", "--libFile",
                 "cand.libraries.txt")
    assert "dip.map" in glf, glf
    # the default engine (streaming, float64 exact ties), and --faster,
    # on the first window
    open("first.txt", "w").write(open("win.1.txt").readline())
    for out, extra in (("stream", ()), ("faster", ("--faster",))):
        run("--analysis", "indels", "--doDiploid", "--device", "cpu",
            "--bamFile", bam, "--ref", fa, "--varFile", "first.txt",
            "--outputFile", out, *extra)
        assert "dip.map" in open(out + ".glf.txt").read(), out
    # the pooled caller with its device EM
    glf = indels("pool", "--doPooled")
    assert "singlevariant" in glf, glf
    open("pool_glfs.txt", "w").write("pool.glf.txt\\n")
    run("--analysis", "mergeOutputPooled", "--inputFiles", "pool_glfs.txt",
        "--ref", fa, "--outputFile", "pooled.vcf", "--numSamples", 1,
        "--numBAMFiles", 1)
    open("bams.txt", "w").write(bam + "\\n")
    run("--analysis", "makeGenotypeLikelihoodFilePooled", "--inputFiles",
        "pool_glfs.txt", "--bamFiles", "bams.txt", "--varFile", "pooled.vcf",
        "--outputFile", "gl.txt")
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "dindel_tpu")]
    assert not loaded, loaded
    print("SELF_CONTAINED_OK")
""")


def test_port_runs_with_jax_package_blocked(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN.format(repo=str(REPO))],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "SELF_CONTAINED_OK" in res.stdout
