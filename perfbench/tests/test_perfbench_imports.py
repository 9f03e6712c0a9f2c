"""No process the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program: module names compared by
their top-level part, whole."""
import ast
import subprocess
import sys
import textwrap

import pytest

from perfbench import harness, manifest

PB = manifest.ROOT / "perfbench"


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("names, bad", [
    (["repro_torch", "repro_torch.serving", "jaxtyping", "reprolib"], []),
    (["repro", "repro.models"], ["repro", "repro.models"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "numpy"],
     ["flax.linen", "jax", "jaxlib.xla_client"]),
])
def test_forbidden_names_are_whole_top_level_names(names, bad):
    assert harness.forbidden_modules(names) == bad


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


PLAIN = {"__future__", "typing", "numpy", "torch"}
# the benchmark's own weight layout and work counts, which a reference module
# draws and counts with; they import nothing of the program either
YARDSTICK = {"perfbench.weights", "perfbench.roofline"}


def imported_modules(path):
    """Every module ``path`` imports, by its full name (``from perfbench
    import weights``: ``perfbench.weights``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out |= ({f"{node.module}.{a.name}" for a in node.names}
                    if node.module == "perfbench" else {node.module})
    return out


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_modules(path)
    assert {n for n in names if n.split(".")[0] not in PLAIN} <= YARDSTICK
    for y in names & YARDSTICK:
        tops = top_level_imports(PB / f"{y.split('.')[1]}.py")
        assert tops <= PLAIN | set(sys.stdlib_module_names), (y, tops)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run at a tiny size, in a fresh interpreter, then the check
    the harness makes before it prints a result."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(manifest.ROOT)!r}, {str(manifest.ROOT / 'src')!r}]
        from pathlib import Path
        from perfbench import harness
        from perfbench.tests import tiny
        r = harness.run_cell(tiny.cell(Path({str(tmp_path)!r})), 3, 0.5,
                             True, "cpu")
        assert r["metrics"], r
        print("FORBIDDEN", harness.forbidden_modules())
        print("PROGRAM", "repro_torch" in sys.modules)
        print("REFERENCE", sorted(m for m in sys.modules
                                  if "perfbench_reference" in m))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "PROGRAM True" in out.stdout
    assert "_perfbench_reference_moe_lm" in out.stdout
