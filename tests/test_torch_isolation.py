"""The port stands alone: nothing under ``src/repro_torch`` imports JAX or
the reference package ``repro``, on the source and at run time."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def _port_sources():
    return sorted(PORT.rglob("*.py"))


def test_port_has_sources():
    names = {p.relative_to(PORT).as_posix() for p in _port_sources()}
    for must in ("kernels/moe_gmm/ops.py", "core/collaborative.py",
                 "serving/engine.py", "launch/serve.py",
                 "kernels/decode_attention/ops.py",
                 "kernels/prefill_attention/ops.py", "kernels/cases.py",
                 "serving/kv_pool.py", "models/ssm.py", "models/model.py",
                 "kernels/ssd_scan/ops.py", "launch/train.py",
                 "optim/adamw.py", "optim/train_step.py", "data/pipeline.py",
                 "checkpoint/ckpt.py", "runtime/fault_tolerance.py",
                 "runtime/elastic.py"):
        assert must in names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_source_imports_neither_jax_nor_repro(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(SRC)} imports {bad}"


def test_import_leaves_jax_and_repro_out_of_sys_modules():
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.kernels, repro_torch.bridge, "
            "repro_torch.serving.kv_pool, repro_torch.launch.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_neither_jax_nor_repro():
    path = SRC.parent / "chip_smoke.py"
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"chip_smoke.py imports {bad}"
