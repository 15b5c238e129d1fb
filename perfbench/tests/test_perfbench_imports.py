"""The import rule: nothing under perfbench/ imports JAX or the JAX package
(top-level names compared whole), and the reference imports nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "bitorch_engine_tpu"}


def top_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = {(str(p.relative_to(PB)), n) for p in PB.rglob("*.py") for n in top_names(p)
           if n in FORBIDDEN}
    assert not bad


def test_the_port_is_not_taken_for_the_jax_package():
    # the port's name begins with the JAX package's: compared whole, it is not it
    assert "bitorch_engine_tpu_torch".split(".")[0] not in FORBIDDEN
    used = {n for p in (PB / "lib").rglob("*.py") for n in top_names(p)}
    assert "bitorch_engine_tpu_torch" in used


def test_reference_imports_nothing_of_the_program():
    for p in (PB / "reference").rglob("*.py"):
        names = set(top_names(p))
        assert "bitorch_engine_tpu_torch" not in names, p
        assert not names & FORBIDDEN, p
        # relative imports stay inside the benchmark: reference/ and lib/weights, lib/flops
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.module in ("lib", "lib.weights", "lib.flops", "llama_ref"), (p, node.module)


def test_run_refuses_a_process_that_loaded_jax():
    code = ("import sys, types; sys.path.insert(0, 'perfbench'); import run; "
            "assert run.forbidden_modules() == []; "
            "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy'); "
            "sys.modules['bitorch_engine_tpu_torch.x'] = types.ModuleType('x'); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=PB.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['jax.numpy']"
