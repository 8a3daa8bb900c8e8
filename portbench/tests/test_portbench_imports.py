"""What the benchmark may import, and the run-time guard."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bnn_pynq_tpu"}


def _imports(path):
    """Top-level names of every module a file imports (whole names)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(d):
    return sorted(p for p in d.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_jax_anywhere():
    bad = {str(p.relative_to(ROOT)): n for p in _files(BENCH)
           for n in _imports(p) if n in FORBIDDEN}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "json", "dataclasses", "typing", "numpy",
               "torch", "portbench"}
    for p in _files(BENCH / "reference"):
        names = set(_imports(p))
        assert names <= allowed, (p, names - allowed)
        assert "bnn_pynq_tpu_torch" not in names


def test_whole_name_comparison():
    """The port's name begins with the JAX package's: only whole top-level
    names count."""
    from portbench import harness
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] in FORBIDDEN}
    try:
        sys.modules["bnn_pynq_tpu_torch_fake"] = object()
        assert harness.forbidden_modules() == []
        sys.modules["bnn_pynq_tpu.fake"] = object()
        assert harness.forbidden_modules() == ["bnn_pynq_tpu"]
    finally:
        sys.modules.pop("bnn_pynq_tpu_torch_fake", None)
        sys.modules.pop("bnn_pynq_tpu.fake", None)
        sys.modules.update(saved)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cnv-w1a1.resident", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    """Without a CUDA device a run fails and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _run(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(tmp_path, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
