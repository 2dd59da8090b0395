"""No module the benchmark runs is of the JAX stack or the JAX package, and
the plain reference imports nothing of the program. Top-level module names
are compared whole: the port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
JAX_NAMES = {"jax", "jaxlib", "flax", "gnn_tumor_seg_tpu"}


def top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "gnn_tumor_seg_tpu_torch" not in names
    assert not names & JAX_NAMES


def test_forbidden_modules_compares_whole_names():
    from benchmark.harness import forbidden_modules

    assert forbidden_modules(["gnn_tumor_seg_tpu_torch", "gnn_tumor_seg_tpu_torch.ops",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["gnn_tumor_seg_tpu.ops.graph", "jax._src", "jaxlib",
                              "flax.linen"]) == ["flax", "gnn_tumor_seg_tpu", "jax",
                                                 "jaxlib"]


def test_a_cpu_run_loads_no_jax():
    """A whole small run in a fresh process leaves no forbidden module and
    the reference's modules none of the program either."""
    code = (
        "import sys, os; sys.path.insert(0, %r);"
        "os.environ['GTS_CNN_CROP_FLOOR'] = 'none';"
        "from benchmark.harness import run_cell, forbidden_modules;"
        "from conftest import small;"
        "res, _ = run_cell('train-gspool-b6', 5, 0.5, False, device='cpu',"
        " overrides=small('train-gspool-b6'));"
        "assert res['attempted'] > 0;"
        "print('FORBIDDEN', forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.join(BENCH, "tests"), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_reference_runs_without_the_program():
    """The reference modules import with the program's package unreachable."""
    code = (
        "import sys; sys.path.insert(0, %r);"
        "import builtins; real = builtins.__import__\n"
        "def guard(name, *a, **k):\n"
        "    if name.split('.')[0] in ('gnn_tumor_seg_tpu_torch', 'gnn_tumor_seg_tpu', 'jax'):\n"
        "        raise ImportError(name)\n"
        "    return real(name, *a, **k)\n"
        "builtins.__import__ = guard\n"
        "import benchmark.reference.serve, benchmark.reference.train, benchmark.reference.gnn\n"
        "print('OK')" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_run_refuses_without_a_card():
    """Without a CUDA device the command prints no result and fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "serve-gspool-deviceprep", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
