"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared whole, by
the part before the first dot: ``repro_torch`` is not ``repro``."""
import ast
import os
import subprocess
import sys

import pytest

from bench.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(HERE)
                 for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, HERE) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(imported_tops(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    tops = set(imported_tops(os.path.join(HERE, "reference.py")))
    assert not {t for t in tops if t.startswith("repro")}


def test_the_name_check_is_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def run_py(args, cwd, env=None):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_without_a_card_it_exits_non_zero_with_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = run_py(["--workload", "lj.load", "--seed", "1", "--seconds", "1",
                "--trace", "0"], ROOT, env)
    assert r.returncode != 0
    assert not r.stdout.strip()
    assert "CUDA" in r.stderr


def test_without_the_program_it_exits_non_zero(tmp_path):
    import shutil
    shutil.copytree(HERE, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = run_py(["--workload", "lj.load", "--seed", "1", "--seconds", "1",
                "--trace", "0"], tmp_path, env)
    assert r.returncode != 0
    assert not r.stdout.strip()
