"""What the benchmark may load: the reference imports nothing of JAX, the
JAX package or the program; a run loads neither JAX nor the JAX package.
Module names are compared by their whole top-level name (the program's
name begins with the JAX package's)."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

REF = os.path.join(ROOT, "benchmark", "reference")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_neither_jax_nor_either_package():
    banned = {"jax", "jaxlib", "flax", "neumesh_tpu", "neumesh_tpu_torch"}
    for f in sorted(os.listdir(REF)):
        if f.endswith(".py"):
            found = set(_imports(os.path.join(REF, f))) & banned
            assert not found, (f, found)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests'); "
        "from conftest import tiny_run; "
        "out = tiny_run('neumesh-volume-f32'); "
        "from benchmark import harness; "
        "print(sorted({m.split('.')[0] for m in sys.modules} "
        "& {'jax', 'jaxlib', 'flax', 'neumesh_tpu', 'neumesh_tpu_torch'}))")
    env = dict(os.environ, NEUMESH_TORCH_GRID_CACHE=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "['neumesh_tpu_torch']"


def test_the_harness_refuses_a_run_that_holds_jax(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.banned_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "neumesh_tpu_torch_extra", object())
    assert harness.banned_modules() == []
