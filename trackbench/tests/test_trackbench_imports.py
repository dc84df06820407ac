"""What trackbench loads: never jax or the JAX package (whole top-level
names: the port's name begins with the JAX package's), and its reference
nothing of the port."""
import ast
import os
import subprocess
import sys

from trackbench import run

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_in_any_source():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(top_imports(path)) & set(run.BANNED), path


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert "shasta_tpu_torch" not in set(top_imports(path)), path


def test_a_run_loads_no_jax():
    """Set-up, a window and the check of the small car cell in a fresh
    interpreter, then the modules it holds."""
    code = ("import sys, json; from trackbench import run; from trackbench.tests.small import small;"
            "cfg, mix = small('shasta-car', 'stream');"
            "run.run_cell(cfg, mix, 3, 0.5, False, 'cpu', [], []);"
            "print(json.dumps(run.loaded_banned()))")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PKG))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=os.path.dirname(PKG), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
