"""The import rule, by whole top-level module name: nothing under
h100_bench imports jax, jaxlib, flax or hisat2_tpu, and the plain
reference imports nothing of hisat2_tpu_torch either."""

import ast
import glob
import os

from conftest import REPO

BENCH = os.path.join(REPO, "h100_bench")


def top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def files():
    return glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)


def test_no_jax_and_no_jax_package():
    for p in files():
        bad = top_imports(p) & {"jax", "jaxlib", "flax", "hisat2_tpu"}
        assert not bad, (p, bad)


def test_reference_takes_nothing_of_the_program():
    for p in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        assert "hisat2_tpu_torch" not in top_imports(p), p


def test_whole_name_compare():
    # hisat2_tpu_torch begins with hisat2_tpu: only whole names count
    from h100_bench.harness import FORBIDDEN
    assert "hisat2_tpu_torch".split(".")[0] not in FORBIDDEN
