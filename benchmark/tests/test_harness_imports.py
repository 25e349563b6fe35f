"""Nothing under benchmark/ loads the JAX stack, and the reference loads
nothing of the program: an AST scan of every module, top-level names
compared whole (``smmdax_torch`` is not ``smmdax``)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "smmdax"}


def _modules(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_stack(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules(os.path.join(BENCH, "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert "smmdax_torch" not in names
    # nor the harness that drives the program
    assert "benchmark" not in names


def test_the_scan_sees_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import smmdax_torch.train\nfrom smmdax.train import x\nimport jaxlib\n")
    assert set(_imports(str(p))) == {"smmdax_torch", "smmdax", "jaxlib"}
