"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference, the yardsticks of every architecture (the toy's under
``tests/`` too) and the metric code import nothing of the port."""

import ast
import pathlib

import pytest

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "practicaldeepstereo_nips2018_tpu")
PORT = "practicaldeepstereo_nips2018_tpu_torch"
# The yardstick: it may not depend on what it measures.
# The generic harness too: what an architecture needs of the port, its
# driver imports.
INDEPENDENT = ["reference.py", "accounting.py", "generator.py", "record.py",
               "trace.py", "spans.py", "cells.py", "calibrate.py",
               "registry.py"] + sorted(
    str(path.relative_to(PACKAGE)) for pattern in (
        "metrics/*.py", "**/architectures/*.py")
    for path in PACKAGE.glob(pattern))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files():
    return sorted(PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("path", _files(),
                         ids=lambda path: str(path.relative_to(PACKAGE)))
def test_no_jax(path):
    for module in _imports(path):
        assert module.split(".")[0] not in FORBIDDEN, (path, module)


@pytest.mark.parametrize("name", INDEPENDENT)
def test_yardstick_imports_nothing_of_the_port(name):
    for module in _imports(PACKAGE / name):
        assert module.split(".")[0] != PORT, (name, module)


def test_whole_name_comparison():
    from pds_bench import run
    import sys
    sys.modules["practicaldeepstereo_nips2018_tpu_torch_probe"] = object()
    try:
        assert run.forbidden_modules() == [] or all(
            name.split(".")[0] in FORBIDDEN
            for name in run.forbidden_modules())
        assert "practicaldeepstereo_nips2018_tpu_torch_probe" not in \
            run.forbidden_modules()
    finally:
        del sys.modules["practicaldeepstereo_nips2018_tpu_torch_probe"]
    sys.modules["jax.probe"] = object()
    try:
        assert "jax.probe" in run.forbidden_modules()
    finally:
        del sys.modules["jax.probe"]
