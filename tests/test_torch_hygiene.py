"""PyTorch port, import rules: the port package and ``chip_smoke.py``
import neither JAX nor the JAX package, not even its numpy-only modules;
kernel builds and ``triton`` stay out of import time. The README's port
map names every module of the JAX package."""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "practicaldeepstereo_nips2018_tpu_torch"
JAX_PACKAGE = ROOT / "practicaldeepstereo_nips2018_tpu"
FORBIDDEN = ("jax", "jaxlib", "practicaldeepstereo_nips2018_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_exist():
    files = _port_files()
    assert all(path.exists() for path in files)
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda path: str(path.relative_to(ROOT)))
def test_no_jax_imports(path):
    for module in _imported_modules(path):
        top = module.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {module}"


def test_no_kernel_work_at_import_time():
    """Building a kernel or importing triton happens inside the call that
    launches it, never at module import: only function bodies may name
    them."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [alias.name for alias in node.names]
                module = getattr(node, "module", None) or ""
                assert "triton" not in names and "triton" not in module
            if isinstance(node, ast.Expr) and isinstance(node.value,
                                                         ast.Call):
                raise AssertionError(
                    f"{path.name}: top-level call {ast.dump(node.value)}")


def _port_map_rows() -> list[str]:
    """The rows of the README's port map table."""
    readme = (ROOT / "README.md").read_text()
    section = readme.split("### Port map", 1)[1].split("\n## ", 1)[0]
    return [line for line in section.splitlines()
            if line.startswith("| ") and not line.startswith("| JAX")]


def _jax_modules() -> list[str]:
    """The JAX package's modules (its ``__init__.py`` files hold no
    names), as paths under the package."""
    return sorted(str(path.relative_to(JAX_PACKAGE))
                  for path in JAX_PACKAGE.rglob("*.py")
                  if path.name != "__init__.py")


def _port_map_path_exists(path: str) -> bool:
    """Whether a ``*.py`` path of the port map's port column names a file:
    ``chip_smoke.py`` and ``tests/`` at the repository's root, any other
    under the port package or ``pds_bench/`` (so the root ``bench.py``,
    the JAX package's, does not count)."""
    if path == "chip_smoke.py" or path.startswith("tests/"):
        return (ROOT / path).is_file()
    return any((root / path).is_file() for root in (PORT, ROOT / "pds_bench"))


@pytest.mark.parametrize("module", _jax_modules())
def test_port_map_names_every_jax_module(module):
    """Each module of the JAX package appears in the port map's JAX
    column, and its row says where it went or why it is TPU-only. Every
    backticked ``*.py`` path in the port column of every row (``::name``
    stripped) exists."""
    all_rows = _port_map_rows()
    rows = [row for row in all_rows if f"`{module}`" in row.split(" | ")[0]]
    assert rows, f"{module} is missing from README.md's port map"
    for row in rows:
        port = row.split(" | ", 1)[1]
        assert re.search(r"`[\w/.:]+`|TPU-only|not ported|same", port), row
    missing = [(path, row) for row in all_rows
               for path in re.findall(r"`([\w/.]+\.py)(?:::\w+)?`",
                                      row.split(" | ", 1)[1])
               if not _port_map_path_exists(path)]
    assert not missing
