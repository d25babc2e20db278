"""Nothing under slambench/ imports JAX or the JAX package, by the whole
top-level name (the port's name, ``roborts_slam_tpu_torch``, begins with
the JAX package's), and the reference imports nothing of the port."""

import ast
from pathlib import Path

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "roborts_slam_tpu"}


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not top_names(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "roborts_slam_tpu_torch" not in top_names(f), f
        assert "roborts_slam_tpu_torch" not in f.read_text(), f


def test_the_check_is_whole_name():
    assert {"roborts_slam_tpu_torch"} & FORBIDDEN == set()
