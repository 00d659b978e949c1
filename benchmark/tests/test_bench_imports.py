"""Nothing under benchmark/ imports JAX, flax or the JAX package, by whole
top-level module names (batrack_tpu_torch begins with batrack_tpu and is
allowed outside the reference); the reference imports nothing of the
port."""

import ast

import bench_paths  # noqa: F401
import pytest

from harness import spec

FILES = sorted(p for p in spec.BENCH_DIR.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "batrack_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "batrack_tpu_torch" not in set(top_level_imports(path))


def test_the_check_of_names_is_by_whole_words():
    from harness import runner

    assert "batrack_tpu_torch" not in runner.FORBIDDEN
    assert runner.forbidden_modules() == []
