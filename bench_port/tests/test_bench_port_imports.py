"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``gbrl_tpu_torch`` is the port), and the reference
imports nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax",
                                          "gbrl_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert "gbrl_tpu_torch" not in top_level_imports(path)
    tree = ast.parse(path.read_text())
    relative = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.level > 0:
            relative |= ({n.module.split(".")[0]} if n.module
                         else {a.name for a in n.names})
    # inside the benchmark the reference reads the frozen envs, the
    # comparison arithmetic and itself, never the program's side
    assert relative <= {"trees", "compare", "envs"}, relative

