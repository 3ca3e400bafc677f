"""No module of the benchmark imports the JAX side, and the references
import nothing of the program (top-level names compared whole)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
REFERENCES = sorted((HERE / "reference").glob("*.py"))


def roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def test_files_found():
    assert len(FILES) > 10 and len(REFERENCES) >= 3


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_side_import(path):
    bad = set(roots(path)) & {"jax", "jaxlib", "ml_dtypes", "flax", "repro"}
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = set(roots(path))
    assert found <= {"__future__", "math", "torch", "portbench"}, found
    text = path.read_text()
    assert "repro_torch" not in text


def test_prefix_is_not_a_match(tmp_path):
    # repro_torch begins with repro: the check compares whole names
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch\nfrom repro_torch.models import x\n")
    assert set(roots(probe)) == {"repro_torch"}
