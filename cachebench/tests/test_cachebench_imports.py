"""No module of the benchmark imports JAX or the JAX package; the
reference imports nothing of the program."""
import ast
import os

import pytest

from cachebench.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "liquid_tpu"}
MODULES = sorted(os.path.relpath(os.path.join(d, f), HERE)
                 for d, _s, fs in os.walk(HERE) for f in fs
                 if f.endswith(".py") and "/_" not in d.replace(HERE, ""))


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("rel", MODULES)
def test_no_jax(rel):
    assert not top_level_imports(os.path.join(HERE, rel)) & FORBIDDEN


@pytest.mark.parametrize("rel", [m for m in MODULES
                                 if m.startswith("reference" + os.sep)])
def test_reference_imports_nothing_of_the_program(rel):
    names = top_level_imports(os.path.join(HERE, rel))
    assert "liquid_tpu_torch" not in names
    assert names <= {"__future__", "datetime", "typing", "pyarrow", "numpy",
                     "cachebench"}


def test_the_check_compares_whole_names():
    # the port's name begins with the JAX package's: it is not forbidden
    assert "liquid_tpu_torch" not in FORBIDDEN
    assert top_level_imports(__file__) >= {"ast", "os", "pytest"}
