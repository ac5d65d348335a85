"""The port stands alone: no module of ``fedml_tpu_torch`` and no line of
``chip_smoke.py`` imports JAX, flax, optax or the JAX package — checked on
the source, so a lazy import inside a function counts too."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fedml_tpu"}
SOURCES = sorted(p.relative_to(REPO).as_posix() for p in
                 (REPO / "fedml_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_port_has_modules_to_check():
    for rel in ("ops/epilogue.py", "ops/pallas_attention.py",
                "models/nlp.py", "data/natural.py", "data/tff_text.py"):
        assert f"fedml_tpu_torch/{rel}" in SOURCES
    assert len(SOURCES) >= 15


@pytest.mark.parametrize("rel", SOURCES)
def test_no_jax_import(rel):
    tree = ast.parse((REPO / rel).read_text(encoding="utf-8"), filename=rel)
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{rel} imports {bad}"
