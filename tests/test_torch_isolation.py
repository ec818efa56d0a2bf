"""The port stands apart from the JAX package: no module under
``nerfstudio_torch/`` and not ``chip_smoke.py`` imports ``jax`` or
``nerfstudio_tpu``, read from their import statements (docstrings and
comments may name them)."""

import ast
from pathlib import Path

import pytest
import _torch_port  # noqa: F401  (caps torch's threads per xdist worker)

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "nerfstudio_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerfstudio_tpu")


def imported_modules(path: Path):
    """Every module an import statement in ``path`` names, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_import(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_sees_imports():
    assert len(SOURCES) > 60
    assert "nerfstudio_torch.ops.hash_grid" in set(imported_modules(REPO / "chip_smoke.py"))
    assert "torch" in set(imported_modules(REPO / "nerfstudio_torch" / "engine" / "trainer.py"))
