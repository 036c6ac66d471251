"""The port stands on torch alone: no module of linnaeus_tpu_torch and not
chip_smoke.py imports jax, flax, optax, orbax or the JAX package.

Every import statement is read from the syntax tree, so an import inside a
function counts too.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "linnaeus_tpu"}
FILES = sorted((REPO / "linnaeus_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_walk_finds_the_port():
    names = {p.relative_to(REPO).as_posix() for p in FILES}
    assert {"chip_smoke.py", "linnaeus_tpu_torch/train/step.py",
            "linnaeus_tpu_torch/ops/flash_attention.py",
            "linnaeus_tpu_torch/ops/fused_dwconv_mlp.py",
            "linnaeus_tpu_torch/tools/fused_block_ab.py"} <= names
    assert len(FILES) > 32


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_import(path):
    bad = imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_the_check_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from linnaeus_tpu.ops import rope\n    import jax.numpy as jnp\n"
                     "import linnaeus_tpu_torch\n")
    assert imported_roots(probe) & FORBIDDEN == {"linnaeus_tpu", "jax"}
