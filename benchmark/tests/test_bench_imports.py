"""Nothing under benchmark/ imports JAX or the JAX package (the top-level
module name compared whole, so the port's name passes), and the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast

from benchmark import common

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "linnaeus_tpu"}


def imported(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    return sorted(common.ROOT.rglob("*.py"))


def test_no_file_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(common.ROOT)): imported(p) & BANNED for p in sources()}
    assert {k: v for k, v in found.items() if v} == {}


def test_the_port_passes_the_whole_name_comparison():
    assert "linnaeus_tpu_torch" not in BANNED
    assert any("linnaeus_tpu_torch" in imported(p) for p in sources())


def test_the_reference_imports_nothing_of_the_program():
    ref = sorted((common.ROOT / "reference").rglob("*.py"))
    assert ref
    for p in ref:
        assert not imported(p) & (BANNED | {"linnaeus_tpu_torch"}), p
