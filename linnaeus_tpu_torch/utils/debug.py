"""Hierarchical debug-flag lookup (reference parity: utils/debug_utils.py:14).

Copy of linnaeus_tpu/utils/debug.py (held against the original by
tests/test_torch_trainer.py).

Flags live under ``cfg.DEBUG`` as a dotted path, e.g. ``check_debug_flag(cfg,
"DEBUG.LOSS.NULL_MASKING")``. Missing paths are treated as False.
"""

from __future__ import annotations

from typing import Any


def check_debug_flag(config: Any, flag_path: str) -> bool:
    """Return the boolean value at a dotted config path, defaulting to False."""
    if config is None or not flag_path:
        return False
    node = config
    for part in flag_path.split("."):
        if node is None:
            return False
        if hasattr(node, "get"):
            node = node.get(part, None)
        else:
            node = getattr(node, part, None)
    return bool(node) if isinstance(node, (bool, int)) else False
