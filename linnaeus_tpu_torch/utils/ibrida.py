"""Taxonomic rank-level naming helper.

Reference parity: ibrida/ancestral_levels.py:5-148 (AncestralLevels) —
conversions between rank-level numbers (10 = species ... 70 = kingdom,
half-levels like 33.5 scaled x10), task keys, and human rank names.

A copy of linnaeus_tpu/utils/ibrida.py, which imports no
JAX: the port imports nothing of the TPU package
(tests/test_torch_data_tools.py holds the two together).
"""

from __future__ import annotations

# major ranks by level value (x10 scaled integers, e.g. L10 = species)
RANK_NAMES: dict[int, str] = {
    10: "species",
    20: "genus",
    25: "subtribe",
    26: "tribe",
    27: "supertribe",
    30: "family",
    33: "superfamily",
    32: "infraorder",
    34: "suborder",
    40: "order",
    43: "superorder",
    44: "infraclass",
    45: "subclass",
    50: "class",
    53: "superclass",
    54: "subphylum",
    57: "subkingdom",
    60: "phylum",
    70: "kingdom",
}


class AncestralLevels:
    """Ordered rank levels for a dataset's task keys."""

    def __init__(self, task_keys: list[str]):
        self.task_keys = list(task_keys)
        self.levels = [self.level_of(t) for t in self.task_keys]

    @staticmethod
    def level_of(task_key: str) -> int:
        numeric = task_key.split("_L")[-1]
        return int("".join(ch for ch in numeric if ch.isdigit()))

    @staticmethod
    def task_key_of(level: int) -> str:
        return f"taxa_L{level}"

    @staticmethod
    def rank_name(level: int) -> str:
        return RANK_NAMES.get(level, f"L{level}")

    def names(self) -> list[str]:
        return [self.rank_name(lv) for lv in self.levels]

    def finest(self) -> str:
        return self.task_keys[0]

    def coarsest(self) -> str:
        return self.task_keys[-1]

    def __repr__(self) -> str:
        pairs = ", ".join(
            f"{t}={self.rank_name(lv)}" for t, lv in zip(self.task_keys, self.levels)
        )
        return f"AncestralLevels({pairs})"
