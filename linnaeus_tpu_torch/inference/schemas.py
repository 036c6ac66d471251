"""Result and request schemas as dataclasses.

Port of linnaeus_tpu/inference/schemas.py with the same field names, so a
result serialises to the same JSON shape (``dataclasses.asdict``). The
conversion to the optional ``typus`` models is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class TaskPrediction:
    rank_level: int  # numeric rank level, e.g. 10 for taxa_L10
    task_key: str
    # (taxon_id, probability) pairs, sorted by descending probability
    predictions: list[tuple[int, float]]


@dataclass
class HierarchicalClassificationResult:
    taxonomy_context: dict[str, Any] = field(default_factory=dict)
    tasks: list[TaskPrediction] = field(default_factory=list)


@dataclass
class InferenceRequestMetadata:
    """Per-request options."""

    top_k: int | None = None
    aux_override: list[float] | None = None


@dataclass
class ModelInformation:
    """The ``info()`` payload."""

    handler_version: str
    architecture_name: str
    task_keys: list[str]
    num_classes_per_task: list[int]
    input_image_size: list[int]
    metadata_components: dict[str, bool]
    taxonomy_source: str
    default_top_k: int
    model_description: str | None = None
