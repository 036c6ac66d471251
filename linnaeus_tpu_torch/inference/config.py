"""Inference-handler configuration as dataclasses.

Port of linnaeus_tpu/inference/config.py with the same sections and field
names (ModelConfig / InputConfig / MetaConfig / TaxonomyConfig /
InferenceOptionsConfig), so the same bundle YAMLs describe both handlers.
YAML is read only by :func:`load_inference_config`, which imports it there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class ModelConfig:
    architecture_name: str
    weights_path: str
    model_task_keys_ordered: list[str]
    num_classes_per_task: list[int]
    null_class_indices: dict[str, int]
    architecture_variant_config_path: str | None = None
    expected_aux_vector_length: int | None = None


@dataclass
class InputConfig:
    image_size: list[int] = field(default_factory=lambda: [3, 224, 224])
    image_mean: list[float] = field(default_factory=lambda: [0.485, 0.456, 0.406])
    image_std: list[float] = field(default_factory=lambda: [0.229, 0.224, 0.225])
    image_interpolation: str = "bilinear"

    def __post_init__(self):
        if not (len(self.image_size) == 3 and self.image_size[0] in (1, 3)):
            raise ValueError("image_size must be [C, H, W] with C in {1, 3}")


@dataclass
class MetaConfig:
    use_geolocation: bool = True
    use_temporal: bool = True
    temporal_use_julian_day: bool = False
    temporal_use_hour: bool = False
    use_elevation: bool = True
    elevation_scales: list[float] = field(default_factory=lambda: [100.0, 1000.0, 5000.0])


@dataclass
class TaxonomyConfig:
    taxonomy_tree_path: str
    class_index_map_path: str
    source_name: str = "CoL2024"
    version: str | None = None
    root_identifier: Any | None = None


@dataclass
class InferenceOptionsConfig:
    default_top_k: int = 5
    device: str = "auto"
    batch_size: int = 8
    enable_hierarchical_consistency_check: bool = True
    handler_version: str = "0.1.0"
    artifacts_source_uri: str | None = None
    # this port serves on one device: "auto", 1, "1", "off", False or None
    data_parallel: int | str | bool | None = "auto"

    def __post_init__(self):
        if self.default_top_k <= 0 or self.batch_size <= 0:
            raise ValueError("default_top_k and batch_size must be positive")


@dataclass
class InferenceConfig:
    model: ModelConfig
    input_preprocessing: InputConfig
    metadata_preprocessing: MetaConfig
    taxonomy_data: TaxonomyConfig
    inference_options: InferenceOptionsConfig
    model_description: str | None = None

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "InferenceConfig":
        """Build from the nested dict a bundle YAML holds; unknown keys raise."""
        sections = {
            "model": ModelConfig,
            "input_preprocessing": InputConfig,
            "metadata_preprocessing": MetaConfig,
            "taxonomy_data": TaxonomyConfig,
            "inference_options": InferenceOptionsConfig,
        }
        unknown = set(raw) - set(sections) - {"model_description"}
        if unknown:
            raise ValueError(f"unknown inference config sections: {sorted(unknown)}")
        return cls(
            **{name: kind(**raw[name]) for name, kind in sections.items()},
            model_description=raw.get("model_description"),
        )

    def aux_vector_length(self) -> int:
        """Packed aux width: the explicit override, else derived from the
        enabled metadata components."""
        if self.model.expected_aux_vector_length is not None:
            return int(self.model.expected_aux_vector_length)
        mc = self.metadata_preprocessing
        return (
            (4 if mc.temporal_use_hour else 2) * int(mc.use_temporal)
            + 3 * int(mc.use_geolocation)
            + 2 * len(mc.elevation_scales) * int(mc.use_elevation)
        )


def load_inference_config(config_path: str | Path) -> InferenceConfig:
    """Read a bundle's config YAML (needs the ``yaml`` package)."""
    import yaml

    config_path = Path(config_path)
    if not config_path.is_file():
        raise FileNotFoundError(f"Inference config not found: {config_path}")
    with open(config_path) as f:
        raw = yaml.safe_load(f)
    return InferenceConfig.from_dict(raw)
