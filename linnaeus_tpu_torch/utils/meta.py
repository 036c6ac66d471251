"""Metadata component helpers.

Copy of linnaeus_tpu/utils/meta.py (upstream parity: utils/meta_utils.py):
the enabled ``DATA.META.COMPONENTS`` in their ``IDX`` order and their slices
of the packed aux vector.
"""

from __future__ import annotations


def get_enabled_meta_components(config) -> list[tuple[str, dict]]:
    """Enabled metadata components ordered by their IDX, as (name, cfg) pairs."""
    items = []
    meta = config.DATA.get("META")
    if not meta or not meta.get("ACTIVE", False):
        return items
    components = meta.get("COMPONENTS")
    if not components:
        return items
    for comp_name, comp_cfg in components.items():
        if isinstance(comp_cfg, dict) and comp_cfg.get("ENABLED", False):
            idx = comp_cfg.get("IDX", -1)
            if idx >= 0:
                items.append((idx, comp_name, comp_cfg))
    items.sort(key=lambda x: x[0])
    return [(name, cfg) for _, name, cfg in items]


def compute_meta_chunk_bounds(config) -> list[tuple[int, int]]:
    """(start, end) slice per enabled metadata component in the packed aux vector."""
    bounds = []
    offset = 0
    for _name, comp_cfg in get_enabled_meta_components(config):
        dim = int(comp_cfg.get("DIM", 0))
        bounds.append((offset, offset + dim))
        offset += dim
    return bounds


def compute_meta_chunk_bounds_by_name(config) -> dict[str, tuple[int, int]]:
    """Named variant of :func:`compute_meta_chunk_bounds`."""
    out = {}
    offset = 0
    for name, comp_cfg in get_enabled_meta_components(config):
        dim = int(comp_cfg.get("DIM", 0))
        out[name] = (offset, offset + dim)
        offset += dim
    return out


def total_meta_dim(config) -> int:
    return sum(
        int(cfg.get("DIM", 0)) for _, cfg in get_enabled_meta_components(config)
    )
