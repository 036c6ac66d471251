"""Composable parameter filters over a torch mFormerV1's parameters.

Port of linnaeus_tpu/utils/param_filters.py. A filter is a predicate over
``(path, leaf)``, and the port evaluates it where the TPU package does: on
the parameter's Flax path (``head/head_taxa_L10/Dense_0/kernel``) and on
the parameter viewed in the Flax layout (a Dense kernel (in, out), a
convolution HWIO), both from ``utils/convert.py::jax_layouts``. So the
configs' patterns ("head_", "meta_", "stage3_", "Dense_0") and dimension
bounds select the same parameters as in JAX; the torch names
(``head.taxa_L10.fc.weight``) are never matched against.
``build_filter_from_config`` consumes the EXCLUDE_CONFIG and
PARAMETER_GROUPS filter dicts of the YAMLs. Results are keyed by the torch
parameter name.
"""

from __future__ import annotations

from typing import Any, Callable

from torch import nn

from linnaeus_tpu_torch.utils.convert import jax_layouts

Predicate = Callable[[str, Any], bool]


def name_filter(patterns: list[str]) -> Predicate:
    """True if any pattern is a substring of the Flax path."""

    def pred(path: str, leaf) -> bool:
        return any(p in path for p in patterns)

    return pred


def dimension_filter(min_ndim: int | None = None, max_ndim: int | None = None) -> Predicate:
    def pred(path: str, leaf) -> bool:
        nd = getattr(leaf, "ndim", 0)
        if min_ndim is not None and nd < min_ndim:
            return False
        if max_ndim is not None and nd > max_ndim:
            return False
        return True

    return pred


def and_filter(*preds: Predicate) -> Predicate:
    return lambda path, leaf: all(p(path, leaf) for p in preds)


def or_filter(*preds: Predicate) -> Predicate:
    return lambda path, leaf: any(p(path, leaf) for p in preds)


def not_filter(pred: Predicate) -> Predicate:
    return lambda path, leaf: not pred(path, leaf)


def build_filter_from_config(filter_cfg: dict) -> Predicate:
    """Build a predicate from a filter-config dict. TYPEs: name (PATTERNS),
    dimension (MIN_NDIM / MAX_NDIM), and / or / not (FILTERS)."""
    ftype = str(filter_cfg.get("TYPE", "name")).lower()
    if ftype == "name":
        return name_filter(list(filter_cfg.get("PATTERNS", [])))
    if ftype == "dimension":
        return dimension_filter(filter_cfg.get("MIN_NDIM"), filter_cfg.get("MAX_NDIM"))
    if ftype in ("and", "or"):
        subs = [build_filter_from_config(f) for f in filter_cfg.get("FILTERS", [])]
        return and_filter(*subs) if ftype == "and" else or_filter(*subs)
    if ftype == "not":
        subs = filter_cfg.get("FILTERS", [])
        if len(subs) != 1:
            raise ValueError("'not' filter requires exactly one sub-filter")
        return not_filter(build_filter_from_config(subs[0]))
    raise ValueError(f"Unknown filter TYPE '{filter_cfg.get('TYPE')}'")


def _leaves(model: nn.Module):
    """(torch name, Flax path, the parameter in the Flax layout) per parameter,
    in the model's order."""
    layouts = jax_layouts(model)
    for name, p in model.named_parameters():
        lay = layouts[name]
        yield name, lay.path, lay.to_jax(p.detach())


def param_labels(model: nn.Module, groups: dict[str, Predicate],
                 default: str = "default") -> dict[str, str]:
    """torch name -> the first group whose predicate matches (group order
    matters), else ``default``."""
    out = {}
    for name, path, leaf in _leaves(model):
        out[name] = next((g for g, pred in groups.items() if pred(path, leaf)), default)
    return out


def param_mask(model: nn.Module, pred: Predicate) -> dict[str, bool]:
    """torch name -> whether the predicate selects the parameter."""
    return {name: bool(pred(path, leaf)) for name, path, leaf in _leaves(model)}


def resolve_gradnorm_exclude(gw_cfg) -> dict:
    """GradNorm exclusion filter: the structured EXCLUDE_CONFIG when it has
    filters, else the legacy EXCLUDE_PATTERNS name list in the same shape."""
    exclude_cfg = gw_cfg.EXCLUDE_CONFIG
    if exclude_cfg.get("FILTERS"):
        return exclude_cfg
    return {
        "TYPE": "or",
        "FILTERS": [{"TYPE": "name", "PATTERNS": list(gw_cfg.get("EXCLUDE_PATTERNS") or [])}],
    }


def trunk_mask_from_exclude(model: nn.Module, exclude_cfg: dict) -> dict[str, bool]:
    """GradNorm trunk mask: True for trunk parameters, False for those that
    ``exclude_cfg`` (LOSS.GRAD_WEIGHTING.TASK.EXCLUDE_CONFIG) excludes."""
    return param_mask(model, not_filter(build_filter_from_config(exclude_cfg)))


def list_matching(model: nn.Module, pred: Predicate) -> list[str]:
    """Sorted Flax paths of the parameters the predicate selects."""
    return sorted(path for _, path, leaf in _leaves(model) if pred(path, leaf))


def filtering_report(model: nn.Module, groups: dict[str, Predicate],
                     default: str = "default", max_examples: int = 8) -> str:
    """Human-readable group assignment: per group, how many tensors and
    parameters matched and example Flax paths, first match wins as in
    :func:`param_labels`. Line for line the TPU package's report."""
    buckets: dict[str, list[tuple[str, int]]] = {}
    for _, path, leaf in _leaves(model):
        label = next((g for g, pred in groups.items() if pred(path, leaf)), default)
        buckets.setdefault(label, []).append((path, int(leaf.numel())))
    total = sum(sz for items in buckets.values() for _, sz in items)
    lines = [f"Parameter filtering report ({total:,} params total):"]
    for gname in list(groups) + [default]:
        items = sorted(buckets.get(gname, []))
        gsize = sum(sz for _, sz in items)
        pct = 100.0 * gsize / total if total else 0.0
        lines.append(f"  [{gname}] {len(items)} tensors, {gsize:,} params ({pct:.1f}%)")
        for p, sz in items[:max_examples]:
            lines.append(f"      {p}  ({sz:,})")
        if len(items) > max_examples:
            lines.append(f"      ... and {len(items) - max_examples} more")
    return "\n".join(lines)
