"""Decorator registries for models, heads, attention, aggregation and
resolvers.

Port of linnaeus_tpu/models/factory.py (reference: models/model_factory.py):
a registry maps the TYPE string of a config to the ``torch.nn.Module``
class that builds it. ``register_*``, ``create_*`` and ``list_*`` keep the
JAX package's names. The registries fill when their modules are imported;
:func:`_load_registered` imports them all, so ``list_*`` and ``create_*``
see every entry whichever module was imported first.
"""

from __future__ import annotations

from typing import Any, Callable

from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()

MODEL_REGISTRY: dict[str, Callable] = {}
HEAD_REGISTRY: dict[str, Callable] = {}
ATTENTION_REGISTRY: dict[str, Callable] = {}
AGGREGATION_REGISTRY: dict[str, Callable] = {}
RESOLVER_REGISTRY: dict[str, Callable] = {}

_REGISTRIES = {
    "model": MODEL_REGISTRY,
    "head": HEAD_REGISTRY,
    "attention": ATTENTION_REGISTRY,
    "aggregation": AGGREGATION_REGISTRY,
    "resolver": RESOLVER_REGISTRY,
}


def _load_registered() -> None:
    """Import every module that registers an entry."""
    from linnaeus_tpu_torch.models import aggregation, mformer_v0, mformer_v1  # noqa: F401
    from linnaeus_tpu_torch.models.attention import zoo  # noqa: F401
    from linnaeus_tpu_torch.models.heads import heads  # noqa: F401


def _register(kind: str, name: str):
    registry = _REGISTRIES[kind]

    def decorator(cls_or_fn):
        if name in registry and registry[name] is not cls_or_fn:
            logger.warning(f"Overwriting {kind} registry entry '{name}'")
        registry[name] = cls_or_fn
        return cls_or_fn

    return decorator


def register_model(name: str):
    return _register("model", name)


def register_head(name: str):
    return _register("head", name)


def register_attention(name: str):
    return _register("attention", name)


def register_aggregation(name: str):
    return _register("aggregation", name)


def register_resolver(name: str):
    return _register("resolver", name)


def _create(kind: str, label: str, name: str, *args: Any, **kwargs: Any):
    _load_registered()
    registry = _REGISTRIES[kind]
    if name not in registry:
        raise ValueError(f"Unknown {label} '{name}'. Available: {sorted(registry)}")
    return registry[name](*args, **kwargs)


def create_model(model_type: str, *args: Any, **kwargs: Any):
    return _create("model", "model type", model_type, *args, **kwargs)


def create_head(head_type: str, *args: Any, **kwargs: Any):
    return _create("head", "head type", head_type, *args, **kwargs)


def create_attention(name: str, *args: Any, **kwargs: Any):
    return _create("attention", "attention type", name, *args, **kwargs)


def create_aggregation(name: str, *args: Any, **kwargs: Any):
    return _create("aggregation", "aggregation type", name, *args, **kwargs)


def create_resolver(name: str, *args: Any, **kwargs: Any):
    return _create("resolver", "resolver type", name, *args, **kwargs)


def _list(kind: str) -> list[str]:
    _load_registered()
    return sorted(_REGISTRIES[kind])


def list_models() -> list[str]:
    return _list("model")


def list_heads() -> list[str]:
    return _list("head")


def list_attention() -> list[str]:
    return _list("attention")


def list_aggregations() -> list[str]:
    return _list("aggregation")


def list_resolvers() -> list[str]:
    return _list("resolver")
