"""A minimal, self-contained configuration node.

Copy of linnaeus_tpu/configuration/cfg_node.py (the port imports nothing of
the JAX package; tests/test_torch_configuration.py holds the copy against
its original). API-compatible with the subset of ``yacs.config.CfgNode``
that the upstream framework uses: attribute access, ``clone()``,
``merge_from_file()``, ``merge_from_other_cfg()``, ``merge_from_list()``,
``freeze()/defrost()``, ``dump()``, ``new_allowed`` sections, and ``get()``.
Plain dicts + PyYAML; yacs is not a dependency.
"""

from __future__ import annotations

import copy
from typing import Any

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))

# dict keys reserved for internal bookkeeping; stored via object.__setattr__
_IMMUTABLE = "__immutable__"
_NEW_ALLOWED = "__new_allowed__"


class CfgNode(dict):
    """Config tree node: a dict with attribute access and merge semantics."""

    def __init__(self, init_dict: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, _IMMUTABLE, False)
        object.__setattr__(self, _NEW_ALLOWED, new_allowed)
        if init_dict:
            for k, v in init_dict.items():
                if isinstance(v, dict) and not isinstance(v, CfgNode):
                    v = CfgNode(v, new_allowed=new_allowed)
                self[k] = v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def __delattr__(self, name: str) -> None:
        if object.__getattribute__(self, _IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot delete {name}")
        del self[name]

    def __setitem__(self, key, value):
        if object.__getattribute__(self, _IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- freeze / defrost --------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _IMMUTABLE)

    def is_new_allowed(self) -> bool:
        return object.__getattribute__(self, _NEW_ALLOWED)

    def set_new_allowed(self, flag: bool) -> None:
        object.__setattr__(self, _NEW_ALLOWED, bool(flag))
        for v in self.values():
            if isinstance(v, CfgNode):
                v.set_new_allowed(flag)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, _IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    # -- clone / merge -----------------------------------------------------
    def clone(self) -> CfgNode:
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        out._set_immutable(False)
        return out

    def merge_from_other_cfg(self, other: CfgNode | dict) -> None:
        _merge_a_into_b(other, self)

    def merge_from_file(self, cfg_filename: str) -> None:
        with open(cfg_filename) as f:
            loaded = yaml.safe_load(f) or {}
        _merge_a_into_b(loaded, self)

    def merge_from_list(self, cfg_list: list) -> None:
        """Merge ``["KEY.SUBKEY", value, ...]`` pairs (the --opts mechanism)."""
        if len(cfg_list) % 2 != 0:
            raise ValueError(f"Override list has odd length: {cfg_list}")
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            key_parts = full_key.split(".")
            d = self
            for sub in key_parts[:-1]:
                if sub not in d:
                    raise KeyError(f"Non-existent config key: {full_key}")
                d = d[sub]
            last = key_parts[-1]
            if last not in d and not d.is_new_allowed():
                raise KeyError(f"Non-existent config key: {full_key}")
            value = _decode_value(v)
            if last in d:
                value = _check_and_coerce(value, d[last], full_key)
            d[last] = value

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump(self, **kwargs) -> str:
        kwargs.setdefault("default_flow_style", False)
        kwargs.setdefault("sort_keys", False)
        return yaml.safe_dump(self.to_dict(), **kwargs)

    def __str__(self) -> str:
        return self.dump()

    def __repr__(self) -> str:
        return f"CfgNode({super().__repr__()})"

    @classmethod
    def load_cfg(cls, yaml_str_or_file) -> CfgNode:
        if hasattr(yaml_str_or_file, "read"):
            data = yaml.safe_load(yaml_str_or_file.read())
        else:
            data = yaml.safe_load(yaml_str_or_file)
        return cls(data or {})


def _decode_value(v: Any) -> Any:
    """Decode a possibly string-encoded python literal (for --opts)."""
    if not isinstance(v, str):
        return v
    try:
        import ast

        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _check_and_coerce(new: Any, old: Any, full_key: str) -> Any:
    """Coerce new value to old value's type when safely convertible."""
    if old is None or new is None:
        return new
    if type(new) is type(old):
        return new
    # permissive casts mirroring yacs behavior
    casts = [(tuple, list), (list, tuple), (int, float), (float, int), (bool, int)]
    for src, dst in casts:
        if isinstance(new, src) and isinstance(old, dst):
            return dst(new)
    if isinstance(old, bool) and isinstance(new, str):
        if new.lower() in ("true", "1", "yes"):
            return True
        if new.lower() in ("false", "0", "no"):
            return False
    raise ValueError(
        f"Type mismatch for key {full_key}: cannot merge {type(new).__name__} "
        f"into {type(old).__name__}"
    )


def _merge_a_into_b(a: dict, b: CfgNode, path: str = "") -> None:
    if a is None:
        return
    for k, v in a.items():
        full_key = f"{path}.{k}" if path else str(k)
        if k in b:
            old = b[k]
            if isinstance(old, CfgNode):
                if isinstance(v, dict):
                    _merge_a_into_b(v, old, full_key)
                else:
                    raise ValueError(
                        f"Cannot merge non-dict into config section {full_key}"
                    )
            else:
                if isinstance(v, dict):
                    b[k] = CfgNode(v)
                else:
                    b[k] = _check_and_coerce(_decode_value(v), old, full_key)
        else:
            if not b.is_new_allowed():
                raise KeyError(f"Non-existent config key: {full_key}")
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                b[k] = CfgNode(v, new_allowed=True)
            else:
                b[k] = copy.deepcopy(v)


# Convenience alias mirroring `from yacs.config import CfgNode as CN`
CN = CfgNode
