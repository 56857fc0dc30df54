"""A minimal yacs-style config node (counterpart of
``mega_pytorch_tpu/config/node.py``): attribute access, YAML merge,
dotted-list merge, freeze and clone, so the repo's ``configs/**/*.yaml`` and
CLI opts written for the JAX package load unchanged.

``yaml`` is imported only where a YAML file is read or dumped, or a CLI
value is parsed, so the modules import without it.
"""

from __future__ import annotations

import ast
import copy
from typing import Any


class ConfigNode(dict):
    """Nested dict with attribute access, freezing, and yaml/list merging."""

    _FROZEN = "_is_frozen"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, ConfigNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode._FROZEN):
            raise AttributeError(f"ConfigNode is frozen; cannot set {name}")
        self[name] = ConfigNode(value) if isinstance(value, dict) else value

    # -- freezing ----------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, ConfigNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, ConfigNode._FROZEN)

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = ConfigNode()
        for k, v in self.items():
            out[k] = copy.deepcopy(v, memo)
        object.__setattr__(out, ConfigNode._FROZEN, False)
        return out

    # -- merging -----------------------------------------------------------
    def merge_from_other(self, other: dict) -> None:
        for k, v in other.items():
            if k not in self:
                raise KeyError(f"Unknown config key: {k}")
            if isinstance(v, dict):
                if not isinstance(self[k], ConfigNode):
                    raise TypeError(f"Cannot merge dict into non-dict key {k}")
                self[k].merge_from_other(v)
            else:
                self[k] = _coerce(v, self[k], k)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        if data:
            self.merge_from_other(data)

    def merge_from_list(self, opts: list) -> None:
        if len(opts) % 2:
            raise ValueError(f"opts must be key/value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, str):
                import yaml

                try:
                    value = yaml.safe_load(value)
                except yaml.YAMLError:
                    pass
            node[leaf] = _coerce(value, node[leaf], key)

    def dump(self) -> str:
        import yaml

        def to_plain(node):
            return {
                k: to_plain(v) if isinstance(v, ConfigNode) else v
                for k, v in node.items()
            }

        return yaml.safe_dump(to_plain(self), sort_keys=True)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Cast merged value to the default's container type.

    yaml has no tuples, and yacs-style files write tuples as "(a, b)" strings —
    parse those with ast.literal_eval like yacs does.
    """
    if isinstance(old, tuple) and isinstance(value, (list, str)):
        if isinstance(value, str):
            value = ast.literal_eval(value)
            if not isinstance(value, (list, tuple)):
                value = (value,)
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if (
        old is not None
        and value is not None
        and not isinstance(value, type(old))
        and not isinstance(old, type(value))
        and not (isinstance(old, (int, float)) and isinstance(value, (int, float)))
    ):
        raise TypeError(
            f"Type mismatch for {key}: default {type(old).__name__}, got {type(value).__name__}"
        )
    return value
