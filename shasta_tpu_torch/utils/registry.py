"""Light registry + build_from_cfg: the port's copy of
shasta_tpu/utils/registry.py (pure Python).

Behavioral reference: det3d/utils/registry.py:6-80. In this framework most
construction is explicit (pure functions + dataclasses), but the registry
is kept for config-driven component selection (datasets, trackers, models)
so `dict(type="Shasta", ...)` style configs keep working.
"""
from __future__ import annotations

from typing import Any, Callable


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._module_dict: dict[str, Callable] = {}

    def get(self, key: str):
        return self._module_dict.get(key)

    def register_module(self, cls=None, *, name: str | None = None):
        def _register(c):
            self._module_dict[name or c.__name__] = c
            return c

        if cls is None:
            return _register
        return _register(cls)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self):
        return f"Registry({self.name}, {sorted(self._module_dict)})"


def build_from_cfg(cfg: dict, registry: Registry, default_args: dict | None = None) -> Any:
    assert isinstance(cfg, dict) and "type" in cfg, cfg
    args = dict(cfg)
    obj_type = args.pop("type")
    cls = registry.get(obj_type)
    if cls is None:
        raise KeyError(f"{obj_type} not in {registry}")
    if default_args:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return cls(**args)


# Framework registries
DATASETS = Registry("datasets")
MODELS = Registry("models")
TRACKERS = Registry("trackers")
