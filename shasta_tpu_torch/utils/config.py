"""Python-file config loader with attribute access: the port of
shasta_tpu/utils/config.py.

Behavioral reference: det3d/torchie/utils/config.py:51-136 (Config.fromfile
executing a python module and exposing its top-level names as nested
attribute-accessible dicts). The files in configs/nusc/*.py are plain
Python that import only their `_base`, so the port reads them unchanged.
"""
from __future__ import annotations

import importlib.util
import os
import types
from typing import Any


class ConfigDict(dict):
    """dict with recursive attribute access."""

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj

    def get(self, k, default=None):
        return super().get(k, default)


class Config:
    @staticmethod
    def fromfile(path: str) -> ConfigDict:
        path = os.path.abspath(path)
        spec = importlib.util.spec_from_file_location("_shasta_cfg", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfg = {
            k: v
            for k, v in vars(mod).items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, types.ModuleType)
        }
        out = ConfigDict.wrap(cfg)
        out["_config_path"] = path
        return out
