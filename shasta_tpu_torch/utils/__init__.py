from .config import Config, ConfigDict  # noqa: F401
from .registry import Registry, build_from_cfg  # noqa: F401
