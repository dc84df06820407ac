from .config import Config, ConfigDict  # noqa: F401
