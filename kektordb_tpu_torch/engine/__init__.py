from .engine import Engine, EngineConfig  # noqa: F401
