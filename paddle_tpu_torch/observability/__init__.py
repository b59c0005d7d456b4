from . import registry, trace

__all__ = ["registry", "trace"]
