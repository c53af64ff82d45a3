from .filter import Filter  # noqa: F401
