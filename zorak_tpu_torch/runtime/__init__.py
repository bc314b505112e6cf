from . import wavio  # noqa: F401
