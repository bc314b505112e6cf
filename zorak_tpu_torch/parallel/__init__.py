from .batch import FaustBatchRenderer  # noqa: F401
