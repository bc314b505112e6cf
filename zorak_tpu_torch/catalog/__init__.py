from .discovery import (  # noqa: F401
    CatalogError, PluginSpec, discover, load_spec, match, select,
)
