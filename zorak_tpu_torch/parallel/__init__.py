from .batch import (  # noqa: F401
    BatchRenderer, FaustBatchRenderer, build_catalog_renderers,
    catalog_batch_render, catalog_stacked_render, render_batch,
)
