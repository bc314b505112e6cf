"""Registry mapping catalog slugs to the port's Faust modules."""
from __future__ import annotations

from typing import Dict, Optional

from .faustmods import GTS, VAR, ClickBeGoneSG, FaustModule, ModTilt, RED

FAUST_MODULES: Dict[str, type] = {
    "GTS": GTS,
    "ModTilt": ModTilt,
    "RED": RED,
    "ClickBeGoneSG": ClickBeGoneSG,
    "VAR": VAR,
}


def get_faust_module(slug: str) -> Optional[FaustModule]:
    cls = FAUST_MODULES.get(slug)
    return cls() if cls is not None else None
