from .interpreter import DrawCmd, GfxCanvas, GfxSession, GfxVM
