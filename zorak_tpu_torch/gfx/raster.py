"""Software raster backend for the @gfx VM.

The reference interpreter draws into a juce::Image per surface
(ref: src/YSFXGfxInterpreter.h — main framebuffer + gfx_dest offscreen
images, blit between them, gfx_getpixel readback).  This is the numpy
equivalent: float32 RGB surfaces, primitives rasterized immediately, so
gfx_getpixel / gfx_blit read real pixels.  Coordinates truncate to
integer pixels; additive mode honors the low bit of gfx_mode like the
reference's classic blend flag.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class Surface:
    def __init__(self, w: int, h: int):
        self.w = max(0, int(w))
        self.h = max(0, int(h))
        self.buf = np.zeros((self.h, self.w, 3), dtype=np.float32)

    def resize(self, w: int, h: int) -> None:
        w, h = max(0, int(w)), max(0, int(h))
        if (w, h) == (self.w, self.h):
            return
        nb = np.zeros((h, w, 3), dtype=np.float32)
        ch, cw = min(h, self.h), min(w, self.w)
        nb[:ch, :cw] = self.buf[:ch, :cw]
        self.w, self.h, self.buf = w, h, nb


class Raster:
    """Surface registry: -1 = main framebuffer, >=0 offscreen images."""

    def __init__(self) -> None:
        self.surfaces: Dict[int, Surface] = {}

    def main(self, w: int, h: int) -> Surface:
        s = self.surfaces.get(-1)
        if s is None:
            s = Surface(w, h)
            self.surfaces[-1] = s
        elif (s.w, s.h) != (int(w), int(h)):
            s.resize(w, h)
        return s

    def image(self, idx: int, create: bool = False) -> Optional[Surface]:
        idx = int(idx)
        s = self.surfaces.get(idx)
        if s is None and create:
            s = Surface(0, 0)
            self.surfaces[idx] = s
        return s

    def dest(self, dest_idx: float) -> Optional[Surface]:
        i = int(dest_idx)
        if i < 0:
            return self.surfaces.get(-1)
        return self.image(i, create=True)

    # -- primitive rasterization ---------------------------------------------

    @staticmethod
    def _blend(dst_view, color, alpha: float, additive: bool) -> None:
        c = np.asarray(color, dtype=np.float32)
        a = np.float32(max(0.0, min(1.0, alpha)))
        if additive:
            dst_view += c * a
        else:
            dst_view *= (1.0 - a)
            dst_view += c * a

    def fill_rect(self, s: Surface, x, y, w, h, color, alpha, additive,
                  fill=True) -> None:
        if s is None or s.w == 0 or s.h == 0:
            return
        x0, y0 = int(x), int(y)
        x1, y1 = int(x + w), int(y + h)
        x0c, y0c = max(0, x0), max(0, y0)
        x1c, y1c = min(s.w, x1), min(s.h, y1)
        if x1c <= x0c or y1c <= y0c:
            return
        if fill:
            self._blend(s.buf[y0c:y1c, x0c:x1c], color, alpha, additive)
        else:
            for (ax0, ay0, ax1, ay1) in ((x0, y0, x1, y0 + 1),
                                         (x0, y1 - 1, x1, y1),
                                         (x0, y0, x0 + 1, y1),
                                         (x1 - 1, y0, x1, y1)):
                bx0, by0 = max(0, ax0), max(0, ay0)
                bx1, by1 = min(s.w, ax1), min(s.h, ay1)
                if bx1 > bx0 and by1 > by0:
                    self._blend(s.buf[by0:by1, bx0:bx1], color, alpha,
                                additive)

    def set_pixel(self, s: Surface, x, y, color, alpha=1.0,
                  additive=False) -> None:
        if s is None:
            return
        xi, yi = int(x), int(y)
        if 0 <= xi < s.w and 0 <= yi < s.h:
            self._blend(s.buf[yi:yi + 1, xi:xi + 1], color, alpha, additive)

    def get_pixel(self, s: Surface, x, y) -> Tuple[float, float, float]:
        if s is None:
            return (0.0, 0.0, 0.0)
        xi, yi = int(x), int(y)
        if 0 <= xi < s.w and 0 <= yi < s.h:
            px = s.buf[yi, xi]
            return (float(px[0]), float(px[1]), float(px[2]))
        return (0.0, 0.0, 0.0)

    def line(self, s: Surface, x0, y0, x1, y1, color, alpha,
             additive) -> None:
        if s is None or s.w == 0 or s.h == 0:
            return
        x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
        n = max(abs(x1 - x0), abs(y1 - y0))
        if n == 0:
            self.set_pixel(s, x0, y0, color, alpha, additive)
            return
        t = np.arange(n + 1, dtype=np.float64) / n
        xs = np.round(x0 + t * (x1 - x0)).astype(np.int64)
        ys = np.round(y0 + t * (y1 - y0)).astype(np.int64)
        ok = (xs >= 0) & (xs < s.w) & (ys >= 0) & (ys < s.h)
        xs, ys = xs[ok], ys[ok]
        if xs.size == 0:
            return
        # dedupe pixel writes so alpha blending stays per-pixel
        keys = ys * s.w + xs
        _, first = np.unique(keys, return_index=True)
        self._blend(s.buf[ys[first], xs[first]], color, alpha, additive)

    def circle(self, s: Surface, cx, cy, r, color, alpha, additive,
               fill=False) -> None:
        if s is None or s.w == 0 or s.h == 0 or r < 0:
            return
        x0 = max(0, int(cx - r) - 1)
        x1 = min(s.w, int(cx + r) + 2)
        y0 = max(0, int(cy - r) - 1)
        y1 = min(s.h, int(cy + r) + 2)
        if x1 <= x0 or y1 <= y0:
            return
        yy, xx = np.mgrid[y0:y1, x0:x1]
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        if fill:
            mask = d2 <= r * r
        else:
            mask = (d2 <= (r + 0.5) ** 2) & (d2 >= (r - 0.5) ** 2)
        view = s.buf[y0:y1, x0:x1]
        sel = view[mask]
        self._blend(sel, color, alpha, additive)
        view[mask] = sel

    def triangle(self, s: Surface, pts, color, alpha, additive) -> None:
        if s is None or s.w == 0 or s.h == 0:
            return
        (ax, ay), (bx, by), (cx, cy) = pts
        x0 = max(0, int(min(ax, bx, cx)))
        x1 = min(s.w, int(max(ax, bx, cx)) + 1)
        y0 = max(0, int(min(ay, by, cy)))
        y1 = min(s.h, int(max(ay, by, cy)) + 1)
        if x1 <= x0 or y1 <= y0:
            return
        yy, xx = np.mgrid[y0:y1, x0:x1]

        def edge(px, py, qx, qy):
            return (qx - px) * (yy - py) - (qy - py) * (xx - px)

        e0, e1, e2 = (edge(ax, ay, bx, by), edge(bx, by, cx, cy),
                      edge(cx, cy, ax, ay))
        mask = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | \
               ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
        view = s.buf[y0:y1, x0:x1]
        sel = view[mask]
        self._blend(sel, color, alpha, additive)
        view[mask] = sel

    def blit(self, dst: Surface, src: Surface, dx, dy, dw, dh,
             sx, sy, sw, sh, alpha, additive) -> None:
        """Nearest-neighbor scaled copy (the reference's gfx_blit without
        rotation; rotation args are recorded in the DrawCmd stream)."""
        if dst is None or src is None or dst.w == 0 or dst.h == 0:
            return
        dw, dh = int(dw), int(dh)
        if dw <= 0 or dh <= 0 or int(sw) <= 0 or int(sh) <= 0:
            return
        xs = (sx + (np.arange(dw) + 0.5) * sw / dw).astype(np.int64)
        ys = (sy + (np.arange(dh) + 0.5) * sh / dh).astype(np.int64)
        xs = np.clip(xs, 0, max(0, src.w - 1))
        ys = np.clip(ys, 0, max(0, src.h - 1))
        patch = src.buf[np.ix_(ys, xs)] if src.w and src.h else None
        if patch is None:
            return
        dx, dy = int(dx), int(dy)
        x0c, y0c = max(0, dx), max(0, dy)
        x1c, y1c = min(dst.w, dx + dw), min(dst.h, dy + dh)
        if x1c <= x0c or y1c <= y0c:
            return
        pv = patch[y0c - dy:y1c - dy, x0c - dx:x1c - dx]
        view = dst.buf[y0c:y1c, x0c:x1c]
        a = np.float32(max(0.0, min(1.0, alpha)))
        if additive:
            view += pv * a
        else:
            view *= (1.0 - a)
            view += pv * a
