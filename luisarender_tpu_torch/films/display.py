"""Display film: a tonemapped preview of the accumulating image.

Counterpart of luisarender_tpu/films/display.py: the color film with a tone
map (none, uncharted2, aces) whose preview is written after accumulation
passes, at most `target_fps` times a second, to `preview_file` (an sRGB
PNG, or a linear EXR with `hdr`) and, with `serve: true`, pushed to a live
HTTP viewer (films/live_server.py) on 127.0.0.1:`port`. The preview is
developed, tonemapped and encoded on the accumulation's device and copied
to the host once a preview.
"""

from __future__ import annotations

import time

from ..core import colorspace
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..utils import imageio
from .base import ColorFilm


@register(SceneNodeTag.FILM, "display", "Display")
class DisplayFilm(ColorFilm):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        tonemap = desc.string("tone_mapping", "none").lower()
        if tonemap not in colorspace.TONEMAP_OPERATORS:
            raise ValueError(
                f"unknown tone mapping '{tonemap}'; "
                f"choose {sorted(colorspace.TONEMAP_OPERATORS)}"
            )
        self.tonemap = tonemap
        self.preview_file = desc.string("preview_file", "preview.png")
        target_fps = desc.float("target_fps", 1.0)
        self.min_interval = 1.0 / max(target_fps, 1e-3)
        self.hdr = desc.bool("hdr", False)
        self._last_preview = 0.0
        self._spp_seen = 0
        self._server = None
        if desc.bool("serve", False):
            from .live_server import LiveServer

            self._server = LiveServer(port=desc.int("port", 8090))
            print(f"[display] live viewer: http://127.0.0.1:{self._server.port}/", flush=True)

    def maybe_preview(self, accum):
        """Called after each pass by the progressive loop; writes a preview
        where min_interval has passed since the last."""
        self._spp_seen += 1
        now = time.time()
        if now - self._last_preview >= self.min_interval:
            self._last_preview = now
            self.write_preview(accum)

    def write_preview(self, accum):
        mapped = colorspace.TONEMAP_OPERATORS[self.tonemap](self.develop(accum))
        encoded = None
        if self._server is not None or not self.hdr:
            encoded = colorspace.srgb_encode(mapped).cpu().numpy()
        if self._server is not None:
            self._server.push(imageio.png_bytes(encoded), spp=self._spp_seen)
        if self.hdr:
            imageio.save_exr(self.preview_file, mapped.cpu().numpy())
        else:
            imageio.save_png(self.preview_file, encoded)
