"""The spectrum node base class and the sRGB (fixed tristimulus) node.

Counterpart of luisarender_tpu/spectra/srgb.py.
"""

from __future__ import annotations

from ..core.spectrum import SRGBSpectrum
from ..scene.node import SceneNodeTag
from ..scene.registry import register
from ..scene.scene import SceneNode


class Spectrum(SceneNode):
    """Host node wrapping a core SpectrumModel."""

    def model(self):
        raise NotImplementedError


@register(SceneNodeTag.SPECTRUM, "srgb", "sRGB", "rgb", "RGB")
class SRGBSpectrumNode(Spectrum):
    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self._model = SRGBSpectrum()

    def model(self):
        return self._model
