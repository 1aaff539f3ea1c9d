"""luisarender_tpu_torch — the luisarender_tpu renderer on PyTorch and CUDA.

A port of the JAX package `luisarender_tpu` (which stays the reference) to
PyTorch, with its TPU kernels rewritten by hand for NVIDIA Hopper. It keeps
the reference's module layout and names, imports neither JAX nor anything
of the reference, and has its own plugin registry.

    import luisarender_tpu_torch as lt
    scene = lt.load_scene("scenes/cornell.json")
    images = lt.render(scene)                  # {file: np array}, on cuda:0
    images = lt.render(scene, device="cpu")    # plain PyTorch on the CPU

Entry points run on the first CUDA card unless the caller passes
device="cpu"; without a card they raise RuntimeError.
"""

from __future__ import annotations

__version__ = "0.1.0"

# plugin modules register themselves on import
from .cameras import impls as _cam_impls  # noqa: F401
from .cameras import pinhole as _pinhole  # noqa: F401
from .environments import impls as _env_impls  # noqa: F401
from .environments import spherical as _env_spherical  # noqa: F401
from .films import base as _films  # noqa: F401
from .films import display as _film_display  # noqa: F401
from .filters import impls as _filters  # noqa: F401
from .integrators import aux as _int_aux  # noqa: F401
from .integrators import gpt as _int_gpt  # noqa: F401
from .integrators import mega_path as _int_mega  # noqa: F401
from .integrators import mega_vpt as _int_vpt  # noqa: F401
from .integrators import megapm as _int_pm  # noqa: F401
from .integrators import pssmlt as _int_pssmlt  # noqa: F401
from .integrators import wave_path as _int_wave  # noqa: F401
from .lights import diffuse as _light_diffuse  # noqa: F401
from .lightsamplers import uniform as _ls_uniform  # noqa: F401
from .media import base as _media_base  # noqa: F401
from .media import grid as _media_grid  # noqa: F401
from .phasefunctions import hg as _phase_hg  # noqa: F401
from .samplers import base as _samplers  # noqa: F401
from .samplers import lds as _samplers_lds  # noqa: F401
from .shapes import impls as _shapes  # noqa: F401
from .shapes import loop_subdiv as _shape_loop  # noqa: F401
from .spectra import hero as _spec_hero  # noqa: F401
from .spectra import srgb as _spec_srgb  # noqa: F401
from .surfaces import disney as _surf_disney  # noqa: F401
from .surfaces import glass as _surf_glass  # noqa: F401
from .surfaces import layered as _surf_layered  # noqa: F401
from .surfaces import matte as _surf_matte  # noqa: F401
from .surfaces import metal as _surf_metal  # noqa: F401
from .surfaces import mirror as _surf_mirror  # noqa: F401
from .surfaces import mix as _surf_mix  # noqa: F401
from .surfaces import null as _surf_null  # noqa: F401
from .surfaces import plastic as _surf_plastic  # noqa: F401
from .textures import constant as _tex_constant  # noqa: F401
from .textures import image as _tex_image  # noqa: F401
from .textures import procedural as _tex_procedural  # noqa: F401
from .textures import sky as _tex_sky  # noqa: F401
from .texturemappings import impls as _tex_mappings  # noqa: F401
from .transforms import all as _transforms  # noqa: F401

from .core.device import resolve_device
from .scene.compiler import CompiledScene, compile_scene  # noqa: F401
from .scene.scene import Scene


def load_scene(path, macros=None) -> Scene:
    """Parse and materialize a scene file (JSON or the .luisa text SDL);
    `macros` overrides the text format's `define`s."""
    return Scene.from_file(path, macros)


def render(scene: Scene, save: bool = False, device=None):
    """Compile the scene onto `device` (default: the first CUDA card) and run
    its integrator over all cameras. Returns {camera_output_file:
    np.ndarray (H, W, 3) linear sRGB}."""
    compiled = compile_scene(scene, device=resolve_device(device))
    return scene.integrator.render(compiled, save=save)


def render_file(path, macros=None, save: bool = True, device=None):
    return render(load_scene(path, macros), save=save, device=device)
