"""Medium interface and the vacuum, null and homogeneous media.

Counterpart of luisarender_tpu/media/base.py: the event codes, media
compiled to a parameter table a type (their rows carry the phase
function's g), the homogeneous medium's closed-form transmittance and its
channel-stochastic distance sample, and `dispatch`, which gives each lane
its current medium type's closure. A type whose closures are elementwise
runs on every lane of the call and is selected by tag, as in the
reference; a type that tracks (media/grid.py, `tracks = True`) runs only
on its own lanes, which are gathered out and scattered back, so its
tracking loops step only those lanes. Each lane's result is the same
either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.node import SceneNodeDesc, SceneNodeTag
from ..scene.registry import register
from ..scene.scene import SceneNode
from ..surfaces.base import gather_rows

# medium event codes, as the reference numbers them
EVENT_ABSORB = 0
EVENT_SCATTER = 1
EVENT_NULL = 2
EVENT_HIT_SURFACE = 3

# host reads made by dispatch (a tracking type's lanes) and by the grid's
# tracking loops (their alive flags), a running count
host_reads = 0


def load_phase(scene, desc):
    """The medium's `phase` node, Henyey-Greenstein with g = 0 by default."""
    phase = desc.node("phase")
    if phase is None:
        phase = SceneNodeDesc(identifier="$default_phase",
                              tag=SceneNodeTag.PHASE_FUNCTION,
                              impl_type="henyeygreenstein")
    return scene.load_phase_function(phase)


class Medium(SceneNode):
    # the closures run only on the lanes of their own type (dispatch)
    tracks = False

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.priority = desc.int("priority", 0)

    @property
    def is_null(self) -> bool:
        return False

    @property
    def is_vacuum(self) -> bool:
        return False

    def compile(self, compiler) -> dict:
        raise NotImplementedError

    @staticmethod
    def transmittance(params, ctx, swl, distance, o=None, d=None, seed=None):
        """Tr over a segment of the given length, (N, C); a tracking medium
        also reads the ray (o, d) and a uint32 seed a lane, which its
        callers always pass."""
        raise NotImplementedError

    @staticmethod
    def sample_distance(params, ctx, swl, t_max, u_channel, u_dist, o=None, d=None,
                        seed=None):
        """A scattering distance: {t (N,), scattered (N,) bool, weight (N, C),
        the throughput factor, g (N,)}."""
        raise NotImplementedError


def phase_g(params, like):
    """The rows' phase-function g a lane, 0 without one."""
    if "g" in params:
        return torch.broadcast_to(params["g"], like.shape)
    return torch.zeros_like(like)


@register(SceneNodeTag.MEDIUM, "vacuum", "Vacuum")
class VacuumMedium(Medium):
    @property
    def is_vacuum(self):
        return True

    def compile(self, compiler) -> dict:
        return {"priority_": np.float32(self.priority)}

    @staticmethod
    def transmittance(params, ctx, swl, distance, o=None, d=None, seed=None):
        return torch.ones(distance.shape + (swl.dimension,), dtype=torch.float32,
                          device=distance.device)

    @staticmethod
    def sample_distance(params, ctx, swl, t_max, u_channel, u_dist, o=None, d=None,
                        seed=None):
        return {
            "t": t_max,
            "scattered": torch.zeros_like(t_max, dtype=torch.bool),
            "weight": torch.ones(t_max.shape + (swl.dimension,), dtype=torch.float32,
                                 device=t_max.device),
            "g": torch.zeros_like(t_max),
        }


@register(SceneNodeTag.MEDIUM, "null", "Null")
class NullMedium(VacuumMedium):
    @property
    def is_null(self):
        return True


def sigmas(params, ctx, swl):
    """(sigma_a, sigma_s) (N, C), decoded as unbounded spectra and clamped
    at 0."""
    sa = ctx.spectrum.decode_unbounded(params["sigma_a"], swl)
    ss = ctx.spectrum.decode_unbounded(params["sigma_s"], swl)
    return torch.clamp(sa, min=0.0), torch.clamp(ss, min=0.0)


@register(SceneNodeTag.MEDIUM, "homogeneous", "Homogeneous")
class HomogeneousMedium(Medium):
    """Beer-Lambert transmittance in closed form and a channel-stochastic
    exponential distance sample."""

    def __init__(self, scene, desc):
        super().__init__(scene, desc)
        self.sigma_a = tuple(desc.float3("sigma_a", (0.0, 0.0, 0.0)))
        self.sigma_s = tuple(desc.float3("sigma_s", (0.0, 0.0, 0.0)))
        self.eta = desc.float("eta", 1.0)
        self.phase = load_phase(scene, desc)

    def compile(self, compiler) -> dict:
        row = {
            "sigma_a": np.asarray(self.sigma_a, np.float32),
            "sigma_s": np.asarray(self.sigma_s, np.float32),
            "eta": np.float32(self.eta),
            "priority_": np.float32(self.priority),
        }
        row.update(self.phase.compile(compiler))
        return row

    @staticmethod
    def transmittance(params, ctx, swl, distance, o=None, d=None, seed=None):
        sa, ss = sigmas(params, ctx, swl)
        return torch.exp(-(sa + ss) * distance[..., None])

    @staticmethod
    def sample_distance(params, ctx, swl, t_max, u_channel, u_dist, o=None, d=None,
                        seed=None):
        """Pick a channel uniformly, sample an exponential distance with its
        sigma_t, and weigh by the pdfs averaged over the channels."""
        sa, ss = sigmas(params, ctx, swl)
        sigma_t = sa + ss
        c = sigma_t.shape[-1]
        ch = torch.clamp((u_channel * c).to(torch.int64), 0, c - 1)
        st_ch = torch.gather(sigma_t, -1, ch[..., None])[..., 0]
        # a channel without extinction never scatters
        t = torch.where(
            st_ch > 1e-9,
            -torch.log(torch.clamp(1.0 - u_dist, min=1e-38)) / torch.clamp(st_ch, min=1e-9),
            torch.inf,
        )
        scattered = t < t_max
        t_clamped = torch.minimum(t, t_max)
        tr = torch.exp(-sigma_t * t_clamped[..., None])
        pdf_scatter = (sigma_t * tr).mean(dim=-1)
        pdf_surface = tr.mean(dim=-1)
        w_scatter = tr * ss / torch.clamp(pdf_scatter, min=1e-20)[..., None]
        w_surface = tr / torch.clamp(pdf_surface, min=1e-20)[..., None]
        return {
            "t": t_clamped,
            "scattered": scattered,
            "weight": torch.where(scattered[..., None], w_scatter, w_surface),
            "g": phase_g(params, t_max),
        }


def _take(x, idx):
    """The lanes idx of x: a tensor (lanes first), a named tuple of them, or
    None."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_take(v, idx) for v in x))
    return x[idx]


def _select(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)


def dispatch(ctx, medium_tag, medium_index, method, *args, init, lanes=None):
    """`method` of each lane's medium type (medium_tag (N,), -1 for none)
    on its row medium_index; lanes outside `lanes` (a mask, all lanes when
    None) and lanes of no type keep `init` (a tensor or a dict of them)."""
    global host_reads
    result = init
    for t, cls in enumerate(ctx.plan.medium_types):
        mask = medium_tag == t
        if lanes is not None:
            mask = mask & lanes
        table = ctx.arrays["media"][t]
        if cls.tracks:
            host_reads += 1
            idx = torch.nonzero(mask)[:, 0]
            if idx.numel() == 0:
                continue
            rows = gather_rows(table, medium_index[idx])
            value = getattr(cls, method)(rows, ctx, *(_take(a, idx) for a in args))
            if isinstance(result, dict):
                result = {k: result[k].index_copy(0, idx, value[k].to(result[k].dtype))
                          for k in result}
            else:
                result = result.index_copy(0, idx, value.to(result.dtype))
            continue
        rows = gather_rows(table, medium_index)
        value = getattr(cls, method)(rows, ctx, *args)
        if isinstance(result, dict):
            result = {k: _select(mask, value[k], result[k]) for k in result}
        else:
            result = _select(mask, value, result)
    return result
