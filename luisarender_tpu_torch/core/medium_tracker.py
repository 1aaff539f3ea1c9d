"""Priority-based nested-medium tracker with a fixed-capacity stack a ray.

Counterpart of luisarender_tpu/core/medium_tracker.py. Each ray carries K
slots of (packed medium ref, priority); the current medium is the live
entry of the highest priority, a tie broken by the first slot (torch.argmax
returns the first maximal index, as jnp.argmax does). Entering fills the
first empty slot, exiting empties the first matching one, both picked by a
cumulative sum over the slots, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

CAPACITY = 8
EMPTY = -1


class MediumTracker(NamedTuple):
    ref: torch.Tensor  # (..., K) int32 packed (tag << 16 | index), -1 empty
    priority: torch.Tensor  # (..., K) float32


def make_tracker(shape, capacity=CAPACITY, device=None):
    shape = tuple(shape) + (capacity,)
    return MediumTracker(
        ref=torch.full(shape, EMPTY, dtype=torch.int32, device=device),
        priority=torch.full(shape, -math.inf, dtype=torch.float32, device=device),
    )


def pack_ref(tag, index):
    return (tag.to(torch.int32) << 16) | index.to(torch.int32)


def unpack_ref(ref):
    """(tag, index); an empty ref (-1) unpacks to (-1, 65535)."""
    return ref >> 16, ref & 0xFFFF


def current(tracker: MediumTracker):
    """(has_medium (...,), ref (...,)) of the highest-priority live entry."""
    live = tracker.ref >= 0
    prio = torch.where(live, tracker.priority, -math.inf)
    best = torch.argmax(prio, dim=-1)
    has = live.any(dim=-1)
    ref = torch.gather(tracker.ref, -1, best[..., None])[..., 0]
    return has, torch.where(has, ref, EMPTY)


def enter(tracker: MediumTracker, mask, ref, priority):
    """Insert (ref, priority) into the first empty slot where mask is True."""
    empty = tracker.ref < 0
    first_empty = torch.cumsum(empty.to(torch.int32), dim=-1) == 1
    slot = empty & first_empty & mask[..., None]
    return MediumTracker(
        ref=torch.where(slot, ref[..., None].to(torch.int32), tracker.ref),
        priority=torch.where(slot, priority[..., None].to(torch.float32), tracker.priority),
    )


def exit_(tracker: MediumTracker, mask, ref):
    """Remove the first entry matching ref where mask is True."""
    match = (tracker.ref == ref[..., None]) & mask[..., None]
    first = torch.cumsum(match.to(torch.int32), dim=-1) == 1
    kill = match & first
    return MediumTracker(
        ref=torch.where(kill, EMPTY, tracker.ref),
        priority=torch.where(kill, -math.inf, tracker.priority),
    )
