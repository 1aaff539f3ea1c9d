"""The frozen bound of the fused kernel against counts made by hand."""

import pytest

from lrbench import bounds


def test_fused_bound_by_hand():
    # 32 rows; 1000 closest rays, 600 open and 100 occluded shadow rays,
    # 900 matte lanes shaded, 400 lane launches
    b = bounds.fused_bound(32, 32, 1000, 600, 100, {"matte": 900}, 400)
    flops = 1000 * 32 * 46 + 600 * 32 * 46 + 100 * 46 + 900 * (330 + 70)
    assert b["flops"] == flops
    assert b["bytes"] == 400 * 24
    assert b["bound_s"] == pytest.approx(flops / 67e12)
    assert b["bound_by"] == "operations"


def test_fused_bound_bytes_bound_without_work():
    b = bounds.fused_bound(1, 1, 0, 0, 0, {}, 10 ** 6)
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(24e6 / 3.35e12)


def test_surface_types_carry_their_own_cost():
    m = bounds.fused_bound(0, 0, 0, 0, 0, {"matte": 1}, 0)["flops"]
    d = bounds.fused_bound(0, 0, 0, 0, 0, {"disney": 1}, 0)["flops"]
    assert (m, d) == (400, 874)
