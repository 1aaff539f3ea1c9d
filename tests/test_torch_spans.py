"""The port's spans (luisarender_tpu_torch/core/trace.py) and its ray
counter, on the CPU:

(a) with no profiler recording, span() is one shared no-op and builds no
    profiler range;
(b) tiny renders under torch.profiler (the fused fork's plain version,
    megawave's persistent passes, the general fork) hold, a camera, one
    `lr.render`, one `lr.samples` around one `lr.trace` and one `lr.film` a
    sample (a pass on megawave), one `lr.develop`, one `lr.to_host` and, on
    the general fork, one `lr.bounce` a bounce step, each inside its
    `lr.render`;
(c) `rays_traced`, which the integrators keep on the device until it is
    read, is an int, and within 4 rays a sample of the reference's count
    for the same samples (its per-sample `rays` summed; the rule of
    tests/test_torch_render.py), on the fused, general, megawave,
    wavefront and vpt renders below;
(d) `cli --profile` writes a Chrome trace that holds the render's span.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu.integrators.mega_path import path_trace_batch as jax_ptb
from luisarender_tpu_torch import cli, testing
from luisarender_tpu_torch.core import trace


def _cornell(spp, **props):
    return testing.cornell_box(resolution=(8, 8), spp=spp, depth=3, **props)


# name: (scene, the fused fork turned off)
RENDERS = {
    "fused": (lambda: _cornell(2), False),
    "general": (lambda: _cornell(2), True),
    "megawave": (lambda: _cornell(4, integrator="megawave", samples_per_pass=2), False),
    "wavefront": (lambda: testing.wavepath(_cornell(2), state_count=32,
                                           iterations_per_launch=2), True),
    "vpt": (lambda: testing.fog((8, 8), 1, 3), False),
}


def _render(name, monkeypatch):
    build, no_fused = RENDERS[name]
    if no_fused:
        monkeypatch.setenv("LUISARENDER_TPU_NO_FUSED", "1")
    else:
        monkeypatch.delenv("LUISARENDER_TPU_NO_FUSED", raising=False)
    scene = lt.Scene.from_dict(build())
    lt.render(scene, device="cpu")
    return scene


def _spans(prof):
    """(name, start, end) in ns of every lr.* range the profiler recorded."""
    out = []
    for evt in prof.profiler.kineto_results.events():
        if evt.name().startswith("lr."):
            out.append((evt.name(), evt.start_ns(), evt.start_ns() + evt.duration_ns()))
    return out


def _pixels(w, h):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return jnp.asarray(np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32))


def _vpt_rays(ji, jcomp, camera, pxy, sample_index, monkeypatch):
    """The reference's megavpt counts a sample's rays in its loop's carry
    and returns only the image: its loop's final carry is read here."""
    loop, finals = jax.lax.while_loop, []

    def keep_final(cond, body, init):
        out = loop(cond, body, init)
        if isinstance(out, dict) and "n_rays" in out:
            finals.append(out)
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "while_loop", keep_final)
        ji._trace_batch(jcomp, jcomp.arrays, camera, pxy, jnp.int32(sample_index))
    (final,) = finals
    return int(final["n_rays"])


def _reference_rays(d, monkeypatch):
    """The reference's rays over the render's samples: the megakernel's
    path_trace_batch (the vpt's trace, on the fog) for sample 0 .. spp-1
    of every pixel."""
    torch_parity.require_reference_builder()
    if d["render"]["integrator"]["impl"] == "wavepath":
        d = {**d, "render": {**d["render"], "integrator": {
            "impl": "megapath", "prop": {"depth": d["render"]["integrator"]["prop"]["depth"]}}}}
    jscene = lr.Scene.from_dict(d)
    jcomp = lr.compile_scene(jscene)
    ji, camera = jscene.integrator, jscene.cameras[0]
    pxy = _pixels(*camera.film.resolution)
    total = 0
    for si in range(camera.spp):
        if d["render"]["integrator"]["impl"] == "megavpt":
            total += _vpt_rays(ji, jcomp, camera, pxy, si, monkeypatch)
        else:
            _, _, st = jax_ptb(jcomp, jcomp.arrays, camera, ji.sampler, ji.light_sampler, pxy,
                               jnp.int32(si), max_depth=ji.max_depth, rr_depth=ji.rr_depth,
                               rr_threshold=ji.rr_threshold, with_stats=True)
            total += int(st["rays"])
    return total, camera.spp


def test_span_without_a_profiler_is_a_shared_no_op(monkeypatch):
    def build(name):
        raise AssertionError(f"a profiler range {name!r} built with no profiler recording")

    monkeypatch.setattr(trace, "_range", build)
    assert not torch.autograd._profiler_enabled()
    off = trace.span("lr.render")
    assert trace.span("lr.trace") is off and trace.span("lr.film") is off
    with off:
        with trace.span("lr.develop"):
            pass


@pytest.mark.parametrize("name", ["fused", "megawave", "general"])
def test_a_render_holds_its_spans_inside_lr_render(name, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("lr.x") is not trace._OFF  # a range, built only now
        scene = _render(name, monkeypatch)
    integ = scene.integrator
    spans = _spans(prof)
    counts = {}
    for s in spans:
        counts[s[0]] = counts.get(s[0], 0) + 1
    passes = 2 if name == "megawave" else scene.cameras[0].spp
    expected = {"lr.render": 1, "lr.samples": 1, "lr.trace": passes, "lr.film": passes,
                "lr.develop": 1, "lr.to_host": 1}
    if name == "general":
        assert integ.fused_passes == 0 and integ.bounces_run > 0
        expected["lr.bounce"] = integ.bounces_run
    else:
        assert integ.fused_passes == passes and integ.bounces_run == 0
    assert counts == expected
    (_, r0, r1), = [s for s in spans if s[0] == "lr.render"]
    assert all(r0 <= s0 <= s1 <= r1 for _, s0, s1 in spans)
    (_, l0, l1), = [s for s in spans if s[0] == "lr.samples"]
    assert all(l0 <= s0 <= s1 <= l1 for n, s0, s1 in spans if n in ("lr.trace", "lr.film"))
    sample_spans = [s for s in spans if s[0] == "lr.trace"]
    for _, b0, b1 in (s for s in spans if s[0] == "lr.bounce"):
        assert any(s0 <= b0 <= b1 <= s1 for _, s0, s1 in sample_spans)


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_rays_traced_is_the_int_it_was(name, monkeypatch):
    scene = _render(name, monkeypatch)
    rays = scene.integrator.rays_traced
    ref, spp = _reference_rays(RENDERS[name][0](), monkeypatch)
    assert type(rays) is int and abs(rays - ref) <= 4 * spp


def test_cli_profile_writes_a_trace_with_the_render_span(tmp_path):
    scene_file = tmp_path / "scene.json"
    scene_file.write_text(json.dumps(testing.cornell_box(resolution=(8, 8), spp=1, depth=2)))
    out, prof = tmp_path / "cli.exr", tmp_path / "trace.json"
    assert cli.main([str(scene_file), "-o", str(out), "--profile", str(prof)], device="cpu") == 0
    assert out.exists()
    names = [e.get("name") for e in json.loads(prof.read_text())["traceEvents"]]
    assert names.count("lr.render") == 1 and names.count("lr.trace") == 1
