"""The port's sharded pass (luisarender_tpu_torch/parallel/render.py) on
the CPU: two worker processes, each a rank of a gloo group
(tests/torch_dist.py), render testing.cornell_box at 32^2, 2 spp, depth 3.

- the gathered image of render_sharded equals the port's one-process
  render (rtol 1e-5, atol 1e-6, the reference's rule for its own sharded
  render, tests/test_parallel.py);
- the two-rank make_sharded_grad_fn (loss and the gradient with respect to
  the constant-texture table) matches the reference's make_sharded_grad_fn
  on its 8-device CPU mesh (tests/conftest.py) within 1% relative or 1e-5
  absolute, and the port's one-process l2 loss and gradient;
- a film height that does not divide over the ranks raises ValueError on
  every rank, and a process without a process group cannot make a mesh.

The group is made with a file under tmp_path, a process-group timeout of
120 s and a join timeout, so that a hang fails the test."""

import multiprocessing as mp
import queue

import jax
import numpy as np
import pytest
import torch

import luisarender_tpu as lr
import luisarender_tpu_torch as lt
from luisarender_tpu import testing as jtesting
from luisarender_tpu.diff.render import get_in as jget_in
from luisarender_tpu.parallel.render import make_mesh as jmake_mesh
from luisarender_tpu.parallel.render import make_sharded_grad_fn as jsharded_grad_fn
from luisarender_tpu_torch import convert
from luisarender_tpu_torch import testing
from luisarender_tpu_torch.diff.render import get_in, l2_loss_fn, make_render_fn

import torch_dist
from torch_parity import require_reference_builder

RES, SPP, DEPTH = (32, 32), 2, 3
WORLD = 2
JOIN_TIMEOUT = 240
ALBEDO_PATH = torch_dist.ALBEDO_PATH


def _close(got, want):
    """Each entry within 1% relative or 1e-5 absolute."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    gap = np.abs(got - want)
    assert np.all((gap <= 0.01 * np.abs(want)) | (gap <= 1e-5)), float(gap.max())


@pytest.fixture(scope="module")
def port_scene():
    scene = lt.Scene.from_dict(testing.cornell_box(resolution=RES, spp=SPP, depth=DEPTH))
    return scene, lt.compile_scene(scene, device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, port_scene):
    """Both ranks' results ({rank: result}), from one two-process group."""
    _, compiled = port_scene
    params = {ALBEDO_PATH: get_in(compiled.arrays, ALBEDO_PATH).numpy()}
    target = torch_dist.target_image(RES)
    init_file = tmp_path_factory.mktemp("pg") / "init"
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=torch_dist.run_rank,
                         args=(r, WORLD, str(init_file), (RES, SPP, DEPTH, params, target), out_q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(WORLD):  # drain before joining
            rank, status, value = out_q.get(timeout=JOIN_TIMEOUT)
            assert status == "ok", f"rank {rank}:\n{value}"
            results[rank] = value
    except queue.Empty:
        pytest.fail(f"ranks {sorted(set(range(WORLD)) - set(results))} gave no result "
                    f"in {JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return {"results": results, "params": params, "target": target}


def test_render_sharded_matches_one_process(ranks, port_scene):
    scene, compiled = port_scene
    single = scene.integrator.render(compiled)["cornell.exr"]
    for rank, res in ranks["results"].items():
        assert res["mesh"] == (WORLD, ("rays",))
        np.testing.assert_allclose(res["image"], single, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {rank}")


def test_sharded_grad_matches_reference_and_one_process(ranks, port_scene):
    require_reference_builder()
    jscene = lr.Scene.from_dict(jtesting.cornell_box(resolution=RES, spp=SPP, depth=DEPTH))
    jcomp = lr.compile_scene(jscene)
    np.testing.assert_array_equal(np.asarray(jget_in(jcomp.arrays, ALBEDO_PATH)),
                                  ranks["params"][ALBEDO_PATH])
    mesh = jmake_mesh(jax.devices()[:8])
    fn = jsharded_grad_fn(jcomp, jscene.cameras[0], jscene.integrator, ranks["target"], mesh,
                          spp=SPP, max_depth=DEPTH)
    jloss, jgrads = fn({ALBEDO_PATH: jax.numpy.asarray(ranks["params"][ALBEDO_PATH])},
                       jcomp.arrays)
    jgrad = np.asarray(jgrads[ALBEDO_PATH])
    assert np.abs(jgrad).max() > 1e-4
    for rank, res in ranks["results"].items():
        _close(res["loss"], float(jloss))
        _close(res["grads"][ALBEDO_PATH], jgrad)
    # the port's one-process loss and gradient
    scene, compiled = port_scene
    render = make_render_fn(compiled, scene.cameras[0], scene.integrator, spp=SPP,
                            max_depth=DEPTH, remat=False)
    params = convert.params_to_device(ranks["params"], "cpu")
    params[ALBEDO_PATH].requires_grad_(True)
    loss = l2_loss_fn(render, torch.as_tensor(ranks["target"]))(params, compiled.arrays)
    loss.backward()
    for res in ranks["results"].values():
        np.testing.assert_allclose(res["loss"], float(loss.detach()), rtol=1e-5)
        np.testing.assert_allclose(res["grads"][ALBEDO_PATH], params[ALBEDO_PATH].grad.numpy(),
                                   rtol=1e-4, atol=1e-7)


def test_height_that_does_not_divide_raises(ranks):
    for res in ranks["results"].values():
        assert all("must divide over 2 devices" in msg for msg in res["ragged"]), res["ragged"]


def test_mesh_needs_a_process_group():
    from luisarender_tpu_torch.parallel.render import make_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh("cpu")
