"""The ranks of tests/test_torch_parallel.py: each worker process is one
rank of a gloo process group on the CPU (init_method a file, a timeout of
PG_TIMEOUT so that a lost peer fails the call instead of hanging). It
imports neither JAX nor the reference: the test process holds the ranks'
results against them."""

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist

PG_TIMEOUT = datetime.timedelta(seconds=120)
ALBEDO_PATH = ("textures", "constant", "value")


def _scene(res, spp, depth):
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing

    scene = lt.Scene.from_dict(testing.cornell_box(resolution=(res[0], res[1]), spp=spp,
                                                   depth=depth))
    return scene, lt.compile_scene(scene, device="cpu")


def _work(res, spp, depth, params, target):
    """This rank's part: the sharded image, the sharded loss and gradient,
    and the ValueError of a film height that does not divide."""
    from luisarender_tpu_torch.parallel.render import (
        make_mesh, make_sharded_grad_fn, render_sharded,
    )

    mesh = make_mesh("cpu")
    scene, compiled = _scene(res, spp, depth)
    cam, integ = scene.cameras[0], scene.integrator
    img = render_sharded(compiled, cam, integ, mesh, spp=spp)
    grad_fn = make_sharded_grad_fn(compiled, cam, integ, target, mesh, spp=spp,
                                   max_depth=depth)
    loss, grads = grad_fn({k: torch.as_tensor(v) for k, v in params.items()}, compiled.arrays)
    ragged = []
    scene_r, compiled_r = _scene((res[0], res[1] + 1), 1, depth)
    for call in (lambda: render_sharded(compiled_r, scene_r.cameras[0], scene_r.integrator,
                                        mesh, spp=1),
                 lambda: make_sharded_grad_fn(compiled_r, scene_r.cameras[0], scene_r.integrator,
                                              target, mesh)):
        try:
            call()
            ragged.append("no error")
        except ValueError as e:
            ragged.append(str(e))
    return {"image": img.numpy(), "loss": float(loss),
            "grads": {k: g.numpy() for k, g in grads.items()}, "ragged": ragged,
            "mesh": (mesh.size(), mesh.mesh_dim_names)}


def run_rank(rank, world, init_file, args, out_q):
    """One rank: joins the group, does its part (_work), and puts (rank,
    "ok", result) or (rank, "error", traceback) on out_q."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                                rank=rank, timeout=PG_TIMEOUT)
        try:
            out_q.put((rank, "ok", _work(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:
        out_q.put((rank, "error", traceback.format_exc()))


def target_image(res, seed=0):
    """The test's target image, made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 0.3, (res[1], res[0], 3)).astype(np.float32)
