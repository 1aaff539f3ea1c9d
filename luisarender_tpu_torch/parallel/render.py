"""Rendering on several devices: rows of pixels data-parallel over ranks.

Counterpart of luisarender_tpu/parallel/render.py on torch.distributed: a
one-axis device mesh named "rays" over the ranks of the default process
group, which the caller initializes (init_method, world size and rank;
NCCL for CUDA devices, gloo for the CPU). Each rank renders its block of
h / n rows with the pixel coordinates the reference's shard_map gives it,
and holds the scene's arrays whole. The forward pass exchanges nothing
until the developed image is gathered (`render_sharded`); the
differentiable pass all-reduces the loss and every parameter gradient
(`make_sharded_grad_fn`). A rank without an initialized process group
raises: nothing falls back to one process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..diff.render import apply_params, render_pixels, with_arrays
from ..integrators.mega_path import path_trace_batch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
AXIS = "rays"


def make_mesh(device=None):
    """A one-axis DeviceMesh named AXIS over every rank of the default
    process group, on `device`'s type (default the first CUDA card), whose
    backend must be NCCL for CUDA and gloo for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call "
                           "init_process_group(backend, init_method, world_size, rank) first")
    dev = resolve_device(device)
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise ValueError(f"the process group's backend is {backend}; "
                         f"{dev.type} devices take {BACKENDS[dev.type]}")
    return init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=(AXIS,))


def _rows(mesh, h):
    """(this rank's index on the mesh, the rows a rank); raises ValueError
    where h does not divide over the ranks."""
    n = mesh.size()
    if h % n != 0:
        raise ValueError(f"film height {h} must divide over {n} devices")
    return mesh.get_local_rank(), h // n


def _block_pixels(rank, rows, w, device):
    """(rows * w, 2) int32 pixel coordinates of a rank's block of rows."""
    ys, xs = torch.meshgrid(
        torch.arange(rows, dtype=torch.int32, device=device) + rank * rows,
        torch.arange(w, dtype=torch.int32, device=device), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def sharded_render_pass(compiled, camera, integrator, mesh):
    """fn(accum, sample_index) -> accum, where accum is this rank's block
    of the film's accumulation, (h / n, w, 4): one sample of each of its
    pixels through path_trace_batch (either fork), added by the film."""
    w, h = camera.film.resolution
    rank, rows = _rows(mesh, h)
    film = camera.film
    pixel_xy = _block_pixels(rank, rows, w, compiled.device)

    def local_pass(accum, sample_index):
        rgb, weight = path_trace_batch(
            compiled, camera, integrator.sampler, integrator.light_sampler, pixel_xy,
            sample_index, max_depth=integrator.max_depth, rr_depth=integrator.rr_depth,
            rr_threshold=integrator.rr_threshold)
        return film.accumulate_image(accum, rgb.reshape(rows, w, 3), weight.reshape(rows, w))

    return local_pass


def make_sharded_grad_fn(compiled, camera, integrator, target, mesh, *, spp=2, max_depth=3):
    """Distributed inverse-rendering step: each rank runs the
    differentiable pass (diff/render.py, remat on, u_lens 0.5 as in the
    reference) on its rows and takes sum((img - target block)^2) and its
    gradient; the loss and every gradient are all-reduced (SUM) over the
    mesh and divided by h * w * 3.

    Returns fn(params, arrays) -> (loss, grads {path: tensor}), both the
    same on every rank. target: the full (h, w, 3) image."""
    w, h = camera.film.resolution
    rank, rows = _rows(mesh, h)
    group = mesh.get_group()
    pixel_xy = _block_pixels(rank, rows, w, compiled.device)
    target = torch.as_tensor(target, dtype=torch.float32, device=compiled.device)
    target_block = target[rank * rows:(rank + 1) * rows].reshape(rows * w, 3)

    def grad_fn(params, arrays):
        keys = list(params)
        leaves = {k: torch.as_tensor(params[k], dtype=torch.float32, device=compiled.device)
                  .detach().requires_grad_(True) for k in keys}
        scene = with_arrays(compiled, apply_params(arrays, leaves))
        img = render_pixels(scene, camera, integrator, pixel_xy, spp=spp,
                            max_depth=max_depth, remat=True, sample_lens=False)
        local = torch.sum((img - target_block) ** 2)
        grads = torch.autograd.grad(local, [leaves[k] for k in keys], allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(keys, grads)]
        loss = local.detach().clone()
        for x in (loss, *grads):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        scale = 1.0 / (h * w * 3)
        return loss * scale, {k: g * scale for k, g in zip(keys, grads)}

    return grad_fn


def render_sharded(compiled, camera, integrator, mesh, spp=None):
    """The full multi-device progressive render: each rank accumulates its
    rows, the blocks are gathered (all_gather) and the developed (h, w, 3)
    image is returned on every rank."""
    film = camera.film
    w, h = film.resolution
    _, rows = _rows(mesh, h)
    step = sharded_render_pass(compiled, camera, integrator, mesh)
    accum = torch.zeros((rows, w, 4), dtype=torch.float32, device=compiled.device)
    for i in range(spp if spp is not None else camera.spp):
        accum = step(accum, i)
    blocks = [torch.empty_like(accum) for _ in range(mesh.size())]
    dist.all_gather(blocks, accum.contiguous(), group=mesh.get_group())
    return film.develop(torch.cat(blocks, dim=0))
