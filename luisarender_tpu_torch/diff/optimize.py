"""Inverse rendering: recover scene parameters by gradient descent.

Counterpart of luisarender_tpu/diff/optimize.py: Adam on the loss of
diff/render.py against a target image. torch.optim.Adam with betas (0.9,
0.999) and eps 1e-8 makes optax.adam's update, lr * m_hat / (sqrt(v_hat)
+ eps); the parameters are clipped to `param_bounds` after every step.
"""

from __future__ import annotations

import torch

from .render import l2_loss_fn, make_render_fn


def recover(compiled, camera, integrator, target_image, init_params: dict, *, spp=4,
            max_depth=4, steps=64, learning_rate=5e-2, param_bounds=(0.0, 1.0),
            verbose=False):
    """Adam-optimize `init_params` ({path: array}) to match target_image.

    Returns (final_params {path: tensor}, losses), each loss that of the
    parameters before its step. Keys are taken in sorted order, as the
    reference's pytree takes them."""
    render_fn = make_render_fn(compiled, camera, integrator, spp=spp, max_depth=max_depth)
    target = torch.as_tensor(target_image, dtype=torch.float32, device=compiled.device)
    loss_fn = l2_loss_fn(render_fn, target)
    keys = sorted(init_params)
    params = {k: torch.as_tensor(init_params[k], dtype=torch.float32, device=compiled.device)
              .detach().clone().requires_grad_(True) for k in keys}
    opt = torch.optim.Adam([params[k] for k in keys], lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, compiled.arrays)
        loss.backward()
        opt.step()
        if param_bounds is not None:
            lo, hi = param_bounds
            with torch.no_grad():
                for p in params.values():
                    p.clamp_(lo, hi)
        losses.append(float(loss.detach()))
        if verbose and (i % 8 == 0 or i == steps - 1):
            print(f"step {i}: loss {losses[-1]:.6f}")
    return {k: p.detach() for k, p in params.items()}, losses
