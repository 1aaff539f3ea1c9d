"""Trace entries that pass no gradient.

The reference wraps each trace kernel in a `jax.custom_vjp` whose backward
returns zeros for every input (ops/brute_pallas.py, cluster_pallas.py,
wide8_pallas.py, subpacket_pallas.py): a hit's t, slot and barycentrics
are constants of the differentiable pass. `no_grad_entry` gives a public
trace entry of the port that meaning: a `torch.autograd.Function` of its
own, the same on the card (the kernel launch) and on the CPU (the plain
version), whose backward returns None for every input. The forward calls
the entry as it is, with autograd off, so its outputs are the entry's bit
for bit; integer and bool outputs are marked non-differentiable.

The analytic spheres (accel/traverse.py sphere_closest / sphere_any) stay
outside any such Function: they are plain PyTorch and stay differentiable,
as the reference's are.
"""

from __future__ import annotations

import functools
import inspect

import torch


def no_grad_entry(fn):
    """fn (a trace entry returning a tensor or a tuple of tensors) as a
    torch.autograd.Function whose backward passes no gradient. The
    Function is the entry's `function` attribute; keyword arguments bind
    to fn's signature, its defaults filled in."""
    sig = inspect.signature(fn)

    def forward(ctx, *args):
        ctx.set_materialize_grads(False)
        ctx.n_inputs = len(args)
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.mark_non_differentiable(*(x for x in outs if not x.is_floating_point()))
        return out

    def backward(ctx, *grads):
        return (None,) * ctx.n_inputs

    module = fn.__module__.rsplit(".", 1)[-1]
    name = module.title() + "".join(p.title() for p in fn.__name__.split("_"))
    function = type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward),
        "__module__": fn.__module__, "__doc__": f"{module}.{fn.__name__}, no gradient.",
    })

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return function.apply(*bound.args)

    entry.function = function
    return entry
