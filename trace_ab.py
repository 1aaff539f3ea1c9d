#!/usr/bin/env python3
"""Time builds of the binary-tree trace kernel's source against each other
on one CUDA card, with the committed build among them.

    python3 trace_ab.py [--pairs K] [NAME=PATH.cu ...]

`committed` is csrc/trace.cu; `stack64` is the committed build launched
with its 64-entry stack. Each PATH is a CUDA source beside the headers it
includes: another design with this C interface, or the source of an
earlier commit unpacked with `git archive` into a git-ignored directory,
whose interface (node table, leaf size, no lane counters) is taken where
the library does not export `trace_counters`.

Every build runs on the trace inputs of chip_smoke.py's mesh-heavy scene
(testing.mesh_heavy at 1280 x 720, 512,004 triangles: its camera and
bounce-1 rays, the tree's tables as chip_smoke.py trace_tables makes them).
Per input it prints a JSON line: each build's agreement with its plain
version (every output bit for bit, and the per-ray walk counts reported:
ops/trace.py walk_plain, or preorder_plain for a build of the earlier
interface; the committed build must agree in both, and walk_plain's hits
must equal preorder_plain's), its device ms in turns (the builds in order,
then in reverse, K times; CUDA events around launches queued behind a spin
kernel), its lane counters where it has them (chip_smoke.py
cluster_lanes), ptxas's report, and both bounds (chip_smoke.py tree_bound:
the pair walk's and the reference order's). A build other than the
committed one that differs is reported and left out of the timing; the
committed one fails the run. The lines also go to chiprun_out/trace_ab.json.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def launcher(torch, lib, rays, tables, stack, pairs):
    """A function (stats=None, counters=None) -> (t, prim, u, v) that
    launches `lib` once on `rays` over `tables` (nodes, tris, leaf size)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "trace_counters")
    fn = lib.trace_closest
    o, d, t_min, t_max = rays
    nodes, tris, leaf_size = tables
    n, dev = o.shape[0], o.device
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    if current:
        fn.argtypes = [ptr] * 5 + [i32, ptr, i32, i32, i32] + [ptr] * 7 + [i32, ptr]
        common = (pairs.data_ptr(), pairs.shape[0], tris.data_ptr(), tris.shape[0], stack, n)
    else:
        fn.argtypes = [ptr] * 5 + [i32, ptr, i32, i32, i32, i32] + [ptr] * 6 + [i32, ptr]
        common = (nodes.data_ptr(), nodes.shape[0], tris.data_ptr(), tris.shape[0], leaf_size,
                  stack, n)
    fn.restype = i32

    def run(stats=None, counters=None):
        outs = (torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, device=dev), torch.empty(n, device=dev))
        extra = (0 if stats is None else stats.data_ptr(),)
        if current:
            extra += (0 if counters is None else counters.data_ptr(),)
        rc = fn(o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), *common,
                *(x.data_ptr() for x in outs), *extra, err.data_ptr(), dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"trace launch failed: CUDA error {rc}")
        return outs

    run.current = current
    run.err = err
    return run


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_ab.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import luisarender_tpu_torch as lt
    from cluster_ab import build_all
    from luisarender_tpu_torch.ops import build, cluster, trace

    pairs_k = 1
    if argv[:1] == ["--pairs"]:
        pairs_k, argv = int(argv[1]), argv[2:]
    sources = {"committed": build.CSRC_DIR / "trace.cu"}
    for arg in argv:
        name, _, path = arg.partition("=")
        sources[name] = Path(path).resolve()
    device = torch.device("cuda:0")
    libs = build_all(build, sources)
    head = {"card": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
            "sources": {k: str(v) for k, v in sources.items()},
            "pairs": pairs_k, "ptxas": {k: v[1] for k, v in libs.items()}}
    cs.emit(head)
    lines = [head]
    compiled, cap = cs.mesh_heavy_inputs(torch, lt, cluster, device)
    tables, stack, pairs, build_ms = cs.trace_tables(trace, compiled.arrays["trace"],
                                                     compiled.plan.bvh_leaf_size)
    # (name, library, stack bound passed)
    builds = [(k, libs[k][0], stack) for k in libs]
    builds.insert(1, ("stack64", libs["committed"][0], trace.STACKS[0] + 1))
    for label, rays in (("camera rays", cap["closest"][0][:4]),
                        ("bounce-1 rays", cap["closest"][1][:4])):
        vis = (torch.zeros(pairs.shape[0], dtype=torch.bool, device=device),
               torch.zeros(tables[1].shape[0], dtype=torch.bool, device=device))
        *want, walk = trace.walk_plain(*rays, *tables, vis, stack=stack, pairs=pairs)
        vis_p = (torch.zeros(tables[0].shape[0], dtype=torch.bool, device=device),
                 torch.zeros(tables[1].shape[0], dtype=torch.bool, device=device))
        *want_p, walk_p = trace.preorder_plain(*rays, *tables, vis_p, stack=stack)
        winners = int(torch.unique(want[1][want[1] >= 0]).numel())
        rec = {"kernel": "trace_closest", "input": label, "n": rays[0].shape[0],
               "live": int((rays[3] > rays[2]).sum()), "stack": stack,
               "stack_build": trace.stack_build(stack), "pair_rows": int(pairs.shape[0]),
               "pair_build_ms": build_ms, "walk": cs.walk_summary(walk),
               "preorder_walk": cs.walk_summary(walk_p),
               "preorder_differ": int(sum((a != b) for a, b in zip(want, want_p)).bool().sum()),
               **dict(zip(("bound_ms", "bound_by"),
                          cs.tree_bound("trace", "closest", tables, rays, walk, vis, winners))),
               **dict(zip(("preorder_bound_ms", "preorder_bound_by"),
                          cs.tree_bound("trace_preorder", "closest", tables, rays, walk_p,
                                        vis_p, winners))),
               "builds": {}}
        runs, timed = {}, []
        for k, lib, bound in builds:
            run = launcher(torch, lib, rays, tables, bound, pairs)
            stats = torch.zeros_like(walk)
            got = run(stats)
            torch.cuda.synchronize()
            ref, ref_walk = (want, walk) if run.current else (want_p, walk_p)
            same_out = int(run.err.item()) == 0 and all(torch.equal(g, w)
                                                       for g, w in zip(got, ref))
            same_walk = torch.equal(stats, ref_walk)
            if k == "committed" and not (same_out and same_walk and not rec["preorder_differ"]):
                raise SystemExit(f"trace_ab.py: {k} differs from walk_plain on {label}")
            b = {"bit_equal": same_out, "walk_equal": same_walk, "ms": [],
                 "walk": cs.walk_summary(stats)}
            rec["builds"][k] = b
            if not same_out:
                continue
            runs[k] = run
            timed.append(k)
            if run.current:
                b["lanes"] = cs.cluster_lanes(torch, trace, lambda c: run(counters=c), device)
        for _ in range(pairs_k):
            for turn in (timed, timed[::-1]):
                for k in turn:
                    rec["builds"][k]["ms"].append(cs.device_ms(torch, runs[k], iters=20))
        cs.emit(rec)
        lines.append(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "trace_ab.json").write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
