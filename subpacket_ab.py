#!/usr/bin/env python3
"""Time builds of the subpacket trace kernel's source against each other on
one CUDA card, with the committed build among them.

    python3 subpacket_ab.py [--pairs K] [NAME=PATH.cu ...]

Each PATH is a CUDA source with csrc/subpacket.cu's C interface, beside the
headers it includes: another design of the kernel, or the source of an
earlier commit unpacked with `git archive` into a git-ignored directory. A
library that exports `subpacket_counters` takes this tree's interface (lane
counters); one that does not, the earlier one-thread-a-ray kernel's.
`committed` is csrc/subpacket.cu. Every build runs on the trace inputs of
chip_smoke.py's mesh-heavy scene (testing.mesh_heavy at 1280 x 720, 512,004
triangles, compiled with the 8-wide tables: camera and bounce-1 rays for
closest hits, the shadow rays of bounces 0 and 1 for any-hit), each in
caller order and in the reference's coherence order (ops/subpacket.py
coherence_order). Per input it prints a JSON line: each build's agreement
with subpacket_plain (every output and the per-ray walk counts bit for bit,
in both orders), its device ms in turns (the builds in order, then in
reverse, K times; CUDA events around launches queued behind a spin kernel)
on caller-order and on sorted rays, its lane counters where it has them
(chip_smoke.py cluster_lanes), the sort's own cost (the keys, the sort, the
gathers of the rays and the scatters of the outputs, without the kernel:
its device time from torch.profiler, since the sort keeps the host from
queueing ahead of the card, and its wall time between CUDA events, host
dispatch included) and the bound (chip_smoke.py tree_bound, a Woop row
charged 13 columns, and 22 beside it). A build other than the committed one
that differs from subpacket_plain is reported and left out of the timing;
the committed one fails the run. The lines also go to
chiprun_out/subpacket_ab.json.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def launcher(torch, lib, args, stack, any_hit):
    """A function (stats=None, counters=None) -> outputs that launches `lib`
    once on `args` (o, d, t_min, t_max, slab8, meta8, woop) in the order
    given."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "subpacket_counters")
    fn = lib.subpacket_any if any_hit else lib.subpacket_closest
    n_out = 1 if any_hit else 2
    fn.argtypes = [ptr] * 6 + [i32, ptr, i32, i32, i32] + [ptr] * (
        n_out + (3 if current else 2)) + [i32, ptr]
    fn.restype = i32
    o, d, t_min, t_max, slab8, meta8, woop = args
    n, dev = o.shape[0], o.device
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    common = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), slab8.data_ptr(),
              meta8.data_ptr(), slab8.shape[0], woop.data_ptr(), woop.shape[0], stack, n)

    def run(stats=None, counters=None):
        if any_hit:
            outs = (torch.empty(n, dtype=torch.int32, device=dev),)
        else:
            outs = (torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev))
        extra = (0 if stats is None else stats.data_ptr(),)
        if current:
            extra += (0 if counters is None else counters.data_ptr(),)
        rc = fn(*common, *(x.data_ptr() for x in outs), *extra, err.data_ptr(), dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"subpacket launch failed: CUDA error {rc}")
        return outs

    run.current = current
    run.err = err
    return run


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("subpacket_ab.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import luisarender_tpu_torch as lt
    from cluster_ab import build_all
    from luisarender_tpu_torch.ops import build, cluster, subpacket
    from wide8_ab import profiled_ms, sort_round_trip

    pairs = 1
    if argv[:1] == ["--pairs"]:
        pairs, argv = int(argv[1]), argv[2:]
    sources = {"committed": build.CSRC_DIR / "subpacket.cu"}
    for arg in argv:
        name, _, path = arg.partition("=")
        sources[name] = Path(path).resolve()
    device = torch.device("cuda:0")
    libs = build_all(build, sources)
    head = {"card": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
            "sources": {k: str(v) for k, v in sources.items()}, "pairs": pairs,
            "ptxas": {k: v[1] for k, v in libs.items()}}
    cs.emit(head)
    lines = [head]
    compiled, cap = cs.mesh_heavy_inputs(torch, lt, cluster, device)
    tr = compiled.arrays["trace"]
    tables = (tr["cluster_slab8"], tr["cluster_meta8"], tr["cluster_woop"])
    meta8 = tables[1]
    stack = subpacket.stack8_need(meta8.cpu().numpy())
    names = list(libs)
    cases = (("closest", "camera rays", cap["closest"][0][:4]),
             ("closest", "bounce-1 rays", cap["closest"][1][:4]),
             ("any", "shadow rays of bounce 0", cap["any"][0][:4]),
             ("any", "shadow rays of bounce 1", cap["any"][1][:4]))
    for kind, label, rays in cases:
        any_hit = kind == "any"
        visited = (torch.zeros(tables[0].shape[0], dtype=torch.bool, device=device),
                   torch.zeros(tables[2].shape[0], dtype=torch.bool, device=device))
        st = subpacket.subpacket_plain(*rays, *tables, any_hit, visited, stack=stack)
        walk = st.stats
        want = ((st.occ.int(),) if any_hit else
                (torch.where(st.best_s >= 0, st.best_t, math.inf), st.best_s))
        winners = 0 if any_hit else int(torch.unique(st.best_s[st.best_s >= 0]).numel())
        perm = subpacket.coherence_order(*rays, meta8)
        srt = tuple(x.index_select(0, perm) for x in rays)
        bound = {}
        for cols, suffix in ((13, ""), (22, "_22")):
            ms, by = cs.tree_bound("subpacket", kind, tables, rays, walk, visited, winners,
                                   woop_cols=cols)
            bound.update({f"bound_ms{suffix}": ms, f"bound_by{suffix}": by})
        rec = {"kernel": f"subpacket_{kind}", "input": label, "n": rays[0].shape[0],
               "live": int((rays[3] > rays[2]).sum()), "stack": stack,
               "stack_build": subpacket.stack_build(stack), "walk": cs.walk_summary(walk),
               "sort_device_ms": profiled_ms(
                   torch, cs, lambda: sort_round_trip(subpacket, rays, meta8, want), iters=20),
               "sort_wall_ms": cs.events_ms(
                   torch, lambda: sort_round_trip(subpacket, rays, meta8, want), iters=20),
               **bound, "builds": {}}
        runs, timed = {}, []
        for k in names:
            same = True
            for order, r in (("caller", rays), ("sorted", srt)):
                run = launcher(torch, libs[k][0], (*r, *tables), stack, any_hit)
                stats = torch.zeros_like(walk)
                got = run(stats)
                torch.cuda.synchronize()
                if order == "sorted":
                    got, stats = subpacket.unsort(got, perm), subpacket.unsort(stats, perm)
                same = same and (int(run.err.item()) == 0 and torch.equal(stats, walk)
                                 and all(torch.equal(g, w) for g, w in zip(got, want)))
                if not same and k == "committed":
                    raise SystemExit(f"subpacket_ab.py: {k} differs from subpacket_plain on "
                                     f"{label}, {order} order")
                runs[k, order] = run
            b = {"bit_equal": same, "ms": [], "ms_sorted": []}
            rec["builds"][k] = b
            if not same:
                continue
            timed.append(k)
            if runs[k, "caller"].current:
                for order, key in (("caller", "lanes"), ("sorted", "lanes_sorted")):
                    run = runs[k, order]
                    b[key] = cs.cluster_lanes(torch, subpacket, lambda ctr: run(counters=ctr),
                                              device)
        for _ in range(pairs):
            for turn in (timed, timed[::-1]):
                for k in turn:
                    for order, key in (("caller", "ms"), ("sorted", "ms_sorted")):
                        rec["builds"][k][key].append(
                            cs.device_ms(torch, runs[k, order], iters=20))
        cs.emit(rec)
        lines.append(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "subpacket_ab.json").write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
