#!/usr/bin/env python3
"""Time builds of the cluster trace kernel's source against each other on one
CUDA card, with the committed build among them.

    python3 cluster_ab.py [NAME=PATH.cu ...]

Each PATH is a CUDA source with csrc/cluster.cu's C interface, beside the
headers it includes: another design of the kernel, or the source of an
earlier commit unpacked with `git archive` into a git-ignored directory. A
library that exports `cluster_counters` takes this tree's interface (lane
counters); one that does not, the earlier one-thread-a-ray kernel's.
`committed` is csrc/cluster.cu. Every build runs on the trace inputs of
chip_smoke.py's mesh-heavy scene (testing.mesh_heavy at 1280 x 720, 512,004
triangles: camera and bounce-1 rays for closest hits, the shadow rays of
bounces 0 and 1 for any-hit), each in caller order and in the reference's
coherence order (ops/cluster.py coherence_order). Per input
it prints a JSON line: each build's agreement with walk_plain (every output
and the per-ray walk counts bit for bit, or the run fails), its device ms
in turns (the builds in order, then in reverse) on caller-order and on
sorted rays, its lane counters where it has them (chip_smoke.py
cluster_lanes), the sort's own cost (keys, sort, gathers of the rays and
scatters of the outputs, without the kernel; CUDA events around the calls,
host dispatch included) and the bound (chip_smoke.py cluster_bound). The lines also go to chiprun_out/cluster_ab.json.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

def build_all(build, sources):
    """{name: (ctypes library, ptxas report)} of {name: source}, built in
    parallel into _build/ab/."""
    def one(item):
        name, src = item
        key = hashlib.sha256(src.read_bytes() + " ".join(build.NVCC_FLAGS).encode())
        for h in sorted(src.parent.glob("*.cuh")):
            key.update(h.read_bytes())
        out = build.BUILD_DIR / "ab" / f"lib{name}-{key.hexdigest()[:12]}.so"
        if not out.exists():
            build.compile_source(src, out)
        report = build.parse_ptxas(out.with_suffix(".ptxas.txt").read_text())
        return name, (ctypes.CDLL(str(out)), report)

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def launcher(torch, cluster, lib, args, any_hit):
    """A function (stats=None, counters=None) -> outputs that launches `lib`
    once on `args` (o, d, t_min, t_max, nodes, tris) in the order given."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "cluster_counters")
    fn = lib.cluster_any if any_hit else lib.cluster_closest
    n_out = 1 if any_hit else 4
    fn.argtypes = [ptr] * 5 + [i32, ptr, i32, i32] + [ptr] * (n_out + (3 if current else 2)) + [
        i32, ptr]
    fn.restype = i32
    o, d, t_min, t_max, nodes, tris = args
    n, dev = o.shape[0], o.device
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    common = (o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), nodes.data_ptr(),
              nodes.shape[0], tris.data_ptr(), tris.shape[0], n)

    def run(stats=None, counters=None):
        if any_hit:
            outs = (torch.empty(n, dtype=torch.int32, device=dev),)
        else:
            outs = (torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
                    torch.empty(n, device=dev), torch.empty(n, device=dev))
        extra = (0 if stats is None else stats.data_ptr(),)
        if current:
            extra += (0 if counters is None else counters.data_ptr(),)
        rc = fn(*common, *(x.data_ptr() for x in outs), *extra, err.data_ptr(), dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cluster launch failed: CUDA error {rc}")
        return outs

    run.current = current
    run.err = err
    return run


def sort_only(cs, cluster, args, outs):
    """What chip_smoke.py launch_sorted adds to a launch: the keys and the
    sort, the gathers of the rays and the scatters of outputs like `outs`."""
    from luisarender_tpu_torch.ops.subpacket import unsort

    perm = cluster.coherence_order(*args[:5])
    rays = [x.index_select(0, perm) for x in args[:4]]
    return rays, unsort(outs, perm)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cluster_ab.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.ops import build, cluster, subpacket

    committed = build.CSRC_DIR / "cluster.cu"
    sources = {"committed": committed}
    for arg in argv:
        name, _, path = arg.partition("=")
        sources[name] = Path(path).resolve()
    device = torch.device("cuda:0")
    smi = cs.nvidia_smi_line()
    libs = build_all(build, sources)
    head = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "sources": {k: str(v) for k, v in sources.items()},
            "ptxas": {k: v[1] for k, v in libs.items()}}
    cs.emit(head)
    lines = [head]
    compiled, cap = cs.mesh_heavy_inputs(torch, lt, cluster, device)
    names = list(libs)
    cases = (("closest", "camera rays", cap["closest"][0]),
             ("closest", "bounce-1 rays", cap["closest"][1]),
             ("any", "shadow rays of bounce 0", cap["any"][0]),
             ("any", "shadow rays of bounce 1", cap["any"][1]))
    for kind, label, args in cases:
        any_hit = kind == "any"
        visited = torch.zeros(args[5].shape[0], dtype=torch.bool, device=device)
        t, slot, u, v, occ, walk = cluster.walk_plain(*args, any_hit, visited)
        want = (occ.int(),) if any_hit else (t, slot, u, v)
        winners = 0 if any_hit else int(torch.unique(slot[slot >= 0]).numel())
        perm = cluster.coherence_order(*args[:5])
        srt = tuple(x.index_select(0, perm) for x in args[:4]) + tuple(args[4:])
        err = torch.zeros(1, dtype=torch.int32, device=device)
        rec = {"kernel": f"cluster_{kind}", "input": label, "n": args[0].shape[0],
               "live": int((args[3] > args[2]).sum()),
               "walk": cs.walk_summary(walk),
               "sort_only_ms": cs.events_ms(torch, lambda: sort_only(cs, cluster, args, want),
                                            iters=20),
               "wrapper_sorted_ms": cs.events_ms(
                   torch, lambda: cs.launch_sorted(*args, any_hit, err), iters=20),
               **dict(zip(("bound_ms", "bound_by"),
                          cs.cluster_bound(kind, args, walk, visited, winners))),
               "builds": {}}
        runs = {}
        for k in names:
            for order, a in (("caller", args), ("sorted", srt)):
                run = launcher(torch, cluster, libs[k][0], a, any_hit)
                stats = torch.zeros_like(walk)
                got = run(stats)
                torch.cuda.synchronize()
                if order == "sorted":
                    got, stats = subpacket.unsort(got, perm), subpacket.unsort(stats, perm)
                same = (int(run.err.item()) == 0 and torch.equal(stats, walk)
                        and all(torch.equal(g, w) for g, w in zip(got, want)))
                if not same:
                    raise SystemExit(f"cluster_ab.py: {k} differs from walk_plain on "
                                     f"{label}, {order} order")
                runs[k, order] = run
            b = {"bit_equal": True, "ms": [], "ms_sorted": []}
            if runs[k, "caller"].current:
                for order, key in (("caller", "lanes"), ("sorted", "lanes_sorted")):
                    run = runs[k, order]
                    b[key] = cs.cluster_lanes(torch, cluster,
                                              lambda ctr: run(counters=ctr), device)
            rec["builds"][k] = b
        for turn in (names, names[::-1]):
            for k in turn:
                for order, key in (("caller", "ms"), ("sorted", "ms_sorted")):
                    rec["builds"][k][key].append(cs.device_ms(torch, runs[k, order], iters=20))
        cs.emit(rec)
        lines.append(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "cluster_ab.json").write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
