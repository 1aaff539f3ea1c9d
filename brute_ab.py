#!/usr/bin/env python3
"""Time builds of the brute-force trace kernels' source against each other on
one CUDA card, with the committed build among them.

    python3 brute_ab.py [--pairs K] [NAME=PATH.cu ...]

Each PATH is a CUDA source with csrc/brute.cu's C interface: another design
of the kernels, or the source of an earlier commit unpacked with `git
archive` into a git-ignored directory. A library that exports
`brute_counters` takes this tree's interface (lane counters, a bool
occlusion output); one that does not, the earlier one-thread-a-ray
kernels' (int32 occlusion). `committed` is csrc/brute.cu. The sources are
built in parallel as cluster_ab.py builds them.

Every build runs on the 16 inputs of one sample of chip_smoke.py's general
scene (testing.cornell_box at 512^2 plus an icosphere, 352 triangles: the
closest-hit rays of bounces 0-7 and their shadow rays). Per input it prints
a JSON line: each build's agreement with the plain version (every output
bit for bit, or the run fails), its device ms in turns (the builds in
order, then in reverse, K times, 1 by default; CUDA events around
launches queued behind a spin kernel, chip_smoke.py device_ms), its lane
counters where it has them
(chip_smoke.py brute_lanes), the live share of lanes, the share of the row
loop's lane-slots one thread a lane gives (chip_smoke.py simt_share) and the
bound (chip_smoke.py kernel_bounds). The last line sums each build's mean
ms over the 16 launches of the sample, and its ms of each turn. The lines
also go to chiprun_out/brute_ab.json.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def launcher(torch, lib, kind, args):
    """A function (counters=None) -> raw outputs that launches `lib`'s kernel
    of `kind` once on `args` (o, d, t_min, t_max, table)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "brute_counters")
    fn = lib.brute_closest if kind == "closest" else lib.brute_any
    n_out = 4 if kind == "closest" else 1
    fn.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * (n_out + (1 if current else 0)) + [i32, ptr]
    fn.restype = i32
    o, table = args[0], args[4]
    n, dev = o.shape[0], o.device
    common = tuple(x.data_ptr() for x in args) + (n, table.shape[0])

    def run(counters=None):
        if kind == "closest":
            outs = (torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
                    torch.empty(n, device=dev), torch.empty(n, device=dev))
        else:
            outs = (torch.empty(n, dtype=torch.bool if current else torch.int32, device=dev),)
        extra = (0 if counters is None else counters.data_ptr(),) if current else ()
        rc = fn(*common, *(x.data_ptr() for x in outs), *extra, dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"brute {kind} launch failed: CUDA error {rc}")
        return outs

    run.current = current
    return run


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("brute_ab.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import luisarender_tpu_torch as lt
    from cluster_ab import build_all
    from luisarender_tpu_torch.ops import brute, build

    pairs = 1
    if argv[:1] == ["--pairs"]:
        pairs, argv = int(argv[1]), argv[2:]
    sources = {"committed": build.CSRC_DIR / "brute.cu"}
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
    cap = cs.general_inputs(torch, lt, brute, device)
    names = list(libs)
    total = {k: 0.0 for k in names}
    turns = {k: [0.0] * (2 * pairs) for k in names}
    cases = [("closest", f"bounce {b} rays", a) for b, a in enumerate(cap["closest"])]
    cases += [("any", f"shadow rays of bounce {b}", a) for b, a in enumerate(cap["any"])]
    for kind, label, args in cases:
        if kind == "closest":
            want = brute.closest_plain(*args)
        else:
            want = (brute.any_plain(*args),)
        rows, ops = cs.brute_work(torch, brute, kind, *args)
        bound_ms, bound_by = cs.kernel_bounds(torch, kind, rows, ops, args[4])
        rec = {"kernel": f"brute_{kind}", "input": label, "n": args[0].shape[0],
               "rows": args[4].shape[0], "live": int((rows > 0).sum()),
               "live_share_of_lanes": float((rows > 0).float().mean()),
               "simt_share_one_thread_a_lane": cs.simt_share(rows),
               "bound_ms": bound_ms, "bound_by": bound_by, "builds": {}}
        runs = {}
        for k in names:
            run = launcher(torch, libs[k][0], kind, args)
            got = run()
            torch.cuda.synchronize()
            if kind == "any":
                got = (got[0] != 0,)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"brute_ab.py: {k} differs from the plain version on "
                                 f"{kind} {label}")
            b = {"bit_equal": True, "ms": []}
            if run.current:
                b["lanes"] = cs.brute_lanes(torch, brute, lambda ctr: run(counters=ctr), device)
            rec["builds"][k] = b
            runs[k] = run
        for turn in (names, names[::-1]) * pairs:
            for k in turn:
                rec["builds"][k]["ms"].append(cs.device_ms(torch, runs[k], iters=20))
        for k in names:
            ms = rec["builds"][k]["ms"]
            total[k] += sum(ms) / len(ms)
            turns[k] = [a + b for a, b in zip(turns[k], ms)]
        cs.emit(rec)
        lines.append(rec)
    summary = {"sample_ms": total, "sample_ms_by_turn": turns, "sample_launches": len(cases)}
    cs.emit(summary)
    lines.append(summary)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "brute_ab.json").write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
