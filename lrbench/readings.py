"""The readings that the limits of `correct` are set from, in one process:
sound runs of the program on many seeds, the control (the reference in
bfloat16 in the program's place) and the planted faults (faults.py) on a
few, each over a short window at the cell's own size and load.

    python3 -m lrbench.readings --workload <cell> --seconds 3 \\
        --seeds 1 2 3 ... --control-seeds 4 5 6 [--faults stale half altered]

Prints, and appends to chiprun_out/readings_<cell>.jsonl, one JSON line a
run: what ran, its seed and the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import faults, jobs, profiling, spec


def reading(cell, seed, seconds, device, what, fault=None):
    job = jobs.make(cell, seed, device)
    job.setup()
    undo = faults.FAULTS[fault](job) if fault else None
    try:
        job.run_window(seconds, profiling.Recorder(False))
    finally:
        if undo:
            undo()
    job.release()
    numbers, _ = job.compare(precision_of_program="bf16" if what == "control" else None)
    return {"cell": cell.name, "what": what, "fault": fault, "seed": seed,
            "jobs": len(job.records), **numbers}


def main(argv=None):
    p = argparse.ArgumentParser(prog="lrbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("lrbench.readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    out = spec.ROOT / "chiprun_out" / f"readings_{cell.name}.jsonl"
    out.parent.mkdir(exist_ok=True)
    plan = [("program", s, None) for s in args.seeds]
    plan += [("control", s, None) for s in args.control_seeds]
    plan += [("fault", s, f) for f in args.faults for s in args.control_seeds]
    with open(out, "a") as f:
        for what, seed, fault in plan:
            t = time.perf_counter()
            rec = reading(cell, seed, args.seconds, device, what, fault)
            rec["seconds"] = time.perf_counter() - t
            line = json.dumps(rec)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
