"""One run of one benchmark cell of luisarender_tpu_torch on a CUDA card.

    python3 -m lrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (BENCHMARK.json names them),
sets the program up and warms every shape the window uses (set-up), runs
the traffic for --seconds, then checks what the window produced against
the plain reference and prints one JSON line: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones from a torch.profiler trace of the window), `device` and,
traced, `breakdown`; `checks`, last, holds each number compared beside its
limit, which also go to standard error. Without a CUDA card with enough
devices it prints no result and exits non-zero.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import jobs, profiling, spec  # noqa: E402

# whole top-level module names that no run may hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "luisarender_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is a forbidden one, compared
    as a whole word (luisarender_tpu_torch is not luisarender_tpu)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def steady_allocator():
    """Hold glibc's malloc in the state its dynamic mmap threshold settles
    in (blocks up to 32 MiB from the heap, which is not trimmed), from the
    start: each job's image lands in a fresh 12 MB host array, and whether
    that came from a new mapping, with its page faults, or from the heap
    otherwise depends on the process's allocation history, and put runs in
    two modes ~15% apart."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    libc.mallopt(m_mmap_threshold, 32 << 20)
    libc.mallopt(m_trim_threshold, 64 << 20)


def parse(argv):
    p = argparse.ArgumentParser(prog="lrbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Run:
    """What a run recorded, as the per-layer readers see it."""

    def __init__(self, cell, job, trace, work):
        self.cell = cell
        self.job = job
        self.trace = trace
        self.work = work  # the reference's counts of the checked paths


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def run_cell(cell, seed, seconds, trace, device, t_process, hook=None):
    """Set up, warm up, measure, check. Returns the result dict (without
    the device's name) and the checks; `hook(job)` may replace the job's
    entry after set-up (the fault tests)."""
    import torch

    job = jobs.make(cell, seed, device)
    job.setup()
    if hook is not None:
        hook(job)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    rec = profiling.Recorder(bool(trace))
    t_window = time.perf_counter()
    job.run_window(seconds, rec)
    print(f"lrbench: window and its trace {time.perf_counter() - t_window:.3f} s", file=sys.stderr)
    if on_cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {', '.join(bad)}")
    job.release()
    if on_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, work = job.compare()
    print(f"lrbench: setup {setup_s:.3f} s, reference check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    limits = cell.checks["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    attempted, failed = job.attempted()
    correct = (failed == 0 and numbers["jobs_checked"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    run = Run(cell, job, rec.trace, work)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = job.end_to_end()
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[spec.quantity(m["name"])], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else "cpu",
                         "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = profiling.busy_s(rec.trace)
        result["device"]["window_s"] = profiling.window_s(rec.trace)
        result["breakdown"] = profiling.breakdown(rec.trace)
    return result, checks


def main(argv=None):
    args = parse(argv)
    steady_allocator()
    import torch

    print(f"lrbench: import torch {time.perf_counter() - T_PROCESS:.3f} s", file=sys.stderr)

    cell = spec.cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lrbench: {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"lrbench: CUDA found {time.perf_counter() - T_PROCESS:.3f} s", file=sys.stderr)
    # one host thread: the program's work is on the card, and idle intra-op
    # threads only contend with it for the host's cores
    torch.set_num_threads(1)
    result, checks = run_cell(cell, args.seed, args.seconds, args.trace,
                              torch.device("cuda", 0), T_PROCESS)
    result["device"]["kind"] = torch.cuda.get_device_name(0)
    result["device"]["power"] = power_limit()
    result["checks"] = checks
    print(json.dumps(result))
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
