"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface and loaded with ctypes. The library goes into
`luisarender_tpu_torch/_build/` (git-ignored) under a name that carries a
hash of its source, the shared headers `csrc/*.cuh` and the flags, so an
edited source or header is rebuilt and a fresh
checkout builds at first use. Nothing is built when a module is imported:
`load_library` runs at the first launch on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# --fmad=false and no fast math: kernels round like their plain PyTorch
# versions (see each source's note); -Xptxas -v: ptxas's register, shared
# memory and spill report, kept beside the library (`ptxas_report`)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the luisarender_tpu_torch kernels")


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's key
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / f"{name}.cu",
                                            *sorted(CSRC_DIR.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def compile_library(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    its path."""
    out = library_path(name)
    if not out.exists():
        compile_source(CSRC_DIR / f"{name}.cu", out)
    return out


def compile_source(src: Path, out: Path) -> None:
    """nvcc `src` into the shared library `out` with NVCC_FLAGS, ptxas's
    report beside it (`out` with the suffix .ptxas.txt)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file


def _kernel_name(mangled: str) -> str:
    """The kernel's own name in a mangled `_ZN<len><name>...E...` name: the
    last of its length-prefixed identifiers (the anonymous namespace's
    comes first), with the integer and bool arguments of a template as
    `<128>` or `<true>`."""
    import re

    names, rest = [], mangled[3 if mangled.startswith("_ZN") else 2:]
    while rest and rest[0].isdigit():
        n = re.match(r"\d+", rest).group(0)
        names.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    if not names:
        return mangled
    args = re.match(r"I((?:L[ib]-?\d+E)+)E", rest)
    if args:
        vals = [v if k == "i" else ("true" if v == "1" else "false")
                for k, v in re.findall(r"L([ib])(-?\d+)E", args.group(1))]
        return f"{names[-1]}<{','.join(vals)}>"
    return names[-1]


def parse_ptxas(text: str) -> dict:
    """ptxas's -v report, per kernel: {kernel: {registers, stack_bytes,
    spill_stores, spill_loads, smem_bytes}}."""
    import re

    report, kernel = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = _kernel_name(m.group(1))
            report[kernel] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernel:
            report[kernel].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            report[kernel].update(registers=int(m.group(1)),
                                  smem_bytes=int(smem.group(1)) if smem else 0)
    return report


def ptxas_report(name: str) -> dict:
    """ptxas's report of csrc/<name>.cu's last build (see parse_ptxas)."""
    path = library_path(name).with_suffix(".ptxas.txt")
    return parse_ptxas(path.read_text()) if path.exists() else {}


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and load it; the caller keeps the
    handle and declares the C signatures."""
    return ctypes.CDLL(str(compile_library(name)))
