"""Build the CUDA C++ kernels under ``paddle_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries are built at first use into
``paddle_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
the shared ``csrc/*.cuh`` headers and the flags, so an edited source is
rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "build_all",
           "load_library", "ptxas_report", "sass_opcode_counts"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers too, so an edited header rebuilds its includers
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(name: str) -> Dict[str, object]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns {"name", "path", "seconds", "log"} (``log`` holds nvcc's
    ``-Xptxas -v`` report: registers, shared memory, spills; kept beside
    the library, so a reused one reports it too)."""
    out = _lib_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return {"name": name, "path": str(out), "seconds": 0.0,
                "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return {"name": name, "path": str(out), "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def build_all() -> List[Dict[str, object]]:
    """Build every ``csrc/*.cu``, one ``nvcc`` per source, all started
    together."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


# libraries loaded by this process (``analysis.recompile`` counts them)
LOADS = [0]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built if needed)."""
    LOADS[0] += 1
    return ctypes.CDLL(build(name)["path"])


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of a build's ``-Xptxas -v`` log: its
    registers, static shared memory, stack and spill bytes."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "smem": 0, "stack": 0,
                         "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = _SPILLS.search(line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
            out[name]["smem"] = int(m.group(2) or 0)
    return out


_FUNCTION = re.compile(r"Function : (\S+)")


def sass_opcode_counts(name: str, opcodes) -> Dict[str, int]:
    """Per kernel (mangled name) of ``csrc/<name>.cu``'s library: how many
    of its SASS instructions (``cuobjdump -sass``, beside ``nvcc``) have
    an opcode in ``opcodes`` (``HMMA`` matches ``HMMA.1684.F32.TF32``)."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass", build(name)["path"]],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {name}: {proc.stderr}")
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    wanted = set(opcodes)
    out: Dict[str, int] = {}
    fn = None
    for line in proc.stdout.splitlines():
        m = _FUNCTION.search(line)
        if m:
            fn = m.group(1)
            out[fn] = 0
            continue
        m = op.search(line)
        if fn is not None and m and m.group(1) in wanted:
            out[fn] += 1
    return out
