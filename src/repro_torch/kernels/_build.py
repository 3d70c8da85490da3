"""Build the port's CUDA kernels from the sources in the checkout.

Each kernel is one ``.cu`` file with a plain C entry point, which may
include headers from its own ``csrc/`` directory.  ``nvcc`` compiles it
for Hopper (``sm_90a``) into a shared library of its own, which
``ctypes`` loads: seconds per file, where an extension that includes
PyTorch's headers takes minutes.  Libraries go to ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``), named by a digest
of every file in the kernel's ``csrc/`` and of ``NVCC_FLAGS``, so an
edited source, header or flag is rebuilt and an unchanged one is reused.
Each library keeps its compiler output (the ptxas register report) in a
``.log`` file beside it.  Nothing is built at
import; the first launch on a CUDA tensor builds what it needs, and
``build`` builds several kernels at once, one ``nvcc`` each, all started
together.

No ``--use_fast_math``: the kernels' divisions must round to nearest to
match the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "library",
           "build_log", "ptxas_report"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
SOURCES = {
    "simstep": _PKG / "simstep" / "csrc" / "simstep.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" /
    "flash_attention.cu",
    "selective_scan": _PKG / "selective_scan" / "csrc" / "selective_scan.cu",
}
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    """The library's path: a digest of the flags and of every file (name and
    bytes) under the directory of the kernel's source."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    csrc = SOURCES[name].parent
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(b"\0" + f.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named kernel (default: all) that is not built yet.

    Returns the wall seconds of each compile that ran.  Raises with the
    compiler's output when one fails.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    try:
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp)
        seconds = {}
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            seconds[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[n]}:\n{log}")
            _target(n).with_suffix(".log").write_text(log)
            os.replace(tmp, _target(n))
        return seconds
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]


def build_log(name: str) -> str:
    """The compiler output of kernel ``name``'s current library, saved
    beside it when it was built; empty if it is not built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def ptxas_report(name: str) -> list[str]:
    """One line per compiled kernel function of ``name``'s current library:
    its (mangled) name, registers, shared memory and spills, from the
    ``-Xptxas=-v`` output in ``build_log``."""
    lines, func, spill = [], None, ""
    for raw in build_log(name).splitlines():
        line = raw.strip()
        if "Compiling entry function" in line:
            func = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line:
            spill = line
        elif line.startswith("ptxas info") and "Used" in line and func:
            used = line.split(":", 1)[1].strip()
            lines.append(f"{func}: {used}; {spill}")
            func, spill = None, ""
    return lines
