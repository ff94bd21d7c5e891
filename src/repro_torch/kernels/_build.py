"""Builds the hand-written CUDA kernels in ``csrc/`` with ``nvcc`` at first
use and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled on its
own into ``build/<name>-<hash>.so`` beside this module (``build/`` is
git-ignored); the hash covers the sources, so an edited kernel is rebuilt.
The compiler's ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside the library as ``<name>-<hash>.ptxas.txt`` and read
by ``ptxas_report``.  A missing ``nvcc`` or a failed compile raises:
nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "build_all", "load",
           "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "rwkv6_scan",
           "rwkv6_scan_bwd", "mamba2_ssd", "mamba2_ssd_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels of "
            "repro_torch are built from source at first use")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this version is already built;
    returns the shared library's path."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; have {SOURCES}")
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def build_all() -> dict[str, Path]:
    """Build every kernel source, one ``nvcc`` per source, all at once."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def ptxas_report(name: str) -> list[dict]:
    """Per kernel of ``csrc/<name>.cu`` as built: its (mangled) name, and
    the registers, static shared memory and spill bytes ``ptxas -v``
    reported.  Builds first if needed."""
    text = build(name).with_suffix(".ptxas.txt").read_text()
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": 0, "smem_bytes": 0,
                   "spill_stores": 0, "spill_loads": 0}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["smem_bytes"] = int(m.group(1)) if m else 0
    return rows
