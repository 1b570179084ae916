"""Build a CUDA source of this package into a shared library at first use.

The route is ``nvcc`` into a ``.so`` with a plain C interface, loaded with
``ctypes``: it needs no PyTorch headers and builds in seconds. Libraries go
to ``build/`` at the repository root, named by a hash of their sources,
the headers they include and the flags, so a changed source or header is
rebuilt and an unchanged one is reused.
There is no fallback: without ``nvcc`` the build raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    seconds: float      # 0.0 when an existing library was reused
    log: str            # nvcc's output, with -Xptxas -v registers and smem


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda), else PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    return shutil.which("nvcc")


def build_library(name: str, sources: Sequence[Path],
                  headers: Sequence[Path] = ()) -> Built:
    """Compile ``sources`` into one library. ``headers`` are the files they
    include: hashed with them, not compiled, and their directories on the
    include path (so a source built from another directory finds them)."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the {name!r} CUDA kernel: nvcc was not found in "
            f"$CUDA_HOME/bin or on PATH. The kernel is compiled from source "
            f"at first use and has no fallback.")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *headers):
        h.update(Path(src).read_bytes())
    includes = [f"-I{d}" for d in dict.fromkeys(
        str(Path(hd).resolve().parent) for hd in headers)]
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *includes, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name!r} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return Built(out, seconds, proc.stdout + proc.stderr)
