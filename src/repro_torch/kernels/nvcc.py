"""Build a hand-written CUDA source into a shared library with ``nvcc``.

Every kernel of the port is a ``csrc/*.cu`` file with a plain C
interface, compiled for ``sm_90a`` at first use into ``_build/`` beside
this file (listed in ``.gitignore``) and loaded with ``ctypes``.  The
library name carries a digest of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Builds of different
sources may run at the same time (each writes a temporary file and
renames it into place).
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["BUILD_DIR", "BASE_FLAGS", "REPORTS", "build", "nvcc"]

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
#: the last ``-Xptxas -v`` report of each source, by file stem.
REPORTS: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def build(source: pathlib.Path, flags: tuple = (), verbose: bool = False) -> pathlib.Path:
    """Compile ``source`` (once per source content and flags) and return
    the library path.  ``verbose`` adds ``-Xptxas -v`` and prints its
    report (kept in :data:`REPORTS`)."""
    all_flags = (*BASE_FLAGS, *flags)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(all_flags).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if lib_path.exists() and not verbose:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *all_flags, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose:
        REPORTS[source.stem] = proc.stderr
        print(proc.stderr, end="")
    os.replace(tmp, lib_path)
    return lib_path
