"""Build a CUDA source of ``csrc/`` into a shared library at first use.

The kernels' wrappers bind the library through ctypes (a plain C
interface, so ``nvcc`` takes seconds, not the minutes a source that
includes PyTorch's headers takes); the serving mux builds its C++
source (``native/motcpp_mux.cpp``) the same way with ``g++``. Each
library lands in
``motcpp_tpu_torch/_build/`` under a name keyed on a hash of its source
and flags, so an edited source or flag set is rebuilt and an unchanged
one is reused. Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: Hopper only: ``sm_90a`` keeps wgmma and setmaxnreg available
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
SHARED_FLAGS = ("-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build(source: Path, flags: tuple, name: str,
          compiler: str | None = None) -> Path:
    """Compile ``source`` with ``flags`` into ``lib<name>_<hash>.so``
    unless that library exists; returns its path. ``compiler`` defaults
    to :func:`nvcc`. The compiler's messages (``-Xptxas -v`` among the
    flags puts each kernel's registers and spills there) are kept beside
    it as ``.log``. The library is written under a name of this process
    and renamed into place, so concurrent builds never load a half-written
    file."""
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cc = compiler or nvcc()
    proc = subprocess.run(
        [cc, *flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed on {source}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
