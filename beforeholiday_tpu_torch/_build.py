"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into ``_build/lib<name>-<hash>.so``,
a library with a plain C interface that :func:`load` opens with ``ctypes``.
No source includes PyTorch's headers, so a build takes seconds, not minutes.
The hash covers the source, every header in ``csrc/`` and the flags, so an
edited source rebuilds and an unchanged one is reused. :func:`build` starts one
``nvcc`` per source, all at once, and waits for every one of them.

Triton kernels compile at their first launch; :func:`triton_cache_env` points
Triton's cache into the same build directory so nothing is written outside the
checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# sm_90a (not sm_90): the arch-specific target that Hopper-only instructions
# (wgmma, setmaxnreg) need
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Every buildable source: ``{name: csrc/<name>.cu}``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = sources().get(name)
    if src is None:
        raise KeyError(f"no CUDA source csrc/{name}.cu")
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (all by default) that are not built yet, in
    parallel. Returns ``{name: library path}``; raises with nvcc's output if
    any build fails."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for n in todo:
        # private temp name, renamed into place when complete: concurrent
        # builders never load a half-written library
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[n])]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"csrc/{n}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def triton_cache_env() -> None:
    """Keep Triton's compile cache inside the build directory unless the
    caller chose one."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
