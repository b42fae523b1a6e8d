"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout (``build/`` is git-ignored). The hash covers the
source and the flags (a source includes no header of the repo), so an edited source builds anew and an unchanged
one is loaded from the earlier build. :func:`build` starts one ``nvcc``
per missing library, all at once, and waits for them together, so the
build time of a checkout is that of its slowest source.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later
#: kernels; every kernel of the port is compiled for it.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


class Built(NamedTuple):
    path: Path
    #: nvcc's output (ptxas registers, shared memory, spills); empty
    #: when the library was already built.
    log: str


def sources() -> List[str]:
    """Names of every kernel source of the port (``csrc/*.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = None) -> Dict[str, Built]:
    """Compile every named source (all of ``csrc/*.cu`` by default) that
    has no current library, one ``nvcc`` per source, all started
    together. Raises with the compiler's output when one fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, out)
    failed = []
    logs = {}
    for n, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        logs[n] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: Built(p, logs.get(n, "")) for n, p in paths.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build([name])[name].path))
    return lib
