"""Build variants of a kernel source for the tune scripts
(``tune_flash``, ``tune_conv_bn``): the source with some of its text
replaced, or another file of the same C interface (an older checkout's
source, to time it in the same call), all ``nvcc`` runs started at once.
Needs ``nvcc``."""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

from horovod_tpu_torch import _build


def build_variants(source, variants, names):
    """Builds each named variant of ``csrc/<source>.cu`` (its text
    replacements applied) into ``build/tune/``, all ``nvcc`` runs at once;
    a name ending in ``.cu`` is the path of a file built as it stands.
    Prints each variant's ptxas lines. Returns {name: loaded library}."""
    out = _build.BUILD_DIR.parent / "tune"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    procs = {}
    for i, name in enumerate(names):
        tag = name
        if name.endswith(".cu"):
            text, tag = Path(name).read_text(), f"file{i}"
        else:
            text = src
            for old, new in variants[name].items():
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} is not in the "
                                       "source exactly once")
                text = text.replace(old, new)
        cu = out / f"{source}_{tag}.cu"
        cu.write_text(text)
        lib = out / f"lib{source}_{tag}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln or "Performance" in ln]}),
            flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs
