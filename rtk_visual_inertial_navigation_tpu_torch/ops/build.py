"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_ext/lib<name>-<hash>.so`` at
the root of the checkout, at first use; the hash of the source keeps a
stale library from being loaded.  ``build`` starts one ``nvcc`` per missing
library, all at once.  Failures raise: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _flags(defines=()) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def library_path(name: str, defines=()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{tag.hexdigest()[:12]}.so"


def build(names, verbose: bool = False, defines=()) -> dict:
    """Compile every library in ``names`` that is not built yet, in
    parallel, with the preprocessor ``defines``.  Returns {name: compiler
    output} for the ones compiled (``verbose`` adds ptxas register/spill
    reports)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines),
               *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built first if needed."""
    build([name], defines=defines)
    return ctypes.CDLL(str(library_path(name, defines)))
