"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``hual_tpu_torch/csrc/<name>.cu`` compiles on its own into
``build/hual_tpu_torch/lib<name>-<digest>.so`` at the repository root, where
the digest covers the source, the csrc files it includes and the flags: a
changed source builds anew, an unchanged one is loaded as it is.  The
sources have a plain C interface, so nvcc takes seconds and no PyTorch
header is compiled.  Nothing is built when this module is imported;
:func:`build` runs at the first launch, or ahead of it (``chip_smoke.py``),
one nvcc process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "hual_tpu_torch"
ARCH = "sm_90a"
# -Xptxas -v: nvcc reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the port's "
                           "kernels are compiled with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def names() -> list[str]:
    """The kernel sources: ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source_bytes(name: str) -> bytes:
    """The source of ``csrc/<name>.cu`` and of the csrc files it includes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    included = re.findall(rb'^#include "([^"]+)"', src, flags=re.M)
    return src + b"".join((CSRC / f.decode()).read_bytes() for f in included
                          if (CSRC / f.decode()).exists())


def library_path(name: str) -> Path:
    src = _source_bytes(name)
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile every missing library of ``names`` in parallel.

    Returns ``{"seconds", "log"}`` per name that was compiled (the log holds
    ptxas's resource report); raises with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    compiled, failures = {}, []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        compiled[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return compiled


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
