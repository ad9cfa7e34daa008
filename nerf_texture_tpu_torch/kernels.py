"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each kernel source ``csrc/<name>.cu`` exposes a plain C entry point.  At
first use it is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into a shared
library under ``build/kernels/`` at the repository root, named by a hash
of the source and the flags: an unchanged source loads the library built
before, a changed one builds anew.  The library is written under a
temporary name and renamed into place, so a build that is cut off never
leaves a half-written library behind.  It is loaded with ``ctypes``.

There is no fallback: a missing ``nvcc`` or a failed build raises.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# --fmad=false: every multiply and add rounds on its own, as PyTorch's
# separate elementwise kernels do, so a kernel and its plain PyTorch
# version on the card compute the same float ops.  -Xptxas -v prints
# registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output (empty when nothing was built)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of nerf_texture_tpu_torch "
        "are built from source at first use and need the CUDA toolkit")


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; returns where it is and what the build cost."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                               f"{src}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(out, time.perf_counter() - t0, res.stdout + res.stderr)


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name).path))
