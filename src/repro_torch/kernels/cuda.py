"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ctypes.
No PyTorch headers are involved, so a build takes seconds.  Libraries land
in ``build/kernels/`` at the repository root, named by a hash of their
source, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is compiled when this module is imported: the first
launch builds what it needs, and :func:`build` compiles every kernel at
once, one ``nvcc`` process per source, all started together.

There is no fallback: a missing ``nvcc``, a failed compile or a failed
load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

#: kernel library name -> source file under ``csrc/``
SOURCES = {"masked_matmul": "masked_matmul.cu", "mask_pack": "mask_pack.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, refused a source, or the library did not load."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME to the CUDA toolkit)")
    return found


def library_path(name: str) -> pathlib.Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source in parallel.  Returns ``{name: {"seconds",
    "ptxas"}}`` for the libraries compiled by this call; ``ptxas`` holds the
    register / shared-memory report of ``-Xptxas -v``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    report, failed = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        tmp.replace(library_path(n))  # atomic: a half-written .so is never seen
        report[n] = {"seconds": time.monotonic() - t0,
                     "ptxas": [ln for ln in log.splitlines() if "ptxas" in ln]}
    if failed:
        raise KernelBuildError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        try:
            lib = ctypes.CDLL(str(library_path(name)))
        except OSError as e:
            raise KernelBuildError(f"loading {name}: {e}") from e
        _loaded[name] = lib
    return lib


def check(status: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {status}")
