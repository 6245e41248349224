"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file has a plain C interface (no PyTorch headers), so
one ``nvcc`` call per source takes seconds. A library is built at first
use into ``build/kernels/<name>-<hash>/`` at the root of the checkout (or
under ``$REPRO_TORCH_BUILD_DIR``), where ``<hash>`` covers the source and
the flags: an edit rebuilds, an unchanged source reuses the library. The
build runs only when a kernel is first needed on a CUDA tensor, never at
import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_dir(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_root() / f"{name}-{h}"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``lib<name>.so`` unless the hashed
    build directory already holds it. Returns the library path; nvcc's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``build.log`` beside it."""
    out_dir = _lib_dir(name)
    lib = out_dir / f"lib{name}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed on {name}.cu (rc={proc.returncode}):\n"
            + proc.stdout + proc.stderr
        )
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """nvcc's output from the build of ``csrc/<name>.cu`` ('' if none)."""
    log = _lib_dir(name) / "build.log"
    return log.read_text() if log.is_file() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``, declaring
    ``{function: (argtypes, restype)}``. Loaded once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _loaded[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA error {rc} at launch")


class LaunchCounter:
    """Counts kernel launches (one per wrapper call that launches) and,
    where the wrapper passes them, the input shapes they ran at."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.shapes = set()

    def hit(self, shape) -> None:
        """One launch at ``shape``."""
        self.count += 1
        self.shapes.add(tuple(shape))
