"""First-use build of the package's CUDA kernels.

Each ``.cu`` file in this directory has a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library under the package's
``_build/`` directory, then loaded with ``ctypes``. All sources are compiled
in parallel (one ``nvcc`` process each, started together). Nothing is built
when the package is imported: only the first kernel launch builds, so the
package imports on a machine without ``nvcc``. A library is named after the
hash of its source, so an edited source is rebuilt and a stale library is
never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parents[1] / "_build"
SOURCES = ("correlation", "correlation_v2", "raycarve", "spa_pcg", "gauss_newton")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source whose library is missing; returns name -> path.
    With ``verbose`` the ptxas resource report of each kernel is printed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    missing = [n for n, t in targets.items() if not t.exists()]
    if not missing:
        return targets
    nvcc = _nvcc()
    procs = {}
    for name in missing:
        tmp = targets[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        if verbose and out:
            print(out)
        os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` is what a kernel takes: device, dtype, shape and
    contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptxas_report(name: str) -> list[str]:
    """What ptxas says of every kernel of source ``name`` (registers, shared
    memory, spills, stack): the source compiled once more to a cubin under
    ``BUILD_DIR``. Needs ``nvcc``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}_report.cubin"
    proc = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin", "-Xptxas", "-v", "-o", str(out), str(SOURCE_DIR / f"{name}.cu")],
        capture_output=True, text=True)
    out.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln or "spill" in ln)
            or "bytes stack frame" in ln]
