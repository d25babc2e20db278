"""ctypes bindings for the native scan-log runtime (native/scanlog.cpp).

Own copy of the JAX package's ``io/native_log.py``. Binary "RSLG" logs are
written from any ScanLog (``write_rslg``) and read back either by random
access (``decode_scan``) or through the native prefetch/decode worker
(``NativeScanStream``), which performs the reference's polar→cartesian +
range-gating ingest (BuildRangeDataContainer, roborts_slam_node.cpp:290-311)
off the engine thread. The same file format as the JAX package's: a log
written by either package reads in the other.

The repository's ``native/scanlog.cpp`` is compiled with ``g++`` at first
use into the port's build directory (``roborts_slam_tpu_torch/_build/``,
where the CUDA kernels' libraries go, under the same build lock), never into
``native/``. Without ``g++`` (or without the source) the native runtime is
unavailable and ``NativeScanStream`` / ``decode_scan`` raise; ``write_rslg``
needs no native code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path

import numpy as np

from ..models.scan import LaserModel
from ..ops.cuda import build
from .scan_log import ScanLog

_SRC = Path(__file__).resolve().parents[2] / "native" / "scanlog.cpp"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_HEADER = struct.Struct("<4sIQIB3x5d")
MAGIC = b"RSLG"


def write_rslg(log: ScanLog, path: str) -> None:
    """Serialize a ScanLog to the fixed-stride binary format."""
    laser = log.laser
    has_gt = log.gt_poses is not None
    with open(path, "wb") as f:
        f.write(_HEADER.pack(
            MAGIC, 1, len(log), laser.num_beams, int(has_gt),
            laser.angle_min, laser.angle_max, laser.range_min,
            laser.range_max, laser.range_threshold_scale))
        for i in range(len(log)):
            f.write(struct.pack("<d", float(log.times[i])))
            f.write(np.asarray(log.odom[i], "<f8").tobytes())
            if has_gt:
                f.write(np.asarray(log.gt_poses[i], "<f8").tobytes())
            f.write(np.asarray(log.ranges[i], "<f4").tobytes())


def _library_path() -> Path:
    """The built library, named after the hash of the source and flags so
    that an edited source is rebuilt and a stale library never loaded."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return build.BUILD_DIR / f"libscanlog_{digest}.so"


def _build_native() -> Path | None:
    """Compile ``native/scanlog.cpp`` if its library is missing; ``None``
    when there is no source or no ``g++``. Callers hold ``build._lock``."""
    if not _SRC.exists():
        return None
    so = _library_path()
    if so.exists():
        return so
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    os.replace(tmp, so)
    return so


_lib = None


def _load_lib():
    global _lib
    with build._lock:
        if _lib is not None:
            return _lib
        so = _build_native()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.rslg_open.restype = ctypes.c_void_p
        lib.rslg_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.rslg_meta.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.POINTER(ctypes.c_uint32),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_double)]
        lib.rslg_decode.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_double),
                                    ctypes.POINTER(ctypes.c_double),
                                    ctypes.POINTER(ctypes.c_double)]
        lib.rslg_next.restype = ctypes.c_long
        lib.rslg_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_double)]
        lib.rslg_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeScanStream:
    """Streaming reader: pops (index, points, mask, n_valid, time, odom)
    decoded ahead of time by the native worker thread."""

    def __init__(self, path: str, max_points: int, ring_slots: int = 8):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native scanlog runtime unavailable (no g++)")
        self._lib = lib
        self._h = lib.rslg_open(os.fsencode(path), max_points, ring_slots)
        if not self._h:
            raise IOError(f"cannot open RSLG log: {path}")
        self.max_points = max_points
        n_scans = ctypes.c_uint64()
        n_beams = ctypes.c_uint32()
        has_gt = ctypes.c_int()
        laser5 = (ctypes.c_double * 5)()
        lib.rslg_meta(self._h, ctypes.byref(n_scans), ctypes.byref(n_beams),
                      ctypes.byref(has_gt), laser5)
        self.n_scans = int(n_scans.value)
        self.laser = LaserModel(
            angle_min=laser5[0], angle_max=laser5[1], range_min=laser5[2],
            range_max=laser5[3], num_beams=int(n_beams.value),
            range_threshold_scale=laser5[4])

    def __iter__(self):
        lib = self._lib
        MP = self.max_points
        while True:
            pts = np.empty((MP, 2), np.float32)
            msk = np.empty(MP, np.uint8)
            nv = ctypes.c_int()
            t = ctypes.c_double()
            odom = (ctypes.c_double * 3)()
            idx = lib.rslg_next(
                self._h, pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                msk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(nv), ctypes.byref(t), odom)
            if idx < 0:
                return
            yield (int(idx), pts, msk.astype(bool), int(nv.value),
                   float(t.value), np.array(odom))

    def close(self):
        if self._h:
            self._lib.rslg_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def decode_scan(path: str, index: int, max_points: int):
    """Random-access decode of one scan (native; no worker thread)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native scanlog runtime unavailable (no g++)")
    h = lib.rslg_open(os.fsencode(path), max_points, 0)
    if not h:
        raise IOError(path)
    try:
        pts = np.empty((max_points, 2), np.float32)
        msk = np.empty(max_points, np.uint8)
        nv = ctypes.c_int()
        t = ctypes.c_double()
        odom = (ctypes.c_double * 3)()
        gt = (ctypes.c_double * 3)()
        rc = lib.rslg_decode(
            h, index, pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            msk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(nv), ctypes.byref(t), odom, gt)
        if rc != 0:
            raise IndexError(index)
        return pts, msk.astype(bool), int(nv.value), float(t.value), np.array(odom)
    finally:
        lib.rslg_close(h)
