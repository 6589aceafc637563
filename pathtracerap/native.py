"""ctypes bindings for the native host runtime (native/ptap_native.cc).

The CUDA reference implements its whole host layer in C++ (Assimp mesh
import ``Scene.cpp:226-291``, grid build ``Scene.cpp:293-396``, BMP writer
``Renderer.cpp:15-63``).  This module exposes this framework's equivalent
native components with the same semantics as the pure-Python
implementations in :mod:`pathtracerap.io.obj`,
:mod:`pathtracerap.scene.grid` and :mod:`pathtracerap.io.bmp` —
either backend can oracle the other (tests/test_native.py).

Loading policy:

* ``PTAP_NATIVE=0`` disables native entirely (pure Python everywhere);
* otherwise the shared library is loaded from ``native/libptap_native.so``
  if present, else built on first use with ``make`` (best-effort — any
  failure silently falls back to Python, because the compute path never
  depends on this layer).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libptap_native.so")

_lock = threading.Lock()
_lib = None
_load_attempted = False


def _try_build() -> bool:
    try:
        subprocess.run(
            ["make", "-s"],
            cwd=_NATIVE_DIR,
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64 = ctypes.c_int64
    c_p = ctypes.c_void_p
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    lib.ptap_obj_load.restype = c_p
    lib.ptap_obj_load.argtypes = [ctypes.c_char_p, ctypes.c_float]
    lib.ptap_obj_error.restype = ctypes.c_char_p
    lib.ptap_obj_error.argtypes = [c_p]
    lib.ptap_obj_sizes.restype = None
    lib.ptap_obj_sizes.argtypes = [c_p, i64p, i64p]
    lib.ptap_obj_copy.restype = None
    lib.ptap_obj_copy.argtypes = [c_p, f32p, f32p, f32p, i32p, f32p, f32p]
    lib.ptap_obj_free.restype = None
    lib.ptap_obj_free.argtypes = [c_p]

    lib.ptap_grid_build.restype = c_p
    lib.ptap_grid_build.argtypes = [
        f32p, c_i64, f32p, f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ptap_grid_nindices.restype = c_i64
    lib.ptap_grid_nindices.argtypes = [c_p]
    lib.ptap_grid_copy.restype = None
    lib.ptap_grid_copy.argtypes = [c_p, i32p, i32p, i32p, f32p]
    lib.ptap_grid_free.restype = None
    lib.ptap_grid_free.argtypes = [c_p]

    lib.ptap_write_bmp.restype = ctypes.c_int
    lib.ptap_write_bmp.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def get_lib():
    """Return the loaded native library, or ``None`` if unavailable."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("PTAP_NATIVE", "1") == "0":
            return None
        if not os.path.exists(_SO_PATH) and not _try_build():
            return None
        try:
            _lib = _bind(ctypes.CDLL(_SO_PATH))
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_native(path: str, scale: float):
    """Native OBJ import; returns the same tuple of arrays the Python
    loader assembles into :class:`~pathtracerap.io.obj.ObjMesh`.

    Raises ``ValueError`` with the same messages as the Python loader
    (non-triangle faces, missing file, empty mesh)."""
    lib = get_lib()
    assert lib is not None, "native library not loaded"
    h = lib.ptap_obj_load(path.encode(), ctypes.c_float(scale))
    try:
        err = lib.ptap_obj_error(h)
        if err is not None:
            raise ValueError(err.decode())
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.ptap_obj_sizes(h, ctypes.byref(nv), ctypes.byref(nt))
        pos = np.empty((nv.value, 3), np.float32)
        nrm = np.empty((nv.value, 3), np.float32)
        uv = np.empty((nv.value, 2), np.float32)
        tris = np.empty((nt.value, 3), np.int32)
        bbmin = np.empty(3, np.float32)
        bbmax = np.empty(3, np.float32)
        lib.ptap_obj_copy(h, _f32p(pos), _f32p(nrm), _f32p(uv), _i32p(tris),
                          _f32p(bbmin), _f32p(bbmax))
        return pos, nrm, uv, tris, bbmin, bbmax
    finally:
        lib.ptap_obj_free(h)


def build_grid_native(tri_verts: np.ndarray, bbox_min: np.ndarray,
                      bbox_max: np.ndarray, dims, tri_index_base: int):
    """Native CSR uniform-grid build; identical output to
    :func:`pathtracerap.scene.grid.build_uniform_grid`."""
    lib = get_lib()
    assert lib is not None, "native library not loaded"
    tv = np.ascontiguousarray(tri_verts, dtype=np.float32)
    bmin = np.ascontiguousarray(bbox_min, dtype=np.float32)
    bmax = np.ascontiguousarray(bbox_max, dtype=np.float32)
    gx, gy, gz = (int(d) for d in dims)
    nvox = gx * gy * gz
    h = lib.ptap_grid_build(_f32p(tv), ctypes.c_int64(tv.shape[0]),
                            _f32p(bmin), _f32p(bmax), gx, gy, gz,
                            int(tri_index_base))
    try:
        n_idx = lib.ptap_grid_nindices(h)
        starts = np.empty(nvox, np.int32)
        counts = np.empty(nvox, np.int32)
        indices = np.empty(max(n_idx, 1), np.int32)
        width = np.empty(3, np.float32)
        lib.ptap_grid_copy(h, _i32p(starts), _i32p(counts), _i32p(indices),
                           _f32p(width))
        return width, starts, counts, indices[:n_idx].copy()
    finally:
        lib.ptap_grid_free(h)


def write_bmp_native(path: str, image: np.ndarray, parity: bool) -> None:
    """Native BMP write, byte-identical to :func:`io.bmp.write_bmp`."""
    lib = get_lib()
    assert lib is not None, "native library not loaded"
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = img.shape[:2]
    rc = lib.ptap_write_bmp(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(w), int(h), 1 if parity else 0)
    if rc != 0:
        raise OSError(f"ptap_write_bmp failed with code {rc} for {path}")
