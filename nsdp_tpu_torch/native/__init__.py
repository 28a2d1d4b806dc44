"""ctypes bindings to the port's native C++ geometry runtime.

The counterpart of ``nsdp_tpu/native/__init__.py:60-102``:
``nearest_neighbor_distances`` (an exact float32 KD-tree query, with
``return_index``) and ``marching_cubes`` (marching tetrahedra with vertex
welding) over ``src/nsdp_native.cpp``, the port's own copy of the JAX
package's source.

The library is built at first use, never on import, by ``c++`` with the
flags of ``nsdp_tpu/native/Makefile:2`` (:data:`CXXFLAGS`), so on one
machine both packages' libraries compute the same bits, the compiler's FMA
contraction included.  It goes into ``build/`` (listed in ``.gitignore``)
under a name keyed by a hash of the source, the compiler command and the
flags, as ``ops/_build.py`` keys its ``nvcc`` builds: an edited source
rebuilds, an unchanged one is reused.  A failed build raises; nothing falls
back to another method, so a metric is never computed by a different
search without notice.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "nsdp_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX = "c++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join((CXX, *CXXFLAGS)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libnsdp_native-{digest}.so"


def build() -> Path:
    """Compile the library if it is missing -> its path.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build: cannot run {CXX!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({CXX} {' '.join(CXXFLAGS)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds each install a whole file
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        f32p, i32p, i64p = (ctypes.POINTER(t) for t in
                            (ctypes.c_float, ctypes.c_int32, ctypes.c_int64))
        signatures = {
            "nsdp_nn_query": [f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p, i32p],
            "nsdp_marching_tetrahedra": [f32p, ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_float, i64p, i64p],
            "nsdp_mc_copy": [f32p, i32p],
            "nsdp_mc_free": [],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def nearest_neighbor_distances(
    queries: np.ndarray, points: np.ndarray, return_index: bool = False
):
    """Exact euclidean NN distance (float32) of each query to the point set
    (KD-tree); with ``return_index`` also the int32 index of the nearest."""
    lib = load()
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    points = np.ascontiguousarray(points, dtype=np.float32)
    for name, a in (("queries", queries), ("points", points)):
        if a.ndim != 2 or a.shape[1] != 3:  # the C side reads 3 floats a row
            raise ValueError(f"{name} must be (N, 3), got {a.shape}")
    n_q = len(queries)
    dist = np.empty(n_q, dtype=np.float32)
    idx = np.empty(n_q, dtype=np.int32) if return_index else None
    lib.nsdp_nn_query(
        _fptr(points), len(points), _fptr(queries), n_q, _fptr(dist),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) if return_index
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_int32)),
    )
    if return_index:
        return dist, idx
    return dist


def marching_cubes(
    grid: np.ndarray, level: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface {grid = level} as (verts (V,3) f32 in index coords,
    faces (F,3) i32), via native marching tetrahedra with vertex welding.

    The C++ keeps the mesh in a ``thread_local`` between the extraction and
    the copy (``src/nsdp_native.cpp:172``); the three calls below run on the
    calling thread, one after another."""
    lib = load()
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-D, got {grid.shape}")
    nx, ny, nz = grid.shape
    n_verts = ctypes.c_int64()
    n_faces = ctypes.c_int64()
    lib.nsdp_marching_tetrahedra(
        _fptr(grid), nx, ny, nz, ctypes.c_float(level),
        ctypes.byref(n_verts), ctypes.byref(n_faces),
    )
    verts = np.empty((n_verts.value, 3), dtype=np.float32)
    faces = np.empty((n_faces.value, 3), dtype=np.int32)
    lib.nsdp_mc_copy(
        _fptr(verts), faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    )
    lib.nsdp_mc_free()
    return verts, faces
