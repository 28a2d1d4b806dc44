"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use by ``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``csrc/build/`` (listed in ``.gitignore``), named by a content hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused.  No PyTorch header is involved, which keeps a build to seconds.
Sources are built in parallel: one ``nvcc`` process per source, all started
together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("attention", "fps")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source whose library is missing.

    All ``nvcc`` processes start together and are all waited for; then the
    first failure raises with the compiler's output.  The compiler's output
    of a success (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside the library as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, proc, tmp, lib))
    failures = []
    for name, proc, tmp, lib in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
            continue
        Path(f"{lib}.log").write_text(out)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))


def build_log(name: str) -> str:
    """The compiler's output for the current build of ``csrc/<name>.cu``."""
    log = Path(f"{library_path(name)}.log")
    return log.read_text() if log.exists() else ""


Signature = Tuple[Optional[type], Sequence[type]]


def load(name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C entry to its ``(restype, argtypes)``; they
    are set once, when the library is first loaded.
    """
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        signatures = {"nsdp_error_string": (ctypes.c_char_p, [ctypes.c_int]), **signatures}
        for entry, (restype, argtypes) in signatures.items():
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = restype, list(argtypes)
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        msg = lib.nsdp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """Raw handle of PyTorch's current stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
