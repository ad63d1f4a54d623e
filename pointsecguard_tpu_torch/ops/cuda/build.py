"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together,
and the objects link into one shared library with a plain C interface,
loaded with ``ctypes``. Nothing here runs at import:
the library is built at the first kernel launch (or by an explicit
``load_library()``), into ``<repo>/build/kernels/`` — a directory that
``.gitignore`` lists — under a name that carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
Processes that load it at once (the ranks of ``--devices N``) build it
once: the build runs under an exclusive ``flock`` of ``build/kernels/
build.lock``, which the system releases if its holder dies.

Each C entry point takes pointers and the stream as ``void*``, sizes as
``int``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point: name → argtypes (restype is int)
_SIGNATURES = {
    # xyz, start, out, workspace, B, N, npoint, stream
    "psg_fps": (_P, _P, _P, _P, _I, _I, _I, _P),
    # N → the kernel a cloud takes (0 register, 1 cluster, 2 stream; -1 none)
    "psg_fps_route": (_I,),
    # N → floats of psg_fps's workspace a point (0 but on the streaming kernel)
    "psg_fps_workspace_floats": (_I,),
    # vals, out_v, out_i, rows, N, k, stream
    "psg_bottom_k": (_P, _P, _P, _I, _I, _I, _P),
    # vals, out_v, out_i, overflow_rows (null or one int), rows, N, k, stream
    "psg_bottom_k_chunked": (_P, _P, _P, _P, _I, _I, _I, _P),
    # query, points, out_v, out_i, scratch, B, S, N, D, k, stream
    "psg_knn": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # fn, fx, w, afn, afx, K, M, D, stream
    "psg_attentive_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # fn, fx, w, g1, g2, dfn, dfx, dw_part, dw, K, M, D, stream
    "psg_attentive_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # K, M, D → slots of the backward's dW buffer
    "psg_attentive_dw_blocks": (_I, _I, _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: building the port's kernels needs "
                       "the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpsg_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]], log: list[str]) -> None:
    """Run the commands side by side; raise if any of them failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def _build(path: Path) -> None:
    """One ``nvcc -c`` per source, all at once, then one link into
    ``path``; the compilers' output goes to ``build.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log: list[str] = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        so = os.path.join(tmp, path.name)
        try:
            _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(src)]
                      for o, src in zip(objs, _sources())], log)
            _run_all([[_nvcc(), *ARCH, "-shared", "-o", so, *objs]], log)
        finally:
            (BUILD_DIR / "build.log").write_text("".join(log))
        os.replace(so, path)  # atomic: a reader never sees half a file


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / "build.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
                if not path.exists():
                    _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def require_sm90(device) -> None:
    """The library holds sm_90a code only; any other card cannot run it."""
    import torch

    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}"
        )
