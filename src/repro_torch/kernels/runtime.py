"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``src/repro_torch/csrc/`` with
a plain C interface.  It is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library and bound with ``ctypes``: no
PyTorch headers are compiled, so a build takes seconds.  Builds happen
at first use, from the sources in the checkout, into
``src/repro_torch/_build/`` (git-ignored); the library's file name
carries a digest of its source and flags, so an edited source is never
served from a stale build.  :func:`build` compiles several sources in
parallel, one ``nvcc`` process each.  :func:`sources_from` serves a
kernel from another directory's source for the length of a block, so
two designs with the same C interface can be timed in turns.

Every wrapper that launches a kernel calls :func:`count_launch` right
at the launch and nowhere else, so a run can show that its path went
through the kernels (:func:`launch_counts`, :func:`reset_launch_counts`).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("temporal_sample", "cache_gather", "temporal_attn",
           "flash_attention", "flash_attention_sm90", "flash_attention_bwd",
           "flash_attention_bwd_sm90", "selective_scan",
           "selective_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_sigs: Dict[str, Dict[str, tuple]] = {}
_counts: Dict[str, int] = {}

# ctypes spellings of the C interface's argument kinds
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source on the machine with the card")
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(csrc.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS,
          csrc: Path = CSRC) -> Dict[str, str]:
    """Compile every listed kernel whose library is missing from the
    sources in ``csrc``, one ``nvcc`` per source, all started together.
    Returns each name's compiler output (``-Xptxas -v`` register and
    spill report); raises with the compiler's messages if any build
    fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", f"-I{csrc}",
               "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs = {name: "cached" for name in names if name not in procs}
    failed = []
    for name, (p, tmp, out) in procs.items():
        text, _ = p.communicate()
        logs[name] = text
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode})\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``name`` (built first if needed), with
    ``argtypes``/``restype`` declared from ``signatures``: C function
    name -> tuple of ctypes argument types (every function returns the
    launch's ``cudaError_t`` as an int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = _open(library_path(name), signatures)
            _sigs[name] = signatures
        return lib


def _open(path: Path, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def sources_from(name: str, csrc: Path) -> Iterator[None]:
    """Inside the block, ``name``'s wrapper launches the kernel built
    from ``csrc/<name>.cu`` (another design with the same C interface,
    such as an earlier commit's sources) instead of the checkout's; the
    checkout's comes back after it.  The wrapper must have loaded its
    own library first."""
    build([name], csrc)
    with _lock:
        own = _libs[name]
        _libs[name] = _open(library_path(name, csrc), _sigs[name])
    try:
        yield
    finally:
        with _lock:
            _libs[name] = own


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device, ndim: int) -> None:
    """Wrapper-side argument check: device, dtype, rank, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def count_launch(name: str) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _lock:
        _counts.clear()
