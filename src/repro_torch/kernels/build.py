"""Build, load and launch the port's CUDA sources.

Every kernel module (``flash_attention``, ``rglru``, ``wkv6``) keeps its
source in ``repro_torch/csrc/`` behind a plain C interface whose entry
points take the stream last and return ``cudaGetLastError()``, and loads
the library with ``ctypes`` (:func:`load`); :func:`check_same`,
:func:`check_aligned`, :func:`check_f32` and :func:`ptr` are the wrappers' shared input
checks.  :func:`build` compiles sources for
``sm_90a`` into ``build/kernels/<name>-<source digest>.so`` at the
checkout root (listed in ``.gitignore``), from the repository's sources
only, at first use.
The library is written under a temporary name and renamed, so a stale or
half-written build is never loaded; several sources compile at once, one
``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

#: The entry points' dtype argument: 0 float32, 1 bfloat16.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: ``build/kernels`` at the checkout root (listed in ``.gitignore``).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return str(path)


def library_path(source: Path) -> Path:
    """Where ``source``'s library lives: its name carries the source's hash."""
    digest = hashlib.sha1(Path(source).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source whose library is not built yet, all at once,
    and return the libraries' paths in the order given.  Raises on the
    first failed compile, with ``nvcc``'s errors (the full log is kept
    beside the library as ``<name>-<digest>.log``)."""
    outs = [library_path(s) for s in sources]
    jobs = []
    for src, out in zip(sources, outs):
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
        jobs.append((out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    failed = []
    for out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{out.name}: nvcc failed (rc={proc.returncode}):\n{log[-4000:]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(source: Path, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build ``source`` (if needed) and load it, with each entry point's
    ``argtypes`` (``ctypes.c_void_p`` for every pointer and the stream, so
    64-bit addresses are not cut) and an ``int`` return code."""
    lib = ctypes.CDLL(str(build(source)[0]))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def stream() -> int:
    """PyTorch's current CUDA stream, as the entry points take it."""
    return torch.cuda.current_stream().cuda_stream


def raise_on(err: int, name: str) -> None:
    """Raise if an entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def check_f32(name: str, t: torch.Tensor | None, shape: tuple, device) -> None:
    """A float32 side input (None passes): contiguous, of ``shape``, on
    ``device``."""
    if t is None:
        return
    if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor of shape {shape} "
                         f"on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def ptr(t: torch.Tensor | None):
    """``t``'s device address for an entry point, None (NULL) for None."""
    return None if t is None else t.data_ptr()


def check_aligned(names: str, *ts: torch.Tensor) -> None:
    """CUDA tensors must start on a 16-byte boundary: the kernels copy
    16-byte chunks, and a misaligned one would kill the CUDA context."""
    if ts[0].is_cuda and any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{names} must start on a 16-byte boundary (the kernels copy "
                         "16-byte chunks)")


def check_same(*ts: torch.Tensor) -> None:
    """One supported dtype and one device for all, each contiguous."""
    dt, dev = ts[0].dtype, ts[0].device
    if dt not in DTYPE_CODE:
        raise ValueError(f"dtype {dt} not supported (float32 or bfloat16)")
    for t in ts:
        if t.dtype != dt or t.device != dev:
            raise ValueError("inputs must share one dtype and one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
