"""Build, load and launch the port's CUDA sources.

Every kernel module (``flash_attention``, ``rglru``, ``wkv6``) keeps its
source in ``repro_torch/csrc/`` behind a plain C interface whose entry
points take the stream last and return ``cudaGetLastError()``, and loads
the library with ``ctypes`` (:func:`load`); :func:`check_same`,
:func:`check_aligned`, :func:`check_f32` and :func:`ptr` are the wrappers' shared input
checks.  :class:`Operators` binds each entry point as a PyTorch operator
(``torch.ops.repro_torch.<kernel>``): its CUDA implementation launches the
kernel, its shape function (``register_fake``) allocates the same outputs and
scratch and launches nothing, and its FLOP formula lets
:class:`torch.utils.flop_counter.FlopCounterMode` count it.  A shape-only
lowering (:mod:`repro_torch.launch.dryrun`) runs the kernels through their
shape functions: :func:`on_kernel_path` sends CUDA tensors, and tensors on
the meta device (shapes only, no data), to the operators.  :func:`build`
compiles sources for ``sm_90a`` into ``build/kernels/<name>-<source digest>.so`` at the
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
import re
import shutil
import subprocess
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

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


def on_kernel_path(t: torch.Tensor) -> bool:
    """Whether a wrapper sends ``t`` to its kernel's operator: a CUDA tensor
    (the kernel launches, or the call raises), or a tensor on the meta
    device, real or fake (the operator's shape function runs: a shape-only
    lowering of the card's path).  Every other tensor takes the plain
    version."""
    return t.is_cuda or t.is_meta


class Operators:
    """The kernels of one kernel module as PyTorch operators.

    The namespace is ``repro_torch`` for the package's own module; a copy of
    the module loaded under another name (``kernels.compare`` loads two
    checkouts' modules side by side) defines its operators in a namespace of
    its own, so that each copy launches through its own library."""

    def __init__(self, module_name: str):
        self.namespace = "repro_torch" if module_name.startswith("repro_torch.") else \
            "repro_torch_" + re.sub(r"\W", "_", module_name)
        self.library = torch.library.Library(self.namespace, "FRAGMENT")

    def define(self, schema: str, cuda, fake, flops):
        """``torch.ops.<namespace>.<name>`` from ``schema``: ``cuda`` its CUDA
        implementation (the launch), ``fake`` its shape function (the
        outputs and scratch of a launch, allocated alike, nothing launched
        and no device queried; also the meta device's implementation),
        ``flops`` its FLOP formula over the arguments' shapes."""
        name = schema.split("(", 1)[0]
        self.library.define(schema)
        self.library.impl(name, cuda, "CUDA")
        torch.library.register_fake(f"{self.namespace}::{name}", fake, lib=self.library)
        op = getattr(getattr(torch.ops, self.namespace), name)
        register_flop_formula(op)(flops)
        return op
