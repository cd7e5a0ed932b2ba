"""Builds the CUDA sources in ``csrc/`` and binds them with ctypes.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles each source
for ``sm_90a``, and one more links them into a shared library with a plain
C interface; no PyTorch header is included, so the build takes as long as
its largest source. The library lands in ``build/kernels/<hash>/``
at the repository root (listed in ``.gitignore``), keyed on a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
at once. The build happens at first use, inside the first kernel launch or
an explicit ``build()`` call, never at import: importing this module needs
no compiler and no card. ``REPRO_SMEM_CHECK=1`` in the environment adds
``-DREPRO_SMEM_CHECK`` (flash decode's address check,
``csrc/flash_decode.cu``): off by default, and a library of its own.

Each entry point returns ``cudaGetLastError()``; ``check`` raises on a
non-zero code. Each wrapper counts its calls, on either device, in
``calls`` and notes the variant it launched in ``launched_variants`` (its
``variant_info`` arguments), so the lint gate can ask the card for the
resources of what ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Set, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_kernels.so"
CHECK_ENV = "REPRO_SMEM_CHECK"   # "1": build with the address check

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, Any] = {}
# wrapper -> calls on either device (a call on a card launches one kernel)
calls: Counter = Counter()
# (wrapper, variant_info arguments...) of every kernel variant launched
# since the last ``kernels.reset_launch_counts()``: few distinct entries
launched_variants: Set[Tuple] = set()


class KernelError(RuntimeError):
    """A kernel was refused or failed to launch, or the build failed."""


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_flags() -> Tuple[str, ...]:
    """The compile flags: ``NVCC_FLAGS``, and ``-DREPRO_SMEM_CHECK`` where
    the environment sets ``REPRO_SMEM_CHECK=1``."""
    check = ("-DREPRO_SMEM_CHECK",) if os.environ.get(CHECK_ENV) == "1" else ()
    return NVCC_FLAGS + check


def _digest() -> str:
    h = hashlib.sha256(" ".join(nvcc_flags()).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile the library if no build of these sources exists; returns
    its path. The compiler's output (register and spill report) is kept
    beside it as ``nvcc.log``. Safe against concurrent builders: each
    writes a private file and renames it into place."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    nvcc = _nvcc()
    jobs = []
    for src in sources():
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [nvcc, *nvcc_flags(), "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
    log, failed = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{stderr[-4000:]}")
    if not failed:
        r = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(f"link ({r.returncode}):\n{r.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out.parent / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise KernelError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def function(name: str, argtypes: Sequence) -> Any:
    """The C entry point ``name`` with its argument types declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise KernelError(f"{name}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_contiguous(name: str, *tensors: torch.Tensor) -> None:
    """Checked on every device, so the CPU tests catch what the card's
    kernels would refuse."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input of shape "
                             f"{tuple(t.shape)}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def require_dtype(name: str, t: torch.Tensor, allowed) -> None:
    if t.dtype not in allowed:
        raise TypeError(f"{name}: dtype {t.dtype} not in "
                        f"{[str(a) for a in allowed]}")
