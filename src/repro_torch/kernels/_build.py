"""Build the CUDA sources under ``repro_torch/csrc`` with ``nvcc`` and
load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C entry points (pointers and the
stream as ``void*``, returning ``cudaGetLastError()``), so it compiles
in seconds without PyTorch's headers. A library is built at first use —
when a CUDA tensor reaches a kernel wrapper — into ``build/repro_torch_kernels/``
at the root of the checkout, under a name that hashes the source and
the flags, so an edited source never reuses a stale build. Importing
this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
SOURCES = ("relayout", "flash_attention_sm90", "flash_attention_f32_sm90")

# Loaded libraries, one per source: a process-wide resource, like an import.
_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/shared-memory report) of this process's builds.
BUILD_LOG: dict[str, str] = {}


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd would record a call of the kernel wrapper
    ``name``: grad mode on and an input that requires grad. The kernels
    (like the Pallas kernels they port) have no backward, and a CUDA
    launch writes through a raw pointer, so its output would carry no
    ``grad_fn`` and training would lose those gradients silently. The
    check is the same on CPU tensors, so the plain twin cannot give
    CPU-only gradients either."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on inputs "
            "that do not require grad (train with attn_impl='reference' or 'chunked')"
        )


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together. Returns the seconds each build
    took (0.0 for one already built); raises with nvcc's output if any
    build fails, after every nvcc process has ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode:
            failed.append(f"--- nvcc {name}.cu (rc={proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def sass(name: str) -> str:
    """The machine code of ``csrc/<name>.cu``'s built library, as
    ``cuobjdump -sass`` prints it (built first if needed)."""
    build((name,))
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run(
        [str(tool), "-sass", str(library_path(name))],
        capture_output=True, text=True, check=True,
    ).stdout


def raw_stream(index: int) -> int:
    """PyTorch's current stream on CUDA device ``index``, as an integer
    pointer, without building a ``torch.cuda.Stream`` object."""
    import torch

    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream
