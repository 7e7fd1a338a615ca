"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds.  Builds happen at
first use (or all at once, in parallel, through ``build_all``) into
``build/kernels/`` at the repository root, which ``.gitignore`` lists.  A
library's file name carries a digest of its sources and flags, so an edited
source is rebuilt and never served stale.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
non-zero code.  There is no fallback: a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pdq_prologue", "w8a8_matmul", "kv_cache", "decode_attend", "act_stats",
           "quantize", "fp_dequant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class OpCount:
    """Calls of one kernel's op on any device (``entries``, counted by
    ``kernels/ops.py``) and launches of its CUDA kernel (``launches``,
    counted by the wrapper right where it launches)."""
    entries: int = 0
    launches: int = 0


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in ``names`` with one ``nvcc`` process
    each, all started together.  Returns {name: ptxas report}; raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return reports


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if missing), with
    ``signatures`` {entry: argtypes} applied; every entry returns int."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


@functools.lru_cache(maxsize=None)
def l2_bytes(device) -> int:
    """The card's L2 cache in bytes, read once per device."""
    import torch
    return torch.cuda.get_device_properties(device).L2_cache_size


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


# Which of a device's buffer sets (split-K workspace, tickets, the guard's
# flag) a launch uses.  Launches on one stream run in order, so one set a
# device serves them; a tensor-parallel row whose shards share a card runs
# each shard on its own stream there (``ops.TPRow``), and shard j's launches
# take set j of that card (``buffer_set``), so that concurrent kernels never
# share one.
_SET = 0


@contextlib.contextmanager
def buffer_set(index: int):
    """Launches inside take buffer set ``index`` of their device."""
    global _SET
    prev, _SET = _SET, int(index)
    try:
        yield
    finally:
        _SET = prev


def buffer_key(device):
    """The key of ``device``'s current buffer set."""
    import torch
    return torch.device(device), _SET


def plain_here(t) -> bool:
    """Whether a kernel's selector takes its plain version for ``t``: a
    CPU tensor, or a fake one (``torch._subclasses.fake_tensor``, the dry
    run's stand-in for a tensor on a card: shape, dtype and device, no
    data), which the plain version only carries through shapes and
    dtypes.  A real CUDA tensor never takes it."""
    if t.device.type == "cpu":
        return True
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def require_cuda(*tensors) -> None:
    """A kernel wrapper's device check: the tensors it launches on are
    CUDA tensors on one device (``None`` stands for an operand the kernel
    does not read)."""
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"kernel launch needs CUDA tensors on one device; got "
                f"{[str(t.device) for t in tensors]}")
