"""Where the port's kernels run, how they are built, and how often they ran.

The kernels are CUDA C++ for ``sm_90a`` under ``repro_torch/csrc``.  They are
compiled by ``nvcc`` at first use into one shared library with a plain C
interface and loaded with ``ctypes``; PyTorch's headers are not involved.
The library lands in ``build/repro_torch/`` at the root of the checkout,
keyed on a hash of the sources, so an unchanged tree builds once.

There is no switch that sends a CUDA tensor to a kernel's plain PyTorch
version: a wrapper given a CUDA tensor launches its kernel or raises.  The
plain versions run only for tensors that lie on the CPU.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# What one thread block may use of an SM's shared memory on sm_90 (227 KB),
# and the SMs of an H100 SXM; `kMaxSharedBytes` in csrc/lstm_common.cuh.
MAX_SHARED_BYTES = 232448
SM_COUNT = 132

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_activation": [_VP, _VP, _LL, _INT, _INT, _INT, _VP, _VP],
    "repro_lstm_cell": [_VP] * 9 + [_INT] * 6 + [_VP],
    "repro_lstm_seq": [_VP] * 10 + [_INT] * 10 + [_VP],
    "repro_lstm_stack": [_VP] * 11 + [_INT] * 11 + [_VP],
}

_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None
_launches: dict[str, int] = {}


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------
def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``torch.device("cuda")``.  Raises when a CUDA
    device is asked for (by ``None`` or by name) and there is none; the CPU
    is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def backend_key(device=None) -> str:
    """Short backend tag: ``"cuda-sm90a"`` or ``"cpu"``."""
    return "cuda-sm90a" if resolve_device(device).type == "cuda" else "cpu"


def require_same_device(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one device, CPU or CUDA; returns it."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------
def count_launch(kernel: str) -> None:
    """Called by a wrapper exactly where it launches ``kernel``."""
    _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------
def _find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    conventional = Path("/usr/local/cuda/bin/nvcc")
    if conventional.exists():
        return str(conventional)
    raise RuntimeError("nvcc not found: the port's kernels are compiled from source at first use")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(sources: list[Path], lib_path: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objects)
    ]
    logs, failed = [], False
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        failed = failed or proc.returncode != 0
    log = "\n".join(logs)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed to compile the kernels:\n{log}")
        tmp = lib_path.with_suffix(f".{tag}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link the kernels:\n{link.stdout}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    (BUILD_DIR / "nvcc.log").write_text(log)


def load_kernels() -> ctypes.CDLL:
    """The shared library of the port's kernels, built if the sources changed.

    Raises ``RuntimeError`` with the compiler's output if the build fails."""
    global _lib, _build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(CSRC_DIR.glob("*.cu"))
    lib_path = BUILD_DIR / f"libkernels-{_sources_hash()}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        _build(sources, lib_path)
    _build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build_seconds() -> float | None:
    """Seconds :func:`load_kernels` spent building (near 0 for a cached
    library); ``None`` before the first load."""
    return _build_seconds


def compile_log() -> str:
    """``nvcc``'s output for the library in use (registers, shared memory,
    spills per kernel), or "" if it was not built by this checkout."""
    path = BUILD_DIR / "nvcc.log"
    return path.read_text() if path.exists() else ""


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def device_guard(dev: torch.device):
    """Context in which ``dev`` is the current CUDA device.  Switching costs
    several microseconds per call, so nothing is switched when ``dev`` is
    current already (the usual case)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check_launch(rc: int, kernel: str) -> None:
    """Raise if the C entry point reported anything but success."""
    if rc == 0:
        return
    if rc == -1:
        raise RuntimeError(
            f"{kernel}: the wrapper's shared-memory layout disagrees with the kernel's, "
            "or exceeds one block's limit"
        )
    if rc < 0:
        raise RuntimeError(f"{kernel}: arguments refused by the kernel's entry point (code {rc})")
    raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


# ---------------------------------------------------------------------------
# Batch tiles of the LSTM kernels
# ---------------------------------------------------------------------------
def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pick_block_b(block_b, batch: int, smem_bytes, kernel: str) -> int:
    """Resolve the ``block_b`` argument of an LSTM kernel to a batch tile.

    ``smem_bytes(bb)`` is the least shared memory one block needs for a tile
    of ``bb`` rows.  An int is honoured (clipped to the batch) and raises
    ``ValueError`` if its tile does not fit a block's shared memory.

    ``"auto"`` is a fixed rule until the block-size tuner is ported: the
    smallest power of two in 1..4 that brings the grid down to at most one
    block per SM (132), halved while the tile does not fit.  A batch of up
    to 132 rows therefore gets one row per block: the S steps of a
    recurrence depend on each other, so spreading rows over SMs shortens
    every step, and 4 rows is what a thread keeps in registers at once.
    """
    if batch < 1:
        raise ValueError(f"{kernel}: empty batch")
    if block_b != "auto":
        if isinstance(block_b, bool) or not isinstance(block_b, int) or block_b < 1:
            raise ValueError(f"{kernel}: block_b must be a positive int or 'auto', got {block_b!r}")
        bb = min(block_b, batch)
        need = smem_bytes(bb)
        if need > MAX_SHARED_BYTES:
            raise ValueError(
                f"{kernel}: a batch tile of {bb} rows needs {need} bytes of shared memory, "
                f"over the {MAX_SHARED_BYTES} one block may use; pass a smaller block_b"
            )
        return bb
    bb = 1
    while bb < 4 and -(-batch // bb) > SM_COUNT:
        bb *= 2
    bb = min(bb, batch)
    while bb > 1 and smem_bytes(bb) > MAX_SHARED_BYTES:
        bb //= 2
    need = smem_bytes(bb)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"{kernel}: even one batch row per block needs {need} bytes of shared memory, "
            f"over the {MAX_SHARED_BYTES} one block may use"
        )
    return bb
