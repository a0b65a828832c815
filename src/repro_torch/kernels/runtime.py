"""Where the port's kernels run, how they are built, and how often they ran.

The kernels are CUDA C++ for ``sm_90a`` under ``repro_torch/csrc``.  They are
compiled by ``nvcc`` at first use into one shared library with a plain C
interface and loaded with ``ctypes``; PyTorch's headers are not involved.
The library lands in ``build/repro_torch/`` at the root of the checkout,
keyed on a hash of the sources, so an unchanged tree builds once.

There is no switch that sends a CUDA tensor to a kernel's plain PyTorch
version: a wrapper given a CUDA tensor launches its kernel or raises.  The
plain versions run only for tensors that lie on the CPU.

Every wrapper launches through :func:`launch`, the one host path they share.
It passes a call's arguments to the C entry point as one array of 64-bit
integers (pointers, sizes and flags, the stream last), packed by
``struct``: ctypes then converts two arguments per call instead of up to
twenty-six.  The stream is the raw handle of PyTorch's current stream,
read without building a ``torch.cuda.Stream``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core import tracing
from repro_torch.core.energy import DEFAULT_CHIP

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# What one thread block may use of an SM's shared memory on sm_90 (227 KB;
# `kMaxSharedBytes` in csrc/lstm_common.cuh), and the SMs of an H100 SXM:
# the chip model's (core/energy.py), which chip_smoke.py holds to the card's.
MAX_SHARED_BYTES = DEFAULT_CHIP.smem_per_block
SM_COUNT = DEFAULT_CHIP.sms
# The backend tag of the CUDA kernels (the tuner's cache keys).
CUDA_BACKEND = "cuda-sm90a"

# C entry point -> how many 64-bit arguments it reads (for those that launch,
# the stream is the last).  Each takes (const long long* args, int count) and
# returns -3 when count is not its own (csrc/launch.cuh).
ENTRY_ARGS = {
    "repro_activation": 8,
    "repro_lstm_cell": 16,
    "repro_lstm_seq": 23,
    "repro_lstm_seq_cluster_occupancy": 3,
    "repro_lstm_stack": 26,
    "repro_int8_matmul": 18,
    "repro_flash_attention": 14,
    "repro_decode_attention": 20,
}

_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None
# entry name -> (C function, packer of its argument array, argument count)
_entries: dict[str, tuple] = {}
# torch._C._cuda_getDevice and _cuda_getCurrentRawStream, bound at load time
# (a CPU build of PyTorch has neither), and whether the machine has one card
# (then a tensor's device is the current one, and launch need not ask)
_get_device = None
_raw_stream = None
_one_device = False


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
    return CUDA_BACKEND if resolve_device(device).type == "cuda" else "cpu"


def require_same_device(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one device, CPU or CUDA; returns it."""
    dev = tensors[0].device
    if dev.type == "cuda":
        index = dev.index
        for t in tensors[1:]:
            if not t.is_cuda or t.get_device() != index:
                raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    elif dev.type == "cpu":
        for t in tensors[1:]:
            if t.device != dev:
                raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    else:
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_dtype(kernel: str, dtype: torch.dtype, names: tuple[str, ...], *tensors) -> None:
    """Every tensor of ``dtype`` (``names`` name them in the error)."""
    for name, t in zip(names, tensors):
        if t.dtype is not dtype:
            raise TypeError(f"{kernel} takes {dtype} for {name}, got {t.dtype}")


def aligned_pointers(kernel: str, names: tuple[str, ...], *tensors) -> list[int]:
    """``data_ptr()`` of each tensor, after checking what the kernels' 16-byte
    loads need of it: contiguous, and starting on a 16-byte boundary."""
    ptrs = []
    for name, t in zip(names, tensors):
        ptr = t.data_ptr()
        if not t.is_contiguous():
            raise ValueError(f"{kernel} takes contiguous tensors; {name} is not")
        if ptr & 15:
            raise ValueError(f"{kernel} takes 16-byte aligned tensors; {name} is not")
        ptrs.append(ptr)
    return ptrs


# ---------------------------------------------------------------------------
# Launch counters: views of the port's ``launch.<kernel>`` counters
# (``core/tracing.py``)
# ---------------------------------------------------------------------------
LAUNCH = "launch."


def count_launch(kernel: str, n: int = 1) -> None:
    """``n`` launches of ``kernel``.  :func:`launch` counts each launch that
    succeeds, and a CUDA graph (``serving/graphs.py``) adds what its
    capture counted each time it replays; nothing else counts."""
    tracing.count(LAUNCH + kernel, n)


def launches_of(counted: dict[str, int]) -> dict[str, int]:
    """The launches per kernel among counters ``counted``."""
    return {k[len(LAUNCH):]: n for k, n in counted.items() if k.startswith(LAUNCH)}


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return launches_of(tracing.counters())


def reset_launch_counts() -> None:
    tracing.clear_counters(LAUNCH)


@contextlib.contextmanager
def launches_recorded():
    """Within, :func:`launch` records its launches (and every other counter
    its work moves) instead of counting them (``tracing.recorded``); the
    launches per kernel are in the dict this yields once the block ends."""
    launches: dict[str, int] = {}
    with tracing.recorded() as counted:
        try:
            yield launches
        finally:
            launches.update(launches_of(counted))


# ---------------------------------------------------------------------------
# Workspaces the kernels leave zeroed
# ---------------------------------------------------------------------------
_zeroed: dict[tuple[str, int, int], torch.Tensor] = {}
# workspaces that were outgrown: a captured CUDA graph may still point at them
_outgrown: list[torch.Tensor] = []


def zeroed_workspace(name: str, dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 named ``name`` for launches on the current
    stream of ``dev``: a kernel's split-K sums, arrival counters or tickets,
    which it returns to zero.  Kept per name, device and stream (two streams
    sharing one would mix their sums) and grown when a call needs more, so
    allocated (``torch.zeros``) only when they grow, and never while a CUDA
    graph is being captured: a capture runs its step once uncaptured first,
    on the capture stream, which makes the workspace it needs."""
    key = (name, dev.index, stream_handle(dev))
    t = _zeroed.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: the workspace of the capture stream must exist before "
                               "the capture (run the step once on that stream)")
        if t is not None:
            _outgrown.append(t)
        t = torch.zeros(max(n, 0 if t is None else t.numel()), dtype=torch.int32, device=dev)
        _zeroed[key] = t
    return t


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
    global _lib, _build_seconds, _get_device, _raw_stream, _one_device
    if _lib is not None:
        return _lib
    sources = sorted(CSRC_DIR.glob("*.cu"))
    lib_path = BUILD_DIR / f"libkernels-{_sources_hash()}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        _build(sources, lib_path)
    _build_seconds = time.perf_counter() - t0
    # PyDLL: the entry points only enqueue work and return, so they keep the
    # GIL rather than pay for releasing and taking it back on every launch
    lib = ctypes.PyDLL(str(lib_path))
    for name, count in ENTRY_ARGS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        _entries[name] = (fn, struct.Struct(f"{count}q").pack, count)
    _get_device = torch._C._cuda_getDevice
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _one_device = torch.cuda.device_count() == 1
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


def launch(kernel: str, entry: str, index: int, *args: int) -> None:
    """Launch C entry point ``entry`` on CUDA device ``index`` with ``args``
    (ints; 0 for an absent pointer) and the raw handle of the device's
    current stream; raise if it reports anything but success, else count
    one launch of ``kernel``.

    The device is made current only for the call, and only when it is not
    current already (the usual case)."""
    try:
        fn, pack, count = _entries[entry]
    except KeyError:
        load_kernels()
        fn, pack, count = _entries[entry]
    if _one_device or index == _get_device():
        rc = fn(pack(*args, _raw_stream(index)), count)
    else:
        with torch.cuda.device(index):
            rc = fn(pack(*args, _raw_stream(index)), count)
    if rc:
        check_launch(rc, kernel)
    count_launch(kernel)


def stream_handle(dev: torch.device) -> int:
    """Raw handle of the current stream of CUDA device ``dev``: the one
    :func:`launch` passes to the kernels."""
    if _raw_stream is None:
        load_kernels()
    return _raw_stream(dev.index)


def query(entry: str, *args: int) -> int:
    """Call a C entry point that launches nothing (a query) on the current
    device and return what it returns."""
    load_kernels()
    fn, pack, count = _entries[entry]
    return fn(pack(*args), count)


def check_launch(rc: int, kernel: str) -> None:
    """Raise if the C entry point reported anything but success."""
    if rc == 0:
        return
    if rc == -3:
        raise RuntimeError(f"{kernel}: the entry point read another number of arguments "
                           "than the wrapper packed")
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
    """Check an LSTM kernel's ``block_b``, a number of batch rows, and clip
    it to the batch.

    ``smem_bytes(bb)`` is the least shared memory one block needs for a tile
    of ``bb`` rows; a tile that does not fit a block's shared memory raises
    ``ValueError`` with the bound.  ``"auto"`` is not resolved here: the
    kernels' plans take it from the block-size tuner (``kernels.autotune``)
    first."""
    if batch < 1:
        raise ValueError(f"{kernel}: empty batch")
    if isinstance(block_b, bool) or not isinstance(block_b, int) or block_b < 1:
        raise ValueError(f"{kernel}: block_b must be a positive int here, got {block_b!r} "
                         "('auto' is resolved by the block-size tuner first)")
    bb = min(block_b, batch)
    need = smem_bytes(bb)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"{kernel}: a batch tile of {bb} rows needs {need} bytes of shared memory, "
            f"over the {MAX_SHARED_BYTES} one block may use; pass a smaller block_b"
        )
    return bb
