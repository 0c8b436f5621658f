"""Build, load and guard the port's hand-written CUDA kernels.

Counterpart of ``theanompi_tpu/ops/pallas_util.py``, with one
difference by design: there is NO switch to plain code. A wrapper runs
a kernel's plain PyTorch version only when it is handed CPU tensors;
for a CUDA tensor it launches the kernel or raises.

Route: each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface
and is compiled by ``nvcc`` alone into a shared library, at first use,
into ``theanompi_tpu_torch/_build/`` (gitignored). The library's file
name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads in milliseconds. It is loaded with
``ctypes``; every pointer and the stream travel as ``c_void_p`` and
lengths as ``c_int64``. No ``torch.utils.cpp_extension``: a source that
includes PyTorch's headers takes minutes to build, this one seconds.
"""

from __future__ import annotations

import array
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Hashable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a: Hopper with its architecture-specific features (wgmma,
# setmaxnreg); -fmad=false keeps every multiply and add separately
# rounded, so kernels reproduce PyTorch's separate elementwise ops bit
# for bit (see csrc/fused_update.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# grid cap of the grid-stride kernels: enough resident blocks per SM to
# keep memory requests in flight, few enough that each thread loops
BLOCKS_PER_SM = 8


class LaunchCounter:
    """A plain count of kernel launches, bumped by a wrapper exactly
    where it launches its kernel (never on the plain CPU path), so a run
    can show that its main path went through the kernel. Every counter
    registers itself by name (``launch_counts``)."""

    def __init__(self, name: str):
        if name in _COUNTERS:
            raise ValueError(f"a launch counter named {name!r} already exists")
        self.name = name
        self.launches = 0
        _COUNTERS[name] = self

    def reset(self) -> None:
        self.launches = 0


_COUNTERS: dict = {}


def launch_counts() -> dict:
    """``{counter name: launches}`` of every kernel wrapper imported in
    this process."""
    return {name: c.launches for name, c in sorted(_COUNTERS.items())}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from csrc/ at first use"
    )


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: keyed by a hash of its bytes,
    every ``.cuh`` beside it, and the flags."""
    h = hashlib.sha256()
    h.update((CSRC_DIR / source).read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> tuple[Path, float]:
    """Compile ``csrc/<source>`` unless its library already exists.
    Returns ``(path, seconds spent compiling)`` (0.0 when it was cached).
    The output is written to a temporary name and renamed into place, so
    a concurrent or interrupted build never leaves a torn library."""
    out = library_path(source)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (rc {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0


class KernelLibrary:
    """One ``csrc/*.cu`` library: built and loaded on first ``get()``,
    with ``argtypes``/``restype`` declared for every exported function."""

    def __init__(self, source: str, signatures: dict):
        self.source = source
        self.signatures = signatures
        self.build_seconds: Optional[float] = None
        self._lib = None

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            path, secs = build(self.source)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.tmpi_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tmpi_cuda_error_string.restype = ctypes.c_char_p
            self.build_seconds = secs
            self._lib = lib
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise when a launch returned a CUDA error code."""
        if rc:
            msg = self.get().tmpi_cuda_error_string(rc)
            raise RuntimeError(
                f"{what}: CUDA error {rc} "
                f"({msg.decode() if msg else 'unknown'}) at launch"
            )


def is_dense(t: torch.Tensor) -> bool:
    """Contiguous in PyTorch's default or ``channels_last`` order: its
    elements fill ``numel`` consecutive slots from ``data_ptr``."""
    return t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
    )


def require_cuda(t: torch.Tensor, name: str, *, dtypes, device: torch.device,
                 numel: Optional[int] = None, like: Optional[torch.Tensor] = None) -> None:
    """Validate one kernel argument before its pointer is handed over:
    a CUDA tensor on ``device`` of one of ``dtypes``, dense, and — when
    ``like`` is given — of ``like``'s shape and strides, so that element
    ``i`` of the flat storage is the same element in both."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; the kernel needs a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(
            f"{name} has dtype {t.dtype}; the kernel takes {sorted(map(str, dtypes))}"
        )
    if not is_dense(t):
        raise ValueError(f"{name} must be contiguous (default or channels_last order)")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")
    if like is not None and (t.shape != like.shape or t.stride() != like.stride()):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)} / strides {t.stride()}, expected "
            f"{tuple(like.shape)} / {like.stride()}"
        )


# --------------------------------------------------------------------------
# multi-tensor work tables: one launch over many leaves
# --------------------------------------------------------------------------

# 16-byte vector accesses need every base pointer of a leaf on this boundary
VECTOR_ALIGN = 16
# kernel-parameter bytes a launch may take: CUDA >= 12.1 on Volta and
# later; 4,096 before (each built library reports its table capacity)
PARAM_LIMIT = 32764
# a work table's row (csrc/work_table.cuh): four int64, then the leaf's
# first chunk and one more int32 of the kernel's own
TABLE_LEAF_BYTES = 40


def table_capacity(header_bytes: int, param_limit: int = PARAM_LIMIT) -> int:
    """Leaves one launch's work table can hold under ``param_limit``
    behind its kernel's header of ``header_bytes``."""
    return (param_limit - header_bytes) // TABLE_LEAF_BYTES


def pack_rows(rows) -> array.array:
    """Work-table rows ``(a, b, c, d, chunk0, extra)`` (four int64, two
    int32) as the kernels' 40-byte rows: the int32 pair packed into one
    little-endian int64. The kernel reads them at
    ``buffer_info()[0]``."""
    flat = []
    for a, b, c, d, chunk0, extra in rows:
        flat += (a, b, c, d, chunk0 | extra << 32)
    return array.array("q", flat)


@dataclass(frozen=True)
class TableLaunch:
    """One launch of a multi-tensor kernel: leaves of one group (``key``),
    in the caller's order, each cut into ``chunk``-element chunks that
    are numbered from 0 across the launch."""

    key: Hashable
    leaves: tuple      # positions of the leaves in the caller's list
    ptrs: tuple        # per leaf: its arrays' device addresses
    lengths: tuple     # per leaf: elements
    chunk0: tuple      # per leaf: the number of its first chunk
    aligned: tuple     # per leaf: every pointer on a VECTOR_ALIGN boundary
    chunks: int        # chunks in the launch


def work_table(ptrs, lengths, keys, *, chunk: int, capacity: int) -> list:
    """The launches that cover a list of leaves -> ``[TableLaunch]``.

    Leaf ``i`` has the device addresses ``ptrs[i]`` (one per array the
    kernel walks), ``lengths[i]`` elements and the group key ``keys[i]``
    (e.g. its dtypes: one kernel instantiation per key). Empty leaves
    are dropped. Leaves are grouped by key, groups in the order their key
    first appears, leaves in input order; a group is split into launches
    only where it holds more than ``capacity`` leaves (the kernel-parameter
    limit). A pure function of the integers it is given."""
    if chunk < 1 or capacity < 1:
        raise ValueError(f"chunk ({chunk}) and capacity ({capacity}) must be positive")
    if not len(ptrs) == len(lengths) == len(keys):
        raise ValueError(f"{len(ptrs)} pointer sets, {len(lengths)} lengths, {len(keys)} keys")
    groups: dict = {}
    for i, (n, key) in enumerate(zip(lengths, keys)):
        if n < 0:
            raise ValueError(f"leaf {i} has a negative length {n}")
        if n:
            groups.setdefault(key, []).append(i)
    out = []
    for key, members in groups.items():
        for lo in range(0, len(members), capacity):
            idx = tuple(members[lo:lo + capacity])
            starts, total = [], 0
            for i in idx:
                starts.append(total)
                total += -(-lengths[i] // chunk)
            out.append(TableLaunch(
                key=key, leaves=idx, ptrs=tuple(tuple(ptrs[i]) for i in idx),
                lengths=tuple(lengths[i] for i in idx), chunk0=tuple(starts),
                aligned=tuple(all(a % VECTOR_ALIGN == 0 for a in ptrs[i]) for i in idx),
                chunks=total))
    return out


_SM_COUNT: dict = {}


def max_blocks(device: torch.device) -> int:
    """Grid cap for grid-stride kernels: ``BLOCKS_PER_SM`` per SM."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx] * BLOCKS_PER_SM


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
