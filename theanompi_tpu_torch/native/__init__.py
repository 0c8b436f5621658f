"""The native (C++) input-pipeline kernels: build and ctypes binding.

Port of ``theanompi_tpu/native/__init__.py`` with the port's own copy of
the source (``loader.cpp``), its own build and its own binding:

- built with the host ``g++ -O3 -march=native`` at first use into
  ``theanompi_tpu_torch/_build/`` (gitignored). ``-march=native`` makes
  the library host-specific, so its file name carries the host's name
  (a shared install never loads another host's build) and a hash of the
  source and flags (an edited source rebuilds). Each process compiles to
  a pid-unique temporary file and renames it into place, so ranks that
  build at once never load a torn library;
- bound with ``ctypes.CDLL``, which releases the interpreter lock for
  the length of a call: the prefetch thread's gather does not stall the
  thread that launches the card's kernels;
- no fallback. A failed build, load or call raises. The plain numpy
  versions (``*_plain`` below) are the functions' definitions, used by
  the tests and for arrays the native code does not take (a dtype other
  than uint8); callers choose them by dtype, explicitly.

``TMPI_LOADER_THREADS`` sets the threads of one call (default: this
process's CPU affinity count less one, at most 8).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_I64, _P, _INT = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # in, n, h, w, c, oy, ox, flip, crop_h, crop_w, mean, mean_len, scale, out, threads
    "tmpi_crop_mirror_normalize": [_P, _I64, _I64, _I64, _I64, _P, _P, _P, _I64, _I64,
                                   _P, _I64, ctypes.c_float, _P, _INT],
    # in, n, h, w, c, oy, ox, flip, crop_h, crop_w, out, threads
    "tmpi_crop_mirror_u8": [_P, _I64, _I64, _I64, _I64, _P, _P, _P, _I64, _I64, _P, _INT],
    # in, row_bytes, idx, n, out, threads
    "tmpi_gather_rows": [_P, _I64, _P, _I64, _P, _INT],
}


def library_path() -> Path:
    """Where ``loader.cpp`` builds to on this host."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    host = platform.node() or "local"
    return BUILD_DIR / f"loader-{host}-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile ``loader.cpp`` unless this host's library exists; returns
    ``(path, seconds compiling)``. Raises when g++ fails or is missing."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} (rc {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native loader is built with g++ at first use: {e}") from e
    finally:
        if tmp.exists():
            tmp.unlink()
    return out, time.perf_counter() - t0


class NativeLoader:
    """The loaded library: built and bound on first ``get()`` (thread-safe),
    with the calls (``calls``) and host seconds (``seconds``) per function
    in this process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.calls: Counter = Counter()
        self.seconds: Counter = Counter()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, secs = build()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self.build_seconds = secs
                self._lib = lib
            return self._lib

    def call(self, name: str, *args) -> None:
        fn = getattr(self.get(), name)
        t0 = time.perf_counter()
        rc = fn(*args)
        if rc != 0:
            raise ValueError(f"{name} failed (rc={rc})")
        self.seconds[name] += time.perf_counter() - t0
        self.calls[name] += 1

    def reset(self) -> None:
        self.calls.clear()
        self.seconds.clear()


LOADER = NativeLoader()


def default_threads() -> int:
    """Threads of one native call: ``TMPI_LOADER_THREADS``, else the CPUs
    this process may run on less one (the launching thread's), at most 8."""
    env = os.environ.get("TMPI_LOADER_THREADS")
    if env:
        return max(1, int(env))
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity mask on this platform
        n = os.cpu_count() or 1
    return max(1, min(8, n - 1))


def _threads(n_threads: Optional[int]) -> int:
    return int(n_threads) if n_threads is not None else default_threads()


def _out(out: Optional[np.ndarray], shape: tuple, dtype) -> np.ndarray:
    """``out`` checked as a writable C-contiguous array of ``shape`` and
    ``dtype`` (e.g. the numpy view of a pinned tensor), or a new one."""
    if out is None:
        return np.empty(shape, dtype=dtype)
    if (out.shape != tuple(shape) or out.dtype != np.dtype(dtype)
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous {np.dtype(dtype)} array of "
                         f"shape {tuple(shape)}, got {out.dtype} {out.shape}")
    return out


def _crop_args(images, oy, ox, flip, crop: int):
    """Validate a crop batch before its pointers go to C: uint8 NHWC
    C-contiguous images, one offset pair and flag per image, every crop
    inside its image."""
    if not isinstance(images, np.ndarray) or images.dtype != np.uint8 or images.ndim != 4:
        raise TypeError(f"images must be a uint8 NHWC array, got "
                        f"{getattr(images, 'dtype', type(images))} {np.shape(images)}")
    images = np.ascontiguousarray(images)
    n, h, w, _ = images.shape
    oy32 = np.ascontiguousarray(oy, dtype=np.int32).reshape(-1)
    ox32 = np.ascontiguousarray(ox, dtype=np.int32).reshape(-1)
    flip8 = np.ascontiguousarray(flip, dtype=np.uint8).reshape(-1)
    if not len(oy32) == len(ox32) == len(flip8) == n:
        raise ValueError(f"{n} images but {len(oy32)} / {len(ox32)} / {len(flip8)} "
                         "row offsets / column offsets / flips")
    if not 0 < crop <= min(h, w):
        raise ValueError(f"crop {crop} does not fit images of {h}x{w}")
    if n and (oy32.min() < 0 or ox32.min() < 0 or oy32.max() > h - crop
              or ox32.max() > w - crop):
        raise ValueError(f"crop offsets out of range for a {crop} crop of {h}x{w} images")
    return images, oy32, ox32, flip8


def crop_mirror_u8(images: np.ndarray, oy, ox, flip, crop: int,
                   n_threads: Optional[int] = None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-image crop at ``(oy[i], ox[i])`` + horizontal mirror where
    ``flip[i]``, uint8 -> uint8 (the pipeline that normalizes on the
    card: the host ships 4x fewer bytes)."""
    images, oy32, ox32, flip8 = _crop_args(images, oy, ox, flip, crop)
    n, h, w, c = images.shape
    out = _out(out, (n, crop, crop, c), np.uint8)
    LOADER.call("tmpi_crop_mirror_u8", images.ctypes.data, n, h, w, c,
                oy32.ctypes.data, ox32.ctypes.data, flip8.ctypes.data, crop, crop,
                out.ctypes.data, _threads(n_threads))
    return out


def crop_mirror_normalize(images: np.ndarray, oy, ox, flip, crop: int, mean, scale: float,
                          n_threads: Optional[int] = None,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
    """Crop + mirror as ``crop_mirror_u8``, then float32
    ``(u8 - mean) * scale`` with ``mean`` a scalar, a per-channel vector
    or a crop-sized ``[crop, crop, c]`` plane."""
    images, oy32, ox32, flip8 = _crop_args(images, oy, ox, flip, crop)
    n, h, w, c = images.shape
    mean32 = np.ascontiguousarray(mean, dtype=np.float32).reshape(-1)
    if mean32.size not in (1, c, crop * crop * c):
        raise ValueError(f"mean of {mean32.size} values: expected 1, {c} or {crop * crop * c}")
    out = _out(out, (n, crop, crop, c), np.float32)
    LOADER.call("tmpi_crop_mirror_normalize", images.ctypes.data, n, h, w, c,
                oy32.ctypes.data, ox32.ctypes.data, flip8.ctypes.data, crop, crop,
                mean32.ctypes.data, mean32.size, ctypes.c_float(scale), out.ctypes.data,
                _threads(n_threads))
    return out


def gather_rows(source: np.ndarray, idx, n_threads: Optional[int] = None,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """``source[idx]`` for a uint8 C-contiguous ``source`` (a memory-mapped
    shard, say) by a multithreaded row memcpy."""
    if not isinstance(source, np.ndarray) or source.dtype != np.uint8 or source.ndim < 1:
        raise TypeError(f"source must be a uint8 array, got "
                        f"{getattr(source, 'dtype', type(source))}")
    if not source.flags.c_contiguous:
        raise ValueError("source must be C-contiguous")
    idx64 = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
    if len(idx64) and (idx64.min() < 0 or idx64.max() >= len(source)):
        raise IndexError(f"row index out of range for {len(source)} rows")
    row_bytes = int(np.prod(source.shape[1:], dtype=np.int64))
    out = _out(out, (len(idx64), *source.shape[1:]), np.uint8)
    LOADER.call("tmpi_gather_rows", source.ctypes.data, row_bytes, idx64.ctypes.data,
                len(idx64), out.ctypes.data, _threads(n_threads))
    return out


# ---- the plain versions: the functions' definitions, in numpy ----------

def gather_rows_plain(source: np.ndarray, idx) -> np.ndarray:
    """``source[idx]`` by numpy fancy indexing."""
    return np.asarray(source[np.asarray(idx)])


def crop_mirror_plain(x: np.ndarray, oy, ox, flips, c: int) -> np.ndarray:
    """The fancy-index crop + mirror (the reference's
    ``ImageNet_data._numpy_crop_mirror``), any dtype."""
    n = len(x)
    oy, ox, flips = np.asarray(oy), np.asarray(ox), np.asarray(flips)
    rows = oy[:, None] + np.arange(c)
    cols = ox[:, None] + np.arange(c)
    cols = np.where(flips[:, None], cols[:, ::-1], cols)
    return x[np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :]]


def normalize_plain(x: np.ndarray, mean, scale) -> np.ndarray:
    """``(x - mean) * scale`` in float32 on the host."""
    return (x.astype(np.float32) - mean) * np.float32(scale)


def crop_mirror_normalize_plain(x: np.ndarray, oy, ox, flips, c: int, mean,
                                scale) -> np.ndarray:
    return normalize_plain(crop_mirror_plain(x, oy, ox, flips, c), mean, scale)
