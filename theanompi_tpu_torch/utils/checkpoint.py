"""Checkpoint / resume in the reference's ``.npz`` format.

Port of ``theanompi_tpu/utils/checkpoint.py``'s single-file format, so a
checkpoint written by either package loads in the other:

- ``ckpt_<step>.npz``, written by ``np.savez`` (not compressed) into a
  temporary file in the directory and renamed onto its name
  (``os.replace``): a reader never sees a partial file under a final
  name;
- one entry per leaf of the TrainState under the reference's tree path
  (``.params/00_conv1/w``, ``.opt_state/vel/...``, ``.step``,
  ``.ef/...``; ``bridge.state_entries`` makes them, conv kernels in
  HWIO);
- ``__integrity__``: a JSON map of every other entry to the CRC32 and
  length of its raw bytes (``np.ascontiguousarray(arr).tobytes()``),
  which ``verify_checkpoint`` checks and ``latest_checkpoint(verify=True)``
  walks back past;
- ``__usermeta__``: the caller's JSON ``extra_meta``.

What the port writes and reads differently:

- It writes no ``__topology__``: that manifest records JAX
  PartitionSpecs per leaf, a concept the port does not have. On read it
  ignores ``__topology__`` and ``__usermeta__``'s ``pipeline_layout``,
  as the reference's ``load_checkpoint`` does.
- Its dropout generators' states go under ``__torch_rng__`` (``[n, L]``
  uint8, one row per rank), never under ``__rng__``: the reference reads
  ``__rng__`` as a JAX key. A JAX-written file carries no torch state,
  and a JAX key's bits cannot seed a torch generator.
- bfloat16 leaves are written as float32 (numpy has no bfloat16); the
  values are exact, and both packages' readers cast to the template's
  dtype.

Left out of this port: the per-host sharded sets, ``load_resharded``,
the scrubber, the write-fault hook and the resumable marker.

``AsyncCheckpointer`` overlaps the write with training: ``save``
copies the entries into a staging buffer on the card in the training
stream, copies that to pinned host memory on a side stream, and hands
the host copy to one writer thread, which computes the CRCs and writes
the file. The optimizer writes parameters in place, so the writer never
reads a live tensor.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import re
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")

INTEGRITY_KEY = "__integrity__"
USERMETA_KEY = "__usermeta__"
TORCH_RNG_KEY = "__torch_rng__"
# entries that describe the state rather than hold it; the reference's
# own (JAX key, topology) are read by it alone
META_KEYS = frozenset({INTEGRITY_KEY, USERMETA_KEY, "__topology__", "__rng__", "__rng_impl__"})

# storage staging buffers are cut at this alignment, so every entry's
# bytes can be viewed as its dtype on the card and on the host
_ALIGN = 64


def _array_crc(arr: np.ndarray) -> dict:
    """{crc32, nbytes} of one array's raw bytes, the bytes of
    ``np.ascontiguousarray(arr).tobytes()`` (read in place, not copied)."""
    buf = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return {"crc32": zlib.crc32(buf) & 0xFFFFFFFF, "nbytes": int(buf.size)}


def integrity_manifest(flat: dict) -> dict:
    """The ``__integrity__`` map of ``flat``: entry -> {crc32, nbytes}."""
    return {k: _array_crc(np.asarray(v)) for k, v in flat.items()}


def manifest_digest(manifest: dict) -> str:
    """A digest of the state a manifest describes (its non-meta entries,
    ``__torch_rng__`` included): equal digests mean equal bytes, entry by
    entry, up to CRC32 collisions."""
    state = {k: manifest[k] for k in sorted(manifest) if k not in META_KEYS}
    return hashlib.sha256(json.dumps(state, sort_keys=True).encode()).hexdigest()[:16]


def _atomic_savez(directory: str, path: str, flat: dict) -> None:
    """``np.savez`` into a temporary file in ``directory``, then
    ``os.replace`` onto ``path``; any failure removes the temporary file."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(directory: str, flat: dict, step: int, keep: int = 3,
                    extra_meta: Optional[dict] = None,
                    info: Optional[dict] = None) -> str:
    """Write ``flat`` (entry name -> numpy array, the reference's names)
    atomically as ``<directory>/ckpt_<step>.npz`` with its integrity
    manifest, then prune to the newest ``keep``; returns the path. Only
    the writing rank calls it: gathering the state is the caller's
    collective part (``launch/worker.py``). ``info``, when given, is
    filled with ``crc_ms``, ``write_ms``, ``bytes`` and ``digest``."""
    t0 = time.perf_counter()
    flat = dict(flat)
    if extra_meta:
        flat[USERMETA_KEY] = np.asarray(json.dumps(extra_meta))
    manifest = integrity_manifest(flat)
    flat[INTEGRITY_KEY] = np.asarray(json.dumps(manifest))
    t1 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step}.npz")
    _atomic_savez(directory, path, flat)
    _prune(directory, keep)
    if info is not None:
        info.update(crc_ms=(t1 - t0) * 1e3, write_ms=(time.perf_counter() - t1) * 1e3,
                    bytes=os.path.getsize(path), digest=manifest_digest(manifest))
    return path


def _prune(directory: str, keep: int) -> None:
    ckpts = sorted((int(m.group(1)), f) for f in os.listdir(directory)
                   if (m := _CKPT_RE.search(f)))
    for _, f in ckpts[:-keep] if keep else []:
        try:
            os.unlink(os.path.join(directory, f))
        except FileNotFoundError:
            pass


def read_checkpoint_meta(path: str) -> dict:
    """The ``extra_meta`` dict embedded at save time ({} when none)."""
    with np.load(path) as data:
        if USERMETA_KEY in data.files:
            return json.loads(str(data[USERMETA_KEY]))
    return {}


def checkpoint_step(path: Optional[str]) -> int:
    """The step in a checkpoint's filename; -1 for None (compared across
    ranks on resume)."""
    if path is None:
        return -1
    m = _CKPT_RE.search(os.path.basename(path))
    if not m:
        raise ValueError(f"{path!r} is not a checkpoint path")
    return int(m.group(1))


def _readable_nonempty(path: str) -> bool:
    """False for a zero-byte or unreadable file (a host that died in
    ``os.replace`` can leave one): discovery treats it as absent."""
    try:
        return os.path.getsize(path) > 0
    except OSError:
        return False


def verify_checkpoint(path: str) -> bool:
    """True when every entry of ``path`` reads back and, when the file
    carries an integrity manifest, the manifest names exactly the other
    entries and each one's CRC32 matches. A truncated file fails to read
    (the zip directory is at its end). Never raises."""
    if not _readable_nonempty(path):
        return False
    try:
        with np.load(path) as data:
            manifest = None
            if INTEGRITY_KEY in data.files:
                manifest = json.loads(str(data[INTEGRITY_KEY]))
                if set(manifest) != {k for k in data.files if k != INTEGRITY_KEY}:
                    return False
            for k in data.files:
                if k == INTEGRITY_KEY:
                    continue
                arr = data[k]
                if manifest is not None and _array_crc(arr) != manifest[k]:
                    return False
        return True
    except Exception:  # noqa: BLE001 — any read failure means a corrupt file
        return False


def _keep_chain(directory: str) -> list:
    """``(step, path)`` of every non-empty ``ckpt_N.npz``, newest first
    (sorted, so every rank walks the chain in the same order)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for f in sorted(os.listdir(directory)):
        if m := _CKPT_RE.search(f):
            p = os.path.join(directory, f)
            if _readable_nonempty(p):
                out.append((int(m.group(1)), p))
    return sorted(out, reverse=True)


def latest_checkpoint(directory: str, verify: bool = False) -> Optional[str]:
    """The newest checkpoint in ``directory``, or None. ``verify=True``
    walks back past files that fail :func:`verify_checkpoint`, saying so."""
    for _, path in _keep_chain(directory):
        if not verify or verify_checkpoint(path):
            return path
        print(f"[checkpoint] skipping corrupt/truncated {path!r} (integrity check "
              "failed); walking back the keep-chain", flush=True)
    return None


def load_checkpoint(path: str) -> dict:
    """Every state entry of ``path`` (its tree paths and ``__torch_rng__``)
    as numpy arrays; the metadata entries are left out.
    ``bridge.state_from_flat`` checks them against a template and raises
    on a missing entry or a wrong shape."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k not in META_KEYS}


def to_numpy(value) -> np.ndarray:
    """An entry as the file holds it: a tensor copied to the host in C
    order (bf16 widened to f32, exactly), an array as it is."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        # C order made where the tensor lives (a conv kernel's HWIO view
        # is transposed on the card), then one copy to the host; a CPU
        # tensor is copied too, so the array never aliases live state
        t = t.contiguous()
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()
    return np.asarray(value)


def _staged_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


class AsyncCheckpointer:
    """Checkpoint writes overlapped with training, with the reference's
    contract:

    - one save in flight: ``save`` first waits for the previous one, so
      checkpoints land in step order;
    - a failed write raises at the next ``save`` / ``wait`` / ``close``,
      except a transient storage error (ENOSPC, EDQUOT, EIO, ESTALE),
      which fails that attempt only: the temporary file is gone and the
      keep-chain intact, so it is logged and counted in
      ``storage_failures``, and training goes on to the next save;
    - ``close`` drains the queue.

    ``save`` reads every tensor on the calling (training) thread: it
    copies the entries into one staging buffer on the card in the
    current stream (the snapshot; a conv kernel's HWIO transpose is this
    copy), records an event, and copies the buffer into one pinned host
    buffer on a side stream that waits on that event. The staging buffer
    is released to the allocator once the side stream is done with it
    (``record_stream``). The pinned buffer is kept across saves and
    grows only when an entry set is larger. The writer thread waits on
    the copy's event, then runs the CRCs and the write. CPU tensors are
    copied into a host buffer on the calling thread. No collective runs
    here: the caller gathers other ranks' entries first.

    ``records`` holds one dict per finished save: ``step``, ``path``,
    ``loop_ms`` (what ``save`` cost the calling thread), ``writer_ms``
    (the writer's wall time: copy wait, CRCs, write), ``crc_ms``,
    ``write_ms``, ``bytes`` and ``digest``."""

    _TRANSIENT_ERRNOS = frozenset(
        e for e in (errno.ENOSPC, getattr(errno, "EDQUOT", None), errno.EIO,
                    getattr(errno, "ESTALE", None)) if e is not None)

    def __init__(self):
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="tmpi-ckpt")
        self._pending = None  # (future, step) of the save in flight
        self._host: Optional[torch.Tensor] = None  # the kept staging area
        self._side: Optional[torch.cuda.Stream] = None
        self.storage_failures = 0
        self.last_storage_error: Optional[OSError] = None
        self.records: list = []

    def _host_buffer(self, nbytes: int, pin: bool) -> torch.Tensor:
        if self._host is None or self._host.numel() < nbytes:
            self._host = None  # the old area is freed before the new one is made
            self._host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        return self._host

    def _snapshot(self, entries: dict):
        """Copy ``entries`` into the host staging area; returns the numpy
        views the writer reads and the event it waits on (None when the
        copy is already done)."""
        layout, total, cuda_dev = {}, 0, None
        for k, v in entries.items():
            if isinstance(v, torch.Tensor):
                nbytes = v.numel() * _staged_dtype(v).itemsize
                layout[k] = (total, nbytes)
                total += -(-nbytes // _ALIGN) * _ALIGN
                if v.is_cuda:
                    cuda_dev = v.device  # a rank's entries share its card
        host = self._host_buffer(max(total, 1), pin=cuda_dev is not None)
        done = None
        if cuda_dev is not None:
            stream = torch.cuda.current_stream(cuda_dev)
            stage = torch.empty(max(total, 1), dtype=torch.uint8, device=cuda_dev)
            for k, (off, nbytes) in layout.items():
                v = entries[k].detach()
                seg = stage[off:off + nbytes].view(_staged_dtype(v)).view(v.shape)
                seg.copy_(v)
            ready = torch.cuda.Event()
            ready.record(stream)
            if self._side is None:
                self._side = torch.cuda.Stream(cuda_dev)
            self._side.wait_event(ready)
            with torch.cuda.stream(self._side):
                host[:total].copy_(stage[:total], non_blocking=True)
            stage.record_stream(self._side)
            done = torch.cuda.Event()
            done.record(self._side)
        else:
            for k, (off, nbytes) in layout.items():
                v = entries[k].detach()
                host[off:off + nbytes].view(_staged_dtype(v)).view(v.shape).copy_(v)
        raw = host.numpy()
        flat = {}
        for k, v in entries.items():
            if k in layout:
                off, nbytes = layout[k]
                np_dtype = torch.empty((), dtype=_staged_dtype(v)).numpy().dtype
                flat[k] = raw[off:off + nbytes].view(np_dtype).reshape(tuple(v.shape))
            else:
                flat[k] = np.array(v, copy=True)
        return flat, done

    def save(self, directory: str, entries: dict, step: int, keep: int = 3,
             extra_meta: Optional[dict] = None) -> None:
        """Snapshot ``entries`` (entry name -> tensor or numpy array, the
        reference's names and layouts) and write them as
        ``ckpt_<step>.npz`` on the writer thread."""
        self.wait()
        t0 = time.perf_counter()
        flat, done = self._snapshot(entries)
        record = {"step": int(step), "loop_ms": None}

        def write():
            t_w = time.perf_counter()
            if done is not None:
                done.synchronize()
            record["path"] = save_checkpoint(directory, flat, step, keep, extra_meta, record)
            record["writer_ms"] = (time.perf_counter() - t_w) * 1e3
            return record

        self._pending = (self._pool.submit(write), int(step))
        record["loop_ms"] = (time.perf_counter() - t0) * 1e3

    def wait(self) -> None:
        """Block until the save in flight (if any) is durable; raise its
        error here, except a transient storage error (class docstring)."""
        if self._pending is None:
            return
        (future, step), self._pending = self._pending, None
        try:
            self.records.append(future.result())
        except OSError as e:
            if e.errno not in self._TRANSIENT_ERRNOS:
                raise
            self.storage_failures += 1
            self.last_storage_error = e
            print(f"[checkpoint] async save at step {step} failed on a storage error "
                  f"({e!r}); the torn attempt left the keep-chain intact — training "
                  "continues, the next save retries", flush=True)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
            self._host = None
