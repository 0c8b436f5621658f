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

- ``__topology__``, the reference's manifest (``version``, ``mesh``
  ``{"shape", "axes"}`` as the reference's ``mesh_topology`` gives it
  for the same rule and world, ``elastic`` policies, and a per-leaf
  ``spec``: ``None`` for a replicated leaf, ``[[axes]]`` for a stack
  over ranks or workers, the reference's ``spec_to_json`` of a leaf the
  ND engine shards), written with every save that passes a
  ``topology`` (the training loop always does). On read it ignores
  ``__usermeta__``'s ``pipeline_layout``, as the reference's
  ``load_checkpoint`` does.
- Its dropout generators' states go under ``__torch_rng__`` (``[n, L]``
  uint8, one row per rank), never under ``__rng__``: the reference reads
  ``__rng__`` as a JAX key. A JAX-written file carries no torch state,
  and a JAX key's bits cannot seed a torch generator.
- bfloat16 leaves are written as float32 (numpy has no bfloat16); the
  values are exact, and both packages' readers cast to the template's
  dtype.

Fault tolerance, as the reference's:

- per-rank sharded sets (``save_checkpoint_sharded``; the reference's
  process is a rank here): rank ``r`` of ``n`` writes
  ``ckpt_<step>.proc<r>of<n>.npz`` with entries ``{leaf}::s{j}``, a
  ``__meta__`` catalogue of each leaf's global shape, dtype and the
  bounds of its pieces (and the full topology manifest), and
  ``__integrity__``. A set missing a member is absent (completeness by
  counting); ``load_checkpoint`` reassembles a set under any rank count;
- ``load_resharded``: a checkpoint of another world or mesh onto this
  one, by the manifest's per-leaf policies (``global``, ``reset``,
  ``worker_consensus``, ``worker_uniform``); every leaf is read whole, in
  its global layout, from the pieces its bounds name, and the engine cuts
  its shards from it (a ``--tp 2`` file onto ``--tp 4`` or ``--sp 2``);
- the write-fault hook (``set_write_fault_hook``: ENOSPC mid-write, a
  slow write), which fires on ``AsyncCheckpointer``'s writer thread too;
- the scrubber (``scrub_checkpoint_dir``, ``CheckpointScrubber``), which
  moves corrupt members into ``<ckpt_dir>/quarantine/``;
- the resumable marker the SIGTERM grace path writes and the supervisor
  reads (``write_resumable_marker``).

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
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")
_SHARD_RE = re.compile(r"ckpt_(\d+)\.proc(\d+)of(\d+)\.npz$")

INTEGRITY_KEY = "__integrity__"
USERMETA_KEY = "__usermeta__"
TOPOLOGY_KEY = "__topology__"
SHARD_META_KEY = "__meta__"
TOPOLOGY_VERSION = 1
TORCH_RNG_KEY = "__torch_rng__"
# entries that describe the state rather than hold it; the reference's
# own (JAX key, topology) are read by it alone
META_KEYS = frozenset({INTEGRITY_KEY, USERMETA_KEY, TOPOLOGY_KEY, SHARD_META_KEY, "__rng__",
                       "__rng_impl__"})

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


# --------------------------------------------------------------------------
# the topology manifest
# --------------------------------------------------------------------------


def _policy_for(key: str, policies: dict) -> dict:
    """Longest-prefix policy entry for one leaf key (prefixes are leaf
    path prefixes such as ``.ef``); ``global`` by default: the leaf's
    content does not depend on the world."""
    best, best_len = {"policy": "global"}, -1
    for prefix, entry in policies.items():
        if (key == prefix or key.startswith(prefix + "/")) and len(prefix) > best_len:
            best, best_len = entry, len(prefix)
    return best


def topology_manifest(keys, topology: Optional[dict]) -> Optional[dict]:
    """The versioned ``__topology__`` manifest of a save holding the
    state entries ``keys`` (the reference's schema): ``topology`` is
    ``{"mesh": {"shape", "axes"}, "elastic": {"policies", "base_world"},
    "stack_axes": [axis, ...]}``, and where the engine shards leaves
    (the ND engine under ``--tp``) ``"leaf_specs"``, ``{entry: spec}`` in
    the reference's ``spec_to_json`` form (``theanompi_tpu/parallel/
    mesh.py``: one item a dimension, None or the list of the axes it is
    sharded on), which each such entry is stamped with. Otherwise a leaf
    under a prefix with an elastic policy is a stack over ``stack_axes``
    (spec ``[stack_axes]``), every other leaf replicated (spec
    ``None``). None without a topology. The port's generator rows
    (``__torch_*``) are not state leaves."""
    if topology is None:
        return None
    elastic = dict(topology.get("elastic") or {})
    policies = elastic.get("policies") or {}
    stack = [str(a) for a in topology.get("stack_axes") or []]
    specs = topology.get("leaf_specs") or {}
    leaves = {}
    for k in sorted(keys):
        if k in META_KEYS or k.startswith("__"):
            continue
        if k in specs:
            leaves[k] = {"spec": specs[k]}
            continue
        stacked = _policy_for(k, policies).get("policy", "global") != "global"
        leaves[k] = {"spec": [stack] if stacked and stack else None}
    return {"version": TOPOLOGY_VERSION, "mesh": topology.get("mesh"), "elastic": elastic,
            "leaves": leaves}


# --------------------------------------------------------------------------
# the write-fault hook: storage faults happen inside the write, where no
# step-loop hook reaches. Both formats write through _atomic_savez, which
# asks the installed hook about the step being saved (on whichever thread
# writes: the AsyncCheckpointer's writer thread too).
# --------------------------------------------------------------------------

_WRITE_FAULT_HOOK: Optional[Callable[[int], Optional[tuple]]] = None


def set_write_fault_hook(hook: Optional[Callable[[int], Optional[tuple]]]) -> None:
    """Install (or clear, with None) the process-wide write fault hook,
    ``step -> None | (kind, arg)`` (``utils/faults.py``'s
    ``FaultInjector.write_fault``). Process-wide because the writer
    thread has no per-save plumbing; the training loop installs it for
    its run and clears it in its ``finally``."""
    global _WRITE_FAULT_HOOK
    _WRITE_FAULT_HOOK = hook


class _EnospcWriter:
    """A file that raises ``OSError(ENOSPC)`` once ``limit`` bytes have
    been written (a disk filled up mid-write): the torn file exists under
    its temporary name when the error surfaces. Afterwards it is dead:
    writes go to a simulated position, so ``np.savez``'s zip file, which
    still holds it, closes quietly."""

    def __init__(self, f, limit: int):
        self._f = f
        self._limit = int(limit)
        self._written = 0
        self._dead = False
        self._pos = 0

    def write(self, data):
        if self._dead:
            self._pos += len(data)
            return len(data)
        if self._written + len(data) > self._limit:
            space = max(0, self._limit - self._written)
            if space:
                self._f.write(data[:space])
                self._written += space
            self._dead = True
            self._pos = self._written
            raise OSError(errno.ENOSPC, "No space left on device (injected enospc)")
        self._written += len(data)
        return self._f.write(data)

    def seek(self, offset, whence=0):
        if not self._dead:
            return self._f.seek(offset, whence)
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        return self._pos

    def tell(self):
        return self._pos if self._dead else self._f.tell()

    def flush(self):
        if not self._dead:
            self._f.flush()

    def __getattr__(self, name):
        return getattr(self._f, name)


def _atomic_savez(directory: str, path: str, flat: dict) -> None:
    """``np.savez`` into a temporary file in ``directory``, then
    ``os.replace`` onto ``path``; any failure (a real OSError or an
    injected write fault) removes the temporary file, so no partial file
    ever stands under a final name. The write-fault hook is asked about
    the step in ``path``'s name."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            sink = f
            fault = _WRITE_FAULT_HOOK(checkpoint_step(path)) if _WRITE_FAULT_HOOK else None
            if fault is not None:
                kind, arg = fault
                if kind == "slow_write":
                    time.sleep(2.0 if arg is None else float(arg))
                elif kind == "enospc":
                    sink = _EnospcWriter(f, 256 if arg is None else int(arg))
            np.savez(sink, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(directory: str, flat: dict, step: int, keep: int = 3,
                    extra_meta: Optional[dict] = None,
                    info: Optional[dict] = None, topology: Optional[dict] = None) -> str:
    """Write ``flat`` (entry name -> numpy array, the reference's names)
    atomically as ``<directory>/ckpt_<step>.npz`` with its integrity
    manifest (and, given ``topology``, its ``__topology__``), then prune
    to the newest ``keep``; returns the path. Only the writing rank calls
    it: gathering the state is the caller's collective part
    (``launch/worker.py``). ``info``, when given, is filled with
    ``crc_ms``, ``write_ms``, ``bytes`` and ``digest``."""
    t0 = time.perf_counter()
    flat = dict(flat)
    topo = topology_manifest(flat, topology)
    if topo is not None:
        flat[TOPOLOGY_KEY] = np.asarray(json.dumps(topo))
    if extra_meta:
        flat[USERMETA_KEY] = np.asarray(json.dumps(extra_meta))
    manifest = integrity_manifest(flat)
    flat[INTEGRITY_KEY] = np.asarray(json.dumps(manifest))
    t1 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step}.npz")
    _atomic_savez(directory, path, flat)
    _prune(directory, keep)
    _prune_sharded(directory, keep)  # a directory switched from sharded saves
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
        except FileNotFoundError:  # the scrubber may have moved it
            pass


# --------------------------------------------------------------------------
# per-rank sharded sets
# --------------------------------------------------------------------------


def save_checkpoint_sharded(directory: str, pieces: dict, step: int, rank: int, world: int,
                            keep: int = 3, extra_meta: Optional[dict] = None,
                            info: Optional[dict] = None, topology: Optional[dict] = None,
                            keys=None) -> str:
    """Rank ``rank``'s member of the sharded set of ``step``:
    ``<directory>/ckpt_<step>.proc<rank>of<world>.npz``, written
    atomically, then older complete sets pruned to ``keep``; returns the
    path. No collective: every unique piece has one writer, decided by
    the caller. ``pieces``: ``{leaf: (global_shape, [(bounds, array),
    ...])}``, ``bounds`` ``[[start, stop], ...]`` in the leaf's global
    index space. ``keys``: every state leaf of the whole set (for the
    topology manifest each member carries; default: this member's).
    ``info`` as :func:`save_checkpoint`'s (its digest covers this
    member)."""
    t0 = time.perf_counter()
    flat: dict = {}
    meta: dict = {"leaves": {}, "step": int(step)}
    if extra_meta:
        meta["user"] = extra_meta
    topo = topology_manifest(pieces if keys is None else keys, topology)
    if topo is not None:
        # every member carries the whole manifest: a reshard plan can be
        # made from any one of them
        meta["topology"] = topo
    for key, (shape, parts) in pieces.items():
        entry = {"shape": [int(d) for d in shape], "dtype": None, "shards": []}
        for j, (bounds, arr) in enumerate(parts):
            arr = np.asarray(arr)
            entry["dtype"] = str(arr.dtype)
            flat[f"{key}::s{j}"] = arr
            entry["shards"].append({"bounds": [[int(a), int(b)] for a, b in bounds],
                                    "file": int(rank)})
        meta["leaves"][key] = entry
    flat[SHARD_META_KEY] = np.asarray(json.dumps(meta))
    manifest = integrity_manifest(flat)
    flat[INTEGRITY_KEY] = np.asarray(json.dumps(manifest))
    t1 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step}.proc{rank}of{world}.npz")
    _atomic_savez(directory, path, flat)
    _prune_sharded(directory, keep)
    if rank == 0:
        _prune(directory, keep)  # a directory switched from single-file saves
    if info is not None:
        info.update(crc_ms=(t1 - t0) * 1e3, write_ms=(time.perf_counter() - t1) * 1e3,
                    bytes=os.path.getsize(path), digest=manifest_digest(manifest))
    return path


def _readable_nonempty(path: str) -> bool:
    """False for a zero-byte or unreadable file (a host that died in
    ``os.replace`` can leave one): discovery treats it as absent."""
    try:
        return os.path.getsize(path) > 0
    except OSError:
        return False


def _sharded_sets(directory: str) -> dict:
    """step -> the member paths of every COMPLETE set (all n present and
    non-empty), in rank order; an incomplete set is absent."""
    by_step: dict = {}
    for f in sorted(os.listdir(directory)):
        if m := _SHARD_RE.search(f):
            if not _readable_nonempty(os.path.join(directory, f)):
                continue
            step, k, n = int(m.group(1)), int(m.group(2)), int(m.group(3))
            by_step.setdefault(step, {})[k] = (n, f)
    out = {}
    for step, files in by_step.items():
        n = next(iter(files.values()))[0]
        if len(files) == n and all(v[0] == n for v in files.values()) and set(files) == set(
                range(n)):
            out[step] = [os.path.join(directory, files[k][1]) for k in range(n)]
    return out


def _prune_sharded(directory: str, keep: int) -> None:
    if not keep:
        return
    sets = _sharded_sets(directory)
    for step in sorted(sets)[:-keep]:
        for f in sets[step]:
            try:
                os.unlink(f)
            except FileNotFoundError:
                pass


class _ShardedSource:
    """Reader over a complete sharded set: the members' ``__meta__``
    catalogues give every piece's global bounds, so any region of a leaf
    is assembled from the pieces that overlap it."""

    def __init__(self, path: str):
        m = _SHARD_RE.search(os.path.basename(path))
        if not m:
            raise ValueError(f"{path!r} is not a sharded checkpoint member")
        directory = os.path.dirname(path) or "."
        step = int(m.group(1))
        files = _sharded_sets(directory).get(step)
        if files is None:
            raise FileNotFoundError(f"sharded checkpoint set for step {step} in {directory} is "
                                    "incomplete (a rank's file is missing)")
        self.step = step
        self._datas = [np.load(f) for f in files]
        self.metas = [json.loads(str(d[SHARD_META_KEY])) for d in self._datas]
        self.catalogue: dict = {}
        for fi, meta in enumerate(self.metas):
            for key, entry in meta["leaves"].items():
                cat = self.catalogue.setdefault(
                    key, {"shape": tuple(entry["shape"]), "dtype": entry["dtype"], "pieces": []})
                if cat["dtype"] is None:
                    cat["dtype"] = entry["dtype"]
                for j, sh in enumerate(entry["shards"]):
                    cat["pieces"].append((tuple(tuple(b) for b in sh["bounds"]), fi,
                                          f"{key}::s{j}"))

    def keys(self):
        return list(self.catalogue)

    def shape(self, key):
        if key not in self.catalogue:
            raise KeyError(f"sharded checkpoint is missing {key!r} — structure mismatch "
                           f"(available: {sorted(self.catalogue)[:8]}...)")
        return self.catalogue[key]["shape"]

    def read(self, key: str) -> np.ndarray:
        """The whole leaf, from its pieces; raises unless they cover it."""
        shape = self.shape(key)
        cat = self.catalogue[key]
        full = np.zeros(shape, dtype=cat["dtype"])
        filled = 0
        for bounds, fi, akey in cat["pieces"]:
            piece = self._datas[fi][akey]
            full[tuple(slice(a, b) for a, b in bounds)] = piece
            filled += piece.size
        if filled < full.size:
            raise ValueError(f"checkpoint leaf {key!r}: shards cover {filled} of {full.size} "
                             "elements — incomplete save")
        return full

    def close(self) -> None:
        for d in self._datas:
            d.close()


class _SingleFileSource:
    """Reader over a single-file checkpoint: an entry is its leaf."""

    def __init__(self, path: str):
        self._data = np.load(path)

    def keys(self):
        return [k for k in self._data.files if k not in META_KEYS]

    def shape(self, key):
        if key not in self._data.files:
            raise KeyError(f"checkpoint is missing {key!r} — structure mismatch")
        return tuple(self._data[key].shape)

    def read(self, key: str) -> np.ndarray:
        return self._data[key]

    def close(self) -> None:
        self._data.close()


def _source(path: str):
    return (_ShardedSource(path) if _SHARD_RE.search(os.path.basename(path))
            else _SingleFileSource(path))


def _load_sharded(path: str) -> dict:
    """Every leaf of the complete set ``path`` belongs to, reassembled."""
    src = _ShardedSource(path)
    try:
        return {k: src.read(k) for k in src.keys()}
    finally:
        src.close()


def read_checkpoint_meta(path: str) -> dict:
    """The ``extra_meta`` dict embedded at save time ({} when none); any
    member of a sharded set carries it."""
    with np.load(path) as data:
        if _SHARD_RE.search(os.path.basename(path)):
            return json.loads(str(data[SHARD_META_KEY])).get("user", {})
        if USERMETA_KEY in data.files:
            return json.loads(str(data[USERMETA_KEY]))
    return {}


def read_topology_manifest(path: str) -> Optional[dict]:
    """The ``__topology__`` manifest stamped at save time, or None for a
    checkpoint without one; any member of a sharded set carries it."""
    with np.load(path) as data:
        if _SHARD_RE.search(os.path.basename(path)):
            return json.loads(str(data[SHARD_META_KEY])).get("topology")
        if TOPOLOGY_KEY in data.files:
            return json.loads(str(data[TOPOLOGY_KEY]))
    return None


def checkpoint_step(path: Optional[str]) -> int:
    """The step in a checkpoint's filename; -1 for None (compared across
    ranks on resume)."""
    if path is None:
        return -1
    base = os.path.basename(path)
    m = _SHARD_RE.search(base) or _CKPT_RE.search(base)
    if not m:
        raise ValueError(f"{path!r} is not a checkpoint path")
    return int(m.group(1))


def _verify_npz(path: str) -> bool:
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


def verify_checkpoint(path: str) -> bool:
    """True when ``path`` can be restored: a single file verifies
    (:func:`_verify_npz`); a sharded member's whole complete set does
    (one rank's corrupt member poisons the step). Never raises."""
    m = _SHARD_RE.search(os.path.basename(path))
    if m:
        try:
            files = _sharded_sets(os.path.dirname(path) or ".").get(int(m.group(1)))
        except OSError:
            return False
        return files is not None and all(_verify_npz(f) for f in files)
    return _verify_npz(path)


def _keep_chain(directory: str) -> list:
    """``(step, tie, path)`` of every restorable-looking candidate, newest
    first: each non-empty ``ckpt_N.npz`` and each complete sharded set
    (as its rank-0 member); a single file wins a tie with a set. Sorted,
    so every rank walks the chain in the same order."""
    if not os.path.isdir(directory):
        return []
    out = []
    for f in sorted(os.listdir(directory)):
        if m := _CKPT_RE.search(f):
            p = os.path.join(directory, f)
            if _readable_nonempty(p):
                out.append((int(m.group(1)), 1, p))
    for step, files in _sharded_sets(directory).items():
        out.append((step, 0, files[0]))
    return sorted(out, reverse=True)


def _walk_verified(candidates, verify: bool) -> Optional[str]:
    for _, _, path in candidates:
        if not verify or verify_checkpoint(path):
            return path
        print(f"[checkpoint] skipping corrupt/truncated {path!r} (integrity check "
              "failed); walking back the keep-chain", flush=True)
    return None


def latest_checkpoint(directory: str, verify: bool = False) -> Optional[str]:
    """The newest checkpoint in ``directory`` (a single file, or a
    complete sharded set as its rank-0 member), or None. ``verify=True``
    walks back past checkpoints that fail :func:`verify_checkpoint`,
    saying so."""
    return _walk_verified(_keep_chain(directory), verify)


def newer_verified_checkpoint(directory: str, than_step: int) -> Optional[str]:
    """The newest verified checkpoint strictly newer than ``than_step``,
    or None; the walk stops before the step the caller holds, so a poll
    with nothing new verifies nothing."""
    return _walk_verified([c for c in _keep_chain(directory) if c[0] > than_step], True)


def load_checkpoint(path: str) -> dict:
    """Every state entry of ``path`` (its tree paths and the port's
    ``__torch_*`` generator rows) as numpy arrays; the metadata entries
    are left out. A sharded member reassembles its whole set.
    ``bridge.state_from_flat`` checks them against a template and raises
    on a missing entry or a wrong shape."""
    if _SHARD_RE.search(os.path.basename(path)):
        return _load_sharded(path)
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k not in META_KEYS}


# --------------------------------------------------------------------------
# elastic resume: a checkpoint of another world onto this one
# --------------------------------------------------------------------------


def _resized(src, key: str, policy: dict, tgt_shape: tuple, tgt_dtype) -> np.ndarray:
    """Leaf ``key`` of ``src`` at the target shape under its policy (the
    reference's ``_region_reader`` over the whole leaf):

    - ``global``: the same global content, read as it is;
    - ``reset``: zeros (the codec's error-feedback residuals, which
      belong to each rank's own quantization history);
    - ``worker_consensus``: a stack over workers resized to the new
      count: a float leaf the mean of the saved workers, an integer leaf
      (a step counter) the first worker's value, for every new worker;
    - ``worker_uniform``: fresh share weights ``1 / W``."""
    kind = policy.get("policy", "global")
    if kind == "reset":
        return np.zeros(tgt_shape, tgt_dtype)
    if kind == "worker_uniform":
        w = int(tgt_shape[0]) if tgt_shape else 1
        return np.full(tgt_shape, 1.0 / w, tgt_dtype)
    src_shape = tuple(src.shape(key))
    if kind == "worker_consensus" and src_shape != tuple(tgt_shape):
        stack = src.read(key)
        one = (stack[:1] if np.issubdtype(np.dtype(tgt_dtype), np.integer)
               else stack.mean(axis=0, keepdims=True))
        return np.ascontiguousarray(np.broadcast_to(one.astype(tgt_dtype),
                                                    (tgt_shape[0], *one.shape[1:])))
    if src_shape != tuple(tgt_shape):
        raise ValueError(
            f"checkpoint leaf {key!r} has global shape {src_shape}, expected "
            f"{tuple(tgt_shape)} and no shape-adapting elastic policy covers it — the "
            "saving engine must declare one in its elastic_spec()")
    return np.asarray(src.read(key))


def load_resharded(path: str, target: dict, target_mesh: dict) -> tuple:
    """Restore ``path`` onto a world whose state entries are ``target``
    (``{leaf: (global_shape, numpy dtype)}``, ``engine.entry_shapes``)
    and whose mesh is ``target_mesh`` (``{"shape", "axes"}``); returns
    ``(flat, info)``, ``flat`` as :func:`load_checkpoint` gives it.

    - Same mesh as the manifest's, or no manifest: exactly
      :func:`load_checkpoint` (``info["resharded"]`` False, ``reason``
      ``same-mesh`` / ``no-manifest``), so such a resume stays bit for
      bit.
    - Another mesh: every target leaf from the file under the manifest's
      policy (:func:`_resized`); the generator rows (``__torch_*``) pass
      through as saved, and the caller restarts them when their row count
      is not its world's. ``info``: ``from_world``, ``to_world``,
      ``from_mesh``, ``leaves``, ``reset`` (the saved leaves under a
      ``reset`` policy: zeroed, or gone where the new world holds none).

    Raises naming the leaves when the target holds leaves the manifest
    never stamped and whose policy reads the file."""
    manifest = read_topology_manifest(path)
    if manifest is None:
        return load_checkpoint(path), {"resharded": False, "reason": "no-manifest"}
    if manifest.get("mesh") == target_mesh:
        return load_checkpoint(path), {"resharded": False, "reason": "same-mesh"}
    policies = (manifest.get("elastic") or {}).get("policies") or {}
    stamped = manifest.get("leaves")
    if stamped is not None:
        missing = sorted(k for k in target if k not in stamped and not k.startswith("__")
                         and _policy_for(k, policies).get("policy", "global")
                         not in ("reset", "worker_uniform"))
        if missing:
            raise ValueError(
                f"cannot plan a reshard of {path!r}: the target state has leaves the "
                f"checkpoint's {TOPOLOGY_KEY!r} manifest never stamped: {missing} — the "
                "saving and resuming engines disagree on the state structure (same "
                "rule/model/wire-codec on both sides?)")
    src = _source(path)
    try:
        flat = {}
        for key, (shape, dtype) in target.items():
            if not key.startswith("__"):
                flat[key] = _resized(src, key, _policy_for(key, policies), tuple(shape), dtype)
        for key in src.keys():
            if key.startswith("__torch"):
                flat[key] = np.asarray(src.read(key))
        # the saved leaves whose content does not carry over (zeroed, or
        # gone where the new world holds none)
        reset = sorted(k for k in src.keys() if not k.startswith("__")
                       and _policy_for(k, policies).get("policy") == "reset")
    finally:
        src.close()
    saved_shape = (manifest.get("mesh") or {}).get("shape") or [0]
    info = {"resharded": True, "from_world": int(np.prod(saved_shape)),
            "to_world": int(np.prod(target_mesh.get("shape") or [0])),
            "from_mesh": manifest.get("mesh"), "leaves": len(flat), "reset": reset}
    return flat, info


def shard_pieces(flat: dict, layout: dict) -> dict:
    """``save_checkpoint_sharded``'s ``pieces`` from host arrays:
    ``layout`` maps each entry of ``flat`` to ``(leaf, global_shape,
    bounds)``."""
    pieces: dict = {}
    for name, (leaf, shape, bounds) in layout.items():
        pieces.setdefault(leaf, (tuple(shape), []))[1].append((bounds, flat[name]))
    return pieces


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
             extra_meta: Optional[dict] = None, topology: Optional[dict] = None,
             shard: Optional[dict] = None) -> None:
        """Snapshot ``entries`` (entry name -> tensor or numpy array, the
        reference's names and layouts) and write them on the writer
        thread: as ``ckpt_<step>.npz``, or with ``shard`` (``{"rank",
        "world", "layout": {entry: (leaf, global_shape, bounds)}, "keys"}``)
        as this rank's member of the sharded set
        (:func:`save_checkpoint_sharded`). The write-fault hook fires on
        the writer thread."""
        self.wait()
        t0 = time.perf_counter()
        flat, done = self._snapshot(entries)
        record = {"step": int(step), "loop_ms": None}

        def write():
            t_w = time.perf_counter()
            if done is not None:
                done.synchronize()
            if shard is None:
                record["path"] = save_checkpoint(directory, flat, step, keep, extra_meta,
                                                 record, topology)
            else:
                record["path"] = save_checkpoint_sharded(
                    directory, shard_pieces(flat, shard["layout"]), step, shard["rank"],
                    shard["world"], keep, extra_meta, record, topology, shard.get("keys"))
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


# --------------------------------------------------------------------------
# the scrubber: a corrupt member in the keep-chain makes every verified
# discovery walk past it again, and bit-rot is silent until a resume. The
# scrubber re-verifies the chain and moves corrupt members into
# <ckpt_dir>/quarantine/ (moved, not deleted: the bytes stay for study).
# --------------------------------------------------------------------------

QUARANTINE_DIR = "quarantine"


def scrub_checkpoint_dir(directory: str, quarantine: str = QUARANTINE_DIR,
                         memo: Optional[dict] = None) -> dict:
    """One pass over ``directory``'s checkpoints: every single file and
    every sharded member is re-verified (:func:`_verify_npz`) and a
    corrupt one moved into ``<directory>/<quarantine>/`` (its name kept,
    ``.N`` added on a collision). Returns ``{"checked", "corrupt",
    "quarantined": [names], "seconds"}``. ``memo`` (kept by the caller
    across passes) skips members verified before at the same size and
    mtime. A writer's temporary ``.tmp`` file never matches a checkpoint
    name, and a file it renames into place is whole, so a pass never
    touches a file being written; a file pruned under the pass is
    skipped."""
    t0 = time.perf_counter()
    out = {"checked": 0, "corrupt": 0, "quarantined": [], "seconds": 0.0}
    if not os.path.isdir(directory):
        return out
    names = [f for f in sorted(os.listdir(directory))
             if _CKPT_RE.search(f) or _SHARD_RE.search(f)]
    for f in names:
        p = os.path.join(directory, f)
        try:
            st = os.stat(p)
        except OSError:
            continue
        out["checked"] += 1
        sig = (st.st_size, st.st_mtime_ns)
        if memo is not None and memo.get(f) == sig:
            continue
        if _verify_npz(p):
            if memo is not None:
                memo[f] = sig
            continue
        if not os.path.exists(p):
            continue  # pruned while it was read
        qdir = os.path.join(directory, quarantine)
        os.makedirs(qdir, exist_ok=True)
        dst, n = os.path.join(qdir, f), 1
        while os.path.exists(dst):
            dst = os.path.join(qdir, f"{f}.{n}")
            n += 1
        try:
            os.replace(p, dst)
        except OSError:
            continue
        out["quarantined"].append(f)
        print(f"[scrub] quarantined corrupt checkpoint member {f!r} -> {dst!r}", flush=True)
    out["corrupt"] = len(out["quarantined"])
    out["seconds"] = time.perf_counter() - t0
    return out


class CheckpointScrubber:
    """:func:`scrub_checkpoint_dir` every ``interval`` seconds on a
    background thread until :meth:`stop` (a failed pass is printed and
    the next interval tries again). Passes are memoized on size and
    mtime, with a full pass every :data:`FULL_EVERY` passes (and the
    first): bit-rot can leave a file's metadata as it was. ``scrub_once``
    runs one pass now."""

    FULL_EVERY = 10

    def __init__(self, ckpt_dir: str, *, interval: float = 60.0):
        self.ckpt_dir = ckpt_dir
        self.interval = float(interval)
        self.runs = 0
        self.quarantined_total = 0
        self._memo: dict = {}
        self._pass_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def scrub_once(self) -> dict:
        with self._pass_lock:
            if self.runs % self.FULL_EVERY == 0:
                self._memo.clear()
            res = scrub_checkpoint_dir(self.ckpt_dir, memo=self._memo)
            self.runs += 1
            self.quarantined_total += res["corrupt"]
        return res

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("scrubber already started")
        self._thread = threading.Thread(target=self._loop, name="tmpi-ckpt-scrub", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scrub_once()
            except Exception as e:  # noqa: BLE001 — the next interval retries
                print(f"[scrub] pass failed ({e!r}); retrying next interval", flush=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None


# --------------------------------------------------------------------------
# the resumable marker: the SIGTERM grace path writes it, the supervisor
# reads it to resume the next invocation
# --------------------------------------------------------------------------

_RESUMABLE_MARKER = "resumable.json"


def write_resumable_marker(ckpt_dir: str, step: int, reason: str) -> str:
    """Mark the run in ``ckpt_dir`` as stopped cleanly and resumable
    (atomically; rank 0 writes it)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, _RESUMABLE_MARKER)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"step": int(step), "reason": str(reason), "t": time.time()}, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def read_resumable_marker(ckpt_dir: str) -> Optional[dict]:
    """The marker, or None when it is absent or unreadable."""
    try:
        with open(os.path.join(ckpt_dir, _RESUMABLE_MARKER)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def clear_resumable_marker(ckpt_dir: str) -> None:
    try:
        os.unlink(os.path.join(ckpt_dir, _RESUMABLE_MARKER))
    except OSError:
        pass
