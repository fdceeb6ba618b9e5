"""Plan-aware sharded checkpointing with verified manifests (the port of
``repro.checkpoint.store``, all of it host code).

Layout (schema ``repro.checkpoint/v2``), the JAX package's to the byte
inside every npz member:

    <dir>/step_000000123/
        shard_00000.npz     # host 0's leaves (flat leaf index -> array)
        shard_00000.json    # sidecar: SHA-256 of the .npz + its leaf list
        shard_00001.npz     # host 1's leaves ...
        shard_00001.json
        manifest.json       # tree metadata, EXPECTED shard list, the
                            # saving plan's state-spec (+ fingerprint)

Leaves are numbered ``a{i}`` in ``jax.tree_util`` order
(:func:`repro_torch.tree.tree_flatten`), so a checkpoint written by either
package restores in the other.  bf16 leaves are stored as the JAX writer
stores them: raw 2-byte words under the ``.npy`` descr ``<V2`` (numpy has
no bfloat16), with ``"dtype": "bfloat16"`` in the manifest; the reader
takes the manifest's dtype and views the words as ``torch.bfloat16``.

Every host writes only its leaves (leaf-wise round-robin) plus a sidecar
recording the shard's SHA-256.  Over ranks (a ``torchrun`` world, one
process per pipeline device and data replica) every rank is a host: it
writes ``shard_<rank>.npz``, the leaves :func:`assign_writers` gives it
(bytes balanced), each whole, as one process of the same plan holds it
(``runtime.resilience.gather_rank_state`` gathers the pieces;
:func:`save_shard` writes them).  Host 0 writes ``manifest.json`` naming every
*expected* shard, so the manifest alone is **not** the completeness marker:
a step is complete only when the manifest exists AND every listed shard is
present, its sidecar hash verifies, and the shards jointly cover every leaf
(:func:`verify_step`).  All writes are atomic (dot-prefixed tmp +
``os.replace``); GC sweeps stale tmps.

Fault-tolerance contract used by ``launch/train.py``:

- save every N steps (async via a background thread, after a host copy of
  every leaf: the port's AdamW updates params and moments in place, so the
  tensors the trainer holds are no snapshot; transient IO errors retry
  with exponential backoff and a final failure degrades to
  keep-training-and-warn),
- on restart, :func:`restore_checkpoint` returns the newest *verified*
  step, its leaves on the devices of the ``like`` tree's leaves;
  ``strict=False`` falls back past corrupt/partial steps,
- the data pipeline is stateless given (step, host_id), so resume is
  exact; a pipeline's state restores through ``runtime.resilience``,
  which reads each device's rows (or, when the plan changed, the saved
  blocks they hold, through the manifest's recorded plan spec) as byte
  ranges of the members (:meth:`_NpzReader.read_rows`): a rank reads only
  what it holds.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
import shutil
import threading
import time
import warnings
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Pytree = Any

MANIFEST_SCHEMA = "repro.checkpoint/v2"

# the .npy descr the JAX writer gives a bfloat16 leaf (ml_dtypes' bfloat16
# is a 2-byte void type to numpy's format module)
_BF16_DESCR = "<V2"


class CheckpointError(ValueError):
    """Structured checkpoint failure.

    ``step``/``shard``/``reason`` survive as fields so callers can log or
    branch on them; the message carries the same context for humans.
    Subclasses ``ValueError`` so ``except ValueError`` callers keep working.
    """

    def __init__(self, message: str, *, step: int | None = None,
                 shard: str | None = None, reason: str | None = None):
        self.step = step
        self.shard = shard
        self.reason = reason
        ctx = ", ".join(f"{k}={v}" for k, v in
                        (("step", step), ("shard", shard),
                         ("reason", reason)) if v is not None)
        super().__init__(f"[checkpoint{'; ' + ctx if ctx else ''}] "
                         f"{message}")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def _shard_name(host_id: int) -> str:
    return f"shard_{host_id:05d}"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write(path: str, write_fn) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp{os.getpid()}")
    write_fn(tmp)
    os.replace(tmp, path)


def _atomic_write_json(path: str, doc: dict) -> None:
    def w(tmp):
        with open(tmp, "w") as f:
            json.dump(doc, f)
    _atomic_write(path, w)


# ---------------------------------------------------------------------------
# Leaves <-> .npy members
# ---------------------------------------------------------------------------

def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a leaf's dtype: numpy's, as the JAX writer
    records ``str(np.asarray(x).dtype)`` (``"bfloat16"`` included)."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _host_array(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """``(array, descr)`` of one leaf on the host: C-contiguous, bf16 as its
    raw 16-bit words under the JAX writer's descr."""
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), _BF16_DESCR
    a = t.numpy()
    return a, np.lib.format.dtype_to_descr(a.dtype)


def _write_npz(f, arrays: dict[str, tuple[np.ndarray, str]]) -> None:
    """What ``np.savez(f, **arrays)`` writes (stored zip64 members
    ``<name>.npy``, version 1.0 headers), with each header's descr given
    and the payload written from the array's own buffer."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, (a, descr) in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": descr, "fortran_order": False,
                          "shape": tuple(int(n) for n in a.shape)})
                fid.write(memoryview(a.reshape(-1).view(np.uint8)))


def _leaf_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """One stored leaf as a tensor on ``device``, through the manifest's
    dtype: a bfloat16 leaf's raw words (``|V2``/``<V2`` on disk) become
    uint16 bits, then ``torch.bfloat16``."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


class _NpzReader:
    """The ``.npy`` members of one verified npz, each read straight from
    the file into one buffer.  ``np.load`` reads a zip member in 256 KiB
    pieces with a CRC per piece, several times slower at tens of GB; the
    shard's SHA-256 has just been checked, so the CRC adds nothing.  Both
    writers store members uncompressed, C-ordered, with 1.0 or 2.0
    headers; anything else is refused.  :meth:`read_rows` reads one
    contiguous run of a member's rows and nothing else; ``bytes_read``
    counts the array bytes read (the headers' few hundred bytes a member
    aside)."""

    def __init__(self, path: str):
        self.path = path
        with zipfile.ZipFile(path) as zf:
            self.infos = {i.filename[:-len(".npy")]: i
                          for i in zf.infolist()
                          if i.filename.endswith(".npy")}
        self.f = open(path, "rb")
        self.bytes_read = 0
        self._members: dict[str, tuple] = {}

    def keys(self):
        return self.infos.keys()

    def _refuse(self, key: str, why: str) -> CheckpointError:
        return CheckpointError(f"{self.path}: member {key}: {why}",
                               reason="format")

    def member(self, key: str) -> tuple[tuple, np.dtype, int]:
        """``(shape, dtype, offset)`` of a member: its array's shape and
        dtype from the ``.npy`` header, and the file offset of its first
        byte."""
        if key in self._members:
            return self._members[key]
        info = self.infos[key]
        if info.compress_type != zipfile.ZIP_STORED:
            raise self._refuse(key, "compressed")
        self.f.seek(info.header_offset)
        local = self.f.read(30)             # the local file header
        if local[:4] != b"PK\x03\x04":
            raise self._refuse(key, "no local header")
        name_len = int.from_bytes(local[26:28], "little")
        extra_len = int.from_bytes(local[28:30], "little")
        self.f.seek(info.header_offset + 30 + name_len + extra_len)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}.get(
                           np.lib.format.read_magic(self.f))
        if read_header is None:
            raise self._refuse(key, "npy header version")
        shape, fortran, dtype = read_header(self.f)
        if fortran:
            raise self._refuse(key, "Fortran order")
        self._members[key] = (tuple(shape), dtype, self.f.tell())
        return self._members[key]

    def read_rows(self, key: str, lead: int, lo: int, hi: int
                  ) -> np.ndarray:
        """Rows ``lo:hi`` of the member seen as ``[rows, *shape[lead:]]``
        (its first ``lead`` dims flattened, C order): one contiguous byte
        range of the file, read into one buffer."""
        shape, dtype, offset = self.member(key)
        tail = shape[lead:]
        row = math.prod(tail) * dtype.itemsize
        if not 0 <= lo <= hi <= math.prod(shape[:lead]):
            raise self._refuse(key, f"rows {lo}:{hi} of {shape[:lead]}")
        out = np.empty((hi - lo,) + tail, dtype=dtype)
        self.f.seek(offset + lo * row)
        if self.f.readinto(memoryview(out.reshape(-1).view(np.uint8))) \
                != out.nbytes:
            raise self._refuse(key, "short")
        self.bytes_read += out.nbytes
        return out

    def __getitem__(self, key: str) -> np.ndarray:
        shape = self.member(key)[0]
        return self.read_rows(key, 0, 0, 1).reshape(shape)

    def close(self) -> None:
        self.f.close()


def save_checkpoint(directory: str, step: int, tree: Pytree, *,
                    host_id: int = 0, num_hosts: int = 1,
                    extra: dict | None = None, plan: dict | None = None,
                    io_fault=None, times: dict | None = None) -> str:
    """Blocking save of this host's shard.  Returns the checkpoint path.

    ``plan``: the saving plan's state-spec
    (``CompiledPipeline.state_spec()``) recorded in the manifest -- what
    elastic restore de-stacks through.  ``io_fault``: optional hook
    called before any byte is written; raising ``OSError`` simulates a
    transient storage failure (the whole save is retryable).
    """
    flat, _ = tree_flatten(tree)
    mine = {i: flat[i] for i in range(len(flat)) if i % num_hosts == host_id}
    return save_shard(directory, step, mine, leaf_meta(flat),
                      host_id=host_id, num_hosts=num_hosts, extra=extra,
                      plan=plan, io_fault=io_fault, times=times)


def leaf_meta(flat: list) -> list[dict]:
    """The manifest's record of each leaf: shape and dtype."""
    return [{"shape": [int(n) for n in np.shape(x)],
             "dtype": dtype_name(x.dtype)} for x in flat]


def assign_writers(nbytes: list[int], num_hosts: int) -> list[int]:
    """The host that writes each leaf: largest leaf first, each to the
    host with the fewest bytes so far (the lowest index on a tie), so the
    shards hold about equal bytes.  Any assignment restores: the reader
    takes each leaf from the shard whose sidecar lists it."""
    load = [0] * num_hosts
    out = [0] * len(nbytes)
    for i in sorted(range(len(nbytes)), key=lambda i: (-nbytes[i], i)):
        h = min(range(num_hosts), key=lambda h: (load[h], h))
        out[i] = h
        load[h] += nbytes[i]
    return out


def save_shard(directory: str, step: int, leaves: dict, meta: list[dict], *,
               host_id: int = 0, num_hosts: int = 1,
               extra: dict | None = None, plan: dict | None = None,
               io_fault=None, times: dict | None = None) -> str:
    """Write host ``host_id``'s shard of step ``step``: ``leaves`` maps
    the flat index of each leaf it writes to the whole leaf (a tensor),
    ``meta`` is every leaf's :func:`leaf_meta` record, for the manifest
    host 0 writes.  ``times``, when given, receives the seconds of the
    npz (``write_s``) and of its SHA-256 (``hash_s``)."""
    path = _step_dir(directory, step)
    if io_fault is not None:
        io_fault(step)
    os.makedirs(path, exist_ok=True)
    mine = sorted(leaves)
    arrays = {f"a{i}": _host_array(leaves[i]) for i in mine}
    shard = _shard_name(host_id)
    npz = os.path.join(path, shard + ".npz")

    def write_npz(tmp):
        with open(tmp, "wb") as f:
            _write_npz(f, arrays)

    t0 = time.perf_counter()
    _atomic_write(npz, write_npz)
    t1 = time.perf_counter()
    digest = _sha256(npz)
    if times is not None:
        times.update(write_s=t1 - t0, hash_s=time.perf_counter() - t1)
    _atomic_write_json(os.path.join(path, shard + ".json"),
                       {"file": shard + ".npz", "sha256": digest,
                        "leaves": mine})
    if host_id == 0:
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "step": step,
            "num_hosts": num_hosts,
            "num_leaves": len(meta),
            "leaves": meta,
            "shards": [_shard_name(h) + ".npz" for h in range(num_hosts)],
            "plan": plan,
            "extra": extra or {},
        }
        _atomic_write_json(os.path.join(path, "manifest.json"), manifest)
    return path


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------

def read_manifest(directory: str, step: int) -> dict:
    path = os.path.join(_step_dir(directory, step), "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointError("manifest.json missing (incomplete save)",
                              step=step, reason="no-manifest") from None
    except json.JSONDecodeError as e:
        raise CheckpointError(f"manifest.json unreadable: {e}",
                              step=step, reason="manifest-corrupt") from None


def verify_step(directory: str, step: int, *, mine=None) -> dict:
    """Full completeness + integrity check of one step; returns its
    manifest.  A step passes only when the manifest exists, every listed
    shard is present with a sidecar whose SHA-256 matches the bytes on
    disk, and the shards jointly cover every leaf.  ``mine(k)``, when
    given, says whether this caller hashes the manifest's shard ``k``
    (the others are checked for presence and coverage only): ranks that
    split the shards between them and agree on their verdicts have
    verified the step once, not once a rank."""
    man = read_manifest(directory, step)
    if man.get("schema") != MANIFEST_SCHEMA:
        raise CheckpointError(
            f"unknown manifest schema {man.get('schema')!r} "
            f"(expected {MANIFEST_SCHEMA})", step=step, reason="schema")
    path = _step_dir(directory, step)
    covered: set[int] = set()
    for k, shard in enumerate(man["shards"]):
        npz = os.path.join(path, shard)
        if not os.path.exists(npz):
            raise CheckpointError("listed shard missing (incomplete "
                                  "multi-host save)", step=step,
                                  shard=shard, reason="missing-shard")
        side_path = os.path.join(path, shard[:-len(".npz")] + ".json")
        try:
            with open(side_path) as f:
                side = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            raise CheckpointError("shard sidecar missing/unreadable",
                                  step=step, shard=shard,
                                  reason="no-sidecar") from None
        digest = _sha256(npz) if mine is None or mine(k) else side["sha256"]
        if digest != side["sha256"]:
            raise CheckpointError(
                f"shard bytes do not match recorded SHA-256 "
                f"({digest[:12]} != {side['sha256'][:12]})",
                step=step, shard=shard, reason="checksum-mismatch")
        covered.update(side["leaves"])
    if covered != set(range(man["num_leaves"])):
        missing = sorted(set(range(man["num_leaves"])) - covered)
        raise CheckpointError(
            f"shards cover {len(covered)}/{man['num_leaves']} leaves "
            f"(missing {missing[:8]}...)", step=step,
            reason="incomplete-leaves")
    return man


def _all_step_dirs(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in
                  (re.fullmatch(r"step_(\d+)", n)
                   for n in os.listdir(directory)) if m)


def complete_steps(directory: str) -> list[int]:
    """Ascending list of steps that pass full verification."""
    out = []
    for s in _all_step_dirs(directory):
        try:
            verify_step(directory, s)
        except CheckpointError:
            continue
        out.append(s)
    return out


def latest_step(directory: str) -> int | None:
    """Newest step that passes full verification (hash-checked), or None."""
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def wait_step_complete(directory: str, step: int, *,
                       timeout: float = 120.0, poll: float = 0.05) -> dict:
    """Block until ``step`` passes full verification: the multi-host
    barrier on step commit (the shard files double as the barrier
    markers).  Returns the verified manifest; raises
    :class:`CheckpointError` with ``reason="commit-timeout"`` (carrying the
    last verification failure) when some host never lands its shard."""
    deadline = time.time() + timeout
    while True:
        try:
            return verify_step(directory, step)
        except CheckpointError as e:
            if time.time() > deadline:
                raise CheckpointError(
                    f"step did not become complete within {timeout:.1f}s "
                    f"(last failure: {e}) -- a peer host likely died "
                    "mid-commit", step=step,
                    reason="commit-timeout") from e
            time.sleep(poll)


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------

def _load_step(directory: str, step: int, man: dict, like: Pytree,
               expect_shapes: bool) -> Pytree:
    """The step's leaves in ``like``'s structure, each moved to the device
    of ``like``'s leaf as soon as it is read (the host holds one leaf at a
    time)."""
    path = _step_dir(directory, step)
    flat, treedef = tree_flatten(like)
    if len(flat) != man["num_leaves"]:
        raise CheckpointError(
            f"checkpoint has {man['num_leaves']} leaves, model expects "
            f"{len(flat)} -- architecture mismatch", step=step,
            reason="structure")
    files = [_NpzReader(os.path.join(path, shard))
             for shard in man["shards"]]
    try:
        where = {int(k[1:]): z for z in files for k in z.keys()}
        out = []
        for i, proto in enumerate(flat):
            if i not in where:
                raise CheckpointError(f"leaf {i} missing from shards",
                                      step=step, reason="missing-leaf")
            a = where[i][f"a{i}"]
            if expect_shapes and list(a.shape) != list(np.shape(proto)):
                raise CheckpointError(
                    f"leaf {i} shape {list(a.shape)} != "
                    f"{list(np.shape(proto))} (pass expect_shapes=False for "
                    "the elastic path)", step=step, reason="shape")
            out.append(_leaf_tensor(a, man["leaves"][i]["dtype"],
                                    proto.device))
            del a
    finally:
        for z in files:
            z.close()
    return tree_unflatten(treedef, out)


def restore_checkpoint(directory: str, like: Pytree, *,
                       step: int | None = None,
                       strict: bool = True,
                       expect_shapes: bool = True) -> tuple[Pytree, int]:
    """Restore the newest verified (or given) step into ``like``'s
    structure, each leaf on the device of ``like``'s leaf.

    Every candidate step is hash-verified before a byte is deserialized.
    ``strict=True`` raises :class:`CheckpointError` on the first
    corrupt/partial candidate; ``strict=False`` walks backwards to the
    newest step that fully verifies (logging what it skipped) and only
    raises when no step survives.  ``expect_shapes=False`` skips leaf-shape
    checks -- the elastic path, where the caller re-stacks through
    ``runtime.resilience``.
    """
    candidates = ([step] if step is not None
                  else sorted(_all_step_dirs(directory), reverse=True))
    if not candidates:
        raise CheckpointError(f"no checkpoints under {directory}",
                              reason="empty")
    skipped: list[int] = []
    last_err: CheckpointError | None = None
    for s in candidates:
        try:
            man = verify_step(directory, s)
            tree = _load_step(directory, s, man, like, expect_shapes)
        except CheckpointError as e:
            if strict:
                raise
            skipped.append(s)
            last_err = e
            continue
        if skipped:
            print(f"[checkpoint] step(s) {skipped} failed verification "
                  f"(last: {last_err}); fell back to step {s}")
        return tree, s
    assert last_err is not None
    raise last_err


# ---------------------------------------------------------------------------
# Manager
# ---------------------------------------------------------------------------

def snapshot(tree: Pytree) -> Pytree:
    """A host copy of every leaf: a device-to-host copy of a leaf on
    the card (pageable, so each copy waits for the card), a clone of a
    leaf already on the CPU (``.cpu()`` of a CPU tensor is the same
    storage, which an in-place optimizer step would go on changing)."""
    def copy(x):
        x = x.detach()
        return x.to("cpu") if x.device.type != "cpu" else x.clone()
    return tree_map(copy, tree)


class CheckpointManager:
    """Async, bounded-retention manager with retry/backoff saves.

    ``plan``: state-spec dict stamped into every manifest.  ``io_fault``:
    fault-injection hook forwarded to :func:`save_checkpoint`.  Saves
    retry transient ``OSError`` up to ``retries`` times with exponential
    backoff (``backoff * 2**attempt`` seconds); a final failure warns
    and returns ``None`` -- checkpointing degrades, training never
    crashes on storage trouble.

    Over ranks (``ranks`` given, a
    ``runtime.resilience.RankSaves``; ``host_id`` the rank, ``num_hosts``
    the world): :meth:`save_async` calls ``ranks.collect(tree)`` on the
    caller's thread, which every rank reaches in the same order; it
    returns ``(leaves, meta, stats)``, the whole leaves this rank writes
    as host tensors (the gather is the snapshot), every leaf's
    :func:`leaf_meta` record and the gather's numbers, and the rank's
    shard is written on the background thread (:func:`save_shard`).
    :meth:`wait` then asks ``ranks.all(landed)``, a collective, whether
    every rank's shard landed: a step whose save degraded on any rank
    never verifies, and every rank warns and trains on.

    GC (host 0; over ranks at :meth:`wait`, once the ranks agree a step
    landed) counts only verified-complete steps toward ``keep``.  A step
    is hashed once: a step this manager saw land whole (one host's save,
    or every rank's shard landed), one :meth:`trust` names (a restore
    verified it), or one GC verified, stays complete while its files keep
    their sizes and modification times.

    ``history`` records each save: step, path (``None`` when it
    degraded), bytes of this host's shard, attempts, and seconds:
    ``snapshot_s`` (the host copy or the gather :meth:`save_async` blocks
    on), ``blocking_s`` (all of :meth:`save_async`, the wait for the
    previous save included), ``write_s`` (the shard), ``hash_s`` (its
    SHA-256), ``gc_s`` (retention; ``gc_hashed`` the steps it hashed) and
    ``total_s`` (from the call to the end of GC); over ranks also the
    gather's ``stats`` and ``landed`` (every rank's shard landed).
    """

    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0,
                 num_hosts: int = 1, retries: int = 3,
                 backoff: float = 0.05, plan: dict | None = None,
                 io_fault=None, ranks=None):
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.retries = retries
        self.backoff = backoff
        self.plan = plan
        self.io_fault = io_fault
        self.ranks = ranks
        self.history: list[dict] = []
        self._thread: threading.Thread | None = None
        self._unagreed: dict | None = None
        self._complete: dict[int, tuple] = {}   # step -> its files' stat

    def save(self, step: int, tree: Pytree,
             extra: dict | None = None) -> str | None:
        """Blocking save with retry/backoff; returns the path or None."""
        return self._save(step, self._record(step), lambda times:
                          save_checkpoint(
                              self.directory, step, tree,
                              host_id=self.host_id, num_hosts=self.num_hosts,
                              extra=extra, plan=self.plan,
                              io_fault=self.io_fault, times=times))

    def _record(self, step: int) -> dict:
        rec = {"step": step, "path": None, "bytes": 0, "attempts": 0,
               "snapshot_s": 0.0, "blocking_s": None, "write_s": None,
               "hash_s": None, "gc_s": None, "gc_hashed": [],
               "total_s": None}
        self.history.append(rec)
        return rec

    def _save(self, step: int, rec: dict, write) -> str | None:
        t0 = time.perf_counter()
        last: OSError | None = None
        for attempt in range(self.retries + 1):
            rec["attempts"] = attempt + 1
            try:
                times: dict = {}
                path = write(times)
                t_gc = time.perf_counter()
                hashed = []
                if self.ranks is None:      # over ranks: at wait()
                    if self.num_hosts == 1:
                        self.trust(step)
                    hashed = self._gc()
                rec.update(path=path, gc_s=time.perf_counter() - t_gc,
                           gc_hashed=hashed,
                           total_s=time.perf_counter() - t0,
                           bytes=os.path.getsize(os.path.join(
                               path, _shard_name(self.host_id) + ".npz")),
                           **times)
                return path
            except OSError as e:
                last = e
                if attempt < self.retries:
                    delay = self.backoff * (2 ** attempt)
                    print(f"[checkpoint] save at step {step} failed "
                          f"({e}); retry {attempt + 1}/{self.retries} "
                          f"in {delay:.2f}s")
                    time.sleep(delay)
        rec["total_s"] = time.perf_counter() - t0
        warnings.warn(
            f"checkpoint save at step {step} failed after "
            f"{self.retries + 1} attempts ({last}); training continues "
            "WITHOUT this checkpoint", RuntimeWarning, stacklevel=2)
        return None

    def save_async(self, step: int, tree: Pytree,
                   extra: dict | None = None) -> None:
        """Snapshot ``tree`` to host memory (:func:`snapshot`, or over
        ranks the gather of ``ranks.collect``), then write it on a background
        thread: the caller may update the tensors in place as soon as
        this returns."""
        t0 = time.perf_counter()
        self.wait()                           # one in flight at a time
        t1 = time.perf_counter()
        if self.ranks is None:
            tree = snapshot(tree)

            def write(times):
                return save_checkpoint(
                    self.directory, step, tree, host_id=self.host_id,
                    num_hosts=self.num_hosts, extra=extra, plan=self.plan,
                    io_fault=self.io_fault, times=times)
            stats = {}
        else:
            leaves, meta, stats = self.ranks.collect(tree)

            def write(times):
                return save_shard(
                    self.directory, step, leaves, meta,
                    host_id=self.host_id, num_hosts=self.num_hosts,
                    extra=extra, plan=self.plan, io_fault=self.io_fault,
                    times=times)
        t2 = time.perf_counter()
        rec = self._record(step)
        rec.update(snapshot_s=t2 - t1, blocking_s=t2 - t0, **stats)

        def run():
            self._save(step, rec, write)
            rec["total_s"] += t2 - t1

        if self.ranks is not None:
            self._unagreed = rec
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the save in flight; over ranks, then agree with every
        rank on whether all their shards landed (a collective: every rank
        calls this at the same point), and run GC once they have."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._unagreed is not None:
            rec, self._unagreed = self._unagreed, None
            rec["landed"] = bool(self.ranks.all(rec["path"] is not None))
            if not rec["landed"]:
                warnings.warn(
                    f"checkpoint step {rec['step']} is incomplete: a "
                    "rank's save failed, so the step never verifies; "
                    "training continues WITHOUT it", RuntimeWarning,
                    stacklevel=2)
            elif self.host_id == 0:
                t0 = time.perf_counter()
                self.trust(rec["step"])
                rec["gc_hashed"] = self._gc()
                rec["gc_s"] = time.perf_counter() - t0

    def _files(self, step: int) -> tuple:
        """``(name, size, mtime_ns)`` of every file of a step directory."""
        path = _step_dir(self.directory, step)
        out = []
        for name in sorted(os.listdir(path)):
            st = os.stat(os.path.join(path, name))
            out.append((name, st.st_size, st.st_mtime_ns))
        return tuple(out)

    def trust(self, step: int) -> None:
        """Count ``step`` complete, without hashing it, while its files
        keep their sizes and modification times: every shard of it was
        verified or written whole by now."""
        self._complete[step] = self._files(step)

    def _is_complete(self, step: int, hashed: list) -> bool:
        try:
            if self._complete.get(step) == self._files(step):
                return True
            hashed.append(step)
            verify_step(self.directory, step)
        except (CheckpointError, OSError):
            self._complete.pop(step, None)
            return False
        self.trust(step)
        return True

    def _gc(self) -> list[int]:
        """Retention keyed on VERIFIED-complete steps only.

        Incomplete step dirs never count toward ``keep``; incomplete dirs
        *older* than the newest complete step are swept (newer ones may
        still be mid-write on another host), as are stale tmp files/dirs
        from crashed saves.  Host 0 owns GC.  A step already known
        complete, with its files unchanged, is not hashed again.  Returns
        the steps it verified (hashed).
        """
        hashed: list[int] = []
        if self.host_id != 0:
            return hashed
        complete = [s for s in _all_step_dirs(self.directory)
                    if self._is_complete(s, hashed)]
        for s in (complete[:-self.keep] if self.keep else []):
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)
            self._complete.pop(s, None)
        newest = complete[-1] if complete else None
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith(".") or ".tmp" in name:
                (shutil.rmtree(full, ignore_errors=True)
                 if os.path.isdir(full) else _unlink_quiet(full))
                continue
            m = re.fullmatch(r"step_(\d+)", name)
            if m and newest is not None and int(m.group(1)) < newest \
                    and int(m.group(1)) not in complete:
                shutil.rmtree(full, ignore_errors=True)
        return hashed


def _unlink_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
