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
recording the shard's SHA-256.  Host 0 writes ``manifest.json`` naming every
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
  exact; when the plan changed, ``runtime.resilience`` de-stacks the
  saved state through the manifest's recorded plan spec.
"""
from __future__ import annotations

import hashlib
import json
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

def _dtype_name(x: torch.Tensor) -> str:
    """The manifest's dtype of a leaf: numpy's name, as the JAX writer
    records ``str(np.asarray(x).dtype)`` (``"bfloat16"`` included)."""
    if x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=x.dtype).numpy().dtype)


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
    headers; anything else is refused."""

    def __init__(self, path: str):
        self.path = path
        with zipfile.ZipFile(path) as zf:
            self.infos = {i.filename[:-len(".npy")]: i
                          for i in zf.infolist()
                          if i.filename.endswith(".npy")}
        self.f = open(path, "rb")

    def keys(self):
        return self.infos.keys()

    def _refuse(self, key: str, why: str) -> CheckpointError:
        return CheckpointError(f"{self.path}: member {key}: {why}",
                               reason="format")

    def __getitem__(self, key: str) -> np.ndarray:
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
        out = np.empty(shape, dtype=dtype)
        view = memoryview(out.reshape(-1).view(np.uint8))
        if self.f.readinto(view) != out.nbytes:
            raise self._refuse(key, "short")
        return out

    def close(self) -> None:
        self.f.close()


def save_checkpoint(directory: str, step: int, tree: Pytree, *,
                    host_id: int = 0, num_hosts: int = 1,
                    extra: dict | None = None, plan: dict | None = None,
                    io_fault=None) -> str:
    """Blocking save of this host's shard.  Returns the checkpoint path.

    ``plan``: the saving plan's state-spec
    (``CompiledPipeline.state_spec()``) recorded in the manifest -- what
    elastic restore de-stacks through.  ``io_fault``: optional hook
    called before any byte is written; raising ``OSError`` simulates a
    transient storage failure (the whole save is retryable).
    """
    path = _step_dir(directory, step)
    if io_fault is not None:
        io_fault(step)
    os.makedirs(path, exist_ok=True)
    flat, _ = tree_flatten(tree)
    mine = [i for i in range(len(flat)) if i % num_hosts == host_id]
    arrays = {f"a{i}": _host_array(flat[i]) for i in mine}
    shard = _shard_name(host_id)
    npz = os.path.join(path, shard + ".npz")

    def write_npz(tmp):
        with open(tmp, "wb") as f:
            _write_npz(f, arrays)

    _atomic_write(npz, write_npz)
    _atomic_write_json(os.path.join(path, shard + ".json"),
                       {"file": shard + ".npz", "sha256": _sha256(npz),
                        "leaves": mine})
    if host_id == 0:
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "step": step,
            "num_hosts": num_hosts,
            "num_leaves": len(flat),
            "leaves": [{"shape": [int(n) for n in np.shape(x)],
                        "dtype": _dtype_name(x)} for x in flat],
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


def verify_step(directory: str, step: int) -> dict:
    """Full completeness + integrity check of one step; returns its
    manifest.  A step passes only when the manifest exists, every listed
    shard is present with a sidecar whose SHA-256 matches the bytes on
    disk, and the shards jointly cover every leaf."""
    man = read_manifest(directory, step)
    if man.get("schema") != MANIFEST_SCHEMA:
        raise CheckpointError(
            f"unknown manifest schema {man.get('schema')!r} "
            f"(expected {MANIFEST_SCHEMA})", step=step, reason="schema")
    path = _step_dir(directory, step)
    covered: set[int] = set()
    for shard in man["shards"]:
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
        digest = _sha256(npz)
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

    ``history`` records each save: step, path (``None`` when it
    degraded), bytes of this host's shard, attempts, and seconds:
    ``snapshot_s`` (the host copy :meth:`save_async` blocks on),
    ``write_s`` (shard, sidecar hash and manifest), ``gc_s`` (retention,
    which re-verifies every kept step) and ``total_s`` (from the call to
    the end of GC).
    """

    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0,
                 num_hosts: int = 1, retries: int = 3,
                 backoff: float = 0.05, plan: dict | None = None,
                 io_fault=None):
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.retries = retries
        self.backoff = backoff
        self.plan = plan
        self.io_fault = io_fault
        self.history: list[dict] = []
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree: Pytree,
             extra: dict | None = None) -> str | None:
        """Blocking save with retry/backoff; returns the path or None."""
        t0 = time.perf_counter()
        rec = {"step": step, "path": None, "bytes": 0, "attempts": 0,
               "snapshot_s": 0.0, "write_s": None, "gc_s": None,
               "total_s": None}
        self.history.append(rec)
        last: OSError | None = None
        for attempt in range(self.retries + 1):
            rec["attempts"] = attempt + 1
            try:
                t_w = time.perf_counter()
                path = save_checkpoint(
                    self.directory, step, tree, host_id=self.host_id,
                    num_hosts=self.num_hosts, extra=extra, plan=self.plan,
                    io_fault=self.io_fault)
                t_gc = time.perf_counter()
                self._gc()
                rec.update(path=path, write_s=t_gc - t_w,
                           gc_s=time.perf_counter() - t_gc,
                           total_s=time.perf_counter() - t0,
                           bytes=os.path.getsize(os.path.join(
                               path, _shard_name(self.host_id) + ".npz")))
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
        """Snapshot ``tree`` to host memory (:func:`snapshot`), then write
        it on a background thread: the caller may update the tensors in
        place as soon as this returns."""
        self.wait()                           # one in flight at a time
        t0 = time.perf_counter()
        tree = snapshot(tree)
        snap_s = time.perf_counter() - t0

        def write():
            self.save(step, tree, extra)
            rec = self.history[-1]
            rec["snapshot_s"] = snap_s
            rec["total_s"] += snap_s

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        """Retention keyed on VERIFIED-complete steps only.

        Incomplete step dirs never count toward ``keep``; incomplete dirs
        *older* than the newest complete step are swept (newer ones may
        still be mid-write on another host), as are stale tmp files/dirs
        from crashed saves.  Host 0 owns GC.
        """
        if self.host_id != 0:
            return
        complete = complete_steps(self.directory)
        for s in (complete[:-self.keep] if self.keep else []):
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)
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


def _unlink_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
