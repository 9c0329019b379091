# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Persistent pre-encoded chunk store: the wire format, written once.

The streamed path (engine/stream.py) uploads every chunk in a WIRE format
that is whole-table-stable by construction: string columns as int32
codes into one whole-table dictionary, int-path columns as narrow
FOR/sorted-dict codes (``io/columnar.plan_column_codec``), everything
else as the lowered device representation (dates as int32 days,
decimals as scaled int64). ``ChunkedTable`` assembles that plan once
per column set (``_wire_plan``), and every chunk is a slice of it. This
module persists the plan across processes:

* :func:`save_plan` writes one directory per table under
  ``NDS_TPU_CHUNK_STORE``: a schema-versioned ``manifest.json`` (codec
  plan, dtypes, per-file CRCs, a content fingerprint of the source
  arrow table) plus one ``.npy`` per buffer — the whole-table code /
  validity arrays ``ChunkedTable.host_chunks`` slices per chunk.
* :func:`load_plan` memory-maps those arrays straight back
  (``np.load(mmap_mode="r")``): a warm process slices mmapped codes into
  the prefetch ring and never touches codec planning or arrow lowering
  again — the files ARE the upload format.

The layout, version, identity digest and fingerprint are the JAX
package's (``nds_tpu/io/chunk_store.py``) byte for byte: a store written
by either package is read by the other. The fingerprint's codec flag is
the ``NDS_TPU_ENCODED`` gate, read as the reference reads it, so an entry
saved under one setting is a miss under the other.

Integrity is refused at load, recovered at the caller, staleness
silent (the ``chunk-store-read``/``-write`` seams of engine/faults.py):

* **version gate** — a manifest whose ``version`` is not this module's
  :data:`STORE_VERSION` raises :class:`ChunkStoreError`: FATAL — an old
  (or newer) writer's layout must never be silently reinterpreted.
* **checksum** — every buffer file carries a CRC32 in the manifest,
  verified at load before the mmap is handed out; a mismatch (torn
  write, bit rot) raises :class:`ChunkStoreCorrupt` rather than
  uploading corrupt codes. TRANSIENT: the engine caller
  (``ChunkedTable._wire_plan``) deletes the entry, re-encodes from the
  source arrow once, and records a FaultEvent — the statement survives,
  wrong codes never upload.
* **stale-codec-plan invalidation** — the manifest records a content
  fingerprint of the source table (row count, schema, buffer sizes and
  head/tail samples, the codec-relevant knobs); a table whose data
  changed no longer matches, the stale entry reads as a MISS, and the
  caller re-encodes and overwrites. Data changes are legitimate; only
  corruption is an error.

The store is keyed by table IDENTITY (column names + canonical types +
row count), so a re-generated table of the same shape reuses the same
directory slot and invalidation-by-fingerprint does the rest.

Concurrent-writer safety: writers serialize on a pid-stamped lock file
per entry slot (:func:`_acquire_entry_lock`; a second LIVE writer
yields — the first writer's entry is equally valid — while a dead
pid's or over-age lock is stolen), buffers land in a temp dir, and ONE
atomic ``os.replace`` swaps the entry in. Two processes warming one
store directory can never interleave inside a slot, and a writer
killed mid-write leaves either the old-valid entry or none — never a
half entry — plus a stale lock the next writer reclaims.

Env: ``NDS_TPU_CHUNK_STORE`` (directory; unset/empty = store off),
``NDS_TPU_CHUNK_STORE_VERIFY`` (default on; ``0`` skips the full CRC
read at load for very large trusted stores) and
``NDS_TPU_CHUNK_STORE_LOCK_STALE_S`` (writer-lock steal age, default
600), all read at use time like every other knob.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import zlib
from dataclasses import dataclass
from hashlib import sha256

import numpy as np

# schema version of the on-disk layout; bump on any incompatible change
STORE_VERSION = 1

# content-fingerprint sampling: CRC the head and tail plus evenly
# spaced interior blocks of every arrow buffer — bounded per column
# (<= (2 + _SAMPLE_STRIDES) x _SAMPLE_BYTES), yet a data regeneration
# that changes values anywhere in the buffer is overwhelmingly likely
# to touch a sampled page (a single flipped value between two sample
# points can in principle slip through — the residual risk of not
# hashing whole >HBM buffers; delete the entry to force a re-encode)
_SAMPLE_BYTES = 1 << 16
_SAMPLE_STRIDES = 16

_MANIFEST = "manifest.json"


class ChunkStoreError(RuntimeError):
    """A store entry that must not be used. Version drift stays in this
    base class — FATAL by classification (an old layout must never be
    silently reinterpreted; the operator deletes or upgrades)."""


class ChunkStoreCorrupt(ChunkStoreError):
    """A corrupt entry: checksum mismatch, torn write, missing buffer
    file, unreadable manifest. TRANSIENT by classification
    (``chunk-store-read`` seam): the store is a cache of the source
    arrow data, so the caller (``engine/table.ChunkedTable._wire_plan``)
    deletes the entry, re-encodes from source ONCE, and records a
    FaultEvent — wrong codes are never uploaded, and a single flipped
    bit no longer fails the statement. Loaded directly (tests, tools),
    this still raises loudly."""


def store_root() -> str | None:
    """``NDS_TPU_CHUNK_STORE`` (read at use time): the store directory,
    or None when the store is off."""
    root = os.environ.get("NDS_TPU_CHUNK_STORE", "").strip()
    return root or None


@dataclass
class WireColumn:
    """The wire form of one column — exactly what
    ``ChunkedTable.host_chunks`` slices per chunk.

    ``codec``: ``"str"`` (dictionary codes + host value table),
    ``"enc"`` (narrow FOR/dict codes + ``Encoding``), or ``"plain"``
    (the lowered device representation). ``data`` is the whole-table
    code/value array (possibly a read-only mmap), ``valid`` the
    whole-table validity or None, ``values`` the host value table
    (str: object array; enc-dict: the Encoding carries it), ``enc`` the
    :class:`nds_tpu_torch.engine.column.Encoding` for ``"enc"`` columns, and
    ``kind`` the device kind the sliced Column is built with."""

    codec: str
    data: np.ndarray
    valid: np.ndarray | None
    values: np.ndarray | None
    enc: object | None
    kind: str


def _identity_digest(arrow, canonical_types: dict) -> str:
    """Directory key: table shape identity (names, canonical types, row
    count). Content changes keep the slot and invalidate by
    fingerprint."""
    from nds_tpu_torch import types as _t
    h = sha256()
    h.update(str(arrow.num_rows).encode())
    for name in arrow.column_names:
        ct = (canonical_types or {}).get(name) or _t.arrow_to_canonical(
            arrow.schema.field(name).type)
        h.update(f"{name}:{ct};".encode())
    return h.hexdigest()[:24]


def table_fingerprint(arrow, canonical_types: dict) -> str:
    """Content fingerprint of the source table: row count, schema, per
    column null count + byte size + CRC of head/tail buffer samples,
    plus the codec-relevant knobs (the ``NDS_TPU_ENCODED`` gate and
    ``DICT_MAX_VALUES``). Any data regeneration that changes values
    moves this, and so does a flip of the gate; the stale store entry
    then reads as a miss."""
    from nds_tpu_torch import types as _t
    from nds_tpu_torch.io.columnar import DICT_MAX_VALUES, encoded_enabled
    h = sha256()
    h.update(f"v{STORE_VERSION};rows={arrow.num_rows};"
             f"enc={int(encoded_enabled())};dict={DICT_MAX_VALUES};"
             .encode())
    for name in arrow.column_names:
        ct = (canonical_types or {}).get(name) or _t.arrow_to_canonical(
            arrow.schema.field(name).type)
        col = arrow.column(name)
        h.update(f"{name}:{ct}:{col.null_count}:{col.nbytes};".encode())
        crc = 0
        for chunk in getattr(col, "chunks", [col]):
            for buf in chunk.buffers():
                if buf is None:
                    continue
                mv = memoryview(buf)
                n = len(mv)
                crc = zlib.crc32(bytes(mv[:_SAMPLE_BYTES]), crc)
                if n > _SAMPLE_BYTES:
                    crc = zlib.crc32(bytes(mv[-_SAMPLE_BYTES:]), crc)
                # interior strides: mid-buffer edits must move the
                # fingerprint too, not just head/tail pages
                if n > 2 * _SAMPLE_BYTES:
                    step = max((n - 2 * _SAMPLE_BYTES)
                               // (_SAMPLE_STRIDES + 1), 1)
                    for s in range(_SAMPLE_BYTES + step,
                                   n - _SAMPLE_BYTES,
                                   step)[:_SAMPLE_STRIDES]:
                        crc = zlib.crc32(
                            bytes(mv[s:s + _SAMPLE_BYTES]), crc)
        h.update(crc.to_bytes(4, "little"))
    return h.hexdigest()


def _crc_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _entry_dir(root: str, arrow, canonical_types: dict) -> str:
    return os.path.join(root, _identity_digest(arrow, canonical_types))


def invalidate_entry(root: str, arrow, canonical_types: dict) -> None:
    """Delete one table's store entry (the corrupt-entry recovery of the
    ``chunk-store-read`` seam): the next ``load_plan`` reads a MISS and
    the caller re-encodes from source."""
    import shutil
    shutil.rmtree(_entry_dir(root, arrow, canonical_types),
                  ignore_errors=True)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True      # e.g. EPERM: exists but not ours
    return True


def lock_stale_s() -> float:
    """``NDS_TPU_CHUNK_STORE_LOCK_STALE_S`` (default 600, read at use):
    age past which a writer lock is stolen even when its recorded pid
    appears alive (pid reuse on a long-lived host)."""
    try:
        return float(os.environ.get("NDS_TPU_CHUNK_STORE_LOCK_STALE_S",
                                    "600"))
    except ValueError:
        return 600.0


def _acquire_entry_lock(final: str):
    """The concurrent-writer lock of one entry slot: an ``O_EXCL`` lock
    file beside the entry dir, pid recorded inside. Returns the lock
    path, or None when another LIVE writer holds it (the caller then
    skips persisting — the other writer's entry is equally valid). A
    lock whose pid is dead (killed writer) or whose mtime is past the
    staleness bound is STOLEN: a kill mid-write must never wedge the
    slot forever."""
    path = final + ".lock"
    for _attempt in (0, 1):
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            try:
                os.write(fd, str(os.getpid()).encode())
            finally:
                os.close(fd)
            return path
        except FileExistsError:
            try:
                with open(path) as f:
                    pid = int(f.read().strip() or "0")
            except FileNotFoundError:
                continue                 # lock vanished: retry O_EXCL
            except (OSError, ValueError):
                pid = 0
            try:
                age = time.time() - os.path.getmtime(path)
            except OSError:
                continue                 # lock vanished: retry O_EXCL
            # pid 0 = not yet stamped (a writer caught between its
            # O_EXCL and its write): only the AGE bound may steal it —
            # treating unstamped-as-dead would unlink a live writer's
            # fresh lock and let two writers interleave in one slot
            stale = age > lock_stale_s() or \
                (pid > 0 and not _pid_alive(pid))
            if not stale:
                return None              # live writer: let it win
            # steal ATOMICALLY via rename: of N concurrent stealers
            # exactly one wins (the losers' rename raises ENOENT), so a
            # freshly re-acquired lock can never be unlinked out from
            # under its new holder; the winner retries the O_EXCL
            grave = f"{path}.stale-{os.getpid()}"
            try:
                os.rename(path, grave)
                os.unlink(grave)
            except OSError:
                pass                     # lost the steal race: retry
    return None


def _release_entry_lock(path: str) -> None:
    """Unlink the lock ONLY while it still holds our pid: after an
    age-based steal the slot's lock belongs to the STEALER, and blindly
    unlinking it would invite a third writer in beside them."""
    try:
        with open(path) as f:
            if f.read().strip() != str(os.getpid()):
                return
    except OSError:
        return                           # gone or unreadable: not ours
    try:
        os.unlink(path)
    except OSError:
        pass


def save_plan(root: str, arrow, canonical_types: dict,
              plan: dict) -> str | None:
    """Persist one table's wire plan (``name -> WireColumn``) under
    ``root``; returns the entry directory, or None when another live
    writer holds the entry's lock (its entry is equally valid — the
    caller serves its in-memory plan).

    Concurrent-writer safety (the ``chunk-store-write`` seam): writers
    serialize on a pid-stamped lock file per entry slot, buffers land in
    a temp dir, and ONE atomic ``os.replace`` swaps the entry in — so
    two processes warming one store directory can never interleave
    inside a slot, and a writer killed mid-write leaves either the
    old-valid entry or none (plus a stale lock the next writer steals by
    pid liveness / age), never a half entry."""
    import shutil
    final = _entry_dir(root, arrow, canonical_types)
    os.makedirs(root, exist_ok=True)
    lock = _acquire_entry_lock(final)
    if lock is None:
        return None
    tmp = None
    try:
        from nds_tpu_torch.engine import faults as _F
        tmp = tempfile.mkdtemp(prefix=".chunkstore-", dir=root)
        cols = []
        for i, name in enumerate(arrow.column_names):
            wc = plan[name]
            rec = {"name": name, "codec": wc.codec, "kind": wc.kind,
                   "dtype": np.dtype(wc.data.dtype).str,
                   "has_valid": wc.valid is not None, "crc": {}}
            dp = os.path.join(tmp, f"{i:03d}.data.npy")
            np.save(dp, np.ascontiguousarray(wc.data))
            rec["crc"]["data"] = _crc_file(dp)
            # chunk-store-write seam: an injection here stops the
            # writer mid-entry; the old-valid-or-none guarantee must
            # hold
            _F.fault_point("chunk-store-write", detail=name)
            if wc.valid is not None:
                vp = os.path.join(tmp, f"{i:03d}.valid.npy")
                np.save(vp, np.ascontiguousarray(wc.valid))
                rec["crc"]["valid"] = _crc_file(vp)
            if wc.codec == "str":
                sp = os.path.join(tmp, f"{i:03d}.values.json")
                with open(sp, "w") as f:
                    json.dump([str(v) for v in wc.values], f)
                rec["crc"]["values"] = _crc_file(sp)
            elif wc.codec == "enc":
                rec["enc_mode"] = wc.enc.mode
                rec["enc_base"] = int(wc.enc.base)
                if wc.enc.values is not None:
                    ep = os.path.join(tmp, f"{i:03d}.values.npy")
                    np.save(ep, np.ascontiguousarray(wc.enc.values))
                    rec["crc"]["values"] = _crc_file(ep)
            cols.append(rec)
        manifest = {"version": STORE_VERSION,
                    "fingerprint": table_fingerprint(arrow,
                                                     canonical_types),
                    "nrows": int(arrow.num_rows), "columns": cols}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        # the one swap: under the lock no concurrent writer can land
        # between the rmtree and the replace, so the slot is always
        # old-valid, new-valid, or (for the instant between the two
        # calls under a kill) absent — never interleaved
        if os.path.isdir(final):
            shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        tmp = None
        return final
    except BaseException:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        _release_entry_lock(lock)


def verify_enabled() -> bool:
    """``NDS_TPU_CHUNK_STORE_VERIFY`` (default on): full CRC
    verification of every wire file at load. The read streams each
    buffer once (it also warms the page cache the mmap will hit);
    operators of very large stores who trust their storage layer can
    set ``0`` to hand the mmap out unchecked — corruption then
    surfaces as wrong data, not a refusal, so the default stays on."""
    return os.environ.get("NDS_TPU_CHUNK_STORE_VERIFY", "1") != "0"


def _load_buffer(d: str, fname: str, want_crc: int, mmap: bool):
    path = os.path.join(d, fname)
    if not os.path.exists(path):
        raise ChunkStoreCorrupt(
            f"chunk store entry {d} is missing {fname} (torn write?); "
            "delete the entry to re-encode")
    if verify_enabled():
        got = _crc_file(path)
        if got != want_crc:
            raise ChunkStoreCorrupt(
                f"chunk store checksum mismatch on {path}: manifest "
                f"{want_crc:#010x} != file {got:#010x}; refusing to "
                "upload corrupt wire data — delete the entry to "
                "re-encode")
    return np.load(path, mmap_mode="r" if mmap else None)


def load_plan(root: str, arrow, canonical_types: dict,
              mmap: bool = True) -> dict | None:
    """The stored wire plan (``name -> WireColumn``) for this table, or
    None on a MISS (no entry, or the entry's fingerprint no longer
    matches the source data — the stale-codec-plan invalidation).
    Raises :class:`ChunkStoreError` on version drift or checksum
    failure — never silently serves a suspect entry."""
    from nds_tpu_torch.engine import faults as _F
    from nds_tpu_torch.engine.column import Encoding
    # chunk-store-read seam (transient): an injected read fault takes
    # the same recovery as a real corrupt entry — delete + re-encode at
    # the caller, evidence-recorded
    _F.fault_point("chunk-store-read")
    d = _entry_dir(root, arrow, canonical_types)
    mpath = os.path.join(d, _MANIFEST)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise ChunkStoreCorrupt(
            f"chunk store manifest {mpath} unreadable: {exc}; delete "
            "the entry to re-encode") from exc
    if manifest.get("version") != STORE_VERSION:
        raise ChunkStoreError(
            f"chunk store entry {d} has layout version "
            f"{manifest.get('version')!r}, this build reads "
            f"{STORE_VERSION}; delete the entry (or upgrade) to "
            "re-encode")
    if manifest.get("fingerprint") != table_fingerprint(arrow,
                                                        canonical_types):
        return None                      # data changed: stale, re-encode
    if manifest.get("nrows") != arrow.num_rows or \
            [c["name"] for c in manifest.get("columns", [])] != \
            list(arrow.column_names):
        return None                      # shape drift: stale, re-encode
    plan = {}
    for i, rec in enumerate(manifest["columns"]):
        data = _load_buffer(d, f"{i:03d}.data.npy", rec["crc"]["data"],
                            mmap)
        valid = None
        if rec["has_valid"]:
            valid = _load_buffer(d, f"{i:03d}.valid.npy",
                                 rec["crc"]["valid"], mmap)
        values, enc = None, None
        if rec["codec"] == "str":
            sp = os.path.join(d, f"{i:03d}.values.json")
            if not os.path.exists(sp):
                raise ChunkStoreCorrupt(
                    f"chunk store entry {d} is missing {sp} (torn "
                    "write?); delete the entry to re-encode")
            if verify_enabled() and _crc_file(sp) != rec["crc"]["values"]:
                raise ChunkStoreCorrupt(
                    f"chunk store checksum mismatch on {sp}; refusing "
                    "to decode against a corrupt dictionary")
            with open(sp) as f:
                values = np.asarray(json.load(f), dtype=object)
            if values.size == 0:
                values = np.asarray([""], dtype=object)
        elif rec["codec"] == "enc":
            ev = None
            if "values" in rec["crc"]:
                ev = np.asarray(_load_buffer(
                    d, f"{i:03d}.values.npy", rec["crc"]["values"],
                    mmap=False))
            enc = Encoding(rec["enc_mode"], rec["enc_base"], ev)
        plan[rec["name"]] = WireColumn(rec["codec"], data, valid,
                                       values, enc, rec["kind"])
    return plan


def lower_plain_column(arr, canonical_type: str):
    """Whole-table HOST lowering of one non-encoded column to its device
    representation (the numpy math of
    ``engine/column.lower_arrow_array``, minus the padding): dates as
    int32 days, decimals as scaled int64, numerics at their device
    dtype. Returns ``(data, valid | None)`` — the arrays ``host_chunks``
    slices per chunk instead of lowering each arrow slice again."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from nds_tpu_torch import types as _t
    from nds_tpu_torch.engine.column import _decimal_to_int64, dec_scale

    if isinstance(arr, pa.Array):
        arr = pa.chunked_array([arr])
    kind = _t.device_kind(canonical_type)
    valid = None
    if arr.null_count:
        valid = ~np.asarray(pc.is_null(arr).combine_chunks().to_numpy(
            zero_copy_only=False))
    if kind.startswith("dec("):
        s = dec_scale(kind)
        if pa.types.is_decimal(arr.type):
            filled = pc.fill_null(arr, pa.scalar(0, arr.type)) \
                if arr.null_count else arr
            data = _decimal_to_int64(filled, arr.type.scale, s)
        else:
            data = np.asarray(pc.fill_null(arr, 0).combine_chunks()
                              .to_numpy(zero_copy_only=False))
            data = np.round(data * (10 ** s)).astype(np.int64)
        return data, valid
    if kind == "date":
        arr = pc.cast(arr, pa.int32())
    filled = pc.fill_null(arr, 0) if arr.null_count else arr
    np_dtype = {"i32": np.int32, "i64": np.int64, "f64": np.float64,
                "date": np.int32, "bool": np.bool_}[kind]
    data = np.asarray(filled.combine_chunks().to_numpy(
        zero_copy_only=False)).astype(np_dtype)
    return data, valid
