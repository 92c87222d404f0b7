"""Asynchronous compression-I/O engine + self-describing stream format
(PyTorch port of the reference's ``io/engine.py``).

The paper's headline result (up to 28.9x MPI_File_write) comes from
hiding compression cost behind the write path. This module is the
overlap layer every write consumer (filewrite, and the gather and
snapshot streams to come) plugs into:

  submit thread  --> [compress stage] --> [serialize pool] --> [committer]
   (bounded q)      one thread: the       CPU workers:        one thread:
                    facade's device       pickle + crc32      ORDERED append
                    passes on shard i+1   in parallel         of shard i

While the committer is appending shard *i* to storage, the compress
stage is already launching the card's passes for shard *i+1*. Bounded
queues between the stages give backpressure: compression can run at
most ``max_inflight`` items ahead of the slowest stage. Payloads land in
submit order, so the async engine writes files BYTE-IDENTICAL to the
synchronous run (``sync=True`` runs the same stages inline).

Stream format (``.ceazs`` v1, little-endian; the normative spec is the
reference's ``docs/STREAM_FORMAT.md``):

    magic | records ("SHRD" header + payload, seq order) | JSON footer
    index | crc-protected 28B trailer

The port writes and reads that format byte for byte. ``ceaz`` records
are pickles that name the reference's classes
(``repro.core.ceaz.CEAZCompressed`` and ``CompressedChunk``): the
writer pickles the port's records under those names
(:class:`_RecordPickler`) and the reader maps them back onto the port's
classes (:class:`_RecordUnpickler`), so a stream written by either
package reads in the other and ``write_stream`` gives the same bytes as
the reference's for the same shards and settings. Neither side imports
the reference. The ``bytes`` codec (bfloat16 and float8 leaves) reads
and writes torch tensors through an integer view, without ``ml_dtypes``.

The read side is paranoid by design — every failure mode raises
``StreamCorruptionError`` instead of returning garbage:

  * truncated file        -> end-magic / bounds check fails
  * corrupted footer      -> footer crc32 mismatch
  * corrupted payload     -> per-record crc32 mismatch
  * out-of-order commit   -> record header seq != index position
  * a record naming a class the port does not read -> refused unpickle

The facade that the default compress stage and the default reader build
runs on ``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import concurrent.futures as futures
import io as _io
import json
import os
import pickle
import queue
import struct
import tempfile
import threading
import time
import warnings
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.ceaz import CEAZCompressed, CompressedChunk
from ..obs import manifest as _manifest
from ..obs import metrics as om
from ..obs import trace as ot

STREAM_MAGIC = b"CEAZS\x01\x00\x00"
END_MAGIC = b"CEAZSEND"
RECORD_MAGIC = b"SHRD"
RECORD_HEADER = struct.Struct("<4sIQ")        # magic, seq, payload bytes
TRAILER = struct.Struct("<QQI8s")             # foot off, foot len, crc, magic
STREAM_FORMAT_VERSION = 1


class StreamCorruptionError(IOError):
    """The stream failed a structural or checksum validation.

    Every construction bumps the process-wide
    ``ceaz_stream_corruption_total`` counter (obs/metrics.py) — the
    single choke point all read-side validation failures flow through.
    """

    def __init__(self, *args):
        super().__init__(*args)
        om.add(om.CORRUPTION)


# ---------------------------------------------------------------------------
# Payload codecs (shared by the write and read sides)
# ---------------------------------------------------------------------------

# `ceaz` records name the reference's classes (docs/STREAM_FORMAT.md):
# the port's records pickle under these names and unpickle onto the
# port's classes
_REF_MODULE = "repro.core.ceaz"
_REF_CLASSES = {"CEAZCompressed": CEAZCompressed,
                "CompressedChunk": CompressedChunk}
_REF_NAMES = {cls: name for name, cls in _REF_CLASSES.items()}
# what else a record may name: numpy's own reconstructors and dtypes,
# under numpy 2's module path and numpy 1's
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    **{(mod, name): fn
       for mod in ("numpy._core.multiarray", "numpy.core.multiarray")
       for name, fn in (("_reconstruct", np.zeros(0).__reduce__()[0]),
                        ("scalar", np.float64(0).__reduce__()[0]))},
}
# the `bytes` codec's leaves: torch's bfloat16 and float8 tensors under
# the names ml_dtypes gives the same bits, each moved through the
# integer type of its width
_BYTES_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_BYTES_NAMES = {dt: name for name, (dt, _, _) in _BYTES_DTYPES.items()}


class _RecordPickler(pickle._Pickler):
    """Pickles the port's records under the reference's class path.

    The C pickler checks a class's name by importing its module, which
    would import the reference (and JAX). This pure-Python pickler
    writes the two names itself and otherwise emits what the C pickler
    emits, so a record's bytes equal the reference's ``pickle.dumps(c,
    protocol=4)`` of the same stream (tests/test_torch_engine.py)."""

    def save_global(self, obj, name=None):
        ref = _REF_NAMES.get(obj)
        if ref is None:
            return super().save_global(obj, name)
        self.save(_REF_MODULE)
        self.save(ref)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _RecordUnpickler(pickle.Unpickler):
    """Reads a `ceaz` record onto the port's classes. Any global other
    than the two record classes and numpy's reconstructors is refused,
    and nothing is imported."""

    def find_class(self, module, name):
        if module == _REF_MODULE and name in _REF_CLASSES:
            return _REF_CLASSES[name]
        obj = _NUMPY_GLOBALS.get((module, name))
        if obj is None:
            raise StreamCorruptionError(
                f"ceaz record names {module}.{name}, which is neither a "
                "CEAZ record class nor a numpy reconstructor: refused")
        return obj


def serialize_payload(obj) -> tuple:
    """Default object -> (payload bytes, codec meta).

    CEAZCompressed pickles under the reference's class path
    (deterministically: numpy arrays pickle bit-stably), bfloat16 and
    float8 tensors (and numpy arrays of ml_dtypes types) take the
    ``bytes`` codec, other ndarrays go through npy, raw bytes pass
    through.
    """
    if isinstance(obj, CEAZCompressed):
        meta: Dict = {"codec": "ceaz"}
        # bank-mode records are self-describing: the index row carries
        # the bank id plus the per-chunk adaptation delta (selected bank
        # rows), so decoders resolve codebooks without re-deriving them
        # (docs/CODEBOOK_BANK.md, docs/STREAM_FORMAT.md)
        delta = [int(getattr(ch, "bank_index", -1)) for ch in obj.chunks]
        if any(d >= 0 for d in delta):
            meta["bank_id"] = next(
                (getattr(ch, "bank_ref", "") for ch in obj.chunks
                 if getattr(ch, "bank_ref", "")), "")
            meta["bank_delta"] = delta
        bio = _io.BytesIO()
        _RecordPickler(bio, protocol=4).dump(obj)
        return bio.getvalue(), meta
    if isinstance(obj, torch.Tensor):
        name = _BYTES_NAMES.get(obj.dtype)
        if name is None:
            raise TypeError(f"no stream codec for a {obj.dtype} tensor (the "
                            f"bytes codec takes {sorted(_BYTES_DTYPES)})")
        t = obj.detach().cpu().contiguous()
        return (t.view(_BYTES_DTYPES[name][1]).numpy().tobytes(),
                {"codec": "bytes", "shape": list(t.shape), "dtype": name})
    if isinstance(obj, np.ndarray):
        if obj.dtype.name not in np.sctypeDict:   # ml_dtypes (bf16, fp8)
            return obj.tobytes(), {"codec": "bytes",
                                   "shape": list(obj.shape),
                                   "dtype": str(obj.dtype)}
        bio = _io.BytesIO()
        np.save(bio, obj, allow_pickle=False)
        return bio.getvalue(), {"codec": "npy"}
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj), {"codec": "raw"}
    raise TypeError(f"no stream codec for {type(obj)!r}")


def deserialize_payload(payload: bytes, meta: Dict):
    """Inverse of serialize_payload (returns the stored OBJECT; ceaz
    records come back as the port's CEAZCompressed — decompression is
    the caller's business so readers can stay lazy; ``bytes`` leaves of
    bfloat16 or float8 as CPU tensors of that dtype)."""
    codec = meta.get("codec", "raw")
    if codec == "ceaz":
        return _RecordUnpickler(_io.BytesIO(payload)).load()
    if codec == "npy":
        arr = np.load(_io.BytesIO(payload), allow_pickle=False)
        if arr.dtype.kind == "V" and "dtype" in meta:
            return _from_bytes(arr.tobytes(), meta["dtype"], arr.shape)
        return arr
    if codec == "bytes":
        return _from_bytes(payload, meta["dtype"], meta["shape"])
    return payload


def _from_bytes(buf: bytes, name: str, shape):
    """A ``bytes``-codec leaf: a CPU tensor read through an integer view
    for bfloat16 and float8, else a numpy array of the named dtype."""
    if name in _BYTES_DTYPES:
        dt, _, np_int = _BYTES_DTYPES[name]
        ints = np.frombuffer(buf, dtype=np_int).copy()
        return torch.from_numpy(ints).view(dt).reshape(list(shape))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


# ---------------------------------------------------------------------------
# Write side: ordered stream writer (the single-appender "phase 2")
# ---------------------------------------------------------------------------

class StreamWriter:
    """Ordered appender for one ``.ceazs`` stream (format spec:
    docs/STREAM_FORMAT.md).

    Writes to a unique temp name and atomically renames on ``close``,
    so a crash mid-stream never leaves a half-file under the final
    name; ``abort`` discards the temp file.

    Args:
      path: final stream path (parent directories are created).
      meta: stream-level footer metadata. Writers of ``ceaz`` payloads
        should include ``block_size`` (the decode block grain) — see
        the format spec's legacy-stream rule.
      emulate_bps: throttle the append to a storage bandwidth (stored
        bytes/s) — used by the overlap benchmark to model the paper's
        parallel-file-system ceiling identically for sync/async runs.
      fsync: fsync before the atomic rename (durability vs speed).
    """

    def __init__(self, path: str, meta: Optional[Dict] = None,
                 emulate_bps: Optional[float] = None,
                 fsync: bool = True):
        self.path = path
        self._meta = dict(meta or {})
        self._records: List[Dict] = []
        self._seq = 0
        self._emulate_bps = emulate_bps
        self._fsync = fsync
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        # unique temp name: concurrent writers to the same target never
        # interleave; last finalized os.replace wins atomically
        fd, self._tmp = tempfile.mkstemp(
            dir=d, prefix="." + os.path.basename(path) + ".tmp_")
        self._f = os.fdopen(fd, "wb")
        self._f.write(STREAM_MAGIC)
        self._off = len(STREAM_MAGIC)
        self.write_s = 0.0

    def append(self, key: str, payload: bytes,
               meta: Optional[Dict] = None) -> Dict:
        """Commit one payload as the next record; returns its index row."""
        t0 = time.perf_counter()
        seq = self._seq
        header = RECORD_HEADER.pack(RECORD_MAGIC, seq, len(payload))
        self._f.write(header)
        self._f.write(payload)
        rec = {"seq": seq, "key": key, "offset": self._off,
               "nbytes": len(payload),
               "crc32": zlib.crc32(payload) & 0xFFFFFFFF}
        if meta:
            rec.update({k: v for k, v in meta.items() if k not in rec})
        self._records.append(rec)
        self._off += len(header) + len(payload)
        self._seq += 1
        el = time.perf_counter() - t0
        if self._emulate_bps:
            budget = (len(header) + len(payload)) / self._emulate_bps
            if budget > el:
                time.sleep(budget - el)
                el = budget
        self.write_s += el
        return rec

    def close(self, extra_meta: Optional[Dict] = None) -> List[Dict]:
        """Write footer + trailer, fsync, atomic-rename to final path."""
        meta = dict(self._meta)
        if extra_meta:
            meta.update(extra_meta)
        footer = json.dumps(
            {"format": STREAM_FORMAT_VERSION, "meta": meta,
             "records": self._records},
            sort_keys=True, separators=(",", ":")).encode()
        self._f.write(footer)
        self._f.write(TRAILER.pack(self._off, len(footer),
                                   zlib.crc32(footer) & 0xFFFFFFFF,
                                   END_MAGIC))
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self.path)
        return self._records

    def abort(self):
        try:
            self._f.close()
        finally:
            if os.path.exists(self._tmp):
                os.unlink(self._tmp)


# ---------------------------------------------------------------------------
# Read side: validating reader
# ---------------------------------------------------------------------------

class StreamReader:
    """Validating reader for a ``.ceazs`` stream (format spec and the
    full list of validation rules: docs/STREAM_FORMAT.md).

    The constructor validates the trailer, footer checksum and the
    structural invariants of the index (monotonic in-bounds offsets,
    dense seq numbering); ``payload(i)`` additionally checks the
    record's self-identifying header and crc32 before returning bytes.
    ``read_seq``/``read_key`` give O(1) random access through the
    footer index; ``iter_objects`` walks the stream in commit order.

    Raises:
      StreamCorruptionError: on ANY structural or checksum violation —
        truncation, bad magic, footer corruption, unsupported format
        version, index inconsistencies, payload corruption,
        out-of-order commits. Never returns silent garbage.
    """

    def __init__(self, path: str):
        self.path = path
        self._key_to_seq: Dict[str, int] = {}
        try:
            size = os.path.getsize(path)
        except OSError as e:
            raise StreamCorruptionError(f"{path}: unreadable ({e})")
        if size < len(STREAM_MAGIC) + TRAILER.size:
            raise StreamCorruptionError(
                f"{path}: {size}B is smaller than an empty stream "
                "(truncated)")
        self._f = open(path, "rb")
        try:
            self._validate(size)
        except BaseException:       # don't leak the handle on bad streams
            self._f.close()
            raise

    def _validate(self, size: int):
        path = self.path
        if self._f.read(len(STREAM_MAGIC)) != STREAM_MAGIC:
            raise StreamCorruptionError(f"{path}: bad stream magic")
        self._f.seek(size - TRAILER.size)
        foot_off, foot_len, foot_crc, magic = TRAILER.unpack(
            self._f.read(TRAILER.size))
        if magic != END_MAGIC:
            raise StreamCorruptionError(
                f"{path}: end magic missing (truncated or not finalized)")
        if (foot_off < len(STREAM_MAGIC)
                or foot_off + foot_len + TRAILER.size != size):
            raise StreamCorruptionError(
                f"{path}: footer bounds inconsistent with file size")
        self._f.seek(foot_off)
        footer = self._f.read(foot_len)
        if (zlib.crc32(footer) & 0xFFFFFFFF) != foot_crc:
            raise StreamCorruptionError(f"{path}: footer checksum mismatch")
        try:
            doc = json.loads(footer)
        except ValueError as e:
            raise StreamCorruptionError(f"{path}: footer unparsable ({e})")
        if doc.get("format") != STREAM_FORMAT_VERSION:
            raise StreamCorruptionError(
                f"{path}: unsupported stream format {doc.get('format')!r}")
        self.meta: Dict = doc.get("meta", {})
        self.records: List[Dict] = doc.get("records", [])
        prev_end = len(STREAM_MAGIC)
        key_to_seq: Dict[str, int] = {}
        for i, rec in enumerate(self.records):
            if rec.get("seq") != i:
                raise StreamCorruptionError(
                    f"{path}: index seq {rec.get('seq')} at position {i} "
                    "(out-of-order commit)")
            off, nb = rec.get("offset", -1), rec.get("nbytes", -1)
            if off != prev_end or nb < 0 \
                    or off + RECORD_HEADER.size + nb > foot_off:
                raise StreamCorruptionError(
                    f"{path}: record {i} offsets out of bounds/non-contiguous")
            prev_end = off + RECORD_HEADER.size + nb
            # keys are the random-access namespace (`read_key`, the
            # paging layer): a duplicate would silently shadow a record,
            # so the format requires uniqueness (docs/STREAM_FORMAT.md)
            key = rec.get("key")
            if key in key_to_seq:
                raise StreamCorruptionError(
                    f"{path}: duplicate record key {key!r} at seq "
                    f"{key_to_seq[key]} and {i} (record keys must be "
                    "unique — key-addressed reads would silently shadow "
                    "one of them)")
            key_to_seq[key] = i
        self._key_to_seq = key_to_seq

    def __len__(self) -> int:
        return len(self.records)

    def payload(self, i: int) -> bytes:
        """Record i's payload bytes, header- and checksum-verified."""
        rec = self.records[i]
        self._f.seek(rec["offset"])
        magic, seq, nbytes = RECORD_HEADER.unpack(
            self._f.read(RECORD_HEADER.size))
        if magic != RECORD_MAGIC:
            raise StreamCorruptionError(
                f"{self.path}: record {i} header magic corrupted")
        if seq != rec["seq"] or nbytes != rec["nbytes"]:
            raise StreamCorruptionError(
                f"{self.path}: record {i} header says seq={seq}/"
                f"{nbytes}B, index says seq={rec['seq']}/{rec['nbytes']}B "
                "(out-of-order or torn commit)")
        payload = self._f.read(nbytes)
        if len(payload) != nbytes:
            raise StreamCorruptionError(
                f"{self.path}: record {i} truncated")
        if (zlib.crc32(payload) & 0xFFFFFFFF) != rec["crc32"]:
            raise StreamCorruptionError(
                f"{self.path}: record {i} payload checksum mismatch")
        return payload

    def read_object(self, i: int):
        return deserialize_payload(self.payload(i), self.records[i])

    def read_seq(self, seq: int):
        """Random access by sequence number: one footer-index lookup and
        one seek+read — no stream scan. The index is validated dense at
        open (records[i].seq == i), so seq IS the record position."""
        if not 0 <= seq < len(self.records):
            raise IndexError(
                f"{self.path}: seq {seq} out of range "
                f"[0, {len(self.records)})")
        return self.read_object(seq)

    def seq_of(self, key: str) -> int:
        """Sequence number of the record stored under `key`.

        The key index is built (and checked for duplicates) at open, so
        this is a plain dict lookup. Raises a clean, unchained KeyError
        for a missing key — the internal lookup miss is not context the
        caller needs."""
        try:
            return self._key_to_seq[key]
        except KeyError:
            raise KeyError(
                f"{self.path}: no record with key {key!r}") from None

    def read_key(self, key: str):
        """Random access by record key (footer-index lookup)."""
        return self.read_seq(self.seq_of(key))

    def telemetry(self) -> Optional[Dict]:
        """The telemetry manifest embedded under the footer meta's
        optional ``telemetry`` key (docs/OBSERVABILITY.md), or None.
        The key is never load-bearing for decode: a stream without it
        (or with a malformed value) reads back identically."""
        return _manifest.from_meta(self.meta)

    def iter_objects(self) -> Iterator[tuple]:
        for i, rec in enumerate(self.records):
            yield rec, self.read_object(i)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Read side: stream self-configuration (shared by the streaming read
# engine and the decode-on-demand paging layer to come)
# ---------------------------------------------------------------------------

def resolve_stream_bank(reader: StreamReader):
    """Reconstruct + register the codebook bank a bank-mode stream
    embeds in its footer meta (docs/CODEBOOK_BANK.md), or None for
    exact-mode streams. Raises StreamCorruptionError on a forged or
    unparsable artifact — never decodes against a guessed bank."""
    from ..core.codebook import CodebookBank, register_bank
    bank_meta = reader.meta.get("codebook_bank")
    if bank_meta is None:
        return None
    try:
        return register_bank(CodebookBank.from_meta(bank_meta))
    except (ValueError, KeyError, TypeError) as e:
        raise StreamCorruptionError(
            f"{reader.path}: footer meta carries an invalid "
            f"'codebook_bank' artifact: {e}") from e


def default_stream_comp(reader: StreamReader, bank=None,
                        device: str = "cuda"):
    """A fused-decode CEAZ facade on `device` self-configured from a
    stream's footer meta — the decode block grain (``block_size``) and
    the codebook bank. Streams from writers that predate the block-size
    meta fall back to the config default with a warning (the facade's
    block-count check is then the only guard against a wrong grain).
    Raises RuntimeError, as the facade does, for ``device='cuda'``
    without a card."""
    from ..core import CEAZ, CEAZConfig
    bs = reader.meta.get("block_size")
    if bs is None:
        bs = CEAZConfig.block_size
        warnings.warn(
            f"{reader.path}: stream footer meta lacks 'block_size' "
            f"(written by a pre-block-grain writer); assuming "
            f"the default {bs}. Pass an explicitly configured "
            "`comp` if the stream was compressed with another "
            "grain.", stacklevel=3)
    return CEAZ(CEAZConfig(mode="rel", eb=1e-4, use_fused=True,
                           block_size=int(bs), codebook="auto",
                           device=device),
                bank=bank)


def check_bank_record(rec: Dict, obj) -> None:
    """Cross-check a record's bank-id/delta index fields against the
    payload before decode touches a codebook (tamper/corruption on the
    cheap index metadata must not decode garbage silently)."""
    from ..core.codebook import lookup_bank
    bank_id = rec.get("bank_id")
    if bank_id is None:
        return
    key = rec.get("key", "?")
    try:
        bank = lookup_bank(str(bank_id))
    except ValueError as e:
        raise StreamCorruptionError(
            f"record {key!r}: unresolvable bank id {bank_id!r} "
            f"({e})") from e
    delta = rec.get("bank_delta")
    chunk_sel = [int(getattr(ch, "bank_index", -1))
                 for ch in obj.chunks]
    if delta is not None:
        if [int(d) for d in delta] != chunk_sel:
            raise StreamCorruptionError(
                f"record {key!r}: bank_delta does not match the "
                f"payload's per-chunk bank selections")
        if any(int(d) >= bank.n_books for d in delta):
            raise StreamCorruptionError(
                f"record {key!r}: bank_delta indexes past the "
                f"bank's {bank.n_books} books")


# ---------------------------------------------------------------------------
# Read side: prefetch-thread -> device-decode pipeline
# ---------------------------------------------------------------------------

def _overlap_efficiency(stage_a_s: float, stage_b_s: float,
                        wall_s: float) -> float:
    """How much of two stages' serial cost a pipeline hid (1.0 = the
    wall clock collapsed to the busier stage). Shared by the write and
    read engines so both directions score overlap identically."""
    serial = stage_a_s + stage_b_s
    if serial <= 0 or wall_s <= 0:
        return 0.0
    busy = max(stage_a_s, stage_b_s)
    if serial == busy:
        return 1.0
    return max(0.0, min(1.0, (serial - wall_s) / (serial - busy)))


def _stat_field(name: str):
    """Read-only property exposing one per-engine metric as the
    familiar stats attribute (`st.compress_s`, `st.n_records`, ...)."""
    def get(self):
        return self._reg.counter("ceaz_engine_" + name).value()
    get.__name__ = name
    return property(get)


class _StatsView:
    """Per-run engine accounting, backed by a scoped
    :class:`repro_torch.obs.metrics.MetricsRegistry` instead of ad-hoc
    mutable fields. The public attributes the consumers have always
    read (``wall_s``, ``compress_s``, ...) are views over that
    registry; the registry itself is reachable as ``.registry`` for
    Prometheus/JSON export of a single run.

    ``wall_s`` is set ONCE, at the engine's terminal state (end of
    iteration, ``close`` or the first error surfaced) — it never moves
    on a later ``close()`` (tests/test_torch_engine.py).
    """

    _FIELDS: tuple = ()

    def __init__(self):
        self._reg = om.MetricsRegistry()
        self._wall: Optional[float] = None

    @property
    def registry(self) -> om.MetricsRegistry:
        return self._reg

    def add(self, field: str, n) -> None:
        """Accumulate into one stats field (engine-internal)."""
        self._reg.counter("ceaz_engine_" + field).add(n)

    @property
    def wall_s(self) -> float:
        return 0.0 if self._wall is None else self._wall

    def finalize_wall(self, t0: float) -> float:
        """Stamp ``wall_s`` from `t0` if and only if it is unset —
        every terminal path (normal completion, error, close) funnels
        through here, so the first one wins and reruns are no-ops."""
        if self._wall is None:
            self._wall = time.perf_counter() - t0
        return self._wall

    def as_dict(self) -> Dict:
        d = {f: getattr(self, f) for f in self._FIELDS}
        d["wall_s"] = self.wall_s
        d["overlap_efficiency"] = self.overlap_efficiency()
        return d

    def overlap_efficiency(self) -> float:
        raise NotImplementedError


class ReadStats(_StatsView):
    """Per-run accounting for the decode read engine; `read_s` is the
    prefetch thread's file+deserialize time, `decode_s` the device
    decode time the prefetch overlapped with."""

    _FIELDS = ("n_records", "stored_bytes", "raw_bytes", "read_s",
               "decode_s")
    n_records = _stat_field("n_records")
    stored_bytes = _stat_field("stored_bytes")
    raw_bytes = _stat_field("raw_bytes")
    read_s = _stat_field("read_s")
    decode_s = _stat_field("decode_s")

    def overlap_efficiency(self) -> float:
        return _overlap_efficiency(self.read_s, self.decode_s, self.wall_s)


class AsyncDecodeReadEngine:
    """Streaming restore pipeline over one ``.ceazs`` stream.

    The write engine hides compression behind the commit path; this is
    the mirror for the read path:

      prefetch thread --> [bounded queue] --> caller's thread
       validated payload                      groups of `group` records
       read + deserialize                     decoded as ONE batched
       of record i+1                          fused device pass each

    While the device runs the fused Huffman-decode pass for group i, the
    prefetch thread is already reading and unpickling group i+1 — the
    records never take a host-numpy decode bounce: ``CEAZCompressed``
    payloads go straight into ``CEAZ.decompress_batch`` (which routes
    eligible streams to runtime/fused_decode and the rest to the staged
    reference). Iteration yields ``(index_record, decoded_object)`` in
    commit order. ``sync=True`` runs the same stages inline — the
    equal-results reference for tests.

    Backpressure: the queue is bounded by ``max_inflight`` groups, so a
    slow decoder stalls the file reads instead of buffering the whole
    stream in memory.

    Args:
      path: stream to read; the constructor fully validates its index.
      comp: a :class:`~repro_torch.core.CEAZ` facade for decoding
        ``ceaz`` records. When omitted, a fused-decode facade on
        `device` self-configures from the stream's footer meta —
        including the decode block grain (``block_size``); legacy
        footers without it fall back to the config default with a
        warning.
      group: records per batched fused decode pass.
      max_inflight: backpressure bound, in groups.
      sync: run the same stages inline (the equal-results reference).
      device: where the self-configured facade decodes (the card unless
        the caller asks for the CPU; ignored when `comp` is given).

    Raises:
      StreamCorruptionError: from the constructor (invalid index) or
        mid-iteration (payload corruption found by the prefetcher).
      ValueError: decode block grain inconsistent with the stream (see
        ``CEAZ.decompress``).
      RuntimeError: second iteration of a one-shot engine, or
        ``device='cuda'`` without a card.
    """

    def __init__(self, path: str, comp=None, *, group: int = 8,
                 max_inflight: int = 2, sync: bool = False,
                 device: str = "cuda"):
        self._reader = StreamReader(path)   # validates trailer/footer/index
        try:
            # bank-mode streams carry the bank artifact in the footer
            # meta; reconstruct + register it so decode resolves
            # bank-coded chunks without the trained artifact on disk
            self._bank = resolve_stream_bank(self._reader)
            if comp is None:
                comp = default_stream_comp(self._reader, self._bank,
                                           device)
        except BaseException:
            self._reader.close()
            raise
        self._comp = comp
        self._group = max(1, group)
        self._sync = sync
        self.stats = ReadStats()
        self._t0 = time.perf_counter()
        self._stop = False
        self._consumed = False
        if not sync:
            self._q: queue.Queue = queue.Queue(
                maxsize=max(1, max_inflight) * self._group)
            self._prefetcher = threading.Thread(
                target=self._prefetch_loop, name="ceazs-prefetch",
                daemon=True)
            self._prefetcher.start()

    @property
    def meta(self) -> Dict:
        return self._reader.meta

    @property
    def records(self) -> List[Dict]:
        return self._reader.records

    def __len__(self) -> int:
        return len(self._reader)

    @property
    def telemetry(self):
        """The underlying reader's ``telemetry()`` accessor."""
        return self._reader.telemetry

    # -- pipeline stages -----------------------------------------------------
    def _read_one(self, i: int):
        t0 = time.perf_counter()
        with ot.span("reader.prefetch", seq=i):
            obj = self._reader.read_object(i)  # header+crc32 verified
        self.stats.add("read_s", time.perf_counter() - t0)
        return self._reader.records[i], obj

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer went away —
        backpressure without deadlocking an abandoned engine."""
        with ot.span("reader.backpressure_stall"):
            while not self._stop:
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
        return False

    def _prefetch_loop(self):
        try:
            for i in range(len(self._reader)):
                if not self._put(self._read_one(i)):
                    return
            self._put(_SENTINEL)
        except BaseException as e:              # surfaced on the consumer
            self._put(("__error__", e))

    # shared with the paging layer: module-level check_bank_record
    _check_bank_record = staticmethod(check_bank_record)

    @staticmethod
    def _tag_record(e: BaseException, rec: Dict) -> BaseException:
        """Prefix an exception's message with the failing record's seq
        and key, in place — mutating args (not re-constructing) keeps
        the exception type AND avoids double-bumping the corruption
        counter ``StreamCorruptionError.__init__`` increments."""
        where = f"record seq={rec.get('seq', '?')} key={rec.get('key', '?')!r}"
        e.args = ((f"{where}: {e.args[0]}" if e.args else where,)
                  + tuple(e.args[1:]))
        return e

    def _decode_group(self, batch: List[tuple]) -> List[tuple]:
        idx = [i for i, (_, obj) in enumerate(batch)
               if isinstance(obj, CEAZCompressed)]
        for i in idx:
            try:
                self._check_bank_record(batch[i][0], batch[i][1])
            except StreamCorruptionError as e:
                raise self._tag_record(e, batch[i][0])
        if idx:
            t0 = time.perf_counter()
            with ot.span("reader.decode_group", n=len(idx)):
                try:
                    dec = self._comp.decompress_batch(
                        [batch[i][1] for i in idx])
                except Exception as group_err:
                    # the batched pass loses which record failed —
                    # localize by replaying one record at a time and
                    # re-raise the per-record failure with its seq
                    for i in idx:
                        try:
                            self._comp.decompress_batch([batch[i][1]])
                        except Exception as e:
                            raise self._tag_record(
                                e, batch[i][0]) from group_err
                    raise
            self.stats.add("decode_s", time.perf_counter() - t0)
            for i, arr in zip(idx, dec):
                batch[i] = (batch[i][0], arr)
        for rec, obj in batch:
            self.stats.add("n_records", 1)
            self.stats.add("stored_bytes", int(rec.get("nbytes", 0)))
            if isinstance(obj, np.ndarray):
                self.stats.add("raw_bytes", int(obj.nbytes))
            elif isinstance(obj, torch.Tensor):     # a `bytes`-codec leaf
                self.stats.add("raw_bytes", obj.numel() * obj.element_size())
        return batch

    # -- public API ----------------------------------------------------------
    def __iter__(self) -> Iterator[tuple]:
        """(index_record, decoded_object) in commit order; groups of
        `group` records decode as one batched device pass. One-shot:
        the stream is consumed as it decodes — re-open to re-read."""
        if self._consumed:
            raise RuntimeError(
                "AsyncDecodeReadEngine is one-shot: the prefetch thread "
                "has already drained the stream; open a new engine to "
                "re-read it")
        self._consumed = True
        if self._sync:
            n = len(self._reader)
            for s in range(0, n, self._group):
                batch = [self._read_one(i)
                         for i in range(s, min(s + self._group, n))]
                yield from self._decode_group(batch)
            self.stats.finalize_wall(self._t0)
            return
        batch: List[tuple] = []
        done = False
        while not done:
            with ot.span("reader.queue_wait"):
                item = self._q.get()
            if item is _SENTINEL:
                done = True
            elif isinstance(item, tuple) and item[0] == "__error__":
                self._stop = True
                self.stats.finalize_wall(self._t0)  # terminal: error
                raise item[1]
            else:
                batch.append(item)
            if batch and (done or len(batch) >= self._group):
                yield from self._decode_group(batch)
                batch = []
        self.stats.finalize_wall(self._t0)

    def objects(self) -> List[tuple]:
        return list(self)

    def close(self):
        self._stop = True
        self.stats.finalize_wall(self._t0)      # terminal if not already
        if not self._sync:
            self._prefetcher.join(timeout=5.0)
            while True:                         # unblock a parked put
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_stream_arrays(path: str, comp=None, *, group: int = 8,
                       sync: bool = False,
                       device: str = "cuda") -> List[np.ndarray]:
    """Decode every record of a stream back to arrays through the
    prefetch -> batched-fused-decode pipeline (ceaz records are
    decompressed with `comp` — a fused facade on `device` configured
    from the footer if omitted)."""
    with AsyncDecodeReadEngine(path, comp, group=group, sync=sync,
                               device=device) as eng:
        return [obj for _, obj in eng]


# ---------------------------------------------------------------------------
# The async engine
# ---------------------------------------------------------------------------

_SENTINEL = object()


class EngineStats(_StatsView):
    """Per-run accounting; `overlap_efficiency` is how much of the
    compress+write cost the pipeline hid (1.0 = perfect overlap)."""

    _FIELDS = ("n_records", "raw_bytes", "stored_bytes", "compress_s",
               "serialize_s", "write_s")
    n_records = _stat_field("n_records")
    raw_bytes = _stat_field("raw_bytes")
    stored_bytes = _stat_field("stored_bytes")
    compress_s = _stat_field("compress_s")
    serialize_s = _stat_field("serialize_s")
    write_s = _stat_field("write_s")

    def __init__(self):
        super().__init__()
        self.records: List[Dict] = []

    def ratio(self) -> float:
        return self.raw_bytes / max(self.stored_bytes, 1)

    def overlap_efficiency(self) -> float:
        return _overlap_efficiency(self.compress_s, self.write_s,
                                   self.wall_s)

    def as_dict(self) -> Dict:
        d = super().as_dict()
        d["ratio"] = self.ratio()
        d["records"] = self.records
        return d


class AsyncCompressWriteEngine:
    """Double-buffered compress -> serialize -> ordered-commit pipeline.

    ``compress_fn(keys, items) -> list[obj]`` runs on a dedicated
    thread (one batch at a time — device passes and AdaptiveCoder
    streams are order-dependent); ``serialize_fn(obj) -> (bytes, meta)``
    fans out on a worker pool; a committer thread appends payloads
    strictly in submit order. ``sync=True`` runs the exact same stages
    inline — the byte-identical reference the tests compare against.

    Backpressure: both inter-stage queues are bounded by
    ``max_inflight`` batches, so a slow storage target stalls
    compression instead of accumulating payloads in memory.

    Args:
      path: final stream path (atomic-rename discipline, see
        :class:`StreamWriter`).
      compress_fn: ``(keys, items) -> list[obj]``; one returned object
        per key (a short return raises RuntimeError rather than
        finalizing a stream with missing shards).
      serialize_fn: ``obj -> (payload_bytes, codec_meta)``; defaults to
        :func:`serialize_payload`.
      block_size: decode block grain recorded in the footer meta —
        REQUIRED (by the format spec) when ``compress_fn`` produces
        CEAZ payloads, so default readers can self-configure.
      codebook_bank: ``CodebookBank.to_meta()`` dict recorded in the
        footer meta — REQUIRED when ``compress_fn`` emits bank-coded
        chunks, so default readers can resolve their codebooks
        (docs/CODEBOOK_BANK.md).
      config: the compression config (``CEAZConfig`` or dict) behind
        ``compress_fn``; fingerprinted into the telemetry manifest so a
        stream records what produced it (docs/OBSERVABILITY.md).
      telemetry: embed the per-stream telemetry manifest (config
        fingerprint, per-record stage timings, ratio summary) under the
        footer meta's ``telemetry`` key. Optional and never
        load-bearing for decode; the built manifest is exposed as
        ``engine.manifest`` after ``close``.

    Raises:
      RuntimeError: on ``submit*`` after ``close``, and from
        ``submit*``/``close`` when any pipeline stage failed (the
        original exception chained); a failed stream is aborted — the
        temp file is removed and nothing appears under ``path``.
    """

    def __init__(self, path: str,
                 compress_fn: Callable[[List[str], List[Any]], List[Any]],
                 serialize_fn: Callable[[Any], tuple] = serialize_payload,
                 *, writers: int = 2, max_inflight: int = 2,
                 meta: Optional[Dict] = None, sync: bool = False,
                 emulate_bps: Optional[float] = None, fsync: bool = True,
                 block_size: Optional[int] = None,
                 codebook_bank: Optional[Dict] = None,
                 config: Any = None, telemetry: bool = True):
        self._compress_fn = compress_fn
        self._serialize_fn = serialize_fn
        self._config = config
        self._telemetry = telemetry
        self.manifest: Optional[Dict] = None
        # per-record / per-batch timing rows for the stream manifest;
        # each list is touched by exactly one pipeline thread
        self._rec_rows: List[Dict] = []
        self._batch_rows: List[Dict] = []
        meta = dict(meta or {})
        # self-description: readers must decode with the block grain the
        # stream was compressed with — consumers whose compress stage
        # produces CEAZ payloads pass their facade's block_size here so
        # default readers can self-configure from the footer meta
        if block_size is not None:
            meta.setdefault("block_size", int(block_size))
        # bank-mode self-description: the full bank artifact (lengths
        # table, CodebookBank.to_meta()) rides in the footer meta so
        # readers resolve bank-coded chunks without the trained artifact
        if codebook_bank is not None:
            meta.setdefault("codebook_bank", dict(codebook_bank))
        self._writer = StreamWriter(path, meta=meta,
                                    emulate_bps=emulate_bps, fsync=fsync)
        self._sync = sync
        self.stats = EngineStats()
        self._t0 = time.perf_counter()
        self._error: Optional[BaseException] = None
        self._closed = False
        if not sync:
            self._pool = futures.ThreadPoolExecutor(
                max_workers=max(1, writers),
                thread_name_prefix="ceazs-serialize")
            self._cq: queue.Queue = queue.Queue(maxsize=max(1, max_inflight))
            self._wq: queue.Queue = queue.Queue(maxsize=max(1, max_inflight))
            self._compressor = threading.Thread(
                target=self._compress_loop, name="ceazs-compress",
                daemon=True)
            self._committer = threading.Thread(
                target=self._commit_loop, name="ceazs-commit", daemon=True)
            self._compressor.start()
            self._committer.start()

    # -- pipeline stages -----------------------------------------------------
    def _compress(self, keys, items):
        t0 = time.perf_counter()
        with ot.span("engine.compress", n=len(keys)):
            objs = self._compress_fn(keys, items)
        el = time.perf_counter() - t0
        self.stats.add("compress_s", el)
        self._batch_rows.append({"keys": list(keys), "compress_s": el})
        if len(objs) != len(keys):      # a silent drop would finalize a
            raise RuntimeError(         # "successful" stream missing shards
                f"compress_fn returned {len(objs)} payloads "
                f"for {len(keys)} keys")
        return objs

    def _serialize_one(self, obj):
        t0 = time.perf_counter()
        with ot.span("engine.serialize"):
            payload, meta = self._serialize_fn(obj)
        return payload, meta, time.perf_counter() - t0

    def _compress_loop(self):
        while True:
            with ot.span("engine.queue_wait", queue="compress"):
                batch = self._cq.get()
            om.set_gauge(om.QUEUE_DEPTH, self._cq.qsize(),
                         queue="compress")
            if batch is _SENTINEL:
                self._wq.put(_SENTINEL)
                return
            keys, items, metas = batch
            try:
                objs = self._compress(keys, items)
                for key, obj, m in zip(keys, objs, metas):
                    fut = self._pool.submit(self._serialize_one, obj)
                    with ot.span("engine.backpressure_stall",
                                 queue="commit"):
                        self._wq.put((key, fut, m))  # bounded: backpressure
                    om.set_gauge(om.QUEUE_DEPTH, self._wq.qsize(),
                                 queue="commit")
            except BaseException as e:              # propagate via close()
                # stamp the wall clock BEFORE publishing the error: the
                # producer raises out of submit() the moment it sees
                # _error, and must observe a finalized terminal state
                self.stats.finalize_wall(self._t0)
                self._error = self._error or e
                # drain remaining submissions so a producer blocked on the
                # bounded queue can't deadlock against a dead compressor
                while self._cq.get() is not _SENTINEL:
                    pass
                self._wq.put(_SENTINEL)
                return

    def _commit_loop(self):
        while True:
            with ot.span("engine.queue_wait", queue="commit"):
                item = self._wq.get()
            if item is _SENTINEL:
                return
            key, fut, user_meta = item
            try:
                payload, meta, ser_s = fut.result()
                # after a failure only drain (the stream is doomed and
                # will be aborted) — don't pay for further commits
                if self._error is None:
                    self._commit(key, payload, meta, user_meta, ser_s)
            except BaseException as e:
                self.stats.finalize_wall(self._t0)  # terminal: pipeline dead
                self._error = self._error or e
                # keep draining so the compressor never deadlocks on _wq
                continue

    def _commit(self, key, payload, meta, user_meta, ser_s):
        merged = dict(meta or {})
        if user_meta:
            merged.update(user_meta)
        self.stats.add("serialize_s", ser_s)
        w0 = self._writer.write_s
        with ot.span("engine.commit", key=key):
            rec = self._writer.append(key, payload, merged)
        self.stats.add("n_records", 1)
        self.stats.add("stored_bytes", rec["nbytes"])
        self.stats.add("raw_bytes", int(merged.get("raw_nbytes", 0)))
        self.stats.records.append(rec)
        self._rec_rows.append({
            "key": key, "nbytes": rec["nbytes"],
            "raw_nbytes": int(merged.get("raw_nbytes", 0)),
            "serialize_s": ser_s,
            "write_s": self._writer.write_s - w0})

    # -- public API ----------------------------------------------------------
    def submit(self, key: str, item: Any, meta: Optional[Dict] = None):
        """Queue one shard (compressed as its own unit)."""
        self.submit_batch([key], [item], [meta])

    def submit_batch(self, keys: Sequence[str], items: Sequence[Any],
                     metas: Optional[Sequence[Optional[Dict]]] = None):
        """Queue a group of shards compressed as ONE unit (e.g. one
        fused batched device pass); payloads still commit per shard."""
        if self._closed:
            raise RuntimeError("engine is closed")
        self._check_error()
        keys, items = list(keys), list(items)
        metas = list(metas) if metas is not None else [None] * len(keys)
        metas = [self._default_meta(it, m) for it, m in zip(items, metas)]
        if self._sync:
            objs = self._compress(keys, items)
            for key, obj, m in zip(keys, objs, metas):
                payload, meta, ser_s = self._serialize_one(obj)
                self._commit(key, payload, meta, m, ser_s)
            return
        with ot.span("engine.backpressure_stall", queue="compress"):
            self._cq.put((keys, items, metas))
        om.set_gauge(om.QUEUE_DEPTH, self._cq.qsize(), queue="compress")

    @staticmethod
    def _default_meta(item, meta: Optional[Dict]) -> Dict:
        out = dict(meta or {})
        if "raw_nbytes" not in out and isinstance(item, np.ndarray):
            out["raw_nbytes"] = int(item.nbytes)
        return out

    def _check_error(self):
        if self._error is not None:
            raise RuntimeError(
                f"async engine failed: {self._error!r}") from self._error

    def close(self, extra_meta: Optional[Dict] = None) -> EngineStats:
        """Drain the pipeline, finalize the stream, return stats.

        Raises (after cleaning up the temp file) if any stage failed —
        a partially-compressed stream is never renamed into place.
        """
        if self._closed:
            return self.stats
        self._closed = True
        if not self._sync:
            self._cq.put(_SENTINEL)
            self._compressor.join()
            self._committer.join()
            self._pool.shutdown(wait=True)
        # wall clock stops at the terminal state, success OR failure —
        # set exactly once, never clobbered by a later path
        self.stats.finalize_wall(self._t0)
        if self._error is not None:
            self._writer.abort()
            self._check_error()
        self.stats.add("write_s", self._writer.write_s)
        if self._telemetry:
            self.manifest = _manifest.build_manifest(
                stats=self.stats.as_dict(), config=self._config,
                records=self._rec_rows, batches=self._batch_rows)
            extra_meta = dict(extra_meta or {})
            extra_meta.setdefault(_manifest.META_KEY, self.manifest)
        try:
            self._writer.close(extra_meta)
        except BaseException:       # footer/fsync failed: no orphan .tmp
            self._writer.abort()
            raise
        return self.stats

    def abort(self):
        """Tear down without finalizing (temp file removed)."""
        if self._closed:
            return
        self._closed = True
        self._error = self._error or RuntimeError("aborted")
        if not self._sync:
            self._cq.put(_SENTINEL)
            self._compressor.join()
            self._committer.join()
            self._pool.shutdown(wait=True)
        self.stats.finalize_wall(self._t0)
        self._writer.abort()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


def ceaz_compress_fn(comp=None, plan=None,
                     device: str = "cuda") -> Callable:
    """Standard compress stage: the CEAZ facade's batch entry point
    (one fused device pass per submitted group when eligible, staged
    per-shard fallback otherwise); a default facade runs on `device`."""
    from ..core import CEAZ, CEAZConfig
    comp = comp or CEAZ(CEAZConfig(mode="rel", eb=1e-4, use_fused=True,
                                   device=device))

    def _fn(keys, items):
        return comp.compress_batch(items, plan=plan)
    return _fn


def write_stream(path: str, shards: Sequence[np.ndarray], comp=None,
                 *, sync: bool = False, group: int = 2,
                 writers: int = 2, max_inflight: int = 2, plan=None,
                 meta: Optional[Dict] = None,
                 emulate_bps: Optional[float] = None,
                 fsync: bool = True, telemetry: bool = True,
                 device: str = "cuda") -> EngineStats:
    """Compress `shards` into one stream file, overlapped (or sync).

    Shards are grouped `group` at a time: each group is one batched
    fused device pass, and compression of group i+1 overlaps the
    ordered commit of group i. Grouping never changes the bytes (each
    shard keeps its own adaptive-coder stream), only the overlap grain.
    With `comp` omitted the facade is the default one on `device` (rel
    eb 1e-4, fused), which raises without a card for ``'cuda'``.
    """
    if comp is None:
        from ..core import CEAZ, CEAZConfig
        comp = CEAZ(CEAZConfig(mode="rel", eb=1e-4, use_fused=True,
                               device=device))
    eng = AsyncCompressWriteEngine(
        path, ceaz_compress_fn(comp, plan), writers=writers,
        max_inflight=max_inflight, meta=meta, sync=sync,
        emulate_bps=emulate_bps, fsync=fsync,
        block_size=comp.cfg.block_size,
        codebook_bank=(comp.bank.to_meta()
                       if getattr(comp, "bank", None) is not None
                       else None),
        config=comp.cfg, telemetry=telemetry)
    with eng:
        shards = [np.asarray(s) for s in shards]
        group = max(1, group)
        for s in range(0, len(shards), group):
            grp = shards[s:s + group]
            keys = [f"shard_{s + j:05d}" for j in range(len(grp))]
            metas = [{"shape": list(a.shape), "dtype": str(a.dtype),
                      "raw_nbytes": int(a.nbytes)} for a in grp]
            eng.submit_batch(keys, grp, metas)
    return eng.stats
