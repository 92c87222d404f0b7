"""Per-stream telemetry manifest embedded in ``.ceazs`` footer meta.

A copy of the reference's ``obs/manifest.py`` (``src/repro/obs/``) with
the same schema, ``META_KEY`` and stage names, so either package reads
the other's manifests.

Every stream the async write engine finalizes carries, under the
optional footer meta key ``"telemetry"`` (docs/STREAM_FORMAT.md), a
JSON manifest answering "what produced this stream and where did the
time go": the writer's config fingerprint, aggregate + per-record stage
timings, and the ratio/drift summary. Readers surface it via
``StreamReader.telemetry()``; ``python -m repro_torch.obs.report
<file>`` prints the breakdown table.

The key is NEVER load-bearing for decode — a reader that does not know
it ignores it, and a manifest of any shape must not break
``telemetry()``.

The fingerprint hashes ``dataclasses.asdict`` of the writer's config.
The port's ``CEAZConfig`` has a ``device`` field, no ``trace`` field and
other defaults for ``backend`` and ``use_fused``, so a stream the port
writes carries another fingerprint than the reference's stream of the
same settings. That is expected: the fingerprint names the config that
produced the stream, and the payload bytes do not depend on it.

Schema (version 1; normative field list in docs/OBSERVABILITY.md):

    {"schema": 1,
     "fingerprint": "<12-hex config fingerprint>",
     "config": {...fingerprinted config fields...},
     "stages": {"compress_s": f, "serialize_s": f, "write_s": f,
                "wall_s": f},
     "summary": {"n_records": i, "raw_bytes": i, "stored_bytes": i,
                 "ratio": f, "overlap_efficiency": f},
     "records": [{"key": s, "nbytes": i, "serialize_s": f,
                  "write_s": f}, ...],
     "batches": [{"keys": [s, ...], "compress_s": f}, ...]}

All values are plain JSON scalars; floats round-trip bit-exactly
through the footer (Python's json repr round-trip), so
``StreamReader.telemetry()`` returns the embedded dict unchanged.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional

__all__ = ["MANIFEST_SCHEMA", "META_KEY", "config_fingerprint",
           "build_manifest", "from_meta", "stage_rows"]

MANIFEST_SCHEMA = 1
META_KEY = "telemetry"

# stage keys in pipeline order (report tables keep this order)
STAGES = ("compress_s", "serialize_s", "write_s")


def _jsonable_config(cfg) -> Dict[str, Any]:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cfg = dataclasses.asdict(cfg)
    elif not isinstance(cfg, dict):
        raise TypeError(f"config must be a dataclass or dict, "
                        f"got {type(cfg)!r}")
    out = {}
    for k, v in cfg.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


def config_fingerprint(cfg) -> str:
    """12-hex digest of a config's field values (CEAZConfig dataclass
    or plain dict). Stable across processes: sorted-key JSON, sha1."""
    doc = json.dumps(_jsonable_config(cfg), sort_keys=True,
                     separators=(",", ":"))
    return hashlib.sha1(("ceaz-config-v1:" + doc).encode()).hexdigest()[:12]


def build_manifest(*, stats: Dict[str, Any],
                   config: Any = None,
                   records: Optional[List[Dict[str, Any]]] = None,
                   batches: Optional[List[Dict[str, Any]]] = None,
                   ) -> Dict[str, Any]:
    """Assemble a schema-1 manifest from an engine stats dict
    (``EngineStats.as_dict()`` shape) + optional per-record/batch
    timing rows. Division is guarded: an empty stream manifests as
    all-zero, never a ZeroDivisionError."""
    raw = int(stats.get("raw_bytes", 0))
    stored = int(stats.get("stored_bytes", 0))
    man: Dict[str, Any] = {
        "schema": MANIFEST_SCHEMA,
        "stages": {k: float(stats.get(k, 0.0))
                   for k in STAGES + ("wall_s",)},
        "summary": {
            "n_records": int(stats.get("n_records", 0)),
            "raw_bytes": raw,
            "stored_bytes": stored,
            "ratio": (raw / stored) if stored > 0 else 0.0,
            "overlap_efficiency": float(
                stats.get("overlap_efficiency", 0.0)),
        },
        "records": list(records or []),
        "batches": list(batches or []),
    }
    if config is not None:
        man["config"] = _jsonable_config(config)
        man["fingerprint"] = config_fingerprint(config)
    return man


def from_meta(meta: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The telemetry manifest out of a stream's footer ``meta`` dict,
    or None. Lenient by contract: a malformed value (wrong type,
    future schema) comes back as-is when it is a dict and as None
    otherwise — never an exception, the key is not load-bearing."""
    if not isinstance(meta, dict):
        return None
    man = meta.get(META_KEY)
    return man if isinstance(man, dict) else None


def stage_rows(man: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Pipeline-ordered ``{stage, seconds, share}`` rows for the report
    table; ``share`` is each stage's fraction of the summed stage time
    (guarded — all-zero timings give share 0.0)."""
    stages = man.get("stages", {}) if isinstance(man, dict) else {}
    vals = {k: float(stages.get(k, 0.0) or 0.0) for k in STAGES}
    total = sum(vals.values())
    return [{"stage": k[:-2], "seconds": v,
             "share": (v / total) if total > 0 else 0.0}
            for k, v in vals.items()]
