"""Stage-time / ratio breakdown of a ``.ceazs`` stream's telemetry.

    python -m repro_torch.obs.report <file.ceazs> [--json] [--records N]

Reads the stream's footer (full index validation via ``StreamReader``),
extracts the embedded telemetry manifest (docs/OBSERVABILITY.md) and
prints a stage-time/ratio breakdown table; ``--json`` dumps the raw
manifest instead. Exit codes:

    0  manifest found and printed
    1  stream unreadable / corrupt (StreamCorruptionError)
    2  usage error
    3  stream valid but carries no telemetry manifest

The port's copy of the reference's ``obs/report.py``: the same table,
flags and exit codes, reading through the port's ``io/engine.py``.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional

from . import manifest as M

__all__ = ["main", "render"]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GB"


def render(path: str, meta: dict, n_records: int,
           top_records: int = 5) -> Optional[str]:
    """The human-readable report for one stream's footer meta; None
    when no manifest is embedded."""
    man = M.from_meta(meta)
    if man is None:
        return None
    lines: List[str] = [f"stream     {path}"]
    s = man.get("summary", {})
    lines.append(
        f"records    {s.get('n_records', n_records)}"
        f"    raw {_fmt_bytes(float(s.get('raw_bytes', 0)))}"
        f"    stored {_fmt_bytes(float(s.get('stored_bytes', 0)))}"
        f"    ratio {float(s.get('ratio', 0.0)):.2f}x")
    head = f"schema     {man.get('schema', '?')}"
    if man.get("fingerprint"):
        head += f"    config fingerprint {man['fingerprint']}"
    lines.append(head)
    lines.append("")
    lines.append(f"{'stage':<12}{'seconds':>10}{'share':>9}")
    for row in M.stage_rows(man):
        lines.append(f"{row['stage']:<12}{row['seconds']:>10.4f}"
                     f"{row['share']:>8.1%}")
    stages = man.get("stages", {})
    wall = float(stages.get("wall_s", 0.0) or 0.0)
    lines.append(
        f"{'wall':<12}{wall:>10.4f}   (overlap efficiency "
        f"{float(s.get('overlap_efficiency', 0.0)):.0%})")
    recs = [r for r in man.get("records", []) if isinstance(r, dict)]
    if recs and top_records > 0:
        lines.append("")
        lines.append(f"slowest records (serialize+write), top "
                     f"{min(top_records, len(recs))} of {len(recs)}:")
        cost = lambda r: (float(r.get("serialize_s", 0.0))
                          + float(r.get("write_s", 0.0)))
        for r in sorted(recs, key=cost, reverse=True)[:top_records]:
            lines.append(
                f"  {str(r.get('key', '?')):<20} "
                f"{_fmt_bytes(float(r.get('nbytes', 0))):>10}   "
                f"serialize {float(r.get('serialize_s', 0.0)):.4f}s   "
                f"write {float(r.get('write_s', 0.0)):.4f}s")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    top = 5
    if "--records" in argv:
        i = argv.index("--records")
        try:
            top = int(argv[i + 1])
        except (IndexError, ValueError):
            print("usage: --records N", file=sys.stderr)
            return 2
        del argv[i:i + 2]
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.report <file.ceazs> "
              "[--json] [--records N]", file=sys.stderr)
        return 2
    path = argv[0]
    from ..io.engine import StreamCorruptionError, StreamReader
    try:
        with StreamReader(path) as reader:
            meta, n = reader.meta, len(reader)
    except StreamCorruptionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if as_json:
        man = M.from_meta(meta)
        if man is None:
            print(f"{path}: no telemetry manifest embedded",
                  file=sys.stderr)
            return 3
        print(json.dumps(man, sort_keys=True, indent=1))
        return 0
    text = render(path, meta, n, top_records=top)
    if text is None:
        print(f"{path}: no telemetry manifest embedded "
              f"({n} records in index)", file=sys.stderr)
        return 3
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
