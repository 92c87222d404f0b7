"""Process-wide pipeline counters / gauges / histograms.

One vocabulary for "how much / how fast / how tight" across the whole
stack — the facade, the fused runtimes, both async engines, the kernel
dispatch layer and the benchmark scripts all report into the same
registry, so runtime telemetry and the nightly ``BENCH_*`` JSON speak
the same names (normative list + units: ``docs/OBSERVABILITY.md``).

Semantics:

  * metrics are keyed ``(name, labels)`` and created on first touch;
  * :func:`snapshot` returns a plain ``{fullname: value}`` dict and
    :func:`diff` subtracts two snapshots — the intended usage for
    scoping ("what did THIS run add?") is snapshot-and-diff, not
    resetting the registry;
  * exporters: :meth:`MetricsRegistry.to_prometheus` (text exposition
    format) and :meth:`MetricsRegistry.to_json`;
  * :func:`summary` derives the ratios (achieved compression ratio,
    speculation hit rate, ...) with guarded division — a zero-chunk run
    summarizes to zeros, never a ``ZeroDivisionError``
    (tests/test_edge_cases.py).

Everything is stdlib-only and thread-safe (one lock per registry for
creation, one per metric for updates — updates are plain adds, cheap
enough to leave enabled unconditionally).
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, Iterable, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT",
    "counter", "gauge", "histogram", "add", "inc", "set_gauge",
    "observe", "snapshot", "diff", "summary", "to_prometheus",
    "to_json", "reset",
    # canonical metric names (docs/OBSERVABILITY.md)
    "CHUNKS", "RAW_BYTES", "STORED_BYTES", "DECODED_CHUNKS",
    "DECODED_BYTES", "SPEC_HITS", "SPEC_MISSES", "SPEC_WINDOW",
    "BANK_DRIFT",
    "BANK_FALLBACKS", "BANK_REPACKS", "QUEUE_DEPTH", "CORRUPTION",
    "KERNEL_CALLS", "KERNEL_SECONDS",
    "PAGE_HITS", "PAGE_MISSES", "PAGE_EVICTIONS", "PAGE_CACHE_BYTES",
]

# -- canonical metric names ---------------------------------------------------
# encode side
CHUNKS = "ceaz_chunks_total"                       # chunks compressed
RAW_BYTES = "ceaz_raw_bytes_total"                 # bytes in (uncompressed)
STORED_BYTES = "ceaz_compressed_bytes_total"       # bytes out (compressed)
# decode side
DECODED_CHUNKS = "ceaz_decoded_chunks_total"
DECODED_BYTES = "ceaz_decoded_bytes_total"         # bytes reconstructed
# speculative fixed-ratio batching (runtime/fused.py)
SPEC_HITS = "ceaz_speculation_hits_total"          # forecast eb held
SPEC_MISSES = "ceaz_speculation_misses_total"      # chunk requantized alone
SPEC_WINDOW = "ceaz_speculation_window"            # gauge: adaptive depth
# codebook-bank mode (docs/CODEBOOK_BANK.md)
BANK_DRIFT = "ceaz_bank_drift"                     # gauge: last achieved/ideal-1
BANK_FALLBACKS = "ceaz_bank_exact_fallbacks_total"  # whole-array re-encodes
BANK_REPACKS = "ceaz_bank_overflow_repacks_total"  # provisioning overflows
# async engines (io/engine.py)
QUEUE_DEPTH = "ceaz_engine_queue_depth"            # gauge, labels: queue=
CORRUPTION = "ceaz_stream_corruption_total"        # StreamCorruptionError raised
# kernel dispatch (kernels/dispatch.py), labels: op=, impl=
KERNEL_CALLS = "ceaz_kernel_calls_total"
KERNEL_SECONDS = "ceaz_kernel_pass_seconds"        # histogram; opt-in timing
# decode-on-demand parameter paging (serve/paging.py)
PAGE_HITS = "ceaz_page_hits_total"                 # cache hits (layer reads)
PAGE_MISSES = "ceaz_page_misses_total"             # decode-on-demand page-ins
PAGE_EVICTIONS = "ceaz_page_evictions_total"       # LRU evictions
PAGE_CACHE_BYTES = "ceaz_page_cache_bytes"         # gauge: decoded-resident

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, labels: _LabelKey, unit: str = "",
                 help: str = ""):
        self.name = name
        self.labels = labels
        self.unit = unit
        self.help = help
        self._lock = threading.Lock()

    @property
    def fullname(self) -> str:
        if not self.labels:
            return self.name
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels)
        return f"{self.name}{{{inner}}}"

    def value(self):
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic accumulator (ints or seconds); ``add`` only."""
    kind = "counter"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._v = 0

    def add(self, n=1) -> None:
        with self._lock:
            self._v += n

    inc = add

    def value(self):
        return self._v


class Gauge(_Metric):
    """Point-in-time value; ``set`` / ``add``."""
    kind = "gauge"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._v = 0

    def set(self, v) -> None:
        with self._lock:
            self._v = v

    def add(self, n=1) -> None:
        with self._lock:
            self._v += n

    def value(self):
        return self._v


class Histogram(_Metric):
    """Streaming distribution: count / sum / min / max.

    Deliberately bucket-free — the consumers here (stage timings, pass
    durations) want totals and extrema; full latency distributions
    belong in the trace timeline, not the counter registry.
    """
    kind = "histogram"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    def value(self) -> Dict[str, float]:
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "min": 0.0 if self._min is None else self._min,
                    "max": 0.0 if self._max is None else self._max}


class MetricsRegistry:
    """A namespace of metrics; most callers use the process-wide
    :data:`DEFAULT` through the module-level helpers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, _LabelKey], _Metric] = {}

    def _get(self, cls, name: str, labels: Dict[str, Any], unit: str,
             help: str) -> _Metric:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], unit=unit, help=help)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, unit: str = "", help: str = "",
                **labels) -> Counter:
        return self._get(Counter, name, labels, unit, help)

    def gauge(self, name: str, unit: str = "", help: str = "",
              **labels) -> Gauge:
        return self._get(Gauge, name, labels, unit, help)

    def histogram(self, name: str, unit: str = "", help: str = "",
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, unit, help)

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- snapshot / diff -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Plain ``{fullname: value}`` dict (histograms nest a dict).
        JSON-serializable; pair with :func:`diff` to scope a run."""
        return {m.fullname: m.value() for m in self.metrics()}

    # -- exporters -----------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        by_name: Dict[str, list] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            ms = by_name[name]
            if ms[0].help:
                lines.append(f"# HELP {name} {ms[0].help}")
            kind = ("histogram" if ms[0].kind == "histogram"
                    else ms[0].kind)
            lines.append(f"# TYPE {name} {kind}")
            for m in sorted(ms, key=lambda m: m.labels):
                inner = ",".join(f'{k}="{v}"' for k, v in m.labels)
                if m.kind == "histogram":
                    v = m.value()
                    for suffix in ("count", "sum"):
                        lines.append(
                            f"{name}_{suffix}"
                            f"{'{' + inner + '}' if inner else ''} "
                            f"{v[suffix]}")
                else:
                    lines.append(
                        f"{name}{'{' + inner + '}' if inner else ''} "
                        f"{m.value()}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({"metrics": self.snapshot(),
                           "summary": self.summary()},
                          sort_keys=True, indent=indent)

    # -- derived summary -----------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Derived ratios with guarded division: all-zero counters give
        an all-zero summary, never a ZeroDivisionError."""
        s = self.snapshot()

        def val(name) -> float:
            v = s.get(name, 0)
            return float(v) if not isinstance(v, dict) else 0.0

        raw, stored = val(RAW_BYTES), val(STORED_BYTES)
        hits, misses = val(SPEC_HITS), val(SPEC_MISSES)
        page_hits, page_misses = val(PAGE_HITS), val(PAGE_MISSES)
        return {
            "chunks": val(CHUNKS),
            "raw_bytes": raw,
            "compressed_bytes": stored,
            "achieved_ratio": _ratio(raw, stored),
            "decoded_chunks": val(DECODED_CHUNKS),
            "decoded_bytes": val(DECODED_BYTES),
            "speculation_hit_rate": _ratio(hits, hits + misses),
            "bank_drift": val(BANK_DRIFT),
            "bank_exact_fallbacks": val(BANK_FALLBACKS),
            "bank_overflow_repacks": val(BANK_REPACKS),
            "stream_corruption": val(CORRUPTION),
            "page_hit_rate": _ratio(page_hits, page_hits + page_misses),
            "page_evictions": val(PAGE_EVICTIONS),
        }

    def reset(self) -> None:
        """Drop every metric (tests only — production code scopes runs
        with snapshot-and-diff instead)."""
        with self._lock:
            self._metrics.clear()


def _ratio(num: float, den: float) -> float:
    return num / den if den > 0 else 0.0


def diff(new: Dict[str, Any], old: Dict[str, Any]) -> Dict[str, Any]:
    """``new - old`` over two :meth:`MetricsRegistry.snapshot` dicts.

    Counters/gauges subtract numerically; histogram dicts subtract
    count/sum and keep the new min/max. Metrics absent from ``old``
    pass through unchanged.
    """
    out: Dict[str, Any] = {}
    for k, v in new.items():
        o = old.get(k)
        if o is None:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = dict(v, count=v["count"] - o.get("count", 0),
                          sum=v["sum"] - o.get("sum", 0.0))
        else:
            out[k] = v - o
    return out


# -- process-wide default registry + helper functions ------------------------
# The instrumented modules call these module-level helpers (not the
# registry methods) so a test can no-op the whole layer by patching four
# names — that is how the disabled-overhead budget is measured.
DEFAULT = MetricsRegistry()


def counter(name: str, unit: str = "", help: str = "", **labels) -> Counter:
    return DEFAULT.counter(name, unit=unit, help=help, **labels)


def gauge(name: str, unit: str = "", help: str = "", **labels) -> Gauge:
    return DEFAULT.gauge(name, unit=unit, help=help, **labels)


def histogram(name: str, unit: str = "", help: str = "",
              **labels) -> Histogram:
    return DEFAULT.histogram(name, unit=unit, help=help, **labels)


def add(name: str, n=1, **labels) -> None:
    """Increment a counter on the default registry (the hot-path call)."""
    DEFAULT.counter(name, **labels).add(n)


inc = add


def set_gauge(name: str, v, **labels) -> None:
    DEFAULT.gauge(name, **labels).set(v)


def observe(name: str, v, **labels) -> None:
    DEFAULT.histogram(name, **labels).observe(v)


def snapshot() -> Dict[str, Any]:
    return DEFAULT.snapshot()


def summary() -> Dict[str, float]:
    return DEFAULT.summary()


def to_prometheus() -> str:
    return DEFAULT.to_prometheus()


def to_json(indent: Optional[int] = None) -> str:
    return DEFAULT.to_json(indent)


def reset() -> None:
    DEFAULT.reset()
