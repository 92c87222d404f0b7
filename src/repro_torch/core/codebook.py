"""Offline codebook generation + the adaptive online update policy.

CEAZ §3.2.2–3.2.3: codeword generation is the slow serial path (two
"necessary delays", Fig 2), so the stream starts on OFFLINE codewords
(pre-built from representative scientific data whose error bounds were
aligned with the rate law so their quant-code histograms match), and per
chunk the coder decides — from the change of the standard deviation of
symbol frequencies chi = |sigma0 - sigma1| — whether to keep, rebuild, or
fall back:

    chi <= tau0          keep previous codewords (distributions ~identical)
    tau0 < chi <= tau1   rebuild codewords from the live histogram
    chi >  tau1          drastic change: reset histogram, use OFFLINE codewords

We additionally enforce the paper's codebook-storage-overhead rule
(size(codewords) / size(compressed) <= ~10%, §3.2.3) via a minimum update
size (default 32 MB, the paper's Fig 11 optimum).
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .dualquant import np_dual_quantize
from .huffman import (NUM_SYMBOLS, Codebook, codebook_from_lengths,
                      entropy_bits)
from .ratecontrol import calibrate_eb_for_bitrate

# sigma is computed on per-mille-normalized frequencies so thresholds are
# independent of chunk size (the paper's raw-count thresholds 5.18/9.69 are
# tied to their chunk size; ours are calibrated in benchmarks/chi_thresholds
# — see EXPERIMENTS.md).
SIGMA_SCALE = 1000.0
DEFAULT_TAU0 = 2.3     # calibrated: benchmarks/chi_thresholds (5% CR-drop knee)
DEFAULT_TAU1 = 8.0     # calibrated: 25% CR-drop knee (paper raw-count scale: 5.18/9.69)


def sigma_of(freqs: np.ndarray) -> float:
    """Std-dev of the normalized symbol-frequency distribution."""
    freqs = np.asarray(freqs, dtype=np.float64)
    total = freqs.sum()
    if total <= 0:
        return 0.0
    return float(np.std(freqs / total * SIGMA_SCALE))


@dataclasses.dataclass
class AdaptiveDecision:
    action: str            # 'keep' | 'rebuild' | 'offline' | 'bank'
    chi: float
    codebook: Codebook
    stored_codebook: bool  # whether codebook bits must be shipped this chunk
    # bank-mode provenance (action == 'bank'): which canonical book of
    # which registered bank encoded this chunk. -1/"" on exact-mode
    # decisions, so old pickled streams deserialize unchanged.
    bank_index: int = -1
    bank_ref: str = ""


class AdaptiveCoder:
    """Implements the 3-way chi policy over a stream of chunk histograms."""

    def __init__(self, offline: Codebook, tau0: float = DEFAULT_TAU0,
                 tau1: float = DEFAULT_TAU1, exact_build: bool = False):
        self.offline = offline
        self.tau0 = tau0
        self.tau1 = tau1
        self.exact_build = exact_build
        self.current: Codebook = offline
        self.prev_sigma: Optional[float] = None
        self.warm = False        # True once live-built codewords are active
        self.history: list[str] = []

    def reset(self):
        self.current = self.offline
        self.prev_sigma = None
        self.warm = False
        self.history.clear()

    def step(self, freqs: np.ndarray) -> AdaptiveDecision:
        s1 = sigma_of(freqs)
        if self.prev_sigma is None:
            # stream start: paper encodes the first chunk with offline
            # codewords while the histogram is still being collected
            # (bridging the codeword-generation delay, Fig 2).
            self.prev_sigma = s1
            self.history.append("offline")
            return AdaptiveDecision("offline", float("inf"), self.offline,
                                    stored_codebook=False)
        chi = abs(s1 - self.prev_sigma)
        self.prev_sigma = s1
        if chi > self.tau1:
            # drastic distribution change: offline fallback + reset
            self.current = self.offline
            self.warm = False
            self.history.append("offline")
            return AdaptiveDecision("offline", chi, self.offline,
                                    stored_codebook=False)
        if chi > self.tau0 or not self.warm:
            # rebuild from the live histogram; `not warm` forces the first
            # build after an offline bridge even on a stable stream —
            # offline codewords only cover the generation delay.
            self.current = Codebook.from_freqs(freqs,
                                               exact=self.exact_build)
            self.warm = True
            self.history.append("rebuild")
            return AdaptiveDecision("rebuild", chi, self.current,
                                    stored_codebook=True)
        self.history.append("keep")
        return AdaptiveDecision("keep", chi, self.current,
                                stored_codebook=False)


def min_update_bytes(target_ratio: float, word_bits: int = 32,
                     codeword_bits: int = 8, overhead: float = 0.10) -> int:
    """Paper §3.2.3: smallest chunk s.t. codebook storage <= `overhead` of
    the compressed chunk:  S*B / (S*B + (W/C)*N_bits...)  =>  N values."""
    sb = NUM_SYMBOLS * codeword_bits
    n_values = int(np.ceil(sb * (1 - overhead) /
                           (overhead * (word_bits / target_ratio))))
    return n_values * (word_bits // 8)


def build_offline_codebook(fields: Iterable[np.ndarray],
                           target_bitrate: float = 4.0,
                           exact: bool = True) -> Codebook:
    """Offline codewords per paper §3.2.2.

    (1) per dataset, pick eb aligning its bit-rate to `target_bitrate` via
        the rate law (one-shot sampling — no trial-and-error);
    (2) collect quant-code histograms; (3) average the NORMALIZED
        histograms; build the codebook from the average.
    """
    acc = np.zeros(NUM_SYMBOLS, dtype=np.float64)
    n_fields = 0
    for f in fields:
        f = np.asarray(f, dtype=np.float32)
        ndim = min(f.ndim, 3)
        if f.ndim > 3:
            f = f.reshape((-1,) + f.shape[-2:])
        eb = calibrate_eb_for_bitrate(f, target_bitrate, ndim)
        codes, _, _ = np_dual_quantize(f, eb, ndim)
        freqs = np.bincount(codes.reshape(-1), minlength=NUM_SYMBOLS)
        acc += freqs / max(freqs.sum(), 1)
        n_fields += 1
    if n_fields == 0:
        raise ValueError("no fields supplied")
    avg = acc / n_fields
    # integerize at high resolution so rare-symbol structure survives
    freqs = np.round(avg * 1e7).astype(np.int64)
    return Codebook.from_freqs(freqs, exact=exact)


_DEFAULT_CODEBOOK: Optional[Codebook] = None


def default_offline_codebook() -> Codebook:
    """Offline codebook from the SDRBench-proxy corpus (see data/fields.py).

    Shipped with the library the way CEAZ ships codewords generated from
    SDRBench; regenerate with scripts in benchmarks/offline_codewords.py.
    Cached module-wide (it is a constant of the library).
    """
    global _DEFAULT_CODEBOOK
    if _DEFAULT_CODEBOOK is None:
        from ..data import fields as F
        corpus = F.sdrbench_proxy_corpus(seed=1234, size="small")
        _DEFAULT_CODEBOOK = build_offline_codebook([a for _, a in corpus],
                                                   target_bitrate=3.0)
    return _DEFAULT_CODEBOOK


# ---------------------------------------------------------------------------
# Codebook bank: K canonical offline codebooks + single-pass selection
# ---------------------------------------------------------------------------
#
# The paper's offline/online co-design generates codewords offline from
# representative data and adapts online without a per-chunk host tree
# build. The bank is the offline artifact: K canonical length tables
# fitted to a corpus; online adaptation is a per-chunk argmin over the
# exact coded sizes hist . lengths_k — an integer dot product that runs
# identically on host int64 and device int32 (sums are bounded by
# 16 * chunk_values, far under 2^31), so the device can select inside
# the fused encode trace and the host can replay the decision from the
# histogram summaries alone. Normative spec: docs/CODEBOOK_BANK.md.

BANK_FORMAT_VERSION = 1
DEFAULT_BANK_DRIFT_TOL = 0.25


@dataclasses.dataclass
class CodebookBank:
    """A versioned bank of K canonical Huffman codebooks.

    Only the length tables are stored (canonical codes re-derive from
    lengths, exactly like shipped per-chunk codebooks); every book
    covers all NUM_SYMBOLS symbols (add-one smoothing at training time)
    so bank encodes can never hit an uncovered symbol.
    """
    lengths: np.ndarray                 # (K, NUM_SYMBOLS) uint8, all > 0
    version: int = BANK_FORMAT_VERSION
    meta: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.lengths = np.ascontiguousarray(
            np.asarray(self.lengths, np.uint8))
        if self.lengths.ndim != 2 or self.lengths.shape[1] != NUM_SYMBOLS:
            raise ValueError(
                f"bank lengths must be (K, {NUM_SYMBOLS}), "
                f"got {self.lengths.shape}")
        if int(self.version) != BANK_FORMAT_VERSION:
            raise ValueError(
                f"unsupported codebook bank version {self.version!r} "
                f"(this reader supports {BANK_FORMAT_VERSION})")
        if (self.lengths == 0).any():
            raise ValueError("bank books must cover every symbol "
                             "(zero-length codeword found)")
        self._id = hashlib.sha1(
            b"ceaz-bank-v%d:" % int(self.version)
            + self.lengths.tobytes()).hexdigest()[:12]
        self._books: Dict[int, Codebook] = {}

    @property
    def n_books(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def id(self) -> str:
        """Content hash over (version, lengths) — the stream-format
        bank reference (``bank_id``)."""
        return self._id

    def codebook(self, k: int) -> Codebook:
        """Book k as a full canonical Codebook (memoized; decode tables
        are shared through the codebook_from_lengths cache)."""
        k = int(k)
        if not 0 <= k < self.n_books:
            raise ValueError(
                f"bank index {k} out of range [0, {self.n_books})")
        if k not in self._books:
            self._books[k] = codebook_from_lengths(self.lengths[k])
        return self._books[k]

    def code_table(self) -> np.ndarray:
        """(K, NUM_SYMBOLS) uint32 canonical codeword values (the
        device-side gather table of the single-pass encoder)."""
        if not hasattr(self, "_codes"):
            self._codes = np.stack(
                [self.codebook(k).codes for k in range(self.n_books)])
        return self._codes

    def select(self, freqs: np.ndarray) -> Tuple[int, int]:
        """The selection statistic: (argmin_k hist . lengths_k, its
        coded payload bits). Exact integer math; first-minimum
        tie-break — bitwise identical to the device argmin."""
        f = np.asarray(freqs, np.int64)
        costs = f @ self.lengths.astype(np.int64).T
        k = int(np.argmin(costs))
        return k, int(costs[k])

    # -- artifact serialization ---------------------------------------------
    def save(self, path: str):
        """Versioned ``.npz`` artifact (layout: docs/CODEBOOK_BANK.md)."""
        np.savez(path, version=np.int64(self.version),
                 lengths=self.lengths,
                 meta_json=np.frombuffer(
                     json.dumps(self.meta, sort_keys=True).encode(),
                     dtype=np.uint8))

    @classmethod
    def load(cls, path: str) -> "CodebookBank":
        """Load an artifact; refuses unknown versions (the constructor
        enforces the versioning rule)."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta_json"]).decode()) \
                if "meta_json" in z else {}
            return cls(lengths=z["lengths"], version=int(z["version"]),
                       meta=meta)

    # -- stream-meta embedding ----------------------------------------------
    def to_meta(self) -> Dict:
        """JSON-safe footer-meta form (``codebook_bank`` stream key)."""
        return {"version": int(self.version), "id": self.id,
                "n_books": self.n_books,
                "lengths": base64.b64encode(self.lengths.tobytes()).decode()}

    @classmethod
    def from_meta(cls, m: Dict) -> "CodebookBank":
        """Rebuild from footer meta, self-validating: the embedded id
        must match the recomputed content hash (a corrupted or forged
        table raises instead of silently decoding garbage)."""
        lengths = np.frombuffer(
            base64.b64decode(m["lengths"]), np.uint8).reshape(
            int(m["n_books"]), NUM_SYMBOLS)
        bank = cls(lengths=lengths, version=int(m.get("version", -1)))
        if m.get("id") != bank.id:
            raise ValueError(
                f"codebook bank id mismatch: meta says {m.get('id')!r}, "
                f"content hashes to {bank.id!r}")
        return bank


# Process-wide bank registry: decode resolves ``bank_ref`` chunk fields
# through it. Facades register their bank at construction; stream
# readers register banks reconstructed from footer meta.
_BANKS: Dict[str, CodebookBank] = {}


def register_bank(bank: CodebookBank) -> CodebookBank:
    _BANKS[bank.id] = bank
    return bank


def lookup_bank(ref: str) -> CodebookBank:
    try:
        return _BANKS[ref]
    except KeyError:
        raise ValueError(
            f"unknown codebook bank {ref!r}: register it "
            "(repro_torch.core.codebook.register_bank) or decode through a "
            "stream whose footer meta carries it") from None


def train_codebook_bank(fields: Iterable[np.ndarray], n_books: int = 8,
                        target_bitrates: Iterable[float] = (1.5, 2.0, 3.0,
                                                            4.0, 5.0, 6.0,
                                                            8.0, 10.0),
                        exact: bool = True,
                        meta: Optional[Dict] = None) -> CodebookBank:
    """Fit a bank of K canonical codebooks from representative corpora.

    Per (field, target bitrate): align eb to the bitrate via the rate
    law, quantize, collect the normalized quant-code histogram — the
    same per-dataset procedure as :func:`build_offline_codebook`, but
    instead of averaging everything into ONE book, the histograms are
    sorted by entropy and partitioned into ``n_books`` contiguous
    quantile groups, one averaged book per group. The entropy ordering
    makes each book canonical for a *rate regime* (sharp distributions
    at one end, heavy-tailed at the other), which is what per-chunk
    selection needs to track drifting data without a rebuild.
    """
    hists: List[np.ndarray] = []
    for f in fields:
        f = np.asarray(f, dtype=np.float32)
        ndim = min(f.ndim, 3)
        if f.ndim > 3:
            f = f.reshape((-1,) + f.shape[-2:])
        for tb in target_bitrates:
            eb = calibrate_eb_for_bitrate(f, float(tb), ndim)
            codes, _, _ = np_dual_quantize(f, eb, ndim)
            freqs = np.bincount(codes.reshape(-1), minlength=NUM_SYMBOLS)
            hists.append(freqs / max(freqs.sum(), 1))
    if not hists:
        raise ValueError("no fields supplied")
    n_books = max(1, min(int(n_books), len(hists)))
    order = np.argsort([entropy_bits(h) for h in hists], kind="stable")
    groups = np.array_split(order, n_books)
    rows = []
    for g in groups:
        avg = np.mean([hists[i] for i in g], axis=0)
        freqs = np.round(avg * 1e7).astype(np.int64)
        rows.append(Codebook.from_freqs(freqs, exact=exact).lengths)
    return CodebookBank(lengths=np.stack(rows),
                        meta=dict(meta or {},
                                  n_hists=len(hists),
                                  target_bitrates=list(map(float,
                                                           target_bitrates))))


_DEFAULT_BANK: Optional[CodebookBank] = None


def _model_zoo_proxies(seed: int = 77) -> List[np.ndarray]:
    """Weight/optimizer-moment proxies at the configs/ model-zoo scales:
    init-scaled gaussians (weights) and heavy-tailed products
    (gradient moments) for a few fan-in widths — the data a checkpoint
    or grad-snapshot consumer actually feeds the compressor."""
    rng = np.random.default_rng(seed)
    out = []
    for width in (512, 2048):
        w = rng.standard_normal((width, 64)).astype(np.float32)
        out.append(w / np.sqrt(width))                      # init-scaled W
        out.append((w * rng.standard_normal(w.shape) ** 2
                    ).astype(np.float32) * 1e-3)            # moment-like
    return out


def default_codebook_bank() -> CodebookBank:
    """The library's shipped bank: SDRBench-proxy fields plus model-zoo
    weight/moment proxies, trained once and cached module-wide (it is a
    constant of the library, like :func:`default_offline_codebook`).
    Regenerate offline with ``python -m benchmarks.offline_codewords``.
    """
    global _DEFAULT_BANK
    if _DEFAULT_BANK is None:
        from ..data import fields as F
        corpus = [a for _, a in F.sdrbench_proxy_corpus(seed=1234,
                                                        size="small")]
        corpus += _model_zoo_proxies()
        _DEFAULT_BANK = register_bank(train_codebook_bank(
            corpus, n_books=12, meta={"corpus": "sdrbench_proxy+zoo"}))
    return _DEFAULT_BANK


class BankCoder:
    """Bank-mode drop-in for :class:`AdaptiveCoder`: per chunk, select
    the cheapest bank book from the histogram (exact integer argmin —
    no tree build, ever) and account achieved vs ideal bits so the
    facade can replay the drift-fallback check from summaries alone.

    ``step`` is stateless across chunks (each selection depends only on
    that chunk's histogram), which is what makes the device-side
    selection of the single-pass fused encoder and the speculative
    fixed-ratio replay trivially consistent with this host policy.
    """

    def __init__(self, bank: CodebookBank):
        self.bank = bank
        self.achieved_bits = 0
        self.ideal_bits = 0.0
        self.history: List[str] = []

    def reset(self):
        self.achieved_bits = 0
        self.ideal_bits = 0.0
        self.history.clear()

    def step(self, freqs: np.ndarray) -> AdaptiveDecision:
        freqs = np.asarray(freqs, np.int64)
        k, bits = self.bank.select(freqs)
        n = int(freqs.sum())
        # ideal = entropy-coded payload, floored at 1 bit/value (a real
        # code spends >= 1 bit per symbol even on a constant stream)
        ideal = max(entropy_bits(freqs) * n, float(n)) if n else 0.0
        chi = bits / ideal - 1.0 if ideal > 0 else 0.0
        self.achieved_bits += bits
        self.ideal_bits += ideal
        self.history.append("bank")
        return AdaptiveDecision("bank", chi, self.bank.codebook(k),
                                stored_codebook=False, bank_index=k,
                                bank_ref=self.bank.id)

    def drift(self) -> float:
        """Aggregate achieved/ideal - 1 over every chunk stepped so far
        (the drift-fallback statistic; docs/CODEBOOK_BANK.md)."""
        if self.ideal_bits <= 0:
            return 0.0
        return self.achieved_bits / self.ideal_bits - 1.0
