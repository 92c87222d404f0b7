"""The stream-level cases of ``decode_fuzz_corpus.json`` replayed on the
port's ``.ceazs`` streams (no JAX): its named cases, then its
derandomized bit flips, each turned into the mutated stream bytes.

Shared by ``tests/test_torch_engine.py`` (the fence on the CPU) and
``chip_smoke.py`` (phase W.fuzz on the card), as the reference's
``tests/test_engine.py::test_decode_differential_fuzz_fence`` replays
the same corpus on its own streams.
"""
import json
import os

import numpy as np

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "decode_fuzz_corpus.json")
# the fuzz target's facade options: 3 walks of 6000 values, books
# shipped with every chunk of 2048
FUZZ_KW = dict(mode="rel", eb=1e-4, adaptive=False, chunk_bytes=1 << 13)


def corpus_cases(n_records):
    """The corpus's stream-level cases, then its derandomized flips."""
    with open(CORPUS) as f:
        corpus = json.load(f)
    cases = list(corpus["cases"])
    rng = np.random.default_rng(corpus["random"]["seed"])
    for _ in range(corpus["random"]["n_bitflips"]):
        cases.append({"kind": "bitflip",
                      "record": int(rng.integers(n_records)),
                      "rel_off": int(rng.integers(1 << 16)),
                      "bit": int(rng.integers(8))})
    return cases


def apply_corpus_case(data, records, case):
    """One corpus case -> the mutated stream bytes (offsets relative to a
    record, or to the live trailer)."""
    from repro_torch.io import engine as E
    if case["kind"] == "truncate_index":
        foot_off, foot_len, _, _ = E.TRAILER.unpack(data[-E.TRAILER.size:])
        cut = {"mid_footer": foot_off + foot_len // 2,
               "mid_trailer": len(data) - E.TRAILER.size // 2}[case["at"]]
        return data[:cut]
    rec = records[case["record"] % len(records)]
    body = rec["offset"] + E.RECORD_HEADER.size
    if case["kind"] == "bitflip":
        mut = bytearray(data)
        mut[body + case["rel_off"] % rec["nbytes"]] ^= 1 << (case["bit"] & 7)
        return bytes(mut)
    if case["kind"] != "truncate":
        raise ValueError(f"unknown corpus case {case}")
    cut = {"after_header": body,
           "mid_payload": body + rec["nbytes"] // 2,
           "after_payload": body + rec["nbytes"]}[case["at"]]
    return data[:cut]
