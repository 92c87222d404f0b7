"""The port's compressed gather through the Huffman codec
(``repro_torch/io/collectives.py``: ``ceaz_gather``, ``ceaz_gather_decode``,
``ceaz_gather_stream``, ``read_gather_stream``) against the reference's,
on the CPU: the same seeded numpy ranks through both packages, streams
compared field by field, decoded arrays and stream records byte for
byte, and each package reading the other's gather stream.
"""
import os

import numpy as np
import pytest

from conftest import assert_streams_bit_identical
from repro.io import collectives as RCOL
from repro_torch import convert as CV
from repro_torch.core import CEAZ, CEAZConfig
from repro_torch.io import collectives as COL
from repro_torch.io import engine as E
from repro_torch.obs import trace as ot

# 2^14-value chunks: each 32^3 rank spans two chunk rows
KW = dict(chunk_values=1 << 14, block_size=1024)


def _nyx_like(shape, seed):
    """A smooth rank-3 field (cumulative sums of seeded normals)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for ax in range(len(shape)):
        x = np.cumsum(x, axis=ax)
    return x.astype(np.float32)


RANKS = {
    "nyx3": [_nyx_like((32, 32, 32), s) for s in range(3)],
    "ragged": [_nyx_like((32, 32, 32), s) for s in range(2)]
    + [_nyx_like((32, 32, 20), 2)],
    "float64": [_nyx_like((32, 32, 32), s).astype(np.float64) * 1.0001
                for s in range(2)],
}


def _batched_passes(fn):
    """fn() under the tracer -> (result, n of every ceaz.batch_fused_pass)."""
    tr = ot.enable(save_at_exit=False)
    tr.clear()
    try:
        out = fn()
        ns = [e["args"]["n"] for e in tr.events()
              if e["name"] == "ceaz.batch_fused_pass"]
    finally:
        ot.disable()
    return out, ns


@pytest.mark.parametrize("case", sorted(RANKS))
def test_ceaz_gather_matches_reference(case):
    ranks = RANKS[case]
    (comps, stats), passes = _batched_passes(
        lambda: COL.ceaz_gather(ranks, device="cpu", **KW))
    ref, ref_stats = RCOL.ceaz_gather(ranks, **KW)
    assert stats == ref_stats
    assert stats["n_ranks"] == len(ranks)
    for c, r in zip(comps, ref):
        assert_streams_bit_identical(c, CV.from_reference(r))
    # one pass pair for the same-shape ranks; a ragged rank its own pass
    same = sum(r.shape == ranks[0].shape for r in ranks)
    assert passes == [same]
    back = COL.ceaz_gather_decode(comps, block_size=KW["block_size"],
                                  device="cpu")
    ref_back = RCOL.ceaz_gather_decode(ref, block_size=KW["block_size"])
    for x, a, b in zip(ranks, back, ref_back):
        assert a.dtype == x.dtype and a.shape == x.shape
        assert a.tobytes() == np.asarray(b).tobytes()


def test_gather_payloads_equal_single_compress():
    ranks = RANKS["ragged"]
    comps, _ = COL.ceaz_gather(ranks, device="cpu", **KW)
    one = CEAZ(CEAZConfig(mode="rel", eb=1e-4, use_fused=True,
                          chunk_bytes=4 * KW["chunk_values"],
                          block_size=KW["block_size"], device="cpu"))
    for x, c in zip(ranks, comps):
        assert_streams_bit_identical(c, one.compress(x))


def _records(path):
    with E.StreamReader(path) as r:
        return r.meta, r.records, [r.payload(i) for i in range(len(r))]


def _strip(meta):
    return {k: v for k, v in meta.items() if k != "telemetry"}


def test_gather_stream_cross_reads(tmp_path):
    ranks = RANKS["nyx3"]
    pp, pr, ps = (str(tmp_path / f"{n}.ceazs") for n in "prs")
    fetchers = [lambda x=x: x for x in ranks]       # ranks may arrive late
    st = COL.ceaz_gather_stream(fetchers, pp, device="cpu", **KW)
    rst = RCOL.ceaz_gather_stream(ranks, pr, **KW)
    COL.ceaz_gather_stream(ranks, ps, overlap=False, device="cpu", **KW)
    for k in ("raw_bytes", "wire_bytes", "ratio", "n_ranks"):
        assert st[k] == rst[k], k
    assert st["path"] == pp
    (m_p, rec_p, pay_p), (m_r, rec_r, pay_r) = _records(pp), _records(pr)
    assert pay_p == pay_r and rec_p == rec_r
    assert _strip(m_p) == _strip(m_r) == {"kind": "gather", "eb_rel": 1e-4,
                                          "block_size": KW["block_size"]}
    assert [r["key"] for r in rec_p] == ["rank_0000", "rank_0001",
                                         "rank_0002"]
    assert _records(ps)[1:] == (rec_p, pay_p)
    # each package reads the other's stream to the same bytes
    mine, stats = COL.read_gather_stream(pr, device="cpu")
    theirs, _ = RCOL.read_gather_stream(pp)
    own, _ = COL.read_gather_stream(pp, group=1, device="cpu")
    assert stats["n_records"] == len(ranks)
    for a, b, c in zip(mine, theirs, own):
        assert a.tobytes() == np.asarray(b).tobytes() == c.tobytes()


def test_read_gather_stream_block_size_precedence(tmp_path):
    path = str(tmp_path / "g.ceazs")
    COL.ceaz_gather_stream(RANKS["nyx3"][:2], path, device="cpu", **KW)
    footer, _ = COL.read_gather_stream(path, device="cpu")
    given, _ = COL.read_gather_stream(path, block_size=KW["block_size"],
                                      device="cpu")
    ref, _ = RCOL.read_gather_stream(path, block_size=KW["block_size"])
    for a, b, c in zip(footer, given, ref):
        assert a.tobytes() == b.tobytes() == np.asarray(c).tobytes()
    # an explicit grain that does not match the stream raises, as in
    # the reference, rather than decoding garbage
    with pytest.raises(ValueError):
        COL.read_gather_stream(path, block_size=4096, device="cpu")
    with pytest.raises(ValueError):
        RCOL.read_gather_stream(path, block_size=4096)
    assert os.path.exists(path)
