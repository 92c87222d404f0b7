"""The split decode route: the `hufdec` walk, then the outlier scatter and
the inverse dual-quant as plain torch ops.

Op level: the port's `hufdec` plain version against the reference's
``hufdec/ref.py::decode_blocks`` and the Pallas ``hufdec`` kernel
(interpret mode) on valid streams, and against the Pallas decode
megakernel's walk on the decode fuzz corpus's garbage. Route level:
``decompress_batch(megakernel=False)`` and the facade's
``decode_megakernel='split'`` decode every cell of the reference's
decode grid to the reference's bytes. All outputs are integers or
floats rebuilt from integers: tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decode import _garbage_cases, _pallas_fused, _stage, _torch
from repro.core import ceaz as RC
from repro.core import codebook as RCB
from repro.kernels.hufdec import kernel as HDK
from repro.kernels.hufdec import ref as HDR
from repro_torch import convert
from repro_torch.core import ceaz as TC
from repro_torch.core import codebook as TCB
from repro_torch.kernels import dispatch
from repro_torch.kernels.hufdec import ops as TH
from repro_torch.kernels.megakernel import ops as TM
from repro_torch.runtime import fused_decode as TFD

REF_OFF = RCB.default_offline_codebook()
PORT_OFF = TCB.default_offline_codebook()
WALK_KEYS = ("words2", "nbits2", "counts", "sym_flat", "len_flat", "cb_idx")


def _pallas_hufdec(arrays, bs):
    sym2 = jnp.asarray(arrays["sym_flat"]).reshape(-1, HDK.TBL) \
        .astype(jnp.int32)
    len2 = jnp.asarray(arrays["len_flat"]).reshape(-1, HDK.TBL) \
        .astype(jnp.int32)
    out = HDK.hufdec(jnp.asarray(arrays["words2"]),
                     jnp.asarray(arrays["nbits2"]),
                     jnp.asarray(arrays["counts"]), sym2, len2,
                     jnp.asarray(arrays["cb_idx"]), block_size=bs,
                     interpret=True)
    return np.asarray(out).reshape(out.shape[0], -1)


@pytest.mark.parametrize("counts,bs", [
    ([3], 512),                          # one short chunk
    ([511, 1], 512),                     # tail counts below a block
    ([4096, 700, 37], 512),              # full, partial, tiny tail
    ([5000, 4096, 2500, 9000], 1024),    # four books, ragged blocks
])
def test_hufdec_op_matches_reference_walks(counts, bs):
    """Valid streams, K = C >= 1 decode tables selected per row: the
    port's walk, the reference's jnp walk and the Pallas kernel agree
    on every position, zero padding past each count included."""
    rng = np.random.default_rng(sum(counts) + bs)
    arrays, syms = _stage(rng, counts, bs)
    walk = [arrays[k] for k in WALK_KEYS]
    ref = np.asarray(HDR.decode_blocks(*(jnp.asarray(a) for a in walk),
                                       bs)).astype(np.int32)
    op = dispatch.resolve("hufdec", "auto", "cpu")
    port = op(*(_torch(a) for a in walk), bs).numpy()
    assert port.dtype == np.int32
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, _pallas_hufdec(arrays, bs))
    for i, s in enumerate(syms):
        np.testing.assert_array_equal(port[i, :len(s)], s)
        assert not port[i, len(s):].any()


def test_hufdec_op_on_garbage_walks_like_the_decode_megakernel():
    """The corpus's garbage-bit cases: the port's walk terminates, stays
    in its row and decodes exactly what the Pallas decode megakernel's
    walk decodes (read back through an identity patch: value rows with
    base 512 and every escape patched to -512, so q equals the codes)."""
    n = 0
    for bs, args in _garbage_cases():
        C, NB = args[1].shape
        codes = TH.hufdec_plain(*(_torch(a) for a in args[:6]), bs).numpy()
        assert codes.shape == (C, NB * bs) and codes.dtype == np.int32
        lanes = np.clip(args[2][:, None] - np.arange(NB) * bs, 0, bs)
        past = np.arange(bs)[None, None, :] >= lanes[:, :, None]
        assert not codes.reshape(C, NB, bs)[past].any()
        if NB * bs > TM.DEC_FUSE_LIMIT:       # the tiled-regime case
            continue
        ident = [np.full((C, 1), -512, np.int32), np.full(C, 512, np.int32),
                 np.arange(C, dtype=np.int32), np.zeros(C, np.int32)]
        np.testing.assert_array_equal(
            codes, _pallas_fused(list(args[:6]) + ident, bs))
        n += 1
    assert n == 5


def test_hufdec_op_refuses_a_one_word_row():
    args = [torch.zeros((2, 1), dtype=torch.int32),
            torch.zeros((2, 1), dtype=torch.int32),
            torch.ones(2, dtype=torch.int32),
            torch.zeros(TH.TBL, dtype=torch.int32),
            torch.ones(TH.TBL, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32)]
    with pytest.raises(ValueError, match="W >= 2"):
        TH.hufdec_plain(*args, 32)
    with pytest.raises(ValueError, match="CUDA"):
        TH.hufdec_cuda(*args, 32)


# -- the route: the reference's decode grid ------------------------------

MODES = [("abs", dict(eb=1e-3)), ("rel", dict(eb=1e-4)),
         ("fixed_ratio", dict(target_ratio=10.0))]


def _data(kind: str, n: int = 6000) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "smooth":
        return np.cumsum(rng.standard_normal(n)) / 10
    return rng.standard_normal(n)


def _cfg(mode, predictor, **kw):
    return dict(mode=mode, predictor=predictor, chunk_bytes=1 << 14,
                block_size=1024, **kw)


def _ref(**kw):
    return RC.CEAZ(RC.CEAZConfig(use_fused=True, backend="jax", **kw),
                   offline_codebook=REF_OFF)


def _port(**kw):
    return TC.CEAZ(TC.CEAZConfig(device="cpu", **kw),
                   offline_codebook=PORT_OFF)


def _check_split(x, cfg):
    """The reference's stream (converted) and the port's own stream both
    decode through the split route to the reference's bytes, and to the
    port's megakernel route's."""
    ref = _ref(**cfg, decode_megakernel="split")
    cr = ref.compress(x)
    want = ref.decompress(cr)
    split, mega = _port(**cfg, decode_megakernel="split"), _port(**cfg)
    for c in (convert.from_reference(cr), mega.compress(x)):
        got = split.decompress(c)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        assert mega.decompress(c).tobytes() == want.tobytes()
    return cr


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("predictor", ["lorenzo", "none"])
@pytest.mark.parametrize("mode,kw", MODES, ids=[m for m, _ in MODES])
def test_split_route_decode_grid(mode, kw, predictor, dtype):
    kind = "noise" if predictor == "none" else "smooth"
    cr = _check_split(_data(kind).astype(dtype), _cfg(mode, predictor, **kw))
    assert len(cr.chunks) > 1


@pytest.mark.parametrize("mode,kw", MODES, ids=[m for m, _ in MODES])
def test_split_route_decode_grid_2d_lorenzo(mode, kw):
    x = _data("smooth", n=96 * 64).astype(np.float32).reshape(96, 64)
    _check_split(x, _cfg(mode, "lorenzo", **kw))


@pytest.mark.parametrize("predictor", ["lorenzo", "none"])
@pytest.mark.parametrize("mode,kw", MODES, ids=[m for m, _ in MODES])
def test_split_route_decodes_bank_chunks(mode, kw, predictor):
    kind = "noise" if predictor == "none" else "smooth"
    cfg = _cfg(mode, predictor, codebook="bank",
               bank_drift_tol=float("inf"), **kw)
    cr = _check_split(_data(kind, n=30000).astype(np.float32), cfg)
    assert all(ch.action == "bank" for ch in cr.chunks)


def test_split_route_mixed_group_is_one_walk(monkeypatch):
    """Streams of every kind in one batch: one `hufdec` pass over all
    their chunks, each stream decoded to the reference's bytes."""
    items = [
        (_data("smooth").astype(np.float32), _cfg("abs", "lorenzo",
                                                  eb=1e-3)),
        (_data("noise").astype(np.float64), _cfg("rel", "none", eb=1e-4)),
        (_data("smooth").astype(np.float32), _cfg("fixed_ratio",
                                                  "lorenzo")),
        (_data("smooth", 96 * 64).reshape(96, 64), _cfg("rel", "lorenzo",
                                                        eb=1e-4)),
    ]
    comps, want = [], []
    for x, cfg in items:
        ref = _ref(**cfg)
        c = ref.compress(x)
        comps.append(convert.from_reference(c))
        want.append(ref.decompress(c).tobytes())
    calls = []
    orig = TFD._ChunkBatch.run
    monkeypatch.setattr(TFD._ChunkBatch, "run", lambda self: calls.append(
        len(self.counts)) or orig(self))
    got = TFD.decompress_batch(comps, 1024, PORT_OFF, device="cpu",
                               megakernel=False)
    assert calls == [sum(len(c.chunks) for c in comps)]
    assert [g.tobytes() for g in got] == want


@pytest.mark.parametrize("fault", ["none", "symbol_1024"])
def test_split_route_checks_and_marks_its_tables(fault, monkeypatch):
    """The split route checks each book's table ranges on the host and
    hands the `hufdec` op tables marked as checked, so the warp walk's
    wrapper need not wait on the card for its own check; a book with a
    symbol >= 1024 (outside the 16-bit table entry) raises before the
    op."""
    from repro_torch.core.huffman import Codebook, encode
    book = Codebook.from_freqs(np.ones(1025 if fault == "symbol_1024"
                                       else 1024, np.int64))
    rng = np.random.default_rng(5)
    batch = TFD._ChunkBatch(256, "cpu")
    rows = [rng.integers(0, 1024, n) for n in (700, 300)]
    for codes in rows:
        w64, bnb, _ = encode(codes, book, 256)
        batch.words.append(TFD._u64_to_u32(w64))
        batch.nbits.append(np.asarray(bnb, np.int64))
        batch.counts.append(len(codes))
        batch.books.append(book)
    seen = []

    def op(*args):
        seen.append(TH.ranges_checked(args[3]) and TH.ranges_checked(args[4]))
        return TH.hufdec_plain(*args)
    monkeypatch.setattr(TFD.dispatch, "resolve", lambda *a: op)
    if fault != "none":
        with pytest.raises(ValueError):
            batch.run()
        assert not seen
        return
    codes = batch.run().numpy()
    assert seen == [True]
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(codes[i, :len(r)], r)


def test_scatter_drops_padding_and_wraps_negative_indices_once():
    """As the reference's mode='drop' scatter: an index in [-cv, 0)
    counts from the row's end, anything else outside the row is
    dropped."""
    codes = torch.full((2, 5), 512, dtype=torch.int32)
    oidx = torch.tensor([[-1, 7, 1 << 30], [-5, -6, 2]], dtype=torch.int32)
    odelta = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    got = TFD._scatter_outliers(codes, oidx, odelta)
    assert got.tolist() == [[0, 0, 0, 0, 1], [4, 0, 6, 0, 0]]


def test_unknown_decode_megakernel_raises():
    c = _port(mode="abs", eb=1e-3).compress(np.ones(4096, np.float32))
    with pytest.raises(ValueError, match="decode_megakernel"):
        _port(mode="abs", eb=1e-3, decode_megakernel="warp").decompress(c)
