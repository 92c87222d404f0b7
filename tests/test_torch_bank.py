"""Single-pass codebook-bank encode in the port against the JAX
reference: the `ceaz_chunk` op (plain version vs ``megakernel/ref.py::
ceaz_chunk`` in both row regimes and vs the fused Pallas kernel in
interpret mode), the bank select and its tie rule, and the facade
``CEAZ(codebook='bank')`` vs the reference's ``CEAZ(use_fused=True,
codebook='bank')`` — every CompressedChunk field (bank_ref, bank_index
and centre included) and the decoded bytes — plus the drift fallback,
the overflow repack and cross-decoding through ``convert``. Inputs are
numpy-seeded and fed to both packages; every compared output is an
integer or a decoded byte, so every comparison is bitwise (tolerance
0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_streams_bit_identical
from repro.core import ceaz as RC
from repro.core import codebook as RCB
from repro.kernels.megakernel import kernel as RMK
from repro.kernels.megakernel import ref as RMR
from repro_torch import convert
from repro_torch.core import ceaz as TC
from repro_torch.core import codebook as TCB
from repro_torch.kernels.megakernel import ops as TMK
from repro_torch.obs import metrics as om
from repro_torch.runtime import fused as TF

REF_OFF = RCB.default_offline_codebook()
PORT_OFF = TCB.default_offline_codebook()
REF_BANK = RCB.default_codebook_bank()
PORT_BANK = TCB.default_codebook_bank()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's small arrays: the suite runs
    its files in parallel workers, and timing tests share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_default_banks_agree():
    assert PORT_BANK.id == REF_BANK.id
    np.testing.assert_array_equal(PORT_BANK.lengths, REF_BANK.lengths)
    np.testing.assert_array_equal(PORT_BANK.code_table(),
                                  REF_BANK.code_table())
    assert convert.bank_from_reference(REF_BANK).id == REF_BANK.id


# ---------------------------------------------------------------------------
# The `ceaz_chunk` op
# ---------------------------------------------------------------------------

def _rows(seed, C, cv, n_valid, predictor):
    """Chunk rows of one stream cut at cv (the last row ragged), with
    the raw-halo contract of the op and some non-finite values."""
    rng = np.random.default_rng(seed)
    if predictor == "lorenzo":
        flat = np.cumsum(rng.standard_normal(n_valid)).astype(np.float32)
    else:
        flat = (rng.standard_normal(n_valid) * 0.05).astype(np.float32)
    flat[::977] = np.nan
    flat[3::1601] = np.inf
    work = np.zeros(C * cv, np.float32)
    work[:n_valid] = flat
    valid = np.arange(C * cv) < n_valid
    prev = np.zeros((C, 1), np.float32)
    if predictor == "lorenzo":
        prev[1:, 0] = work[np.arange(1, C) * cv - 1]
    return (work.reshape(C, cv), prev, valid.reshape(C, cv),
            np.full(C, 0.05 if predictor == "lorenzo" else 1e-3, np.float32))


def _tables(bank):
    return (bank.lengths.astype(np.int32),
            bank.code_table().astype(np.uint32))


def _assert_op_equal(ref, port):
    names = ("q2", "codes2", "outl2", "delta2", "centers", "hists", "sel",
             "totals", "words", "block_nbits")
    for name, r, p in zip(names, ref, port):
        r = np.asarray(r)
        p = p.numpy()
        if name == "words":
            p = p.view(np.uint32)
        np.testing.assert_array_equal(p, r, err_msg=name)
        assert p.shape == r.shape, name


def _port_op(work, prev, valid, ebs, bs, w32, predictor, bank=PORT_BANK):
    ln, cw = _tables(bank)
    return TMK.ceaz_chunk_plain(_t(work), _t(prev), _t(valid), _t(ebs),
                                _t(ln), _t(cw.view(np.int32)), bs, w32,
                                predictor)


@pytest.mark.parametrize("predictor", ["lorenzo", "value"])
@pytest.mark.parametrize("C,cv,n_valid,bs,provision", [
    (3, 4096, 2 * 4096 + 1500, 512, 16),        # one-program regime
    (3, 4096, 2 * 4096 + 1500, 512, 8),         # truncated provisioning
    (1, (1 << 17) + 4097, (1 << 17) + 2222, 4096, 16),   # tiled regime
])
def test_ceaz_chunk_plain_matches_jnp_reference(predictor, C, cv, n_valid,
                                                bs, provision):
    work, prev, valid, ebs = _rows(C + cv, C, cv, n_valid, predictor)
    w32 = TF._bank_w32(provision, cv)
    ln, cw = _tables(REF_BANK)
    ref = RMR.ceaz_chunk(jnp.asarray(work), jnp.asarray(prev),
                         jnp.asarray(valid), jnp.asarray(ebs),
                         jnp.asarray(ln), jnp.asarray(cw), bs, w32, 33,
                         predictor)
    _assert_op_equal(ref, _port_op(work, prev, valid, ebs, bs, w32,
                                   predictor))


@pytest.mark.parametrize("predictor", ["lorenzo", "value"])
def test_ceaz_chunk_plain_matches_fused_pallas_kernel(predictor):
    work, prev, valid, ebs = _rows(11, 2, 4096, 4096 + 3000, predictor)
    w32 = TF._bank_w32(16, 4096)
    ln, cw = _tables(REF_BANK)
    ref = RMK.ceaz_chunk_fused(
        jnp.asarray(work), jnp.asarray(prev), jnp.asarray(valid),
        jnp.asarray(ebs), jnp.asarray(ln), jnp.asarray(cw), block_size=1024,
        w32=w32, cands=33, predictor=predictor, interpret=True)
    ref = list(ref)
    ref[2] = np.asarray(ref[2]).astype(bool)          # outl2 stored as i32
    _assert_op_equal(ref, _port_op(work, prev, valid, ebs, 1024, w32,
                                   predictor))


def test_bank_select_tie_takes_the_first_book():
    """Two identical books tie on every histogram: the first wins, as in
    jnp.argmin and the host replay BankCoder.step."""
    rng = np.random.default_rng(12)
    lengths = np.stack([PORT_BANK.lengths[3], PORT_BANK.lengths[5],
                        PORT_BANK.lengths[5], PORT_BANK.lengths[3]])
    bank = TCB.CodebookBank(lengths=lengths)
    hists = rng.integers(0, 50, (6, 1024)).astype(np.int32)
    hists[0] = 0                                       # every cost 0
    ln, cw = _tables(bank)
    sel, totals, ln_sel, cw_sel = TMK.bank_select_plain(
        _t(hists), _t(ln), _t(cw.view(np.int32)))
    r_sel, r_totals = RMR.select_bank(jnp.asarray(hists), jnp.asarray(ln))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(r_sel))
    np.testing.assert_array_equal(totals.numpy(), np.asarray(r_totals))
    assert set(sel.numpy().tolist()) <= {0, 1}
    assert sel.numpy()[0] == 0
    coder = TCB.BankCoder(bank)
    assert [coder.step(h).bank_index for h in hists] == sel.numpy().tolist()
    np.testing.assert_array_equal(ln_sel.numpy(), ln[sel.numpy()])
    np.testing.assert_array_equal(cw_sel.numpy(),
                                  cw.view(np.int32)[sel.numpy()])


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

def _assert_same(cr, cp):
    assert_streams_bit_identical(cr, cp)
    for a, b in zip(cr.chunks, cp.chunks):
        assert (a.bank_ref, a.bank_index) == (b.bank_ref, b.bank_index)
        assert a.chi == b.chi


def _field(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        x = rng.standard_normal(shape)
        for ax in range(len(shape)):
            x = np.cumsum(x, axis=ax)
        return x.astype(np.float32)
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


SHAPES = {"1d": (3 * 4096 + 321,), "2d": (72, 130)}


def _facades(**kw):
    ref = RC.CEAZ(RC.CEAZConfig(use_fused=True, codebook="bank", **kw),
                  offline_codebook=REF_OFF, bank=REF_BANK)
    port = TC.CEAZ(TC.CEAZConfig(device="cpu", codebook="bank", **kw),
                   offline_codebook=PORT_OFF)
    return ref, port


def _check(x, **kw):
    ref, port = _facades(**kw)
    cr, cp = ref.compress(x), port.compress(x)
    _assert_same(cr, cp)
    yr, yp = ref.decompress(cr), port.decompress(cp)
    assert yp.dtype == x.dtype and yp.shape == x.shape
    assert yp.tobytes() == yr.tobytes()
    return cp, yp


@pytest.mark.parametrize("mode,eb", [("abs", 1e-2), ("rel", 1e-3)])
@pytest.mark.parametrize("dim", ["1d", "2d"])
@pytest.mark.parametrize("predictor", ["lorenzo", "none", "auto"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bank_facade_matches_reference(dtype, predictor, dim, mode, eb):
    kind = "smooth" if predictor == "lorenzo" else "noise"
    x = _field(kind, SHAPES[dim], 13).astype(dtype)
    cp, y = _check(x, mode=mode, eb=eb, predictor=predictor,
                   chunk_bytes=1 << 14)
    assert cp.predictor == ("lorenzo" if kind == "smooth" else "none")
    assert all(ch.action == "bank" and ch.bank_ref == PORT_BANK.id
               for ch in cp.chunks)
    if dim == "1d" and dtype == np.float32:
        assert len(cp.chunks) == 4
    bound = eb * (1.0 if mode == "abs" else TC.value_range(x))
    assert np.abs(y.astype(np.float64) - x.astype(np.float64)).max() <= bound


@pytest.mark.parametrize("stats_on_device", [False, True])
def test_bank_stats_branches_agree(stats_on_device):
    """The card always takes the device-stats branch: hold both branches
    of the bank route to the reference on the CPU."""
    x = _field("smooth", (2 * 4096 + 99,), 14)
    ref, port = _facades(mode="rel", eb=1e-3, chunk_bytes=1 << 14)
    cr = ref.compress(x)
    cp = TF.compress_error_bounded_bank(
        x, port._abs_eb(x), "rel", TCB.BankCoder(port.bank),
        port._chunk_values(32), port.cfg.block_size, device="cpu",
        stats_on_device=stats_on_device)
    _assert_same(cr, cp)


def test_drift_fallback_is_the_exact_route():
    """A random walk coded value-direct drifts far from every book: the
    facade recompresses on the exact route, byte-identical to
    codebook='exact', and counts the fallback."""
    x = _field("smooth", (3 * 4096,), 15)
    kw = dict(mode="rel", eb=1e-4, predictor="none", chunk_bytes=1 << 14)
    before = om.snapshot()
    cp, _ = _check(x, **kw)
    d = om.diff(om.snapshot(), before)
    assert d.get(om.BANK_FALLBACKS, 0) == 1
    assert all(ch.action != "bank" for ch in cp.chunks)
    exact = TC.CEAZ(TC.CEAZConfig(device="cpu", **kw),
                    offline_codebook=PORT_OFF).compress(x)
    _assert_same(exact, cp)


def test_overflow_repack_matches_reference():
    """White noise at a tight bound needs more than BANK_PROVISION_BITS
    per value: the pack re-runs at full capacity, as in the reference."""
    x = np.random.default_rng(16).uniform(-1, 1, 2 * 4096 + 5) \
        .astype(np.float32)
    before = om.snapshot()
    cp, _ = _check(x, mode="abs", eb=1.0 / 600, chunk_bytes=1 << 14,
                   bank_drift_tol=100.0)
    d = om.diff(om.snapshot(), before)
    assert d.get(om.BANK_REPACKS, 0) == 1
    assert all(ch.action == "bank" for ch in cp.chunks)
    assert max(ch.payload_bits() for ch in cp.chunks) \
        > TF.BANK_PROVISION_BITS * 4096


def test_cross_decode_bank_streams_through_convert():
    x = _field("smooth", SHAPES["1d"], 17)
    ref, port = _facades(mode="rel", eb=1e-3, chunk_bytes=1 << 14)
    cr = ref.compress(x)
    assert cr.chunks[0].bank_index >= 0
    # reference stream -> port decode, the bank resolved by its id
    conv = convert.from_reference(cr)
    plain = TC.CEAZ(TC.CEAZConfig(device="cpu"), offline_codebook=PORT_OFF,
                    bank=convert.bank_from_reference(REF_BANK))
    assert plain.decompress(conv).tobytes() == ref.decompress(cr).tobytes()
    # port stream -> reference decode
    f = convert.to_reference_fields(port.compress(x))
    f["chunks"] = [RC.CompressedChunk(**c) for c in f["chunks"]]
    back = RC.CEAZCompressed(**f)
    _assert_same(cr, back)
    assert ref.decompress(back).tobytes() == ref.decompress(cr).tobytes()


def test_codebook_auto_follows_the_bank_argument():
    x = _field("smooth", SHAPES["1d"], 18)
    exact = TC.CEAZ(TC.CEAZConfig(device="cpu", codebook="auto"),
                    offline_codebook=PORT_OFF).compress(x)
    assert all(ch.bank_index == -1 for ch in exact.chunks)
    banked = TC.CEAZ(TC.CEAZConfig(device="cpu", codebook="auto"),
                     offline_codebook=PORT_OFF, bank=PORT_BANK).compress(x)
    assert all(ch.bank_index >= 0 for ch in banked.chunks)
    with pytest.raises(ValueError, match="codebook"):
        TC.CEAZ(TC.CEAZConfig(device="cpu", codebook="nope"),
                offline_codebook=PORT_OFF).compress(x)
