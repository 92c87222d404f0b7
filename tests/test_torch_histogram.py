"""The `histogram` op's plain version (the one the card's kernel is held
against) vs the reference's Pallas ``histogram`` kernel in interpret
mode (through ``histogram/ops.py``, which pads with a -1 sentinel) and
``np.bincount``. Bitwise: the counts are exact int32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.histogram import ops as RH
from repro_torch.kernels import dispatch
from repro_torch.kernels.histogram import ops as TH


def _rows(rng, C, n, kind):
    if kind == "smooth":
        codes = np.clip(rng.normal(512, 3, (C, n)), 0, 1023)
    elif kind == "wide":
        codes = rng.integers(0, 1024, (C, n))
    else:                                   # every code at the centre
        codes = np.full((C, n), 512)
    return codes.astype(np.int32)


def _port(codes, valid):
    fn = dispatch.resolve("histogram", "auto", "cpu")
    return fn(torch.from_numpy(codes), torch.from_numpy(valid)).numpy()


def _expect(codes, valid):
    """np.bincount of each row's valid in-range codes."""
    out = []
    for c, v in zip(codes, valid):
        c = c[v]
        out.append(np.bincount(c[(c >= 0) & (c < 1024)], minlength=1024))
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("kind", ["smooth", "wide", "centre"])
@pytest.mark.parametrize("n", [1, 1000, 65536])
def test_rows_match_pallas_and_bincount(n, kind):
    rng = np.random.default_rng(n)
    C = 3
    codes = _rows(rng, C, n, kind)
    valid = np.ones((C, n), bool)
    valid[1] = rng.random(n) < 0.7              # scattered invalid
    valid[2, n // 2:] = False                   # a padded tail
    got = _port(codes, valid)
    assert got.dtype == np.int32 and got.shape == (C, 1024)
    np.testing.assert_array_equal(got, _expect(codes, valid))
    for r in range(C):
        ref = RH.histogram(jnp.asarray(codes[r][valid[r]]), interpret=True)
        np.testing.assert_array_equal(got[r], np.asarray(ref))


def test_out_of_range_codes_count_nowhere():
    """-1 (the reference's padding sentinel), 1024 and 5000 fall in no
    bin, as the reference kernel's one-hot compare drops them."""
    codes = np.array([[-1, 0, 1023, 1024, 5000, 512, 512, -7]], np.int32)
    valid = np.ones_like(codes, bool)
    got = _port(codes, valid)
    ref = np.asarray(RH.histogram(jnp.asarray(codes[0]), interpret=True))
    np.testing.assert_array_equal(got[0], ref)
    assert got.sum() == 4 and got[0, 512] == 2
    assert _port(codes, np.zeros_like(valid)).sum() == 0


def test_cuda_impl_refuses_cpu_tensors():
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TH.histogram_cuda(z, z.bool())


@pytest.mark.parametrize("C,n,per,ctas", [
    (1, 1, 4096, 1), (1, 1 << 15, 4096, 8), (1, (1 << 15) + 1, 4096, 9),
    (1, 1 << 17, 4096, 32), (1, 1 << 23, 16384, 512),
    (64, 1 << 17, 16384, 512), (1, 6480000, 12288, 528),
    (70000, 3, 4096, 65535)])
def test_histogram_grid(C, n, per, ctas):
    """The kernel's grid on a 132-SM card: at least 4096 values a CTA, a
    multiple of 1024, about 4 CTAs an SM where the data allows; past
    65535 rows the grid's CTAs stride over the rows."""
    got_per, grid_y = TH.histogram_grid(C, n, 132)
    assert (got_per, -(-n // got_per) * grid_y) == (per, ctas)
    assert got_per % 1024 == 0 and got_per >= TH.MIN_PER_CTA
    assert grid_y == min(C, TH.MAX_GRID_Y)
    if C * n >= 4 * 132 * TH.MIN_PER_CTA:        # the card is filled
        assert -(-n // got_per) * C >= 4 * 132 * 0.9


def test_all_valid_mask_is_one_cached_mask():
    """The all-true (1, n) mask the single-row callers pass: views of one
    mask a device, grown when a longer row asks."""
    a = dispatch.all_valid(5, "cpu")
    b = dispatch.all_valid(3, "cpu")
    assert a.shape == (1, 5) and b.shape == (1, 3)
    assert a.dtype == torch.bool and bool(a.all()) and b.is_contiguous()
    assert a.data_ptr() == b.data_ptr()
    c = dispatch.all_valid(1 << 15, "cpu")
    assert c.shape == (1, 1 << 15) and bool(c.all())
    assert dispatch.all_valid(7, "cpu").data_ptr() == c.data_ptr()
    codes = torch.arange(7, dtype=torch.int32).reshape(1, 7)
    np.testing.assert_array_equal(
        _port(codes.numpy(), dispatch.all_valid(7, "cpu").numpy()),
        _expect(codes.numpy(), np.ones((1, 7), bool)))

