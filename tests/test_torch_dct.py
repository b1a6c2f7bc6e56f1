"""The port's 2-D DCT on the CPU: the torch.matmul path bit for bit, the
plan of the CUDA kernel D1 (`csrc/dct.cu`) for every view the codec passes,
replayed here launch by launch in float64, and the device basis cache."""

import numpy as np
import pytest
import torch

from jxl_tpu_torch.transforms import dct as td
from tests.test_torch_cuda import DCT_SHAPES, _dct_view_names, _dct_views

CPU = torch.device("cpu")


def _d64(n: int) -> torch.Tensor:
    return torch.from_numpy(td._dct_matrix_np(n)).double()


@pytest.mark.parametrize("n,m", DCT_SHAPES, ids=str)
def test_cpu_dct_is_the_matmul(n, m):
    """On a CPU tensor dct2d / idct2d are torch.matmul(torch.matmul(Dn, x),
    Dm.T) and its inverse, bit for bit, on every view the codec passes."""
    dn = torch.from_numpy(td._dct_matrix_np(n))
    dm = torch.from_numpy(td._dct_matrix_np(m))
    for name, x in _dct_views(n, m, CPU).items():
        assert torch.equal(td.dct2d(x), torch.matmul(torch.matmul(dn, x), dm.T)), name
        assert torch.equal(td.idct2d(x), torch.matmul(torch.matmul(dn.T, x), dm)), name


def _replay(x: torch.Tensor, launches: list, inverse: bool) -> torch.Tensor:
    """What the launches compute, read through their sizes and strides alone,
    in float64: each contracts its blocks' rows with M (D forward, D^T
    inverse), then with `two` their columns, else writes them transposed."""

    def mat(n):
        return _d64(n).T if inverse else _d64(n)

    src, offset = x, x.storage_offset()  # the view's own storage
    for lau in launches:
        sizes = [s for s, _ in lau.batch] + [lau.rows, lau.cols]
        strides = [st for _, st in lau.batch] + [lau.row_stride, lau.col_stride]
        blocks = torch.as_strided(src, sizes, strides, offset).double()
        t = mat(lau.rows) @ blocks
        y = t @ mat(lau.cols).T if lau.two else t.transpose(-1, -2)
        src, offset = y.contiguous().reshape(-1), 0
    return src.reshape(x.shape)


@pytest.mark.parametrize("inverse", [False, True], ids=["dct", "idct"])
@pytest.mark.parametrize("n,m", DCT_SHAPES, ids=str)
def test_plan_covers_each_call_site_view(n, m, inverse):
    """For every call site's view: one launch doing both passes up to 64,
    two above (rows, then columns over strips of the intermediate); batch
    dims merged where they step over each other; at most 256 blocks a CTA
    and 48 KB of shared memory; and the launches, replayed through their
    strides, give D X D^T (or its inverse)."""
    for name, x in _dct_views(n, m, CPU).items():
        launches = td.plan(x.shape, x.stride(), x.dtype)
        assert len(launches) == (1 if max(n, m) <= 64 else 2), name
        assert [lau.two for lau in launches] == ([True] if max(n, m) <= 64 else [False, False])
        for lau in launches:
            assert 1 <= lau.nb <= td.MAX_NB and len(lau.batch) <= 8
            assert lau.nb * lau.rows * lau.cols <= max(td.CTA_SAMPLES, lau.rows * lau.cols)
            assert td.smem_bytes(lau.nb, lau.rows, lau.cols) <= td.SMEM_LIMIT, (name, lau)
        want = (_d64(n).T @ x.double() @ _d64(m)) if inverse else (_d64(n) @ x.double() @ _d64(m).T)
        got = _replay(x, launches, inverse)
        assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max()), name


def test_plan_merges_the_sub8_views():
    """The 4x4 quadrants of 8x8 blocks of a contiguous [3, 7, 9, 8, 8] and
    the candidates_merged tiles of wider planes, as the kernel reads them."""
    blocks = torch.zeros(3, 7, 9, 8, 8)
    q = blocks.reshape(3, 7, 9, 2, 4, 2, 4).permute(0, 1, 2, 3, 5, 4, 6)
    (lau,) = td.plan(q.shape, q.stride(), q.dtype)
    assert lau == td.Launch(((3 * 7 * 9 * 2, 32), (2, 4)), 4, 4, 8, 1, True, 256)
    planes = torch.zeros(3, 520, 770)
    tiles = planes[:, :512, :768].reshape(3, 2, 256, 3, 256).permute(0, 1, 3, 2, 4)
    first, second = td.plan(tiles.shape, tiles.stride(), tiles.dtype)
    assert first == td.Launch(((3, 520 * 770), (2, 256 * 770), (3 * 16, 16)), 256, 16, 770, 1, False, 1)
    assert second == td.Launch(((3 * 2 * 3, 256 * 256), (16, 16)), 256, 16, 256, 1, False, 1)


@pytest.mark.parametrize(
    "shape,dtype,match",
    [
        ((4, 8, 8), torch.float64, "float32"),
        ((4, 8, 8), torch.float16, "float32"),
        ((8,), torch.float32, "dims"),
        ((1,) * 7 + (8, 8), torch.float32, "dims"),
        ((2, 2049, 8), torch.float32, "sides"),
    ],
)
def test_plan_refuses_what_the_kernel_does_not_take(shape, dtype, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        td.plan(x.shape, x.stride(), x.dtype)


@pytest.mark.parametrize("n,m", [(1, 64), (64, 1), (1, 1), (3, 5), (2048, 3), (7, 2048), (64, 63), (2048, 2048)])
def test_plan_fits_any_side_in_a_cta(n, m):
    """Odd sides, sides of 1 and the largest take a plan whose CTAs fit
    their shared memory, and replay to D X D^T."""
    x = torch.randn(2, n, m, dtype=torch.float32) if n * m <= 1 << 16 else torch.randn(1, n, m)
    launches = td.plan(x.shape, x.stride(), x.dtype)
    assert all(td.smem_bytes(lau.nb, lau.rows, lau.cols) <= td.SMEM_LIMIT for lau in launches)
    want = _d64(n) @ x.double() @ _d64(m).T
    assert float((_replay(x, launches, False) - want).abs().max()) <= 1e-9 * float(want.abs().max())


def test_plan_of_an_empty_view_launches_nothing():
    for shape in [(0, 8, 8), (3, 0, 5, 8, 8), (4, 0, 8), (4, 8, 0)]:
        x = torch.zeros(shape)
        assert td.plan(x.shape, x.stride(), x.dtype) == ()


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 256])
def test_device_basis_is_cached_per_size_and_device(n):
    """One [2, n, n] tensor per (n, device), made once: D_n and its
    transpose, equal to `_dct_matrix_np(n)`; `dct_matrix` hands out its
    first half. (The meta device stands in for a second device.)"""
    meta = torch.device("meta")
    a, b = td.device_basis(n, CPU), td.device_basis(n, meta)
    assert td.device_basis(n, CPU) is a and td.device_basis(n, meta) is b and a is not b
    assert a.shape == b.shape == (2, n, n) and a.dtype == b.dtype == torch.float32 and b.device == meta
    np.testing.assert_array_equal(a[0].numpy(), td._dct_matrix_np(n))
    np.testing.assert_array_equal(a[1].numpy(), td._dct_matrix_np(n).T)
    assert td.dct_matrix(n, "cpu").data_ptr() == a[0].data_ptr()


def test_dct_view_names_cover_the_call_sites():
    assert _dct_view_names(4, 4) == ["contiguous", "transposed", "sub8_quadrants", "overlay_dc"]
    assert _dct_view_names(64, 64) == ["contiguous", "transposed", "merged_tiles"]
