"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip (with the reason) where no CUDA device is
present.  On a GPU machine without JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deflate_rs_tpu_torch.ops import (  # noqa: E402
    field_kernel, hist_kernel, lr_kernel, parse_scan, pm_kernel,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _same(got, want):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("N,S,M", [(98304, 64, 48), (36864, 64, 48), (4096, 8, 6),
                                   (98304, 32, 48), (36864, 32, 48),
                                   (29888, 8, 6),  # a window of 1,001 words
                                   # chunks of 128 and 256 KiB: windows of 707 to 2,371 words
                                   (163840, 64, 48), (294912, 64, 48), (163840, 32, 48),
                                   (294912, 32, 48)])
def test_lr_measure(dev, N, S, M):
    rng = np.random.default_rng(N)
    B = 3
    q = min(N // 4, 16384)  # a distance inside the 32 KiB window
    base = rng.integers(97, 101, (B, N + 72), dtype=np.uint8)
    base[:, 2 * q : 3 * q] = base[:, q : 2 * q]  # a long copy at distance q
    doms = rng.integers(0, 32769, (B, S, M)).astype(np.int32)
    doms[:, :, M // 2 :] = 0  # dead tail
    doms[0, 1, 2] = 0  # and a hole before live slots
    doms[:, :, 0] = q
    buf = torch.from_numpy(base).to(dev)
    d = torch.from_numpy(doms).to(dev)
    _same(lr_kernel.lr_measure(buf, d, N), lr_kernel.lr_measure_plain(buf, d, N))


@pytest.mark.parametrize("E", [4096, 65536, 131072, 262144, 65536 + 4096])
def test_parse_scan(dev, E):
    rng = np.random.default_rng(E)
    B = 5
    steps = np.ones((B, E), np.int32)
    m = rng.random((B, E)) < 0.3
    steps[m] = rng.integers(3, 259, m.sum())
    steps[1] = 258
    n = np.array([E, E // 2, 0, 7, E - 1], np.int32)
    s, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
    _same(parse_scan.parse_scan(s, nn), parse_scan.parse_scan_plain(s, nn))


@pytest.mark.parametrize("max_len,A", [(15, 286), (7, 19), (15, 30)])
def test_package_merge(dev, max_len, A):
    rng = np.random.default_rng(A)
    R = 64
    f = rng.integers(0, 5000, (R, A))
    f[rng.random((R, A)) < 0.5] = 0
    f[0] = 0
    f[1, 1:] = 0
    f[2, : A // 2] = 1
    leaf = np.sort(np.where(f > 0, f, pm_kernel.BIG), axis=1).astype(np.int32)
    x = torch.from_numpy(leaf).to(dev)
    _same(pm_kernel.lengths_by_rank(x, max_len), pm_kernel.lengths_by_rank_plain(x, max_len))


@pytest.mark.parametrize("E,nq", [(4096, 8), (65536, 8), (2048, 1), (65536, 1), (4096, 4),
                                  (262144, 8), (131072, 1)])
def test_token_fields(dev, E, nq):
    rng = np.random.default_rng(E + nq)
    B = 3
    lsym = rng.integers(0, 288, (B, E)).astype(np.int32)
    lsym[rng.random((B, E)) < 0.3] = 999
    dcode = rng.integers(0, 30, (B, E)).astype(np.int32)
    dcode[rng.random((B, E)) < 0.6] = 99
    args = [
        np.array([1, 0, 1], np.int32), lsym,
        rng.integers(0, 6, (B, E)).astype(np.int32), rng.integers(0, 32, (B, E)).astype(np.int32),
        dcode,
        rng.integers(0, 14, (B, E)).astype(np.int32),
        rng.integers(0, 1 << 13, (B, E)).astype(np.int32),
        (rng.integers(0, 1 << 15, (B, nq, 288)) | (rng.integers(1, 16, (B, nq, 288)) << 16)).astype(np.int32),
        (rng.integers(0, 1 << 15, (B, nq, 30)) | (rng.integers(1, 16, (B, nq, 30)) << 16)).astype(np.int32),
    ]
    t = [torch.from_numpy(a).to(dev) for a in args]
    _same(field_kernel.token_fields(*t), field_kernel.token_fields_plain(*t))


@pytest.mark.parametrize("E", [4096, 65536, 262144])
@pytest.mark.parametrize("nq", [1, 4, 8])
def test_quarter_hist(dev, E, nq):
    rng = np.random.default_rng(E + nq)
    B = 5
    lsym = rng.integers(0, 286, (B, E)).astype(np.int32)
    lsym[rng.random((B, E)) < 0.3] = 999
    lsym[rng.random((B, E)) < 0.02] = -7
    lsym[1] = 32  # one symbol everywhere: worst-case atomic contention
    dcode = rng.integers(0, 30, (B, E)).astype(np.int32)
    dcode[rng.random((B, E)) < 0.6] = 99
    dcode[rng.random((B, E)) < 0.02] = 30
    ls, dc = torch.from_numpy(lsym).to(dev), torch.from_numpy(dcode).to(dev)
    _same(hist_kernel.quarter_histograms(ls, dc, nq),
          hist_kernel.quarter_histograms_plain(ls, dc, nq))


# Adversarial operands of deflate_rs_tpu_torch/utils/kernel_cases.py, the
# same ones the CPU tests hold against the JAX package.

from deflate_rs_tpu_torch.utils import kernel_cases  # noqa: E402


@pytest.mark.parametrize("E,B,seed", kernel_cases.PARSE_CASES)
def test_parse_scan_adversarial(dev, E, B, seed):
    steps, n = kernel_cases.parse_scan_batch(E, B, seed)
    s, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
    _same(parse_scan.parse_scan(s, nn), parse_scan.parse_scan_plain(s, nn))


@pytest.mark.parametrize("E,B,seed", kernel_cases.PARSE_CASES_WIDE)
def test_parse_scan_adversarial_wide(dev, E, B, seed):
    """Chunks of several windows of the kernel: every kind of hand-over."""
    steps, n = kernel_cases.parse_scan_batch_wide(E, B, seed)
    s, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
    _same(parse_scan.parse_scan(s, nn), parse_scan.parse_scan_plain(s, nn))


_PM_CASES = kernel_cases.package_merge_cases()


@pytest.mark.parametrize("name,freqs,max_len", _PM_CASES, ids=[c[0] for c in _PM_CASES])
def test_package_merge_adversarial(dev, name, freqs, max_len):
    x = torch.from_numpy(kernel_cases.sorted_leaves(freqs)).to(dev)
    got = pm_kernel.lengths_by_rank(x, max_len)
    assert got.shape == x.shape
    if x.numel():
        _same(got, pm_kernel.lengths_by_rank_plain(x, max_len))


@pytest.mark.parametrize("B,S,N,seed", kernel_cases.LR_CASES + kernel_cases.LR_CASES_WIDE)
def test_lr_measure_adversarial(dev, B, S, N, seed):
    buf, doms = (torch.from_numpy(a).to(dev) for a in kernel_cases.lr_measure_batch(B, S, N, seed))
    _same(lr_kernel.lr_measure(buf, doms, N), lr_kernel.lr_measure_plain(buf, doms, N))


@pytest.mark.parametrize("B,N,D,seed", kernel_cases.LR_GLOBAL_CASES)
def test_lr_measure_global_adversarial(dev, B, N, D, seed):
    """The tiled path at the whole-chunk window (S = 1) of the lr_global pass."""
    buf, doms = (torch.from_numpy(a).to(dev) for a in kernel_cases.lr_global_batch(B, N, D, seed))
    _same(lr_kernel.lr_measure(buf, doms, N), lr_kernel.lr_measure_plain(buf, doms, N))


@pytest.mark.parametrize("N,S,M", kernel_cases.LR_TILED_GEOMETRIES)
def test_lr_measure_tiled_other_geometries(dev, N, S, M):
    """The tiled path where the block path's key has no room (more than 64
    slots) at windows that fit it, and the widest union of Default (64
    segments x 48 dominants), rows unaligned."""
    buf, d = (torch.from_numpy(a).to(dev) for a in kernel_cases.lr_tiled_batch(N, S, M))
    _same(lr_kernel.lr_measure(buf, d, N), lr_kernel.lr_measure_plain(buf, d, N))


def test_lr_measure_tiled_wide_keys(dev):
    """One slot more than the 32-bit key takes at the widest window: the
    64-bit keys; every slot ties over the whole window in the first row."""
    N, S, M = kernel_cases.LR_WIDE_KEY_GEOMETRY
    assert lr_kernel.tiled_key_bits(lr_kernel.window_words(N, S), M) == (32, 8)
    buf, d = (torch.from_numpy(a).to(dev)
              for a in kernel_cases.lr_tiled_batch(N, S, M, rows=2))
    _same(lr_kernel.lr_measure(buf, d, N), lr_kernel.lr_measure_plain_sliced(buf, d, N, 512))


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_lr_measure_unaligned_rows(dev, shift):
    """Rows of an odd length: each starts at another byte alignment."""
    N, S = 36864, 64
    buf, doms = kernel_cases.lr_measure_batch(4, S, N, shift)
    rng = np.random.default_rng(shift)
    buf = np.concatenate([buf, rng.integers(1, 255, (4, shift), dtype=np.uint8)], axis=1)
    b, d = torch.from_numpy(buf).to(dev), torch.from_numpy(doms).to(dev)
    _same(lr_kernel.lr_measure(b, d, N), lr_kernel.lr_measure_plain(b, d, N))


def unaligned(t):
    """``t`` one element into a larger buffer: contiguous, not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("B,E,nq,seed", kernel_cases.FIELD_CASES)
def test_token_fields_adversarial(dev, B, E, nq, seed):
    """The operands the CPU tests hold against the Pallas kernel, aligned
    (16-byte loads) and each [B, E] operand one element in (scalar loads)."""
    t = [torch.from_numpy(a).to(dev) for a in kernel_cases.field_batch(B, E, nq, seed)]
    _same(field_kernel.token_fields(*t), field_kernel.token_fields_plain(*t))
    u = [unaligned(a) if a.dim() == 2 else a for a in t]
    assert u[1].data_ptr() % 16 == 4
    _same(field_kernel.token_fields(*u), field_kernel.token_fields_plain(*u))


@pytest.mark.parametrize("B,E,nq", kernel_cases.FIELD_ODD_SHAPES)
def test_token_fields_odd_shapes(dev, B, E, nq):
    t = [torch.from_numpy(a).to(dev) for a in kernel_cases.field_batch(B, E, nq, 2)]
    _same(field_kernel.token_fields(*t), field_kernel.token_fields_plain(*t))


@pytest.mark.parametrize("B,E,nq,seed", kernel_cases.HIST_CASES + kernel_cases.HIST_CASES_WIDE)
def test_quarter_hist_adversarial(dev, B, E, nq, seed):
    ls, dc = (torch.from_numpy(a).to(dev) for a in kernel_cases.hist_batch(B, E, seed))
    _same(hist_kernel.quarter_histograms(ls, dc, nq),
          hist_kernel.quarter_histograms_plain(ls, dc, nq))


@pytest.mark.parametrize("B,E,nq", [(3, 6000, 3), (2, 4098, 2), (5, 65536, 16), (1, 12, 4)])
def test_quarter_hist_odd_shapes(dev, B, E, nq):
    """Quarters that no 16-byte load fits, and more quarters than a preset uses."""
    ls, dc = (torch.from_numpy(a).to(dev) for a in kernel_cases.hist_batch(B, E, 4))
    _same(hist_kernel.quarter_histograms(ls, dc, nq),
          hist_kernel.quarter_histograms_plain(ls, dc, nq))


@pytest.mark.parametrize("max_len,A", [(7, 286), (3, 30), (2, 19), (16, 512)])
def test_package_merge_past_the_limit(dev, max_len, A):
    """More live leaves than 2**max_len, and the widest alphabet taken."""
    rng = np.random.default_rng(A)
    f = rng.integers(1, 5000, (9, A)).astype(np.int32)
    f[1, ::2] = 0
    f[2, 5:] = 0
    # Leaves so heavy that every package is clamped at BIG and the selection
    # runs into them and the padding.
    f[3] = 0
    f[3, : 2 * A // 3] = rng.integers(1 << 28, 1 << 29, 2 * A // 3)
    x = torch.from_numpy(kernel_cases.sorted_leaves(f)).to(dev)
    _same(pm_kernel.lengths_by_rank(x, max_len), pm_kernel.lengths_by_rank_plain(x, max_len))


def test_wrappers_refuse_unsupported_shapes(dev):
    with pytest.raises(ValueError):  # a width that is no multiple of 16
        parse_scan.parse_scan(torch.ones((1, 4096 + 8), dtype=torch.int32, device=dev),
                              torch.ones(1, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):  # N not a multiple of 4 * S
        lr_kernel.lr_measure(torch.zeros((1, 32768 + 72), dtype=torch.uint8, device=dev),
                             torch.ones((1, 3, 4), dtype=torch.int32, device=dev), 32768)
    with pytest.raises(ValueError):
        pm_kernel.lengths_by_rank(torch.ones((1, 513), dtype=torch.int32, device=dev), 15)
    with pytest.raises(ValueError):  # no slot at all
        lr_kernel.lr_measure(torch.zeros((1, 4096 + 72), dtype=torch.uint8, device=dev),
                             torch.ones((1, 8, 0), dtype=torch.int32, device=dev), 4096)
    with pytest.raises(ValueError):
        pm_kernel.lengths_by_rank(torch.ones((1, 30), dtype=torch.int32, device=dev), 17)
    # token_fields: quarters of one position make a tile touch 64 quarters.
    t = [torch.from_numpy(a).to(dev) for a in kernel_cases.field_batch(1, 64, 64, 0)]
    with pytest.raises(ValueError):
        field_kernel.token_fields(*t)



# The chunk sizes of the corpus engine beyond 256 KiB (1 MiB) and the
# multiples of 16 that are no multiple of 64 (4,112 bytes and its kin).

@pytest.mark.parametrize("E,B,seed", kernel_cases.PARSE_CASES_GRANULE)
def test_parse_scan_partial_segment(dev, E, B, seed):
    """A last segment of 16, 32 or 48 positions in one window."""
    steps, n = kernel_cases.parse_scan_batch(E, B, seed, kernel_cases.parse_payloads_granule)
    s, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
    _same(parse_scan.parse_scan(s, nn), parse_scan.parse_scan_plain(s, nn))


@pytest.mark.parametrize("E,B,seed", kernel_cases.PARSE_CASES_WIDE_GRANULE
                         + kernel_cases.PARSE_CASES_MIB)
def test_parse_scan_partial_window_and_16_windows(dev, E, B, seed):
    """A last window of one 16-position segment (65,552) and 16 windows."""
    steps, n = kernel_cases.parse_scan_batch_wide(E, B, seed)
    s, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
    _same(parse_scan.parse_scan(s, nn), parse_scan.parse_scan_plain(s, nn))


@pytest.mark.parametrize("B,S,N,seed", kernel_cases.LR_CASES_MIB)
def test_lr_measure_adversarial_mib(dev, B, S, N, seed):
    """Default's block path at 512 KiB and 1 MiB chunks, high's tiled path
    at 1 MiB (the launch the counters show)."""
    buf, doms = (torch.from_numpy(a).to(dev) for a in kernel_cases.lr_measure_batch(B, S, N, seed))
    tiled = lr_kernel.window_words(N, S) > lr_kernel.MAX_WINDOW_WORDS
    assert tiled == (S == 32)
    before = lr_kernel._TILED.launches
    _same(lr_kernel.lr_measure(buf, doms, N), lr_kernel.lr_measure_plain(buf, doms, N))
    assert (lr_kernel._TILED.launches > before) == tiled


@pytest.mark.parametrize("E,B,seed", kernel_cases.PARSE_CASES_16MIB)
def test_parse_scan_128_and_256_windows(dev, E, B, seed):
    """8 and 16 MiB - 16: 128 and 256 windows a chunk, the last ending in a
    partial segment."""
    steps, n = kernel_cases.parse_scan_batch_wide(E, B, seed)
    s, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
    _same(parse_scan.parse_scan(s, nn), parse_scan.parse_scan_plain(s, nn))


@pytest.mark.parametrize("B,S,N,seed", kernel_cases.LR_CASES_16MIB)
def test_lr_measure_adversarial_16mib(dev, B, S, N, seed):
    """Default's local pass at 16 MiB chunks and a raised dom_segs: the
    block path at 1,024 segments, the tiled path at 512."""
    buf, doms = (torch.from_numpy(a).to(dev) for a in kernel_cases.lr_measure_batch(B, S, N, seed))
    tiled = lr_kernel.window_words(N, S) > lr_kernel.MAX_WINDOW_WORDS
    assert tiled == (S == 512)
    before = lr_kernel._TILED.launches
    _same(lr_kernel.lr_measure(buf, doms, N), lr_kernel.lr_measure_plain(buf, doms, N))
    assert (lr_kernel._TILED.launches > before) == tiled


@pytest.mark.parametrize("B,E,nq,seed", kernel_cases.FIELD_CASES_GRANULE)
def test_token_fields_granule(dev, B, E, nq, seed):
    """Rows of 1 MiB and of 4,112 positions, aligned and one element in."""
    t = [torch.from_numpy(a).to(dev) for a in kernel_cases.field_batch(B, E, nq, seed)]
    _same(field_kernel.token_fields(*t), field_kernel.token_fields_plain(*t))
    u = [unaligned(a) if a.dim() == 2 else a for a in t]
    _same(field_kernel.token_fields(*u), field_kernel.token_fields_plain(*u))


@pytest.mark.parametrize("B,E,nq,seed", kernel_cases.HIST_CASES_GRANULE)
def test_quarter_hist_granule(dev, B, E, nq, seed):
    """Rows of 1 MiB and of 4,112 positions (quarters of 1,028 at nq = 4),
    aligned and one element in (scalar loads)."""
    ls, dc = (torch.from_numpy(a).to(dev) for a in kernel_cases.hist_batch(B, E, seed))
    for form in (lambda x: x, unaligned):
        a, b = form(ls), form(dc)
        _same(hist_kernel.quarter_histograms(a, b, nq),
              hist_kernel.quarter_histograms_plain(a, b, nq))
