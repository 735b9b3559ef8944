"""The port's matcher and long-range pass against the JAX package (CPU,
XLA forms).  Exact comparisons: every value is an integer."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deflate_rs_tpu.ops import longrange as jlr  # noqa: E402
from deflate_rs_tpu.ops import matching as jm  # noqa: E402
from deflate_rs_tpu_torch.ops import longrange as tlr  # noqa: E402
from deflate_rs_tpu_torch.ops import lr_kernel  # noqa: E402
from deflate_rs_tpu_torch.ops import matching as tm  # noqa: E402
from deflate_rs_tpu_torch.utils import kernel_cases  # noqa: E402

HALO, PAD = 32768, 72
TAIL = (4, 5, 6, 7, 8, 9, 10, 11)
DATA = os.path.join(os.path.dirname(__file__), "data")


def _pg11():
    with open(os.path.join(DATA, "pg11.txt"), "rb") as f:
        return f.read()


def _chunk(data: bytes, off: int, ln: int, emit: int):
    buf = np.zeros(HALO + emit + PAD, np.uint8)
    h = min(off, HALO)
    src = np.frombuffer(data, np.uint8)
    buf[HALO - h : HALO + ln] = src[off - h : off + ln]
    return buf, HALO + ln, HALO - h


def _cases():
    pg = _pg11()
    rng = np.random.default_rng(5)
    runs = b"".join(bytes([v]) * int(r) for v, r in
                    zip(rng.integers(0, 256, 400), rng.integers(1, 300, 400)))
    return {
        "pg11_full": (pg, 65536, 65536, 65536),
        "pg11_first": (pg, 0, 65536, 65536),
        "pg11_tail": (pg, 131072, len(pg) - 131072, 65536),
        "tier4k": (pg[:4000], 0, 4000, 4096),
        "random": (rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(), 0, 65536, 65536),
        "runs": (runs, 0, min(len(runs), 65536), 65536),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_find_matches_equal(name):
    data, off, ln, emit = CASES[name]
    buf, nt, hs = _chunk(data, off, ln, emit)
    N = HALO + emit
    jl, jd = jax.jit(lambda b, nt, hs: jm.find_matches(
        b, N, nt, hs, 64, probe_words=6, nkey=4, tail_jumps=TAIL))(
            buf, np.int32(nt), np.int32(hs))
    tl, td = tm.find_matches(torch.from_numpy(buf)[None], N, torch.tensor([nt]),
                             torch.tensor([hs]), 64, 6, 4, TAIL)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))


# The suffix-order scan on the kernel cases that mask rows' keys to all ones
# beside all-0xFF bytes, and on tie groups deeper than the tail's reach, at
# Default's two parameter sets (64 KiB chunks, and chain_scale > 1): the
# plain version against the JAX package's sa_scan_xla on the same sorted
# words.
@pytest.mark.parametrize("params", kernel_cases.SA_PARAMS[:2], ids=["k64", "k128"])
@pytest.mark.parametrize("pattern", ["ff_invalid", "period3", "ties"])
def test_sa_scan_plain_equals_sa_scan_xla(pattern, params):
    K, PW, NK, tail = params
    E = 4096
    buf, hs, nt = kernel_cases.sa_batch(E, 1, kernel_cases.SA_PATTERNS.index(pattern))
    b, h, n = torch.from_numpy(buf), torch.from_numpy(hs), torch.from_numpy(nt)
    N = HALO + E
    keys = tm.key_words(b, N, n, h, NK)
    perm = tm._stable_lex_sort(keys)
    got = tm.sa_scan_plain(b, perm, h, n, K, PW, NK, tail).gather(1, perm)
    packed = tm.pack_words(b)
    words = [k.gather(1, perm)[0].numpy().astype(np.uint32) for k in keys]
    pay = [packed[:, 4 * w : N + 4 * w].gather(1, perm)[0].numpy().astype(np.uint32)
           for w in range(NK, PW)]
    want = jax.jit(lambda sk, sp, sy, hs, nt: jm.sa_scan_xla(sk, sp, sy, hs, nt, K, PW, tail))(
        words, perm[0].numpy().astype(np.int32), pay, np.int32(hs[0]), np.int32(nt[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_pack_words_and_extensions_equal():
    rng = np.random.default_rng(1)
    buf = rng.integers(0, 4, 3000, dtype=np.uint8)
    np.testing.assert_array_equal(tm.pack_words(torch.from_numpy(buf)).numpy(),
                                  np.asarray(jm.pack_words(jnp.asarray(buf))).astype(np.int64))
    N = 2048
    bl = rng.integers(0, 30, N).astype(np.int32)
    bl[bl < 3] = 0
    bd = np.where(bl > 0, rng.integers(1, 4, N), 0).astype(np.int32)
    lim = np.clip(2000 - np.arange(N), 0, 258).astype(np.int32)
    want = jm.stride_extend(jm.chain_extend(jnp.asarray(bl), jnp.asarray(bd), jnp.asarray(lim), N),
                            jnp.asarray(bd), jnp.asarray(lim))
    t = [torch.from_numpy(a)[None] for a in (bl, bd, lim)]
    got = tm.stride_extend(tm.chain_extend(t[0], t[1], t[2], N), t[1], t[2])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def _harvest(name, noise: bool):
    data, off, ln, emit = CASES[name]
    buf, nt, hs = _chunk(data, off, ln, emit)
    N = HALO + emit
    bl, bd = tm.find_matches(torch.from_numpy(buf)[None], N, torch.tensor([nt]),
                             torch.tensor([hs]), 64, 6, 4, TAIL)
    dc = torch.where(bl >= 24, bd, 0)
    if noise:
        rng = np.random.default_rng(2)
        m = torch.from_numpy(rng.random(N) < 0.05)[None]
        dc = torch.where(m, torch.from_numpy(rng.integers(1, 32769, N).astype(np.int32))[None], dc)
    return buf, N, nt, hs, dc


@pytest.mark.parametrize("name,noise", [("pg11_full", False), ("pg11_full", True),
                                        ("tier4k", False), ("tier4k", True),
                                        ("runs", True)])
def test_dominants_and_local_lengths_equal(name, noise):
    buf, N, nt, hs, dc = _harvest(name, noise)
    jd, jf = jlr._select_dominants(jnp.asarray(dc[0].numpy()), 64, 48, 1, sel="run", pair=True)
    td, tf = tlr.select_dominants(dc, 64, 48)
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
    want = jlr.local_dominant_lengths(
        jnp.asarray(buf), N, jnp.int32(nt), jnp.int32(hs), jnp.asarray(dc[0].numpy()),
        num_dom=48, num_seg=64, harvest_stride=1, sel="run", pair=True)
    got = tlr.local_dominant_lengths(torch.from_numpy(buf)[None], N, torch.tensor([nt]),
                                     torch.tensor([hs]), dc, num_dom=48, num_seg=64)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("name", ["pg11_full", "tier4k"])
def test_freq_dominants_and_local_lengths_equal(name):
    """The high preset's long-range pass: freq selection at S = 32."""
    buf, N, nt, hs, dc = _harvest(name, True)
    jd, jf = jlr._select_dominants(jnp.asarray(dc[0].numpy()), 32, 48, 1, sel="freq", pair=True)
    td, tf = tlr.select_dominants(dc, 32, 48, "freq")
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf))
    want = jlr.local_dominant_lengths(
        jnp.asarray(buf), N, jnp.int32(nt), jnp.int32(hs), jnp.asarray(dc[0].numpy()),
        num_dom=48, num_seg=32, harvest_stride=1, sel="freq", pair=True)
    got = tlr.local_dominant_lengths(torch.from_numpy(buf)[None], N, torch.tensor([nt]),
                                     torch.tensor([hs]), dc, num_dom=48, num_seg=32, sel="freq")
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))


# 4 KiB-tier chunks for the hash and rle matchers: fresh, with history, runs.
TIER4K = {
    "fresh": (CASES["pg11_first"][0], 0, 4000),
    "history": (CASES["pg11_first"][0], 70001, 4096),
    "runs": (CASES["runs"][0], 5000, 4096),
}


def _tier4k(name):
    data, off, ln = TIER4K[name]
    buf, nt, hs = _chunk(data, off, ln, 4096)
    return buf, HALO + 4096, nt, hs


def test_probe_schedule_equal():
    for K in (1, 16, 128, 256):
        assert tm.probe_schedule(K) == jm._probe_schedule(K)


@pytest.mark.parametrize("name", ["fresh", "history"])
def test_find_matches_hash_equal(name):
    buf, N, nt, hs = _tier4k(name)
    jl, jd = jax.jit(lambda b, nt, hs: jm.find_matches_hash(b, N, nt, hs, 256, probe_words=16))(
        buf, np.int32(nt), np.int32(hs))
    tl, td = tm.find_matches_hash(torch.from_numpy(buf)[None], N, torch.tensor([nt]),
                                  torch.tensor([hs]), 256, 16)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))


@pytest.mark.parametrize("name", list(TIER4K))
def test_find_rle_matches_equal(name):
    buf, N, nt, hs = _tier4k(name)
    jl, jd = jax.jit(lambda b, nt, hs: jm.find_rle_matches(b, nt, hs, N))(
        buf, np.int32(nt), np.int32(hs))
    tl, td = tm.find_rle_matches(torch.from_numpy(buf)[None], torch.tensor([nt]),
                                 torch.tensor([hs]), N)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))


def test_lr_measure_batched_rows_independent():
    """A batch of chunks gives each row what it gives alone."""
    rows = [_harvest("pg11_full", True), _harvest("tier4k", False)]
    rows = [r for r in rows if r[1] == rows[0][1]] + [_harvest("pg11_first", True)]
    bufs = torch.stack([torch.from_numpy(r[0]) for r in rows])
    dc = torch.cat([r[4] for r in rows])
    N = rows[0][1]
    doms, _ = tlr.select_dominants(dc, 64, 48)
    together = lr_kernel.lr_measure(bufs, doms, N)
    for i in range(len(rows)):
        alone = lr_kernel.lr_measure(bufs[i : i + 1], doms[i : i + 1], N)
        for a, b in zip(together, alone):
            np.testing.assert_array_equal(a[i].numpy(), b[0].numpy())
