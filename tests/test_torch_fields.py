"""The port's token fields and bit packer against the JAX package."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from deflate_rs_tpu.ops.bitpack import pack_fields as j_pack  # noqa: E402
from deflate_rs_tpu.ops.symbolmap import dist_code as j_dist_code  # noqa: E402
from deflate_rs_tpu.ops.symbolmap import length_code as j_length_code  # noqa: E402
from deflate_rs_tpu.ops.symbolmap import table_lookup  # noqa: E402
from deflate_rs_tpu_torch.ops.bitpack import pack_fields  # noqa: E402
from deflate_rs_tpu_torch.ops.field_kernel import token_fields  # noqa: E402
from deflate_rs_tpu_torch.ops.symbolmap import dist_code, length_code  # noqa: E402


def jax_fields(huff, lsym, len_en, len_ev, dcode, dist_en, dist_ev, l_pack_q, d_pack_q):
    """The JAX package's table_lookup path (chunk_encode.py:717-729)."""
    B, E = lsym.shape
    nq = l_pack_q.shape[1]
    QL = E // nq
    outs = [np.zeros((B, E), np.int64) for _ in range(4)]
    for b in range(B):
        for q in range(nq):
            sl = slice(q * QL, (q + 1) * QL)
            tok = (lsym[b, sl] < 288) & bool(huff[b])
            lp = np.asarray(table_lookup(jnp.asarray(l_pack_q[b, q]),
                                         jnp.asarray(np.clip(lsym[b, sl], 0, 287)), 288))
            ln = (lp >> 16).astype(np.uint32)
            outs[0][b, sl] = (lp & 0xFFFF).astype(np.uint32) | (len_ev[b, sl].astype(np.uint32) << ln)
            outs[1][b, sl] = np.where(tok, ln + len_en[b, sl], 0)
            mt = (dcode[b, sl] < 30) & bool(huff[b])
            dp = np.asarray(table_lookup(jnp.asarray(d_pack_q[b, q]),
                                         jnp.asarray(np.clip(dcode[b, sl], 0, 29)), 30))
            dl = (dp >> 16).astype(np.uint32)
            outs[2][b, sl] = (dp & 0xFFFF).astype(np.uint32) | (dist_ev[b, sl].astype(np.uint32) << dl)
            outs[3][b, sl] = np.where(mt, dl + dist_en[b, sl], 0)
    return outs


@pytest.mark.parametrize("nq", [1, 8])
def test_token_fields_equal_where_width_nonzero(nq):
    rng = np.random.default_rng(nq + 10)
    B, E = 2, 2048
    lsym = rng.integers(0, 288, (B, E)).astype(np.int32)
    lsym[rng.random((B, E)) < 0.3] = 999
    len_en = rng.integers(0, 6, (B, E)).astype(np.int32)
    len_ev = rng.integers(0, 32, (B, E)).astype(np.int32)
    dcode = rng.integers(0, 30, (B, E)).astype(np.int32)
    dcode[rng.random((B, E)) < 0.6] = 99
    dist_en = rng.integers(0, 14, (B, E)).astype(np.int32)
    dist_ev = rng.integers(0, 1 << 13, (B, E)).astype(np.int32)
    l_pack_q = (rng.integers(0, 1 << 15, (B, nq, 288))
                | (rng.integers(1, 16, (B, nq, 288)) << 16)).astype(np.int32)
    d_pack_q = (rng.integers(0, 1 << 15, (B, nq, 30))
                | (rng.integers(1, 16, (B, nq, 30)) << 16)).astype(np.int32)
    huff = np.array([1, 0], np.int32)
    args = (huff, lsym, len_en, len_ev, dcode, dist_en, dist_ev, l_pack_q, d_pack_q)
    got = [o.numpy().astype(np.int64) & 0xFFFFFFFF for o in
           token_fields(*(torch.from_numpy(a) for a in args))]
    want = jax_fields(*args)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(np.where(got[1] > 0, got[0], 0), np.where(want[1] > 0, want[0], 0))
    np.testing.assert_array_equal(np.where(got[3] > 0, got[2], 0), np.where(want[3] > 0, want[2], 0))


def test_length_and_dist_codes_equal():
    ln = np.arange(3, 259, dtype=np.int32)
    d = np.arange(1, 32769, dtype=np.int32)
    for got, want in zip(length_code(torch.from_numpy(ln).long()), j_length_code(jnp.asarray(ln))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(dist_code(torch.from_numpy(d).long()), j_dist_code(jnp.asarray(d))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["random", "wide", "wraparound", "zero_tail"])
def test_pack_fields_equal(case):
    rng = np.random.default_rng(len(case))
    F = 5000
    nbits = rng.integers(0, 33, F).astype(np.int32)
    values = rng.integers(0, 1 << 32, F, dtype=np.uint64).astype(np.uint32)
    if case == "wide":
        nbits[:] = 32
    elif case == "wraparound":  # running sums wrap mod 2^32 many times
        nbits = rng.choice(np.array([31, 32], np.int32), F)
        values[:] = 0xFFFFFFFF
    elif case == "zero_tail":
        nbits[-100:] = 0
        nbits[:50] = 16
    total = int(nbits.sum())
    num_words = min(F, (total + 31) // 32 + 3)
    jw, jt = j_pack(jnp.asarray(values), jnp.asarray(nbits), num_words)
    tw, tt = pack_fields(torch.from_numpy(values.astype(np.int64))[None],
                         torch.from_numpy(nbits)[None], num_words)
    assert int(tt[0]) == int(jt) == total
    np.testing.assert_array_equal(tw[0].numpy(), np.asarray(jw).astype(np.int64))
