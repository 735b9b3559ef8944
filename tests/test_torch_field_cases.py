"""``token_fields_plain`` against the JAX package's Pallas kernel, in
interpret mode, on the adversarial operands of
``deflate_rs_tpu_torch/utils/kernel_cases.py`` (``FIELD_CASES``): negative
and boundary symbols, table widths of 0, 15, 32 and more and below 0, extra
values with bits above their width, stored rows, both tiers at every number
of quarters, and one row of 262,144 positions.  All four outputs are
compared everywhere, not only where a width is non-zero; tolerance 0 (every
value is an integer).  The card-side checks (``tests/test_torch_cuda.py``,
``chip_smoke.py``) hold the CUDA kernel against the same plain version on the
same operands.

The JAX side is computed once for the module: rows of one shape are
stacked into one call (the kernel's rows are independent), and the shapes
go to spawned processes, since each costs seconds to lower.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_field_ref import pallas_fields  # noqa: E402

from deflate_rs_tpu_torch.ops import field_kernel  # noqa: E402
from deflate_rs_tpu_torch.utils import kernel_cases  # noqa: E402

OUTPUTS = ("t1v", "t1b", "t2v", "t2b")
# The symbols of the fault this file was written for, at the head of a
# chunk of the 4 KiB tier at nq = 8: the Pallas kernel counts the negative
# ones (positions 0, 1, 6) as tokens of width len_en (dist_en).
NEGATIVE_SYMBOLS = np.array([-1, -5, 0, 287, 288, 1000, -999, 5], np.int32)
NEG_E, NEG_NQ, NEG_LEN_EN, NEG_DIST_EN = 4096, 8, 3, 5


def negative_symbol_operands() -> tuple:
    rng = np.random.default_rng(3)
    lsym = np.full((1, NEG_E), 999, np.int32)
    dcode = np.full((1, NEG_E), 99, np.int32)
    lsym[0, :8] = NEGATIVE_SYMBOLS
    dcode[0, :8] = NEGATIVE_SYMBOLS
    table = lambda n: (rng.integers(0, 1 << 15, (1, NEG_NQ, n))  # noqa: E731
                       | (rng.integers(1, 16, (1, NEG_NQ, n)) << 16)).astype(np.int32)
    return (np.ones(1, np.int32), lsym, np.full((1, NEG_E), NEG_LEN_EN, np.int32),
            rng.integers(0, 32, (1, NEG_E)).astype(np.int32), dcode,
            np.full((1, NEG_E), NEG_DIST_EN, np.int32),
            rng.integers(0, 1 << 13, (1, NEG_E)).astype(np.int32), table(288), table(30))


@pytest.fixture(scope="module")
def cases():
    """case -> (operands, the Pallas kernel's four outputs)."""
    operands = {c: kernel_cases.field_batch(*c) for c in kernel_cases.FIELD_CASES}
    operands["negative_symbols"] = negative_symbol_operands()
    groups = {}  # (E, nq) -> the cases of that shape
    for c, ops in operands.items():
        groups.setdefault((ops[1].shape[1], ops[7].shape[1]), []).append(c)
    stacked = {k: tuple(np.concatenate(col) for col in zip(*(operands[c] for c in cs)))
               for k, cs in groups.items()}
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn")) as pool:
        outs = dict(zip(stacked, pool.map(pallas_fields, stacked.values())))
    got = {}
    for k, cs in groups.items():
        row = 0
        for c in cs:
            B = operands[c][1].shape[0]
            got[c] = (operands[c], tuple(o[row : row + B] for o in outs[k]))
            row += B
    return got


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("B,E,nq,seed", kernel_cases.FIELD_CASES)
def test_token_fields_plain_equals_pallas(cases, B, E, nq, seed, output):
    operands, want = cases[B, E, nq, seed]
    got = field_kernel.token_fields(*(torch.from_numpy(np.ascontiguousarray(a))
                                      for a in operands))
    i = OUTPUTS.index(output)
    assert got[i].dtype == torch.int32 and tuple(got[i].shape) == (B, E)
    np.testing.assert_array_equal(got[i].numpy(), want[i])


def test_negative_symbols_are_tokens(cases):
    """Negative symbols are tokens, as the Pallas kernel has it: their table
    value is 0 and their width the extra-bit count alone."""
    operands, want = cases["negative_symbols"]
    got = field_kernel.token_fields_plain(*(torch.from_numpy(a) for a in operands))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    neg = [0, 1, 6]
    np.testing.assert_array_equal(want[1][0, neg], NEG_LEN_EN)
    np.testing.assert_array_equal(want[3][0, neg], NEG_DIST_EN)
    np.testing.assert_array_equal(want[1][0, [4, 5]], 0)  # 288 and 1000: no token
    np.testing.assert_array_equal(want[3][0, [3, 4, 5]], 0)  # 287, 288, 1000: no match


def test_field_cases_reach_every_corner():
    """The operands hold what the file claims: every edge symbol, every odd
    width, stored rows and extra values above their width."""
    seen_l, seen_d, widths, stored, above = set(), set(), set(), 0, False
    for c in kernel_cases.FIELD_CASES:
        huff, lsym, len_en, len_ev, dcode, _, _, lq, dq = kernel_cases.field_batch(*c)
        seen_l |= set(np.unique(lsym).tolist())
        seen_d |= set(np.unique(dcode).tolist())
        widths |= set(np.unique(np.concatenate([lq.ravel(), dq.ravel()]).view(np.uint32)
                                >> 16).tolist())
        stored += int((huff == 0).sum())
        above |= bool((len_ev.astype(np.int64) >> np.clip(len_en, 0, 31) != 0).any())
    assert set(kernel_cases.FIELD_LSYM_EDGES.tolist()) <= seen_l
    assert set(kernel_cases.FIELD_DCODE_EDGES.tolist()) <= seen_d
    assert set(kernel_cases.FIELD_WIDTHS.tolist()) <= widths
    assert stored >= 2 and above
