"""The ratio-contract tools of the port: ``tools/corpora.py``,
``tools/contract_margins.py`` and ``tools/corpora_ratio.py``.

``corpora`` gives byte for byte what ``scripts/contract_margins.py``'s
``corpora(cap)`` gives (loaded by path, unedited) at 16 KiB, a class with no
files on this machine named as skipped; the margin table's ``ours`` equals
the JAX ``deflate_bytes_conf`` size for three classes at Default and high,
and every row's ratio and margin follow from its sizes.  Tolerance: exact
equality.
"""

import functools
import importlib.util
import os
import zlib

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import deflate_rs_tpu as dj  # noqa: E402
from deflate_rs_tpu_torch.tools import contract_margins, corpora, corpora_ratio  # noqa: E402

CAP = 16 << 10
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "contract_margins.py")
CHECKED = ("bash_elf", "pg11", "py_source")


@functools.lru_cache(maxsize=None)
def _jax_corpora() -> dict:
    spec = importlib.util.spec_from_file_location("jax_contract_margins", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.corpora(CAP)


@functools.lru_cache(maxsize=None)
def _rows():
    return contract_margins.margin_rows([16], device="cpu")


def test_corpora_equal_the_jax_script():
    got, skipped = corpora.corpora(CAP)
    want = _jax_corpora()
    for name, data in want.items():
        if data:
            assert got[name] == data, name
        else:  # no files here: the JAX script keeps it empty, the port skips it
            assert name not in got and name in skipped
    assert set(got) | set(skipped) == set(corpora.CLASSES)
    assert not set(got) & set(skipped)
    assert all(len(v) <= CAP and v for v in got.values())


@pytest.mark.parametrize("preset", ["default", "high"])
@pytest.mark.parametrize("name", CHECKED)
def test_ours_equals_the_jax_size(name, preset):
    rows, _ = _rows()
    row = next(r for r in rows if (r["class"], r["preset"]) == (name, preset))
    data = corpora.corpora(CAP)[0][name]
    assert row["ours"] == len(dj.deflate_bytes_conf(data, getattr(dj.CompressionOptions,
                                                                  preset)()))


def test_rows_follow_from_their_sizes():
    rows, skipped = _rows()
    found, skip = corpora.corpora(CAP)
    assert skipped == sorted(skip)
    assert {(r["class"], r["preset"]) for r in rows} == {
        (c, p) for c in found for p in ("default", "high")}
    for r in rows:
        data = found[r["class"]]
        assert r["bytes"] == len(data) and r["round_trip"] and r["equals_cpu"] is None
        assert (r["zlib6"], r["zlib9"]) == (len(zlib.compress(data, 6)) - 6,
                                            len(zlib.compress(data, 9)) - 6)
        want = (r["ours"] / r["zlib6"] if r["preset"] == "default"
                else max(r["ours"] / r["zlib9"], r["ours"] / r["zlib6"]))
        assert r["ratio"] == want and r["margin"] == contract_margins.CEILING - want


def test_the_tools_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert contract_margins.main(["--sizes", "16"]) == 1
    assert corpora_ratio.main([]) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contract_margins.margin_rows([16])
