"""The port's structure-guided fuzzer (``deflate_rs_tpu_torch/tools/fuzz.py``)
against the JAX package's (``scripts/fuzz.py``, loaded by path, unedited).

The seed inputs, the mutants and the structure keys are the same for three
rng seeds; ``encode_with_structure`` on the CPU gives the JAX script's stream
and (btypes, ntokens, data_bits) on inputs that cross a chunk boundary, at
Default and fast; a 20-iteration CPU run finds no failure; a failing input is
saved to the output directory and replays.  Tolerance: exact equality.
"""

import functools
import importlib.util
import os
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deflate_rs_tpu import CompressionOptions as JOpts  # noqa: E402
from deflate_rs_tpu_torch import CompressionOptions as TOpts  # noqa: E402
from deflate_rs_tpu_torch.tools import fuzz  # noqa: E402

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "fuzz.py")


@functools.lru_cache(maxsize=None)
def _jax_fuzz():
    spec = importlib.util.spec_from_file_location("jax_fuzz_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_seeds_and_mutants_equal_the_jax_script(seed):
    j = _jax_fuzz()
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    cj, ct = j.seeds(rj), fuzz.seeds(rt)
    assert cj == ct and len(ct) > 7
    for i in range(40):
        mj, mt = j.mutate(rj, cj, 300_000), fuzz.mutate(rt, ct, 300_000)
        assert mj == mt, i
        if i % 3 == 0:  # the corpus grows as it does on a new structure
            cj.append(mj)
            ct.append(mt)
    assert rj.integers(0, 1 << 30) == rt.integers(0, 1 << 30)


def test_structure_keys_equal_the_jax_script():
    j = _jax_fuzz()
    metas = [([], [], []), ([1], [0], [3]), ([2, 3, 0], [5000, 17, 0], [70000, 123, 524312]),
             (list(range(10)), list(range(0, 100_000, 10_000)), [1 << 20] * 10)]
    for meta in metas:
        for preset in ("default", "fast"):
            assert fuzz.structure_key(meta, preset) == j.structure_key(meta, preset)


def _inputs():
    afl = os.path.join(os.path.dirname(SCRIPT), "..", "tests", "data", "afl")
    names = sorted(os.listdir(afl))
    text = fuzz.seeds(np.random.default_rng(0))[-5]  # pg11[:70,000]
    rng = np.random.default_rng(3)
    with open(os.path.join(afl, names[0]), "rb") as f:
        first = f.read()
    with open(os.path.join(afl, names[-1]), "rb") as f:
        last = f.read()
    return {
        "afl first": first,
        "afl last": last,
        "zeros 65537": b"\x00" * 65_537,
        "tail 4097": text[:65_536] + text[:4_097],
        "text then noise": text[:40_000] + rng.integers(0, 256, 40_000, np.uint8).tobytes(),
        "small": text[:3_000],
    }


@functools.lru_cache(maxsize=None)
def _jax_streams(preset: str) -> dict:
    j = _jax_fuzz()
    opts = getattr(JOpts, preset)()
    return {name: j.encode_with_structure(data, opts) for name, data in _inputs().items()}


@pytest.mark.parametrize("preset", ["default", "fast"])
@pytest.mark.parametrize("name", sorted(_inputs()))
def test_encode_with_structure_equals_the_jax_script(preset, name):
    data = _inputs()[name]
    stream, meta = fuzz.encode_with_structure(data, getattr(TOpts, preset)(), device="cpu")
    want_stream, want_meta = _jax_streams(preset)[name]
    assert stream == want_stream
    assert tuple(meta) == tuple(want_meta)
    assert zlib.decompress(stream, -15) == data
    if len(data) > 65536:
        assert len(meta[0]) == 2  # two chunks in one batch


def test_twenty_iterations_on_the_cpu_find_no_failure(tmp_path):
    s = fuzz.fuzz(20, seed=0, presets="fast", device="cpu", out=str(tmp_path),
                  log=lambda m: None)
    assert s["failures"] == [] and not os.listdir(tmp_path)
    assert s["iters"] == 20 and s["seeds"] == len(fuzz.seeds(np.random.default_rng(0)))
    assert s["structures"] > s["structures_seeded"] > 0
    assert s["corpus_checks"] > 0  # every 8th multi-chunk input took the corpus engine
    assert s["compared_with_cpu"] == 0  # nothing to compare on the CPU


def test_a_failure_is_saved_and_replays(tmp_path):
    fz = fuzz.Fuzzer({"fast": TOpts.fast()}, device="cpu", out=str(tmp_path))
    fz._check_inflate("fast", b"abc", b"\x03\x00")  # an empty fixed block: not b"abc"
    fz.close()
    assert [f[:2] for f in fz.failures] == [("fast", 3)]
    saved = tmp_path / "fail_1_fast.bin"
    assert saved.read_bytes() == b"abc"
    # The input itself encodes and round-trips: a replay finds no failure.
    assert fuzz.replay([str(saved)], "fast", device="cpu", out=str(tmp_path / "r")) == []


def test_the_fuzzer_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert fuzz.main(["--iters", "1"]) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.fuzz(1)
