"""The sharded soak (``deflate_rs_tpu_torch/tools/sharded_soak.py``) on the
CPU: 2.6 MiB of its corpus in steps of 16 chunks of 64 KiB (three steps, the
last with padding rows, one rank of them all padding at world size 4) over
spawned gloo ranks, once per world size.  ``soak`` raises unless the
byte-aligned stream the ranks wrote round-trips through ``zlib``, the
combined Adler-32 and CRC-32 partials equal ``zlib``'s and the packed splice
equals the CPU one-shot ``deflate_bytes_conf``; the tests also check that
stored and Huffman chunks share the corpus.  Exact equality throughout.
"""

import functools
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deflate_rs_tpu_torch import constants as C  # noqa: E402
from deflate_rs_tpu_torch.ops.chunk_encode import HALO  # noqa: E402
from deflate_rs_tpu_torch.tools import sharded_soak  # noqa: E402

TOTAL = 2_726_297  # 41.6 chunks: the third step has 10 real rows of 16
STEP = 16


@functools.lru_cache(maxsize=None)
def _soak(world: int) -> dict:
    return sharded_soak.soak(TOTAL, world=world, device="cpu", step_chunks=STEP)


@pytest.mark.parametrize("world", [2, 4])
def test_soak_round_trips_and_equals_one_shot(world):
    s = _soak(world)
    assert s["world"] == world and s["input_bytes"] == TOTAL
    assert s["steps"] == 3 and s["chunks"] % STEP  # the last step is padded
    types = s["block_types"]
    assert types.get(C.BTYPE_STORED, 0) > 0
    assert types.get(C.BTYPE_DYNAMIC, 0) + types.get(C.BTYPE_SPLIT, 0) > 0
    assert sum(types.values()) == s["chunks"]
    # Byte-aligned: a sync marker after every chunk but the last.
    assert s["stream_bytes"] > s["packed_bytes"]
    assert s["mb_per_s"] > 0


def test_soak_bytes_do_not_depend_on_the_world_size():
    a, b = _soak(2), _soak(4)
    for key in ("stream_bytes", "packed_bytes", "block_types", "fetched_bytes"):
        assert a[key] == b[key], key


def test_corpus_recipe():
    """pg11, then 1 MiB of seeded random bytes, then the files of
    tests/data (the regression inputs and the fuzzer finds), repeated."""
    data = sharded_soak.build_corpus(TOTAL)
    assert len(data) == TOTAL and data == sharded_soak.build_corpus(TOTAL)
    with open(sharded_soak.PG11, "rb") as f:
        pg11 = f.read()
    rand = np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    assert data.startswith(pg11 + rand)
    data_dir = os.path.dirname(sharded_soak.PG11)
    files = [p for p in glob.glob(os.path.join(data_dir, "*")) + glob.glob(
        os.path.join(data_dir, "afl", "*")) if os.path.isfile(p) and not p.endswith(".md")]
    assert len(files) > 40
    unit = sum(os.path.getsize(p) for p in files) + len(rand)  # pg11 is one of them
    big = sharded_soak.build_corpus(unit + 5000)
    assert big[unit:] == big[:5000]


def test_step_batch_history_and_padding():
    data = sharded_soak.build_corpus(3 * 65536 + 100)
    bufs, hist, ns, lasts = sharded_soak.step_batch(data, 2, 4)
    assert ns.tolist() == [65536, 100, 0, 0]
    assert hist.tolist() == [HALO, HALO, 0, 0]
    assert lasts.tolist() == [False, True, True, True]
    assert bufs[0, :HALO].tobytes() == data[2 * 65536 - HALO : 2 * 65536]
    assert bufs[1, HALO : HALO + 100].tobytes() == data[3 * 65536 :]
    assert not bufs[2:].any()
