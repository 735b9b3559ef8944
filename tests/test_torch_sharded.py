"""The port's sharded encoder (``parallel/sharded.py``) over spawned gloo
ranks at world sizes 2 and 4, against the one-shot bytes and against the
JAX sharded path on its 8-device CPU mesh; and, against that mesh's arrays,
one process's mesh of 8 logical CPU devices and, in the world-size-2 spawn,
a mesh of 2 ranks x 2 logical devices.

The eight cases of ``tests/test_sharded.py``: sharded bytes equal the
one-shot bytes (byte-aligned, with the checksum partials), packed bytes equal
the one-shot packed bytes, ``assemble_local`` segments tile the stream,
stored chunks need their payloads, outputs stay per rank and offsets tile,
offsets past 2 GiB, one compaction rule, the fetch volume on mixed content;
and the uncompacted word rows.  Ranks are spawned once per world size
(``tests/torch_sharded_ranks.py`` runs every case); the JAX 8-device step
is compiled once per module and each JAX reference computed once.  A JAX
mesh's per-chunk arrays do not depend on its device count, and a device's
used words are its rows' words in row order, so the 8-device mesh's arrays
hold the 4-device mesh's too (its device k's words are the 8-device mesh's
devices 2k and 2k + 1, one after the other).  Tolerance: exact equality.
"""

import functools
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu import CompressionOptions as JOptions  # noqa: E402
from deflate_rs_tpu import constants as JC  # noqa: E402
from deflate_rs_tpu.ops import compaction as jcompaction  # noqa: E402
from deflate_rs_tpu.parallel import mesh as jmesh  # noqa: E402
from deflate_rs_tpu.parallel import sharded as jsharded  # noqa: E402
from deflate_rs_tpu_torch.models import deflate as tdeflate  # noqa: E402
from deflate_rs_tpu_torch.ops import checksum as ck  # noqa: E402
from deflate_rs_tpu_torch.ops import compaction as tcompaction  # noqa: E402
from deflate_rs_tpu_torch.ops.chunk_encode import out_words  # noqa: E402
from deflate_rs_tpu_torch.parallel.mesh import is_distributed, make_mesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import (assemble_host, global_offsets,  # noqa: E402
                                                   make_sharded_encoder)
from deflate_rs_tpu_torch.tools.dryrun_multichip import spawn_ranks  # noqa: E402
from torch_sharded_ranks import (EMIT, META, MIXED, batch, case_inputs,  # noqa: E402
                                 jax_mesh_arrays, sharded_cases)

WORLDS = [2, 4]
CPU = {"device": "cpu"}


@functools.lru_cache(maxsize=None)
def _ranks(world: int) -> list:
    """Every rank's results at ``world`` ranks, spawned once."""
    return spawn_ranks(sharded_cases, world, device="cpu")


def _case(world: int, name: str):
    """(input, shards of every rank, local results, batch arrays, B)."""
    data, _, _, pad = case_inputs()[name]
    results = _ranks(world)
    (bufs, hist, ns, lasts), B = batch(data, pad, world)
    return (data, [r[name]["shard"] for r in results], [r[name]["local"] for r in results],
            (bufs, hist, ns, lasts), B)


def _payloads(data: bytes, ns, B: int) -> list:
    return [data[i * EMIT : i * EMIT + int(ns[i])] for i in range(B)]


@functools.lru_cache(maxsize=None)
def _one_shot(name: str, packed: bool) -> bytes:
    """The port's one-shot bytes on the sharded path's chunk grid."""
    data = case_inputs()[name][0]
    full, small = tdeflate.FULL_EMIT, tdeflate.SMALL_EMIT
    try:
        tdeflate.FULL_EMIT, tdeflate.SMALL_EMIT = EMIT, 0
        if packed:
            return dt.deflate_bytes(data, **CPU)
        return tdeflate.compress_stream(data, dt.CompressionOptions.default(), packed=False,
                                        **CPU).deflate
    finally:
        tdeflate.FULL_EMIT, tdeflate.SMALL_EMIT = full, small


@functools.lru_cache(maxsize=None)
def _jax_out(name: str):
    """The JAX sharded step's output on its 8-device CPU mesh."""
    data, _, _, pad = case_inputs()[name]
    (bufs, hist, ns, lasts), _ = batch(data, pad, 8)
    return _jax_step()(bufs, hist.astype(np.int32), ns.astype(np.int32), lasts)


@functools.lru_cache(maxsize=None)
def _jax_sharded(name: str, packed: bool) -> bytes:
    """The JAX sharded path's bytes on its 8-device CPU mesh."""
    data, _, _, pad = case_inputs()[name]
    (_, _, ns, lasts), B = batch(data, pad, 8)
    return jsharded.assemble_host(_jax_out(name), B, packed=packed,
                                  payloads=_payloads(data, ns, B), is_lasts=lasts[:B])


@functools.lru_cache(maxsize=None)
def _jax_step():
    return jsharded.make_sharded_encoder(jmesh.make_mesh(8), JOptions.default(), EMIT)


def test_eight_devices_equal_the_jax_8_device_mesh():
    """One process's mesh of 8 logical CPU devices, no process group, on
    the text case (four rows a device): its shard's meta is the JAX
    8-device mesh's array for array, and its compacted words are the eight
    JAX devices' used words one after the other."""
    data, _, _, pad = case_inputs()["text"]
    (bufs, hist, ns, lasts), B = batch(data, pad, 8)
    mesh = make_mesh(8, device="cpu")
    assert (mesh.size, mesh.group) == (8, None)
    shard = make_sharded_encoder(mesh, dt.CompressionOptions.default(), EMIT)(
        bufs, hist, ns, lasts)
    arrays, words = jax_mesh_arrays(_jax_out("text"))
    assert shard["row0"] == 0 and len(words) == 8
    for key in META:
        np.testing.assert_array_equal(shard[key], arrays[key])
    np.testing.assert_array_equal(shard["cw"], np.concatenate(words))
    assert assemble_host(shard, B) == _one_shot("text", False)


def test_two_ranks_of_two_devices_equal_the_jax_4_device_mesh():
    """Array for array: the meta of the 2 x 2 mesh's two shards, in row
    order, is the JAX mesh's, and each rank's compacted words are its two
    devices' used words one after the other: the JAX 4-device mesh's
    devices 2r and 2r + 1, which are the 8-device mesh's devices 4r to
    4r + 3 (see the module docstring); the bytes are the one-shot bytes and
    the segments tile the stream."""
    data, _, _, pad = case_inputs()["text"]
    mixed = [r[MIXED] for r in _ranks(2)]
    assert [m["mesh"] for m in mixed] == [(4, 0, 2), (4, 1, 2)]
    (bufs, hist, ns, lasts), B = batch(data, pad, 4)
    assert len(ns) == len(batch(data, pad, 8)[0][2])  # the 8-device mesh's rows
    arrays, words = jax_mesh_arrays(_jax_out("text"))
    shards = [m["shard"] for m in mixed]
    assert [s["row0"] for s in shards] == [0, len(ns) // 2]
    for key in META:
        if key == "all_nbytes":
            for s in shards:
                np.testing.assert_array_equal(s[key], arrays[key])
        else:
            np.testing.assert_array_equal(np.concatenate([s[key] for s in shards]), arrays[key])
    for rank, s in enumerate(shards):
        np.testing.assert_array_equal(s["cw"], np.concatenate(words[4 * rank : 4 * rank + 4]))
    stream = assemble_host(shards, B)
    assert stream == _one_shot("text", False)
    assert b"".join(seg for seg, _ in (m["local"] for m in mixed)) == stream
    assert [off for _, off in (m["local"] for m in mixed)] == [
        0, int(global_offsets(arrays["all_nbytes"])[len(ns) // 2])]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_oneshot(world):
    data, shards, _, (_, _, ns, _), B = _case(world, "text")
    out = assemble_host(shards, B)
    assert zlib.decompress(out, wbits=-15) == data
    assert out == _one_shot("text", False)
    assert out == _jax_sharded("text", False)
    s1, s2, crc = (np.concatenate([s[k] for s in shards]) for k in ("s1", "s2", "crc_raw"))
    adler, raw = ck.ADLER_INIT, 0
    for i in range(B):
        adler = ck.adler32_combine(adler, int(s1[i]), int(s2[i]), int(ns[i]))
        raw = ck.crc32_combine_raw(raw, int(crc[i]), int(ns[i]))
    assert ck.adler32_value(adler) == zlib.adler32(data)
    assert ck.crc32_from_raw(raw, len(data)) == zlib.crc32(data)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_packed_matches_oneshot_packed(world):
    data, shards, _, (_, _, ns, lasts), B = _case(world, "text_packed")
    out = assemble_host(shards, B, packed=True, payloads=_payloads(data, ns, B),
                        is_lasts=lasts[:B])
    assert zlib.decompress(out, wbits=-15) == data
    assert out == _one_shot("text_packed", True)
    assert out == _jax_sharded("text_packed", True)


@pytest.mark.parametrize("world", WORLDS)
def test_assemble_local_segments_tile_the_stream(world):
    _, shards, local, _, B = _case(world, "text")
    offsets = global_offsets(shards[0]["all_nbytes"])
    stream = assemble_host(shards, B)
    pos = 0
    for shard, (segment, offset) in zip(shards, local):
        assert offset == pos == offsets[shard["row0"]]
        assert stream[offset : offset + len(segment)] == segment
        pos += len(segment)
    assert pos == len(stream)
    errors = [r["errors"] for r in _ranks(world)]
    assert all("not divisible" in e["indivisible"] for e in errors)
    assert all("one a device" in e["mesh_size"] for e in errors)
    assert all("not this rank's rows" in e["foreign_rows"] for e in errors)


@pytest.mark.parametrize("world", WORLDS)
def test_is_distributed_inside_the_ranks_only(world):
    assert [(r["rank"], r["size"], r["distributed"]) for r in _ranks(world)] == [
        (rank, world, True) for rank in range(world)]
    assert not is_distributed()  # this process joined no group


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_packed_requires_payloads_for_stored(world):
    data, shards, local, (_, _, ns, lasts), B = _case(world, "stored")
    with pytest.raises(ValueError, match="stored chunks"):
        assemble_host(shards, B, packed=True, is_lasts=lasts[:B])
    # A rank holding a stored chunk refuses to assemble it without payloads.
    for shard, res in zip(shards, local):
        if (shard["btype"][: max(0, B - shard["row0"])] == JC.BTYPE_STORED).any():
            assert isinstance(res, str) and "stored chunks" in res
    out = assemble_host(shards, B, packed=True, payloads=_payloads(data, ns, B),
                        is_lasts=lasts[:B])
    assert zlib.decompress(out, wbits=-15) == data


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_outputs_stay_sharded_and_offsets_tile(world):
    data, shards, _, (bufs, _, ns, lasts), B = _case(world, "random_fast")
    rows = bufs.shape[0] // world
    assert [len(s["nbytes"]) for s in shards] == [rows] * world
    assert [s["row0"] for s in shards] == [r * rows for r in range(world)]
    used = tcompaction.used_words_host(np.concatenate([s["btype"] for s in shards]),
                           np.concatenate([s["data_bits"] for s in shards]))
    assert int(used[:B].sum()) == 0  # random data: every chunk stored
    assert sum(len(s["cw"]) for s in shards) == int(used.sum())  # padding rows only
    nbytes = np.concatenate([s["nbytes"] for s in shards])
    for s in shards:
        np.testing.assert_array_equal(s["all_nbytes"], nbytes)
    offsets = global_offsets(shards[0]["all_nbytes"])
    assert offsets.dtype == np.int64 and offsets[0] == 0
    np.testing.assert_array_equal(offsets[1:], (offsets + nbytes)[:-1])
    out = assemble_host(shards, B, payloads=_payloads(data, ns, B), is_lasts=lasts[:B])
    assert zlib.decompress(out, wbits=-15) == data


def test_global_offsets_past_2gib():
    rng = np.random.default_rng(7)
    nbytes = rng.integers(60_000, 66_000, 164_000).astype(np.int32)
    offsets = global_offsets(nbytes)
    total = int(nbytes.astype(np.int64).sum())
    assert total > 10_000_000_000
    assert offsets.dtype == np.int64 and offsets[0] == 0
    np.testing.assert_array_equal(np.diff(offsets), nbytes[:-1].astype(np.int64))
    assert int(offsets[-1]) + int(nbytes[-1]) == total
    np.testing.assert_array_equal(offsets, jsharded.global_offsets(nbytes))


def test_compaction_rule_single_source():
    rng = np.random.default_rng(3)
    B, NW = 16, 8
    btype = rng.choice([JC.BTYPE_STORED, JC.BTYPE_FIXED, JC.BTYPE_DYNAMIC, JC.BTYPE_SPLIT],
                       B).astype(np.int32)
    dbits = rng.integers(1, 32 * NW, B).astype(np.int32)
    used_h = tcompaction.used_words_host(btype, dbits)
    np.testing.assert_array_equal(used_h, jcompaction.used_words_host(btype, dbits))
    used_d = tcompaction.used_words_device(torch.from_numpy(btype), torch.from_numpy(dbits))
    np.testing.assert_array_equal(used_h, used_d.numpy())
    assert (used_h[btype == JC.BTYPE_STORED] == 0).all()
    words = rng.integers(0, 1 << 32, (B, NW), dtype=np.uint64).astype(np.uint32)
    flat = tcompaction.compact_words_device(torch.from_numpy(words.view(np.int32)), used_d)
    flat = flat.numpy().view(np.uint32)
    want = np.asarray(jcompaction.compact_words_device(jnp.asarray(words),
                                                       jnp.asarray(used_h)))
    n = int(used_h.sum())
    np.testing.assert_array_equal(flat[:n], want[:n])
    woff = np.cumsum(used_h) - used_h
    for i in range(B):
        np.testing.assert_array_equal(flat[woff[i] : woff[i] + used_h[i]], words[i, : used_h[i]])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_compact_fetch_volume_mixed(world):
    data, shards, _, (_, _, ns, lasts), B = _case(world, "mixed")
    btype = np.concatenate([s["btype"] for s in shards])[:B]
    dbits = np.concatenate([s["data_bits"] for s in shards])[:B]
    used = tcompaction.used_words_host(btype, dbits)
    assert (btype[4:] == JC.BTYPE_STORED).all()
    assert (used[4:] == 0).all()
    assert (used[:4] == (dbits[:4] + 31) // 32).all()
    assert sum(len(s["cw"]) for s in shards) == used.sum()  # the fetch is the used prefix
    assert used.sum() * 4 < 0.30 * B * out_words(EMIT) * 4
    payloads = _payloads(data, ns, B)
    out = assemble_host(shards, B, payloads=payloads, is_lasts=lasts[:B])
    assert zlib.decompress(out, wbits=-15) == data
    packed = assemble_host(shards, B, packed=True, payloads=payloads, is_lasts=lasts[:B])
    assert zlib.decompress(packed, wbits=-15) == data


@pytest.mark.parametrize("world", WORLDS)
def test_uncompacted_rows_give_the_same_bytes(world):
    data, shards, local, (_, _, ns, lasts), B = _case(world, "uncompact")
    assert all(s["words"].shape[1] == out_words(EMIT) for s in shards)
    aligned = assemble_host(shards, B)
    assert aligned == _one_shot("uncompact", False)
    assert b"".join(seg for seg, _ in local)[: len(aligned)] == aligned
    packed = assemble_host(shards, B, packed=True, payloads=_payloads(data, ns, B),
                           is_lasts=lasts[:B])
    assert packed == _one_shot("uncompact", True)
