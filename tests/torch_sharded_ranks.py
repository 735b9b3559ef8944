"""The rank side of ``tests/test_torch_sharded.py``: one function that runs
every sharded case on one rank of a gloo process group and returns what the
test checks.  Spawned ranks import this module afresh, so it imports no JAX.
"""

import os

import numpy as np

from deflate_rs_tpu_torch.compression_options import CompressionOptions
from deflate_rs_tpu_torch.parallel.mesh import is_distributed, local_chunk_range, make_mesh
from deflate_rs_tpu_torch.parallel.sharded import assemble_local, make_sharded_encoder
from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch

EMIT = 4096
PAD_ROWS = 32  # the text cases' batches, padded alike (one JAX compile serves both)


def _pg11() -> bytes:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "pg11.txt"),
              "rb") as f:
        return f.read()


def case_inputs() -> dict:
    """name -> (input bytes, preset, compact, rows padded to a multiple of)."""
    pg = _pg11()
    rng = np.random.default_rng(11)
    stored = rng.integers(0, 256, 3 * EMIT, dtype=np.uint8).tobytes()
    rand = np.random.default_rng(5).integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    mixed = pg[: 4 * EMIT] + np.random.default_rng(6).integers(
        0, 256, 4 * EMIT, dtype=np.uint8).tobytes()
    return {
        "text": (pg[:100_000], "default", True, PAD_ROWS),
        "text_packed": (pg[:60_000], "default", True, PAD_ROWS),
        "stored": (stored, "default", True, 1),
        "random_fast": (rand, "fast", True, 1),
        "mixed": (mixed, "default", True, 1),
        "uncompact": (pg[:40_000], "default", False, 1),
    }


def pad_to_multiple(arrs, m: int):
    """Pad every array's rows with zeros to a multiple of ``m``; returns
    (padded arrays, the original row count).  A padding row is an empty
    non-final chunk whose bytes the assembly drops (``n=``)."""
    B = arrs[0].shape[0]
    pad = (-B) % m
    return [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrs], B


def batch(data: bytes, pad: int, world: int):
    return pad_to_multiple(build_batch(data, EMIT), np.lcm(pad, world))


def sharded_cases(mesh) -> dict:
    """Every case on this rank: its shard, its local segment and offset (or
    the ValueError a compacted stored chunk without payload raises), and
    the errors of the mesh helpers."""
    steps = {}
    out = {}
    for name, (data, preset, compact, pad) in case_inputs().items():
        key = (preset, compact)
        if key not in steps:
            steps[key] = make_sharded_encoder(mesh, getattr(CompressionOptions, preset)(), EMIT,
                                              compact=compact)
        (bufs, hist, ns, lasts), B = batch(data, pad, mesh.size)
        shard = steps[key](bufs, hist, ns, lasts)
        try:
            local = assemble_local(shard, is_lasts=lasts, n=B, mesh=mesh)
        except ValueError as e:
            local = str(e)
        out[name] = {"shard": shard, "local": local}
    errors = {}
    for label, call in (("indivisible", lambda: local_chunk_range(mesh.size + 1, mesh)),
                        ("mesh_size", lambda: make_mesh(mesh.size + 1, device="cpu")),
                        ("foreign_rows", lambda: assemble_local(
                            dict(out["text"]["shard"], row0=out["text"]["shard"]["row0"] + 1),
                            mesh=mesh))):
        try:
            call()
            errors[label] = None
        except ValueError as e:
            errors[label] = str(e)
    out["errors"] = errors
    out["rank"], out["size"], out["distributed"] = mesh.rank, mesh.size, is_distributed()
    if mesh.size == 2:
        out[MIXED] = mixed_case()
    return out


MIXED = "text_2x2"  # the text case over 2 ranks x 2 logical devices


def mixed_case() -> dict:
    """The text case on a mesh of two logical CPU devices a rank: this
    rank's shard, its segment and offset, and the mesh's form."""
    mesh = make_mesh(device="cpu", local_devices=2)
    data, preset, _, pad = case_inputs()["text"]
    (bufs, hist, ns, lasts), B = batch(data, pad, mesh.size)
    shard = make_sharded_encoder(mesh, getattr(CompressionOptions, preset)(), EMIT)(
        bufs, hist, ns, lasts)
    return {"shard": shard, "local": assemble_local(shard, is_lasts=lasts, n=B, mesh=mesh),
            "mesh": (mesh.size, mesh.rank, len(mesh.devices))}


def emit_case(mesh, data: bytes, emit: int, preset: str) -> dict:
    """This rank's shard of ``data`` in chunks of ``emit`` bytes at ``preset``
    (compact mode), the batch padded to a multiple of the mesh size."""
    (bufs, hist, ns, lasts), _ = pad_to_multiple(build_batch(data, emit), mesh.size)
    step = make_sharded_encoder(mesh, getattr(CompressionOptions, preset)(), emit)
    return step(bufs, hist, ns, lasts)


META = ("nbytes", "all_nbytes", "btype", "data_bits", "s1", "s2", "crc_raw")


def jax_mesh_arrays(out) -> tuple:
    """A JAX sharded step's output (compact mode) as host arrays: the meta
    arrays whole, and each JAX device's used words (its head and rest
    pieces cut to the used prefix), in device order.  Reads the arrays'
    shards; imports no JAX."""
    from deflate_rs_tpu_torch.ops.compaction import used_words_host

    arrays = {k: np.asarray(out[k]) for k in META}

    def shards(arr):
        return [np.asarray(s.data) for s in sorted(arr.addressable_shards,
                                                   key=lambda s: s.index[0].start or 0)]

    words, row0 = [], 0
    for bt, head, rest in zip(shards(out["btype"]), shards(out["cw_head"]),
                              shards(out["cw_rest"])):
        used = used_words_host(bt, arrays["data_bits"][row0 : row0 + len(bt)])
        words.append(np.concatenate([head, rest])[: int(used.sum())])
        row0 += len(bt)
    return arrays, words
