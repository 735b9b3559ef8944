"""The sharded encoder on a mesh of several devices in one process
(``parallel/mesh.py``, ``parallel/sharded.py``), on the CPU.

``make_mesh(n, device="cpu")`` gives ``n`` logical devices, the counterpart
of the JAX tests' ``--xla_force_host_platform_device_count=8``: the step
splits the batch's rows into one contiguous block a device.  At 1, 2, 4 and
8 devices the packed and byte-aligned splices equal the one-shot bytes and
every device count gives the one-device shard (the JAX 8-device mesh is held
array for array in ``tests/test_torch_sharded.py``, which compiles that JAX
step once for both files' cases).  An indivisible batch and a mesh of more
cards than exist raise ``ValueError``; a rank of a process group picks its
first card in one place, and ``init_distributed`` binds that card.  Then one
small CPU case of each tool's single-process form:
``tools/dryrun_multichip.py``, ``tools/sharded_soak.py``,
``tools/sharded_overhead.py`` and ``tools/scaling_curve.py``.  Chunks of
4 KiB keep it quick.  Tolerance: exact equality throughout.
"""

import functools
import json
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu_torch.models import deflate as tdeflate  # noqa: E402
from deflate_rs_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import (assemble_host, assemble_local,  # noqa: E402
                                                   make_sharded_encoder)
from deflate_rs_tpu_torch.tools import dryrun_multichip, scaling_curve  # noqa: E402
from deflate_rs_tpu_torch.tools import sharded_overhead, sharded_soak  # noqa: E402
from deflate_rs_tpu_torch.utils.mix import pg11  # noqa: E402
from torch_sharded_ranks import EMIT, batch  # noqa: E402

SIZES = [1, 2, 4, 8]
ROWS = 8  # seven chunks and one padding row: one row a device at 8


@functools.lru_cache(maxsize=None)
def _data() -> bytes:
    return pg11()[: 7 * EMIT - 700]


def _batch():
    return batch(_data(), ROWS, 1)


@functools.lru_cache(maxsize=None)
def _shard(n: int) -> dict:
    (bufs, hist, ns, lasts), _ = _batch()
    step = make_sharded_encoder(make_mesh(n, device="cpu"), dt.CompressionOptions.default(),
                                EMIT)
    return step(bufs, hist, ns, lasts)


@functools.lru_cache(maxsize=None)
def _one_shot(packed: bool) -> bytes:
    """The port's one-shot bytes on the sharded path's chunk grid."""
    full, small = tdeflate.FULL_EMIT, tdeflate.SMALL_EMIT
    try:
        tdeflate.FULL_EMIT, tdeflate.SMALL_EMIT = EMIT, 0
        if packed:
            return dt.deflate_bytes(_data(), device="cpu")
        return tdeflate.compress_stream(_data(), dt.CompressionOptions.default(), packed=False,
                                        device="cpu").deflate
    finally:
        tdeflate.FULL_EMIT, tdeflate.SMALL_EMIT = full, small


@pytest.mark.parametrize("n", SIZES)
def test_mesh_splices_equal_the_one_shot_bytes(n):
    data = _data()
    (_, _, ns, lasts), B = _batch()
    shard = _shard(n)
    assert shard["row0"] == 0 and len(shard["nbytes"]) == ROWS
    np.testing.assert_array_equal(shard["all_nbytes"], shard["nbytes"])
    payloads = [data[i * EMIT : i * EMIT + int(ns[i])] for i in range(B)]
    packed = assemble_host(shard, B, packed=True, payloads=payloads, is_lasts=lasts[:B])
    aligned = assemble_host(shard, B, payloads=payloads, is_lasts=lasts[:B])
    assert packed == _one_shot(True) and zlib.decompress(packed, -15) == data
    assert aligned == _one_shot(False)
    mesh = make_mesh(n, device="cpu")
    assert assemble_local(shard, payloads=payloads, is_lasts=lasts, n=B, mesh=mesh) == (
        aligned, 0)
    for key in shard:
        np.testing.assert_array_equal(shard[key], _shard(1)[key])


def test_an_indivisible_batch_raises():
    (bufs, hist, ns, lasts), _ = _batch()
    step = make_sharded_encoder(make_mesh(4, device="cpu"), dt.CompressionOptions.default(),
                                EMIT)
    with pytest.raises(ValueError, match="not divisible by the mesh size 4"):
        step(bufs[:6], hist[:6], ns[:6], lasts[:6])


def test_a_mesh_of_more_cards_than_exist_raises():
    seen = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"this process sees {seen}"):
        make_mesh(seen + 1, device="cuda")
    with pytest.raises(ValueError, match="one card"):
        make_mesh(2, device="cuda:0")
    with pytest.raises(ValueError, match="local_devices"):
        make_mesh(device="cpu", local_devices=2)


def test_mesh_device_stays_the_first_device():
    mesh = make_mesh(3, device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (3, 0, None)
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.device == torch.device("cpu")
    assert make_mesh(device="cpu").devices == (torch.device("cpu"),)
    cards = Mesh(None, 2, 0, (torch.device("cuda", 1), torch.device("cuda", 2)))
    assert cards.device == torch.device("cuda", 1)


@pytest.mark.parametrize("local_rank, per_rank, card", [(0, 2, 0), (1, 2, 2), (3, 2, 6),
                                                        (1, 4, 4)])
def test_a_rank_binds_its_first_card_before_the_group_forms(monkeypatch, local_rank,
                                                             per_rank, card):
    """``init_distributed(local_devices=k)`` makes ``LOCAL_RANK * k`` current
    before ``init_process_group``, the card ``make_mesh`` gives the rank
    first (``rank_card``); no other rank's card is bound on the way."""
    calls = []
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setattr(tmesh.torch.cuda, "set_device", lambda d: calls.append(("bind", d)))
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append(("group", backend, kw["rank"])))
    tmesh.init_distributed("file:///nowhere", 8, 5, device="cuda", local_devices=per_rank)
    assert calls == [("bind", torch.device("cuda", card)), ("group", "nccl", 5)]
    assert tmesh.rank_card(5, per_rank) == torch.device("cuda", card)


def test_dryrun_single_process(capsys):
    assert dryrun_multichip.main(["--ranks", "2", "--single-process", "--device", "cpu",
                                  "--emit", "4096"]) == 0
    line = capsys.readouterr().out
    assert "dryrun_multichip(2): 8 chunks x 4096 B on cpu" in line
    assert "written by one process round-trips" in line


def test_soak_single_process():
    s = sharded_soak.soak(70_000, world=2, device="cpu", step_chunks=2, preset="fast",
                          single_process=True)
    assert (s["world"], s["processes"], s["chunks"], s["steps"]) == (2, 1, 2, 1)
    assert s["stream_bytes"] > s["packed_bytes"]


def test_overhead_single_process(capsys):
    assert sharded_overhead.main(["--device", "cpu", "--batch", "2", "--emit", "4096",
                                  "--iters", "1", "--single-process"]) == 0
    r = json.loads(capsys.readouterr().out)
    assert r["words_equal"] and (r["device"], r["backend"]) == ("cpu", None)
    assert "cpu_ms_per_chunk" in r and "ms_per_chunk" not in r


def test_scaling_curve_on_the_cpu(capsys):
    assert scaling_curve.main(["--device", "cpu", "--devices", "2", "--forms", "process",
                               "--mb", "0.03125", "--emit", "4096", "--step", "8",
                               "--runs", "1", "--preset", "fast"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["form"], r["devices"], r["processes"]) for r in rows] == [("process", 2, 1)]
    assert all(r["equal_one_shot"] and r["cpu_mb_per_s_median"] > 0 for r in rows)
    assert not any("busy_share" in r or "mb_per_s" in r for r in rows)  # no device metric
