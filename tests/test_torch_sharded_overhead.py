"""``deflate_rs_tpu_torch/tools/sharded_overhead.py`` on the CPU: a gloo
process group of one rank in this process, two chunks of 4 KiB of the mix.

The sharded step's compacted words, block types, data bits and byte counts
equal the plain ``ChunkEncoder``'s (the tool raises otherwise, and its check
catches one changed word); the times are the host's, labelled so.  The plain
encoder's words also equal the JAX ``encode_chunk``'s on the same rows.
Tolerance: exact equality.
"""

import shutil
import tempfile

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from deflate_rs_tpu import CompressionOptions as JOpts  # noqa: E402
from deflate_rs_tpu.ops.chunk_encode import get_chunk_encoder  # noqa: E402
from deflate_rs_tpu_torch import CompressionOptions as TOpts  # noqa: E402
from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder  # noqa: E402
from deflate_rs_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: E402
from deflate_rs_tpu_torch.parallel.sharded import make_sharded_encoder  # noqa: E402
from deflate_rs_tpu_torch.tools import sharded_overhead as so  # noqa: E402
from deflate_rs_tpu_torch.tools.stage_timing import batch_inputs  # noqa: E402
from deflate_rs_tpu_torch.utils.mix import mix  # noqa: E402

B, EMIT = 2, 4096


@pytest.fixture
def group():
    tmp = tempfile.mkdtemp(prefix="test_sharded_overhead_")
    init_distributed(f"file://{tmp}/rendezvous", 1, 0, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def test_sharded_words_equal_the_plain_encoder(group):
    r = so.overhead(B, EMIT, iters=1, device="cpu")
    assert r["words_equal"] and (r["batch"], r["emit"], r["world"]) == (B, EMIT, 1)
    assert r["backend"] == "gloo"
    assert set(r["cpu_ms_per_chunk"]) == {"floor", "plain", "plain_checksums", "sharded"}
    assert "ms_per_chunk" not in r and "card" not in r  # no device metric from the CPU


def test_the_check_catches_a_changed_word(group):
    bufs, hist, ns, lasts = batch_inputs(mix(B * EMIT), B, EMIT)
    step = make_sharded_encoder(make_mesh(device="cpu"), TOpts.default(), EMIT)
    with torch.no_grad():
        plain = ChunkEncoder(TOpts.default(), EMIT)(*(torch.from_numpy(a) for a in
                                                      (bufs, hist, ns, lasts)))
    shard = step(bufs, hist, ns, lasts)
    assert so._same_words(shard, plain)
    shard["cw"] = shard["cw"].copy()
    shard["cw"][len(shard["cw"]) // 2] ^= 1
    assert not so._same_words(shard, plain)


def test_the_plain_rows_equal_jax():
    bufs, hist, ns, lasts = batch_inputs(mix(B * EMIT), B, EMIT)
    with torch.no_grad():
        got = ChunkEncoder(TOpts.default(), EMIT)(*(torch.from_numpy(a) for a in
                                                    (bufs, hist, ns, lasts)))
    jenc = get_chunk_encoder(JOpts.default(), EMIT, with_checksums=False)
    for i in range(B):
        want = jenc(bufs[i], np.int32(hist[i]), np.int32(ns[i]), np.bool_(lasts[i]))
        assert int(got["data_bits"][i]) == int(want["data_bits"])
        np.testing.assert_array_equal(got["words"][i].numpy(),
                                      np.asarray(want["words"]).astype(np.int64))


def test_the_tool_on_the_cpu(capsys):
    assert so.main(["--device", "cpu", "--batch", "2", "--emit", "4096", "--iters", "1"]) == 0
    assert '"words_equal": true' in capsys.readouterr().out
    assert not (dist.is_available() and dist.is_initialized())


def test_the_tool_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert so.main([]) == 1
