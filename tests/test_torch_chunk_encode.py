"""``ChunkEncoder`` against the JAX package's ``encode_chunk`` on crafted
chunks of the 4 KiB tier, encoded as one batch: every output field must be
equal, and the crafted set must cover every block type."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

from deflate_rs_tpu import CompressionOptions as JOpts  # noqa: E402
from deflate_rs_tpu.ops.chunk_encode import get_chunk_encoder  # noqa: E402
from deflate_rs_tpu_torch import CompressionOptions as TOpts  # noqa: E402
from deflate_rs_tpu_torch.ops.chunk_encode import HALO, PAD, ChunkEncoder  # noqa: E402

EMIT = 4096


def _crafted():
    rng = np.random.default_rng(9)
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9))).astype(np.uint8))
             for _ in range(40)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 40, 900))
    rand = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
    runs = b"".join(bytes([v]) * int(r) for v, r in
                    zip(rng.integers(0, 256, 64), rng.integers(1, 200, 64)))
    # (payload, history, is_last)
    return [
        (text[:4096], b"", True),                   # text
        (text[:4096], text[-9000:], False),          # text with history, non-final
        (rand[:4096], b"", True),                    # incompressible -> stored
        (rand[:1000], rand[4096:6000], False),       # stored, partial, with history
        (runs[:4096], b"", True),                    # runs
        (b"ab", b"", True),                          # n <= 4: forced fixed
        (b"", b"", True),                            # empty
        (b"xyzw", text[:500], False),                # n = 4 with history
        (text[:2048] + rand[:2048], b"", True),      # text then noise -> split
        (rand[:1536] + bytes(2560), b"", False),     # noise then zeros -> split
    ]


def _buffers(cases):
    bufs = np.zeros((len(cases), HALO + EMIT + PAD), np.uint8)
    hist = np.zeros(len(cases), np.int64)
    ns = np.zeros(len(cases), np.int64)
    last = np.zeros(len(cases), bool)
    for i, (p, h, is_last) in enumerate(cases):
        h = h[-HALO:]
        bufs[i, HALO - len(h) : HALO] = np.frombuffer(h, np.uint8)
        bufs[i, HALO : HALO + len(p)] = np.frombuffer(p, np.uint8)
        hist[i], ns[i], last[i] = len(h), len(p), is_last
    return bufs, hist, ns, last


def test_chunk_encoder_equals_encode_chunk():
    cases = _crafted()
    bufs, hist, ns, last = _buffers(cases)
    enc = ChunkEncoder(TOpts.default(), EMIT)
    with torch.no_grad():
        got = enc(torch.from_numpy(bufs), torch.from_numpy(hist), torch.from_numpy(ns),
                  torch.from_numpy(last))
    jenc = get_chunk_encoder(JOpts.default(), EMIT, with_checksums=False)
    btypes = set()
    for i in range(len(cases)):
        want = jenc(bufs[i], np.int32(hist[i]), np.int32(ns[i]), np.bool_(last[i]))
        for k in ("total_bits", "data_bits", "btype", "ntokens"):
            assert int(got[k][i]) == int(want[k]), (i, k)
        np.testing.assert_array_equal(got["words"][i].numpy(),
                                      np.asarray(want["words"]).astype(np.int64),
                                      err_msg=f"chunk {i}")
        btypes.add(int(want["btype"]))
    assert btypes == {0, 1, 2, 3}, btypes
