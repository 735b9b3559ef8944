"""The JAX package's last three public helpers in the port, each against its
JAX function on the CPU: ``runtime.native.available``,
``ops.package_merge.package_merge_lengths`` (the single-row form) and
``ops.bitpack.words_to_bytes``.  Tolerance: exact equality."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deflate_rs_tpu.ops.bitpack import words_to_bytes as j_words_to_bytes  # noqa: E402
from deflate_rs_tpu.ops.package_merge import package_merge_lengths as j_lengths  # noqa: E402
from deflate_rs_tpu.runtime import native as j_native  # noqa: E402
from deflate_rs_tpu_torch.ops.bitpack import words_to_bytes  # noqa: E402
from deflate_rs_tpu_torch.ops.package_merge import package_merge_lengths  # noqa: E402
from deflate_rs_tpu_torch.runtime import native  # noqa: E402


def test_native_runtime_available():
    assert native.available(), "native runtime failed to build: check g++"
    assert native.available() == j_native.available()


def _freqs(seed: int, A: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = np.zeros(A, np.int32)
    m = (0, 1, 2, A)[seed] if seed < 4 else int(rng.integers(3, A + 1))
    used = rng.choice(A, m, replace=False)
    f[used] = rng.integers(1, [50, 5000, 1 << 19][seed % 3], m)
    return f


@pytest.mark.parametrize("A,max_len", [(286, 15), (30, 15), (19, 7)])
@pytest.mark.parametrize("seed", range(8))
def test_package_merge_lengths_equals_jax(A, max_len, seed):
    f = _freqs(seed, A)
    want = np.asarray(jax.jit(j_lengths, static_argnums=1)(jnp.asarray(f), max_len))
    got = package_merge_lengths(torch.from_numpy(f), max_len)
    assert got.dtype == torch.int32 and got.shape == (A,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W", [0, 1, 7, 4096])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_words_to_bytes_equals_jax(W, dtype):
    rng = np.random.default_rng(W)
    words = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    words[: min(W, 2)] = [0xFFFFFFFF, 0][: min(W, 2)]
    # int64 carries uint32 values as they are, int32 as their bit pattern.
    held = torch.from_numpy(words.astype(np.int64) if dtype == torch.int64
                            else words.view(np.int32))
    got = words_to_bytes(held)
    assert got.dtype == torch.uint8 and got.shape == (4 * W,)
    want = np.asarray(j_words_to_bytes(jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().tobytes() == np.asarray(words, "<u4").tobytes()
