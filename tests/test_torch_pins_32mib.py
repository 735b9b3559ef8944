"""The JAX package's streams of one 32 MiB chunk, pinned by length and
sha256, against the port's.

A JAX stream of a 32 MiB chunk takes 39-45 GB and up to two minutes, more
than the suite can spend; this file, run as a script, computes each once
with the JAX package (one process a preset, ``tests/torch_pins.py``) and
writes ``tests/data/torch_pins_32mib.json``:

    JAX_PLATFORMS=cpu python tests/test_torch_pins_32mib.py [PRESET ...]

The input is ``deflate_rs_tpu_torch.utils.mix.spread(32 << 20)``, on which
no symbol of a block reaches 2**20.  The test holds the CPU port's
huffman_only stream to its pin (about 10 GB); ``chip_smoke.py`` holds the
card's stream at every pinned preset.  Tolerance: exact equality.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_pins import check_pins_cover, check_port_stream, write_pins  # noqa: E402

PINS_PATH = os.path.join(HERE, "data", "torch_pins_32mib.json")
E = 32 << 20
# Presets pinned; "default_segs1024" is Default with dom_segs=1024, the
# widest long-range pass the JAX package takes at 32 MiB chunks.
PRESETS = ("fast", "rle", "huffman_only", "turbo", "default_segs1024")


def test_pins_cover_every_preset_of_this_input():
    check_pins_cover(PINS_PATH, E, PRESETS)


def test_port_stream_equals_the_jax_pin():
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    check_port_stream(PINS_PATH, E, "huffman_only")


if __name__ == "__main__":
    write_pins(PINS_PATH, E, sys.argv[1:] or PRESETS)
