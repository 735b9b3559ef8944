"""The JAX package's streams of one 16 MiB chunk, pinned by length and
sha256, against the port's.

A JAX stream of a 16 MiB chunk takes about 22 GB and up to a minute, more
than the suite can spend; this file, run as a script, computes each once
with the JAX package (one process a preset, ``tests/torch_pins.py``) and
writes ``tests/data/torch_pins_16mib.json``:

    JAX_PLATFORMS=cpu python tests/test_torch_pins_16mib.py [PRESET ...]

The input is ``deflate_rs_tpu_torch.utils.mix.spread(16 << 20)``, on which
no symbol of a block reaches 2**20, so every JAX stream there is valid (the
script checks each through zlib before it pins it).  The tests hold the CPU
port's huffman_only and turbo streams to their pins; ``chip_smoke.py`` holds
the card's stream at every pinned preset.  Tolerance: exact equality.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_pins import check_pins_cover, check_port_stream, write_pins  # noqa: E402

PINS_PATH = os.path.join(HERE, "data", "torch_pins_16mib.json")
E = 16 << 20
# Presets pinned; "default_segs512" is Default with dom_segs=512, the
# widest long-range pass the JAX package takes at 16 MiB chunks.
PRESETS = ("fast", "rle", "huffman_only", "turbo", "default_segs512")


def test_pins_cover_every_preset_of_this_input():
    check_pins_cover(PINS_PATH, E, PRESETS)


@pytest.mark.parametrize("preset", ["huffman_only", "turbo"])
def test_port_stream_equals_the_jax_pin(preset):
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    check_port_stream(PINS_PATH, E, preset)


if __name__ == "__main__":
    write_pins(PINS_PATH, E, sys.argv[1:] or PRESETS)
