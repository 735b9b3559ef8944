"""The JAX package's streams of one 16 MiB chunk, pinned by length and
sha256, against the port's.

A JAX stream of a 16 MiB chunk takes about 22 GB and up to a minute, more
than the suite can spend; this file, run as a script, computes each once
with the JAX package (one process a preset) and writes
``tests/data/torch_pins_16mib.json``:

    JAX_PLATFORMS=cpu python tests/test_torch_pins_16mib.py [PRESET ...]

The input is ``deflate_rs_tpu_torch.utils.mix.spread(16 << 20)``, on which
no symbol of a block reaches 2**20, so every JAX stream there is valid (the
script checks each through zlib before it pins it).  The tests hold the CPU
port's huffman_only and turbo streams to their pins; ``chip_smoke.py`` holds
the card's stream at every pinned preset.  Tolerance: exact equality.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import zlib

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from deflate_rs_tpu_torch.utils.mix import spread  # noqa: E402

PINS_PATH = os.path.join(HERE, "data", "torch_pins_16mib.json")
E = 16 << 20
# Presets pinned; "default_segs512" is Default with dom_segs=512, the
# widest long-range pass the JAX package takes at 16 MiB chunks.
PRESETS = ("fast", "rle", "huffman_only", "turbo", "default_segs512")


def options(pkg, name: str):
    preset, _, segs = name.partition("_segs")
    o = getattr(pkg.CompressionOptions, preset)()
    return dataclasses.replace(o, dom_segs=int(segs)) if segs else o


def load_pins() -> dict:
    with open(PINS_PATH) as f:
        return json.load(f)


def test_pins_cover_every_preset_of_this_input():
    pins = load_pins()
    assert pins["input_sha256"] == hashlib.sha256(spread(E)).hexdigest()
    assert pins["chunk_size"] == E
    assert set(pins["streams"]) == set(PRESETS)
    for pin in pins["streams"].values():
        assert 0 < pin["bytes"] < E and len(pin["sha256"]) == 64


@pytest.mark.parametrize("preset", ["huffman_only", "turbo"])
def test_port_stream_equals_the_jax_pin(preset):
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.parallel import corpus

    data = spread(E)
    got = corpus.compress_corpus(data, options(dt, preset), chunk_size=E, device="cpu").deflate
    pin = load_pins()["streams"][preset]
    assert (len(got), hashlib.sha256(got).hexdigest()) == (pin["bytes"], pin["sha256"])
    assert zlib.decompress(got, wbits=-15) == data


def _jax_pin(preset: str) -> dict:
    """The JAX package's stream of the input at ``preset``, one chunk a
    batch, checked through zlib."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import deflate_rs_tpu as dj
    from deflate_rs_tpu.parallel import corpus as jcorpus

    data = spread(E)
    got = jcorpus.compress_corpus(data, options(dj, preset), batch_size=1, chunk_size=E).deflate
    assert zlib.decompress(got, wbits=-15) == data, preset
    return {"bytes": len(got), "sha256": hashlib.sha256(got).hexdigest()}


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_jax_pin(sys.argv[2])))
        sys.exit(0)
    names = sys.argv[1:] or PRESETS
    pins = load_pins() if os.path.exists(PINS_PATH) else {"streams": {}}
    pins.update(input_sha256=hashlib.sha256(spread(E)).hexdigest(), chunk_size=E)
    for name in names:
        out = subprocess.run([sys.executable, __file__, "--one", name], check=True,
                             capture_output=True, text=True).stdout
        pins["streams"][name] = json.loads(out.strip().splitlines()[-1])
        print(name, pins["streams"][name], flush=True)
    with open(PINS_PATH, "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")
