"""The JAX package's streams of one chunk of ``deflate_rs_tpu_torch.utils.
mix.spread(E)``, pinned by length and sha256, shared by
``tests/test_torch_pins_16mib.py`` and ``tests/test_torch_pins_32mib.py``.

A JAX stream of a 16 MiB chunk takes about 22 GB, of a 32 MiB chunk up to
45 GB, more than the suite can spend; each test file, run as a script,
computes its pins once with the JAX package, one process a preset (run
nothing else large beside it), and writes its JSON file under
``tests/data``.  On ``spread`` no symbol of a block reaches 2**20 at these
sizes, so every JAX stream there is valid: the script checks each through
zlib before it pins it.  A preset is named as in ``CompressionOptions``, or
``<preset>_segs<S>``: the preset with ``dom_segs=S``.  Importing this module
imports no JAX.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from deflate_rs_tpu_torch.utils.mix import spread  # noqa: E402


def options(pkg, name: str):
    preset, _, segs = name.partition("_segs")
    o = getattr(pkg.CompressionOptions, preset)()
    return dataclasses.replace(o, dom_segs=int(segs)) if segs else o


def load_pins(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def check_pins_cover(path: str, E: int, presets) -> None:
    """The pins of ``path`` are of ``spread(E)`` in one chunk, at ``presets``."""
    pins = load_pins(path)
    assert pins["input_sha256"] == hashlib.sha256(spread(E)).hexdigest()
    assert pins["chunk_size"] == E
    assert set(pins["streams"]) == set(presets)
    for pin in pins["streams"].values():
        assert 0 < pin["bytes"] < E and len(pin["sha256"]) == 64


def check_port_stream(path: str, E: int, preset: str) -> None:
    """The CPU port's stream of ``spread(E)`` in one chunk has the pin's
    length and sha256, and inflates to the input through zlib."""
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.parallel import corpus

    data = spread(E)
    got = corpus.compress_corpus(data, options(dt, preset), chunk_size=E, device="cpu").deflate
    pin = load_pins(path)["streams"][preset]
    assert (len(got), hashlib.sha256(got).hexdigest()) == (pin["bytes"], pin["sha256"])
    assert zlib.decompress(got, wbits=-15) == data


def jax_pin(E: int, preset: str) -> dict:
    """The JAX package's stream of ``spread(E)`` at ``preset``, one chunk a
    batch, checked through zlib."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import deflate_rs_tpu as dj
    from deflate_rs_tpu.parallel import corpus as jcorpus

    data = spread(E)
    got = jcorpus.compress_corpus(data, options(dj, preset), batch_size=1, chunk_size=E).deflate
    assert zlib.decompress(got, wbits=-15) == data, preset
    return {"bytes": len(got), "sha256": hashlib.sha256(got).hexdigest()}


def write_pins(path: str, E: int, names) -> None:
    """Compute the pins of ``names`` (one spawned process each) and merge
    them into ``path``."""
    pins = load_pins(path) if os.path.exists(path) else {"streams": {}}
    pins.update(input_sha256=hashlib.sha256(spread(E)).hexdigest(), chunk_size=E)
    for name in names:
        out = subprocess.run([sys.executable, __file__, "--one", str(E), name], check=True,
                             capture_output=True, text=True).stdout
        pins["streams"][name] = json.loads(out.strip().splitlines()[-1])
        print(name, pins["streams"][name], flush=True)
    with open(path, "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--one":
        sys.exit("usage: torch_pins.py --one CHUNK_SIZE PRESET")
    print(json.dumps(jax_pin(int(sys.argv[2]), sys.argv[3])))
