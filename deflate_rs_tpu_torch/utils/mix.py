"""The 16 MiB mix that ``chip_smoke.py`` and the tools measure on.

pg11 text, structured records, random bytes and runs, seeded: the recipe
of ``bench.py:85-97``.  Its pieces come from the checkout (``tests/data``)
and a seeded generator; nothing else is read.
"""

from __future__ import annotations

import os

import numpy as np

PG11 = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "tests", "data", "pg11.txt")
MIX_BYTES = 16 << 20


def build_mix(total_bytes: int, text: bytes) -> bytes:
    """pg11 text, structured records, random bytes and runs, seeded."""
    rng = np.random.default_rng(1234)
    rec = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    structured = b"".join(
        rec[:48] + int(i).to_bytes(8, "little") + rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
        for i in range(4096)
    )
    rand = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    runs = (b"\x00" * 4096 + b"\xff" * 2048 + b"ab" * 1024) * 64
    unit = text * 8 + structured * 2 + rand + runs
    return (unit * (total_bytes // len(unit) + 1))[:total_bytes]


def pg11() -> bytes:
    with open(PG11, "rb") as f:
        return f.read()


def mix(total_bytes: int = MIX_BYTES) -> bytes:
    """The first ``total_bytes`` of the mix."""
    return build_mix(total_bytes, pg11())
