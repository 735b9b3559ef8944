"""The plain reference that decides ``correct``.

It imports nothing of the program.  A zlib stream (RFC 1950) of a job is
right when the standard inflater, Python's own ``zlib``, reads it back to
the job's bytes: that checks the header, every DEFLATE block and the
Adler-32 trailer.  A stream that inflates right but was made with less
effort than the configuration's preset is also wrong; its size is held to
that of the standard deflater at the preset's level over the same chunks,
each with the 32 KiB of history the program gives it.

Numbers compared (``check(...)`` returns them):

- ``bad_jobs``: sampled jobs whose stream does not inflate to their bytes;
- ``size_excess``: the largest, over the sampled jobs, of the stream's
  DEFLATE body over the reference's, less 1.
"""

from __future__ import annotations

import zlib

HISTORY = 32768
ZLIB_FRAME = 6  # 2 header bytes, 4 trailer bytes


def reference_size(data: bytes, chunk: int, level: int) -> int:
    """Raw DEFLATE bytes of ``data`` in chunks of ``chunk`` bytes, each
    compressed alone at ``level`` with the 32 KiB before it as history."""
    total = 0
    for off in range(0, len(data), chunk):
        hist = data[max(0, off - HISTORY) : off]
        z = (zlib.compressobj(level, zlib.DEFLATED, -15, 9, zlib.Z_DEFAULT_STRATEGY, hist)
             if hist else zlib.compressobj(level, zlib.DEFLATED, -15, 9))
        total += len(z.compress(data[off : off + chunk])) + len(z.flush())
    return total


def inflates_to(stream: bytes, data: bytes) -> bool:
    """Whether ``stream`` is one zlib stream of exactly ``data``."""
    try:
        d = zlib.decompressobj()
        out = d.decompress(stream) + d.flush()
    except zlib.error:
        return False
    return d.eof and not d.unused_data and out == data


def check(samples, chunk: int, level: int) -> dict:
    """The compared numbers over ``samples``, pairs of (job bytes, stream)."""
    bad, excess = 0, None
    for data, stream in samples:
        if not inflates_to(stream, data):
            bad += 1
            continue
        e = (len(stream) - ZLIB_FRAME) / reference_size(data, chunk, level) - 1
        excess = e if excess is None else max(excess, e)
    return {"checked_jobs": len(samples), "bad_jobs": bad, "size_excess": excess}


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``correct`` and the lines that print each number beside its limit.

    ``limits`` maps a number to its largest allowed value; a number with no
    value (no sample, or none that inflated) fails."""
    ok = numbers.get("checked_jobs", 0) >= 1
    lines = [f"checked_jobs {numbers.get('checked_jobs', 0)} least 1"]
    for key, limit in limits.items():
        value = numbers.get(key)
        ok = ok and value is not None and value <= limit
        lines.append(f"{key} {value} limit {limit}")
    return ok, lines
