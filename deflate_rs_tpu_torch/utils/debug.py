"""Debug accounting (the reference's DebugCounter analogue).

Port of ``deflate_rs_tpu/utils/debug.py``.  The reference cross-checks
bytes written against block accounting in debug builds (DebugCounter,
deflate_state.rs:14-48, reconciled at compress.rs:161).  Here the streaming
encoders check, when ``DEFLATE_TPU_DEBUG=1`` (the JAX package's variable, so
one setting covers both packages):

* every encoded chunk accounts a sane number of emitted bits;
* the total of bytes consumed equals the sum of the chunks' payload lengths.
"""

from __future__ import annotations

import os


def enabled() -> bool:
    return os.environ.get("DEFLATE_TPU_DEBUG", "0") == "1"


class ByteAccountant:
    """Tracks bytes-in vs bytes-accounted across chunk encodes."""

    def __init__(self):
        self.consumed = 0
        self.accounted = 0

    def consume(self, n: int):
        self.consumed += n

    def account_chunk(self, payload_len: int, emitted_bits: int, is_last: bool):
        self.accounted += payload_len
        if emitted_bits < 0 or (payload_len and emitted_bits == 0):
            raise AssertionError(
                f"chunk of {payload_len} B accounted {emitted_bits} emitted bits"
            )

    def reconcile(self):
        if self.consumed != self.accounted:
            raise AssertionError(
                f"byte accounting mismatch: consumed {self.consumed}, "
                f"accounted {self.accounted}"
            )
