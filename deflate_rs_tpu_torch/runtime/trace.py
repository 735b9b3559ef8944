"""The program's profiler ranges, under one switch.

With ``DEFLATE_TPU_TRACE_CORPUS=1`` in the environment, ``span(name)`` opens
a range of that name for ``torch.profiler``; otherwise it is a
``nullcontext``.  The switch is read at every call, so a caller may set it
after its warm-up.  It covers every range of the program: the corpus
engine's steps (``corpus.upload``, ``corpus.encode``, ``corpus.meta_fetch``,
``corpus.words_fetch``, ``corpus.splice``; ``parallel/corpus.py``) and the
chunk encoder's stages (``encoder.<stage>`` for each of
``ChunkEncoder.STAGES``, opened by ``ChunkEncoder.run_stage``; the corpus
engine, the one-shot and streaming encoders and the sharded step all run
their stages through it).

The ranges live on the host's timeline only.  They are function-scope
records (the kind ``torch.profiler`` gives each operator), not user
annotations, so the profiler mirrors no range onto the device's timeline:
a trace's device events are the device's work and nothing else.  A device
activity is put down to the range that launched it through the CUDA call
that launched it: both carry one correlation id, and the call's parents on
the host (``cpu_parent``) lead up to the range.
"""

from __future__ import annotations

import contextlib
import os

import torch

SWITCH = "DEFLATE_TPU_TRACE_CORPUS"


def span(name: str):
    """The profiler range ``name`` where the switch is on, else nothing."""
    if os.environ.get(SWITCH) == "1":
        return torch._C._profiler._RecordFunctionFast(name)
    return contextlib.nullcontext()
