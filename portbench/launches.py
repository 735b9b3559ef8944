"""Which of the program's host ranges launched each device activity.

A ``torch.profiler`` trace gives each device activity (kernel, copy,
memset) the correlation id of the CUDA API call that queued it, and that
call's parents on the host (``cpu_parent``) lead up through the operators
to the program's ranges (``corpus.*``, ``encoder.<stage>``;
``deflate_rs_tpu_torch/runtime/trace.py``).  The kernels the program
launches through ``ctypes`` are placed the same way: their
``cuLaunchKernel`` call sits right under the range that made it.

- ``launched_in(events, prefixes)``: ``{range: [[start_us, end_us, name],
  ...]}``, every device activity of the trace under the innermost range
  named with one of ``prefixes`` above its call, or under ``OUTSIDE``;
- ``host_ranges(events, prefixes)``: ``{range: [[start_us, end_us], ...]}``,
  the host's spans of those ranges.

``deflate_rs_tpu_torch/tools/stage_timing.py`` splits a traced ``forward``
by stage with them.
"""

from __future__ import annotations

import re

# The CUDA API calls that queue device work (cudaLaunchKernel,
# cudaMemcpyAsync, cuLaunchKernel, ...): each carries the correlation id of
# the activity it queued.
LAUNCH_CALL = re.compile(r"cu(da)?[A-Z]")
# The key of activity launched under none of the ranges; ``trace.breakdown``
# files idle gaps under the same name.
OUTSIDE = "outside any span"


def launched_in(events, prefixes=("encoder.",)) -> dict:
    """Every device activity of ``events`` (a ``torch.profiler`` trace's
    events) as ``[start_us, end_us, name]``, under the innermost host range
    named with one of ``prefixes`` whose code launched it: the CUDA call
    with the activity's correlation id, then that call's parents on the
    host.  An activity whose call is not in the trace, or has no such range
    above it, goes under ``OUTSIDE``: each activity lands under one key.  A
    host range's mirror on the device's timeline is no activity."""
    from torch.autograd import DeviceType

    calls, acts = {}, []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                acts.append(e)
        elif LAUNCH_CALL.match(e.name):
            calls[e.id] = e
    out = {}
    for a in acts:
        p = calls.get(a.id)
        while p is not None and not p.name.startswith(prefixes):
            p = p.cpu_parent
        out.setdefault(OUTSIDE if p is None else p.name, []).append(
            [a.time_range.start, a.time_range.end, a.name])
    return out


def host_ranges(events, prefixes=("encoder.",)) -> dict:
    """The host ranges of ``events`` named with one of ``prefixes``, as
    ``{name: [[start_us, end_us], ...]}``."""
    from torch.autograd import DeviceType

    out = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(prefixes):
            out.setdefault(e.name, []).append([e.time_range.start, e.time_range.end])
    return out
