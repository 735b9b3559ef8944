"""A hand-built ``torch.profiler`` trace, as ``portbench.launches`` and
``deflate_rs_tpu_torch/tools/stage_timing.py`` read one."""

from types import SimpleNamespace


def event(name, start, end, *, device=False, id=0, parent=None, mirror=False):
    """A ``torch.profiler`` event: ``id`` is the correlation id of a CUDA
    call or of the device activity it queued."""
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), id=id,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           cpu_parent=parent, is_user_annotation=mirror)


def two_stage_trace(outer: str = "corpus.encode") -> list:
    """Host ranges encoder.lz77 [0, 40] and encoder.parse [40, 60] inside
    ``outer`` [-1, 70]; the device activity their CUDA calls queued, one
    activity a hand-written kernel's (its call right under the range), and
    activity launched outside every stage: under ``outer`` itself, with no
    range above its call, and with no call in the trace; plus a host
    range's mirror on the device, which is no activity."""
    enc = event(outer, -1.0, 70.0)
    lz = event("encoder.lz77", 0.0, 40.0, parent=enc)
    parse = event("encoder.parse", 40.0, 60.0, parent=enc)
    add = event("aten::add", 1.0, 5.0, parent=lz)
    sort = event("aten::sort", 6.0, 20.0, parent=lz)
    calls = [event("cudaLaunchKernel", 2.0, 3.0, id=101, parent=add),
             event("cudaMemcpyAsync", 7.0, 8.0, id=102, parent=sort),
             event("cudaLaunchKernel", 9.0, 10.0, id=103, parent=sort),
             event("cuLaunchKernel", 41.0, 42.0, id=104, parent=parse),
             event("cudaLaunchKernel", 61.0, 62.0, id=105, parent=enc),
             event("cudaLaunchKernel", 80.0, 81.0, id=106)]
    device = [event("add_kernel", 10.0, 20.0, device=True, id=101),
              event("Memcpy HtoD (Pinned -> Device)", 22.0, 25.0, device=True, id=102),
              event("sort_kernel", 30.0, 45.0, device=True, id=103),
              event("parse_scan_kernel(int const*)", 50.0, 58.0, device=True, id=104),
              event("compact_kernel", 63.0, 66.0, device=True, id=105),
              event("tail_kernel", 82.0, 84.0, device=True, id=106),
              event("lost_kernel", 90.0, 91.0, device=True, id=107),
              event("encoder.parse", 50.0, 58.0, device=True, mirror=True)]
    return [enc, lz, parse, add, sort, *calls, *device]
