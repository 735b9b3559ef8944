"""What the harness takes from the program: its options, its counters, the
card's name.  Imported only where the program runs, never by the reference."""

from __future__ import annotations


def options_of(config: dict):
    """The program's preset that the configuration names, held to the
    numbers the configuration states (``preset_numbers``, where given)."""
    from deflate_rs_tpu_torch.compression_options import CompressionOptions

    options = getattr(CompressionOptions, config["preset"])()
    stated = config.get("preset_numbers")
    if stated:
        got = {"max_hash_checks": options.max_hash_checks,
               "lazy_if_less_than": options.lazy_if_less_than,
               "num_quarters": options.num_quarters,
               "dom_segs": options.resolved_dom_segs,
               "num_dom": options.resolved_num_dom}
        if got != stated:
            raise ValueError(f"the program's {config['preset']} preset is {got}; the "
                             f"configuration states {stated}")
    return options


def launches() -> dict:
    """The program's kernel counters (``runtime/cuda.py``), by name."""
    from deflate_rs_tpu_torch.runtime import cuda

    return {name: k.launches for name, k in cuda.KERNELS.items()}


def launches_since(before: dict) -> dict:
    return {name: n - before.get(name, 0) for name, n in launches().items()}


def build(device) -> None:
    """Build the program's kernel library and host runtime before any
    timing (on the CPU only the host runtime)."""
    import torch
    from deflate_rs_tpu_torch.runtime import native

    native.available()
    if torch.device(device).type == "cuda":
        from deflate_rs_tpu_torch.runtime import cuda

        cuda.load_library()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profiler(device):
    """A ``torch.profiler`` of the host and, on a card, the device."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
