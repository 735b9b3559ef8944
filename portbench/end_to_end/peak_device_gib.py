"""The highest ``torch.cuda.max_memory_allocated`` of any card of the cell
over the window, in GiB: what a user must leave free on the card."""

UNIT, BETTER, SOURCE = "GiB", "lower", "host_clock"


def read(run: dict) -> float:
    return run["peak_bytes"] / 2**30
