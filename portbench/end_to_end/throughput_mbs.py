"""Input bytes of every job the window completed, over the window's whole
time, in MB/s (10**6 bytes), on one card: what a batch pipeline pays GPU
seconds for."""

UNIT, BETTER, SOURCE = "MB/s", "higher", "host_clock"


def read(run: dict) -> float:
    return run["bytes_done"] / run["window_s"] / 1e6
