"""Input bytes of every job the window completed over its whole time, in
MB/s (10**6 bytes), for corpus jobs split over the ranks: rank 0's clock,
from a barrier to the last job's packed stream."""

UNIT, BETTER, SOURCE = "MB/s", "higher", "host_clock"


def read(run: dict) -> float:
    return run["bytes_done"] / run["window_s"] / 1e6
