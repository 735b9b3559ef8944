"""Seconds from the start of the process to the start of the window: the
traffic's pool, building and loading the program, the warm-up jobs."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run: dict) -> float:
    return run["setup_s"]
