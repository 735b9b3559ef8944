"""The readings that a cell's limits are set from: the compared numbers of
sound runs of the program over many seeds, and of the control.

The control is the program with its own path of less effort switched on:
the preset the configuration states replaced by the program's ``fast``
preset (one hash check, greedy matching, no long-range pass), every other
setting as stated.  Its streams inflate right, so ``size_excess`` has to
fail it.  Each seed is one run of the cell with a short window, in this
process (the ranks form: in one launch of its ranks a kind of run).

    python3 -m portbench.calibrate --workload corpus.default-64k.mix --seconds 4 \\
        --seeds 11 12 13 --control-seeds 21 22 23

Prints one JSON line a run: ``kind`` (``program`` or ``control``), the
seed, the compared numbers and whether the cell's limits pass them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import reference, spec


def control_config(config: dict) -> dict:
    """The configuration with the program's fast preset in place of its own."""
    return dict(config, preset="fast", preset_numbers=None)


def readings(cell, seeds, seconds: float, *, config=None, device="cuda") -> list:
    """One run of ``cell`` a seed (at ``config`` where given); the compared
    numbers of each."""
    import dataclasses

    if config is not None:
        cell = dataclasses.replace(cell, config=config)
    form = cell.config["form"]
    if form == "ranks":
        from .drivers import ranks

        runs = ranks.launch_runs(cell, seeds, seconds, False, device=device)
    else:
        drv = spec.driver(form)
        runs = [drv.run(cell, s, seconds, False, started=time.time(), device=device)
                for s in seeds]
    out = []
    for seed, run in zip(seeds, runs):
        ok, _ = reference.verdict(run["numbers"], cell.check["limits"])
        out.append({"seed": seed, "attempted": run["attempted"], "failed": run["failed"],
                    **run["numbers"], "passes_limits": ok and not run["failed"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload)
    for kind, seeds, config in (("program", a.seeds, None),
                                ("control", a.control_seeds, control_config(cell.config))):
        if seeds:
            for r in readings(cell, seeds, a.seconds, config=config, device=a.device):
                print(json.dumps({"workload": a.workload, "kind": kind, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
