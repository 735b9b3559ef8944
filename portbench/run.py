"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for
(``torch.cuda``; without them it exits 2 and prints no result).  Set-up
(the traffic's pool, building and loading the program's kernels, the
warm-up jobs) runs first and is ``setup_s``, from this module's first line
to the window's start; then the cell's driver runs jobs for ``--seconds``;
then the plain reference checks a sample of the window's jobs, drawn from
the seed.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``check``, each compared number
beside its limit; the same numbers are the last lines of standard error.
It exits 3 and prints no result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from . import reference, spec, trace  # noqa: E402


def result(cell, run: dict, trace_on: bool, device: dict) -> tuple:
    """(the result's line as a dict, the check's lines for standard error)."""
    ok, lines = reference.verdict(run["numbers"], cell.check["limits"])
    for err in run["errors"]:
        lines.insert(0, f"error {err}")
    lines.append(f"failed_jobs {run['failed']} limit 0")
    out = {"correct": ok and run["failed"] == 0, "attempted": run["attempted"],
           "failed": run["failed"]}
    rec = run["trace"]
    if trace_on:
        metrics = {}
        for m in cell.per_layer:
            value = None if rec is None else spec.metric(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if rec is not None:
            cards = rec.get("cards") or [{"busy_s": trace.device_seconds(rec),
                                          "window_s": rec["window_s"]}]
            device = dict(device, busy_s=statistics.mean(c["busy_s"] or 0.0 for c in cards),
                          window_s=statistics.mean(c["window_s"] or 0.0 for c in cards))
    else:
        metrics = {m["name"]: {"value": spec.end_to_end(m["name"]).read(run), "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    out["device"] = device
    if trace_on and rec is not None and rec["device"]:
        out["breakdown"] = trace.breakdown(rec)
    out["check"] = {"checked_jobs": {"value": run["numbers"]["checked_jobs"], "least": 1},
                    "failed_jobs": {"value": run["failed"], "limit": 0}}
    out["check"].update({k: {"value": run["numbers"].get(k), "limit": v}
                         for k, v in cell.check["limits"].items()})
    return out, lines


def execute(cell, seed: int, seconds: float, trace_on: bool, *, device="cuda") -> tuple:
    """Run ``cell`` once on ``device`` without looking for cards: (result,
    check lines)."""
    import torch

    run = spec.driver(cell.config["form"]).run(cell, seed, seconds, trace_on, started=STARTED,
                                              device=device)
    if torch.device(device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    else:
        info = {"platform": "cpu", "kind": "cpu"}
    info.update(count=run["cards"], memory_peak_bytes=run["peak_bytes"])
    return result(cell, run, trace_on, info)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} seen",
              file=sys.stderr)
        return 2
    out, lines = execute(cell, a.seed, a.seconds, bool(a.trace))
    found = spec.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
