"""No rank outlives a run of the ranks form: after a run, after a rank that
hangs, and after ``SIGTERM`` to the launcher in mid-run, every rank's pid
is gone from ``/proc``.  Four gloo ranks on the CPU.

Run as a module, this file is also a test-only rank entry (``python -m
portbench.tests.test_portbench_lifetime <dir> <rank> <pid>``), which plants
the fault that ``PORTBENCH_TEST_RANK`` names, and a test-only launcher
(``... launcher``), which prints its ranks' pids and runs until killed.
"""

import json
import os
import signal
import subprocess
import sys
import time

from portbench import procs
from portbench.drivers import ranks
from portbench.tests import tiny
from portbench.tests.conftest import ROOT

ENTRY = "portbench.tests.test_portbench_lifetime"


def gone(pid: int) -> bool:
    return not os.path.exists(f"/proc/{pid}")


def test_ranks_are_gone_after_a_run():
    pids = []
    (one,) = ranks.launch_runs(tiny.cell("sharded.default-64k.ranks4"), [tiny.SEED], 0.5,
                               False, device="cpu", on_start=pids.extend)
    assert one["attempted"] >= 1 and one["failed"] == 0
    assert len(pids) == 4 and all(gone(p) for p in pids)


def test_a_hanging_rank_is_killed_at_the_deadline(monkeypatch):
    monkeypatch.setenv("PORTBENCH_TEST_RANK", "hang")
    pids = []
    t0 = time.monotonic()
    try:
        procs.launch(ENTRY, 4, {"seeds": []}, 5.0, cwd=ROOT, on_start=pids.extend)
    except procs.RanksFailed as e:
        assert "deadline" in str(e)
    else:
        raise AssertionError("a hanging rank passed")
    assert time.monotonic() - t0 < 30
    assert len(pids) == 4 and all(gone(p) for p in pids)


def test_sigterm_to_the_launcher_leaves_no_rank():
    launcher = subprocess.Popen([sys.executable, "-m", ENTRY, "launcher"], cwd=ROOT,
                                stdout=subprocess.PIPE, text=True)
    try:
        pids = json.loads(launcher.stdout.readline())
        time.sleep(1.0)  # the ranks are importing or encoding
        assert not any(gone(p) for p in pids)
        launcher.send_signal(signal.SIGTERM)
        assert launcher.wait(timeout=30) != 0
    finally:
        launcher.kill()
        launcher.wait()
    assert len(pids) == 4 and all(gone(p) for p in pids)


def _rank(argv):
    fault = os.environ.get("PORTBENCH_TEST_RANK")
    if fault == "hang":
        procs.rank_args(argv)
        time.sleep(3600)
    gather = ranks.gather_shards
    if fault == "exchange":  # rank 0 splices without the other ranks' shards
        gather = lambda shards, mesh: shards if mesh.rank == 0 else None  # noqa: E731
    elif fault == "altered":  # a bit of one chunk's words flipped on its way

        def gather(shards, mesh):
            every = ranks.gather_shards(shards, mesh)
            if every is not None:
                every[1]["cw"] = every[1]["cw"].copy()
                every[1]["cw"][3] ^= 1 << 7
            return every

    ranks.rank_main(argv, gather=gather)


def _launcher():
    """Run ranks far longer than the test waits, and say their pids."""
    def started(pids):
        print(json.dumps(pids), flush=True)

    ranks.launch_runs(tiny.cell("sharded.default-64k.ranks4"), [tiny.SEED], 600.0, False,
                      device="cpu", on_start=started)


if __name__ == "__main__":
    if sys.argv[1:] == ["launcher"]:
        _launcher()
    else:
        _rank(sys.argv[1:])
