"""Start ranks as plain child processes and reap every one of them.

``launch`` starts ``world`` processes with ``subprocess.Popen``, all in one
new process group, each running ``python -m <entry> <dir> <rank> <pid of
this process>`` from the checkout's root.  No ``multiprocessing``, no
``torch.multiprocessing``, no ``torchrun`` or elastic agent: nothing but
the ranks is started, so nothing else can outlive a run.  A rank first
arranges to die with this process (``die_with_parent``), meets the others
through a ``file://`` rendezvous in a fresh directory under ``TMPDIR``, and
leaves its numbers in a small file there (``write_result``).

The launcher waits for every rank against a deadline.  On a rank's
failure, on the deadline, or on ``SIGTERM``/``SIGINT`` (turned into
``Interrupted``), it kills the whole group with ``SIGKILL`` in a
``finally``, collects every exit status, and only then removes the
directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

PR_SET_PDEATHSIG = 1
POLL_S = 0.05


class RanksFailed(RuntimeError):
    """A rank exited with an error, or the ranks passed their deadline."""


class Interrupted(BaseException):
    """The launcher got ``SIGTERM`` or ``SIGINT``."""


def _interrupt(signum, frame):
    raise Interrupted(signal.Signals(signum).name)


def _kill_all(procs: list) -> None:
    """``SIGKILL`` to the ranks' group and to each rank, then reap each."""
    if procs:
        try:
            os.killpg(procs[0].pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass  # the group is empty: every rank has exited already
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def launch(entry: str, world: int, spec: dict, deadline_s: float, *, cwd: str,
           on_start=None) -> list:
    """Run ``world`` ranks of module ``entry`` on ``spec`` and return each
    rank's result, in rank order.  ``on_start(pids)`` is called once every
    rank has started."""
    tmp = tempfile.mkdtemp(prefix="portbench-ranks-")
    procs = []
    previous = {s: signal.signal(s, _interrupt) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(dict(spec, world=world, rendezvous=os.path.join(tmp, "rendezvous")), f)
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", entry, tmp, str(rank), str(os.getpid())], cwd=cwd,
                process_group=procs[0].pid if procs else 0))
        if on_start is not None:
            on_start([p.pid for p in procs])
        end = time.monotonic() + deadline_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RanksFailed(f"ranks exited with errors (rank, code): {bad}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > end:
                raise RanksFailed(f"the ranks passed their deadline of {deadline_s:.0f} s")
            time.sleep(POLL_S)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result-{rank}.json")) as f:
                results.append(json.load(f))
        return results
    finally:
        for s in previous:  # a second signal must not cut the reaping short
            signal.signal(s, signal.SIG_IGN)
        _kill_all(procs)
        for s, handler in previous.items():
            signal.signal(s, handler)
        shutil.rmtree(tmp, ignore_errors=True)


def die_with_parent(parent: int) -> None:
    """Have the kernel send this process ``SIGKILL`` when its parent exits;
    exit at once if the parent has gone already."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:
        os._exit(1)


def rank_args(argv: list) -> tuple:
    """(directory, rank, spec) of a rank started by ``launch``."""
    tmp, rank, parent = argv[0], int(argv[1]), int(argv[2])
    die_with_parent(parent)
    with open(os.path.join(tmp, "spec.json")) as f:
        return tmp, rank, json.load(f)


def write_result(tmp: str, rank: int, result: dict) -> None:
    """The rank's numbers, written whole or not at all."""
    path = os.path.join(tmp, f"result-{rank}.json")
    with open(path + ".part", "w") as f:
        json.dump(result, f)
    os.replace(path + ".part", path)
