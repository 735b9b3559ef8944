"""The control fails the check: the program with its fast preset in place
of the configuration's Default, over jobs that hold a whole period of the
mix, reads a ``size_excess`` above the cell's limit; the program itself at
Default does not.  (On the card at the cells' own sizes:
``python3 -m portbench.calibrate``, see PERF.md.)"""

import dataclasses

import pytest

from portbench import calibrate, spec
from portbench.tests import tiny

# One job of 4 MiB covers a whole period of the mix (3.4 MB), whatever its start.
JOB = 4 << 20


def _cell(name):
    cell = spec.load_cell(name)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, job_bytes=JOB, warmup_jobs=0),
                               check=dict(cell.check, sample_jobs=1))


@pytest.mark.parametrize("name", ["corpus.default-64k.mix"])
def test_control_fails_and_program_passes(name):
    cell = _cell(name)
    (ctl,) = calibrate.readings(cell, [tiny.SEED], 0.01,
                                config=calibrate.control_config(cell.config), device="cpu")
    limit = cell.check["limits"]["size_excess"]
    assert ctl["bad_jobs"] == 0 and ctl["size_excess"] > limit
    assert not ctl["passes_limits"]
    (ok,) = calibrate.readings(cell, [tiny.SEED], 0.01, device="cpu")
    assert ok["passes_limits"] and ok["size_excess"] < limit
    assert ctl["size_excess"] > 3 * max(ok["size_excess"], 0)
