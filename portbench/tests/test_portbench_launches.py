"""``portbench.launches`` on a hand-built trace: each device activity goes
under the innermost program range above the CUDA call that queued it, each
lands under exactly one key, a range's device mirror under none; the host
ranges keep their spans."""

import pytest

from portbench import launches
from portbench.tests.events import two_stage_trace


def test_device_activity_goes_under_the_range_that_launched_it():
    launched = launches.launched_in(two_stage_trace())
    names = {k: [a[2] for a in v] for k, v in launched.items()}
    assert names == {"encoder.lz77": ["add_kernel", "Memcpy HtoD (Pinned -> Device)",
                                      "sort_kernel"],
                     "encoder.parse": ["parse_scan_kernel(int const*)"],
                     launches.OUTSIDE: ["compact_kernel", "tail_kernel", "lost_kernel"]}
    assert launched["encoder.lz77"][0] == [10.0, 20.0, "add_kernel"]


@pytest.mark.parametrize("prefixes", [("encoder.",), ("corpus.", "encoder."), ("corpus.",)])
def test_every_activity_lands_under_one_key(prefixes):
    launched = launches.launched_in(two_stage_trace(), prefixes)
    keys = [k for k, acts in launched.items() for _ in acts]
    assert len(keys) == 7  # the mirror is no activity
    if "corpus." in prefixes:
        assert [a[2] for a in launched["corpus.encode"]][-1] == "compact_kernel"
    if prefixes == ("corpus.",):  # the stages' work goes under the range above them
        assert len(launched["corpus.encode"]) == 5


def test_host_ranges_keep_the_named_ranges():
    assert launches.host_ranges(two_stage_trace()) == {"encoder.lz77": [[0.0, 40.0]],
                                                       "encoder.parse": [[40.0, 60.0]]}
    assert launches.host_ranges(two_stage_trace(), ("corpus.",)) == {
        "corpus.encode": [[-1.0, 70.0]]}
