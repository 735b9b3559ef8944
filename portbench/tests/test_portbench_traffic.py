"""The seeded mix: the recipe of ``utils/mix.py``, different bytes for
different seeds, the same bytes again for one seed."""

import dataclasses

import numpy as np
import pytest

from portbench import spec
from portbench.traffic import Jobs, Sample, period, unit

MIXES = ("mix-16m", "mix-64m")


def _traffic(name, job_bytes=1 << 20):
    cell = next(spec.load_cell(w["name"]) for w in spec.load_json(spec.BENCHMARK)["workloads"]
                if w["traffic"] == name)
    return dict(cell.traffic, job_bytes=job_bytes)


def test_recipe_is_utils_mix():
    from deflate_rs_tpu_torch.utils.mix import build_mix, pg11

    t = _traffic("mix-16m")
    got = period(t["recipe"], pg11(), np.random.default_rng(1234))
    assert got == build_mix(len(got), pg11())


@pytest.mark.parametrize("name", MIXES)
def test_seed_repeats_and_differs(name):
    t = _traffic(name)
    seeds = (2**31 + 5, 3 * 2**33 + 1)
    a, b = (Jobs(t, s) for s in seeds)
    a2 = Jobs(t, seeds[0])
    assert a.pool == a2.pool and a.pool != b.pool
    starts = [a.next_start() for _ in range(8)]
    assert starts == [a2.next_start() for _ in range(8)]
    assert len(set(starts)) > 1
    assert len(a.data(starts[0])) == t["job_bytes"]


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, -3])
def test_every_seed_has_the_recipe_s_parts(seed):
    t = _traffic("mix-16m")
    u = unit(t["recipe"], seed)
    assert len(u) == len(unit(t["recipe"], 7))  # the same sizes from every seed
    rnd = t["recipe"]["random_bytes"]
    runs_len = 64 * (4096 + 2048 + 2048)
    assert u[-runs_len:].startswith(b"\x00" * 4096 + b"\xff" * 2048 + b"ab" * 1024)
    rand = u[-runs_len - rnd : -runs_len]
    assert len(set(rand)) == 256


def test_starts_on_the_grain():
    j = Jobs(_traffic("mix-64m", 1 << 20), 11, grain=65536)
    starts = [j.next_start() for _ in range(20)]
    assert all(s % 65536 == 0 and 0 <= s <= j.span for s in starts)
    assert len(j.pool) // 65536 * 65536 >= max(starts) + j.job_bytes


def test_sample_is_seeded_and_bounded():
    picks = []
    for _ in range(2):
        s = Sample(3, 99)
        for j in range(50):
            s.offer(j, b"%d" % j)
        picks.append([k[0] for k in s.kept])
    assert picks[0] == picks[1] and len(picks[0]) == 3
