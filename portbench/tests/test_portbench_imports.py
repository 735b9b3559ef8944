"""Nothing a run of ``portbench`` loads is JAX or the JAX package, and the
plain reference loads nothing of the program.  Top-level names are
compared whole: ``deflate_rs_tpu_torch`` begins with ``deflate_rs_tpu``."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

PROBE = """
import json, sys
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", ["corpus.default-64k.mix", "sharded.default-64k.ranks4"])
def test_a_run_loads_no_jax(name):
    tops = loaded(
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        f"out, _ = run.execute(tiny.cell({name!r}), tiny.SEED, 0.3, True, device='cpu')\n"
        "assert out['correct'], out\n")
    assert "deflate_rs_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "deflate_rs_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded(
        "from portbench import reference\n"
        "import zlib\n"
        "data = b'abc' * 50000\n"
        "n = reference.check([(data, zlib.compress(data))], 65536, 6)\n"
        "assert n['bad_jobs'] == 0 and n['checked_jobs'] == 1\n")
    assert not tops & {"deflate_rs_tpu_torch", "deflate_rs_tpu", "jax", "torch"}


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result; so
    does a copy that holds only BENCHMARK.json and portbench/."""
    import shutil

    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
            shutil.copytree(f"{ROOT}/portbench", tmp_path / "portbench")
        p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                            "corpus.default-64k.mix", "--seed", "5", "--seconds", "1"],
                           cwd=cwd, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and not p.stdout.strip()
