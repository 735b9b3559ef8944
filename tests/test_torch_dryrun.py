"""The multi-rank dry run (``deflate_rs_tpu_torch.tools.dryrun_multichip``)
at two spawned gloo ranks: the file both ranks write at their offsets
round-trips and equals the one-shot bytes, byte-aligned and packed (the
function raises otherwise), over text, stored, runs, periodic and mixed
chunks.  Small chunks (4 KiB) keep it quick on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")

from deflate_rs_tpu_torch.tools import dryrun_multichip as dm  # noqa: E402
from torch_sharded_ranks import pad_to_multiple  # noqa: E402


def test_dryrun_two_ranks(capsys):
    assert dm.main(["--ranks", "2", "--device", "cpu", "--emit", "4096"]) == 0
    line = capsys.readouterr().out
    assert "dryrun_multichip(2): 8 chunks x 4096 B on cpu" in line
    assert "block types [0, 2, 3]" in line  # stored, dynamic and split chunks


def test_batch_helpers():
    data = bytes(range(256)) * 40  # 10,240 B: three chunks, the last short
    bufs, hist, ns, lasts = dm.build_batch(data, 4096)
    assert bufs.shape == (3, dm.HALO + 4096 + dm.PAD)
    assert hist.tolist() == [0, 4096, 8192] and ns.tolist() == [4096, 4096, 2048]
    assert lasts.tolist() == [False, False, True]
    assert bytes(bufs[2, dm.HALO - 8192 : dm.HALO + 2048]) == data
    (pb, ph, pn, pl), B = pad_to_multiple([bufs, hist, ns, lasts], 4)
    assert B == 3 and pb.shape[0] == 4 and pn[3] == 0 and not pl[3]
    assert len(dm.dryrun_data(4096, 8)) == 8 * 4096
