"""The PyTorch port's constants, options and split tables against the JAX
package, its import isolation from jax, and every preset, force mode and
long-range knob at the 4 KiB tier against JAX."""

import dataclasses
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import deflate_rs_tpu.constants as jc  # noqa: E402
import deflate_rs_tpu_torch.constants as tc  # noqa: E402
from deflate_rs_tpu import CompressionOptions as JOpts  # noqa: E402
from deflate_rs_tpu.ops import chunk_encode as jce  # noqa: E402
from deflate_rs_tpu_torch import CompressionOptions as TOpts  # noqa: E402
from deflate_rs_tpu_torch import options_from_reference  # noqa: E402
from deflate_rs_tpu_torch.ops import chunk_encode as tce  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ["default", "high", "fast", "huffman_only", "turbo", "rle"]


def test_constant_tables_equal():
    names = [k for k, v in vars(jc).items() if isinstance(v, (np.ndarray, int, dict))
             and not k.startswith("_")]
    assert len(names) > 20
    for k in names:
        a, b = getattr(jc, k), getattr(tc, k)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k
    assert jc.zlib_header() == tc.zlib_header()


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_and_cache_key(preset):
    j = getattr(JOpts, preset)()
    t = getattr(TOpts, preset)()
    assert t.cache_key() == j.cache_key()[:-1]  # JAX's last entry: kernel gates
    assert options_from_reference(dataclasses.asdict(j)) == t
    for prop in ("num_quarters", "exact_split_scoring", "probe_words", "num_candidates",
                 "resolved_sa_tail", "use_long_range", "lazy"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("nq", [1, 4, 8])
def test_split_cfg_arrays_equal(nq):
    j = jce._SplitCfg(nq)
    t = tce.SplitCfg(nq)
    assert t.ranges == j.ranges and t.comps == j.comps
    for name in ("hdr_start", "blk_end", "last_start", "slotq", "mem", "exist", "rid_t",
                 "comp_ranges"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert t.range_id == j.range_id
    for emit in (4096, 65536):
        assert tce.out_words(emit) == jce.out_words(emit, force_fixed=False)
        assert tce.out_words(emit, force_fixed=True) == jce.out_words(emit, force_fixed=True)


def test_encoder_buffers_move_with_module():
    enc = tce.ChunkEncoder(TOpts.default(), 4096)
    bufs = dict(enc.named_buffers())
    assert {"comp_ranges", "fixed_l_len", "l_extra", "mem_c"} <= set(bufs)
    np.testing.assert_array_equal(bufs["fixed_l_len"].numpy(), jc.FIXED_LITLEN_LENGTHS)
    assert all(b.device.type == "cpu" for b in bufs.values())


def test_import_pulls_in_no_jax():
    code = (
        "import sys; before = set(sys.modules); import deflate_rs_tpu_torch; "
        "import deflate_rs_tpu_torch.ops.chunk_encode; "
        "import deflate_rs_tpu_torch.ops.inflate_device, deflate_rs_tpu_torch.models.inflate; "
        "import deflate_rs_tpu_torch.parallel.mesh, deflate_rs_tpu_torch.parallel.sharded; "
        "import deflate_rs_tpu_torch.tools.dryrun_multichip; "
        "new = [m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 'jaxlib')]; "
        "assert not new, new; assert 'deflate_rs_tpu' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_no_jax_import_in_port_sources():
    root = os.path.join(REPO, "deflate_rs_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax")), (f, s)


def _pg11_4k() -> bytes:
    with open(os.path.join(REPO, "tests", "data", "pg11.txt"), "rb") as f:
        return f.read(4096)


def _equal_jax(data: bytes, t_opts, j_opts):
    import deflate_rs_tpu as dj
    import deflate_rs_tpu_torch as dt

    got = dt.deflate_bytes_conf(data, t_opts, device="cpu")
    assert got == dj.deflate_bytes_conf(data, j_opts), len(data)
    assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("preset", ["high", "fast", "huffman_only", "turbo", "rle"])
def test_non_default_presets_raise(preset):
    """The scope guard once refused these presets.  Each now runs and equals
    JAX on a short input and on a full chunk of the 4 KiB tier."""
    for data in (b"hello hello hello", _pg11_4k()):
        _equal_jax(data, getattr(TOpts, preset)(), getattr(JOpts, preset)())


@pytest.mark.parametrize("special", ["ForceFixed", "ForceStored"])
def test_force_modes_raise(special):
    """The scope guard once refused the force modes.  Each now runs and
    equals JAX at the 4 KiB tier: empty, 1-, 3- and 4-byte inputs (the
    encoder pins fixed codes at n <= 4), text and incompressible bytes."""
    import deflate_rs_tpu as dj
    import deflate_rs_tpu_torch as dt

    rand = np.random.default_rng(8).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    for data in (b"", b"\x7f", b"abc", b"\xff\x00\x90\x91", _pg11_4k(), rand):
        _equal_jax(data, TOpts(special=dt.SpecialOptions[special]),
                   JOpts(special=dj.SpecialOptions[special]))


@pytest.mark.parametrize("knob", [{"lr_global": 64}, {"lr_stride": 2}])
def test_unported_long_range_knobs_raise(knob):
    """The scope guard once refused the two long-range knobs.  Each now runs
    and equals JAX at Default in the 4 KiB tier (on text and on records
    whose claims hit the probe cap); on fast, which runs no long-range pass,
    the knob is inert."""
    import deflate_rs_tpu_torch as dt
    from torch_knob_data import records

    for data in (b"hello hello hello", _pg11_4k(), records(4096, seed=3)):
        _equal_jax(data, TOpts(**knob), JOpts(**knob))
    fast = dataclasses.replace(TOpts.fast(), **knob)
    assert (dt.deflate_bytes_conf(b"hello hello hello", fast, device="cpu")
            == dt.deflate_bytes_conf(b"hello hello hello", TOpts.fast(), device="cpu"))
