"""The JAX side of ``tests/test_torch_field_cases.py``: the Pallas
token-field kernel in interpret mode on stacked rows of one shape.

Lowering the interpreted kernel costs seconds for every new shape and
holds the interpreter's lock, so the test hands the shapes to a few spawned
processes; each imports this module afresh and keeps JAX on the CPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402


def pallas_fields(operands: tuple) -> tuple:
    """``token_fields_batched(*operands, interpret=True)`` as numpy arrays."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from deflate_rs_tpu.ops.field_kernel import token_fields_batched

    outs = token_fields_batched(*(jnp.asarray(a) for a in operands), interpret=True)
    return tuple(np.asarray(o) for o in outs)
