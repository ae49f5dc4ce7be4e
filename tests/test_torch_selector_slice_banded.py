"""The banded selector (``force_path="pallas_banded"``, K6 and K7) as a
whole, against the JAX package's own chunk on the same selector.

For each model a JAX builder state (classic_fluid, edpd_slab,
tdpd_diffusion at l=6, strict buckets, forces from the dense set-up) is
carried across by the bridge, and one chunk of ``run_bucket_chunked``
(rebuild + 2 steps) runs in both packages: JAX's own
``run_bucket_chunked`` with its banded Pallas kernels interpreted on the CPU
(their ``interpret`` argument set, which JAX's dispatch leaves at False),
the port's with the plain version of its kernel. The fused selector's chunk
is tests/test_torch_selector_slice.py, whose start and comparison this file
shares.

Bounds are those of the port's slice tests (tests/test_torch_slice.py,
tests/test_torch_transport_slice.py): tags bitwise after the chunk, forces
and dT/dt or dC/dt within 1e-4 of their scale, v within 1e-4, x within
1e-5, T or C within 1e-5, pad rows exactly 0, overflow 0 in both."""

import functools

import pytest

from meso_tpu.kernels import pair_dpd as j_pair_dpd
from meso_tpu.kernels import pair_multiphysics as j_pair_multiphysics
from test_torch_selector_slice import check_chunk, jax_start
from test_torch_imports import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("model", ["dpd", "edpd", "tdpd"])
def test_banded_chunk_matches_jax(monkeypatch, model):
    for mod, name in ((j_pair_dpd, "bucket_forces_pallas"),
                      (j_pair_multiphysics, "bucket_forces_pallas_edpd"),
                      (j_pair_multiphysics, "bucket_forces_pallas_tdpd")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))
    check_chunk(model, *jax_start(model, "pallas_banded", "v3", l=6.0,
                                  spill=False))
