"""The port's neighbour-list forces (``ops.dpd.nlist_forces``) against the
JAX package's on the same state and the same lists (carried across by the
bridge), and against the port's dense oracle, at the v3 gate of
tests/unit/test_pallas_v3.py:40-59: max relative force error 2e-5,
relative virial error 1e-4, pad rows exactly 0. Both RNG tiers; one type,
and two types with s_exp 0.5 and special-bonds exclusions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core.box import Box as JBox
from meso_tpu.core.state import create_random as j_create_random
from meso_tpu.neighbor import cells as jcells
from meso_tpu.neighbor import nlist as jnlist
from meso_tpu.ops import dpd as jdpd
from meso_tpu_torch import bridge
from meso_tpu_torch.ops import dpd as tdpd
from test_torch_imports import one_torch_thread  # noqa: F401

L, N, N_PAD, STEP, DT = 6.0, 648, 20, 42, 0.01
j_build_cells = jax.jit(jcells.build_cells, static_argnames="cfg")
j_build_nlist = jax.jit(jnlist.build_nlist,
                        static_argnames=("cfg", "rc_max", "m_cap", "block"))
j_nlist_forces = jax.jit(jdpd.nlist_forces,
                         static_argnames=("dt", "rng_mode", "rng_rounds"))


def _params(general: bool):
    """One type; or two types (asymmetric a, rc_01 = 0.8), s_exp 0.5 and
    exclusions of each tag's two chain neighbours at weight 0.25."""
    if not general:
        return jdpd.DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                    seed=77)
    p = jdpd.DPDParams.build(a=[[25.0, 35.0], [35.0, 40.0]], gamma=4.5,
                             rc=[[1.0, 0.8], [0.8, 1.0]], kt=1.0, seed=77,
                             n_types=2, s_exp=0.5)
    bonds = np.stack([np.arange(1, N), np.arange(2, N + 1)], 1)
    excl, w = jdpd.build_exclusions(bonds, N, weight=0.25)
    return p.replace(excl=excl, excl_w=w)


def _case(general: bool):
    box = JBox.cubic(L)
    st = j_create_random(jax.random.PRNGKey(3), N, box)
    mask = np.arange(N) < N - N_PAD
    typ = (np.arange(N) % 3 == 0).astype(np.int32) if general \
        else np.zeros(N, np.int32)
    st = st.replace(mask=jnp.asarray(mask), typ=jnp.asarray(typ))
    cfg = jcells.CellConfig.for_box([L] * 3, 1.0, 3.0, skin=0.3)
    st, cells = j_build_cells(st, cfg)
    m = jnlist.neighbor_capacity(3.0, 1.0, 0.3)
    nl = j_build_nlist(st.x, st.mask, st.box, cells, cfg, 1.0, m)
    assert int(nl.overflow) == 0 and int(cells.overflow) == 0
    return st, nl, _params(general)


def _gate(f, vir, f_ref, vir_ref, mask, what):
    f, f_ref = np.asarray(f), np.asarray(f_ref)
    scale = np.abs(f_ref[mask]).max()
    rel = np.abs(f[mask] - f_ref[mask]).max() / scale
    assert rel < 2e-5, (what, rel)
    assert np.abs(f[~mask]).max() == 0.0, what
    vrel = abs(float(vir) - float(vir_ref)) / abs(float(vir_ref))
    assert vrel < 1e-4, (what, vrel)


@pytest.mark.parametrize("general", [False, True], ids=["one-type",
                                                        "two-types-sexp-excl"])
@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
def test_nlist_forces_match_jax_and_dense(rng_mode, general):
    jst, jnl, jp = _case(general)
    f_j, vir_j = j_nlist_forces(jst.x, jst.v, jst.typ, jst.tag, jst.mask,
                                jst.box, jnp.int32(STEP), jp, DT, jnl.idx,
                                rng_mode=rng_mode)
    st = bridge.state_from(jst, device="cpu")
    p = bridge.dpd_params_from(jp, device="cpu")
    idx = bridge.neighbor_list_from(jnl, device="cpu").idx
    f_t, vir_t = tdpd.nlist_forces(st.x, st.v, st.typ, st.tag, st.mask,
                                   st.box, STEP, p, DT, idx,
                                   rng_mode=rng_mode)
    mask = np.asarray(jst.mask)
    _gate(f_t.numpy(), vir_t, f_j, vir_j, mask, "against JAX")
    f_d, vir_d, _ = tdpd.dense_forces(st.x, st.v, st.typ, st.tag, st.mask,
                                      st.box, STEP, p, DT, rng_mode=rng_mode)
    _gate(f_t.numpy(), vir_t, f_d.numpy(), vir_d, mask,
          "against the dense oracle")
