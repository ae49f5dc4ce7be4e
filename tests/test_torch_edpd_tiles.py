"""K2 (``pair_edpd_v3_kernel``) on K1's cell tiles, held on the CPU. The
kernel runs only on the card (chip_smoke.py holds it against its plain
version there); what decides which pairs it takes is the bucket-row walk
over K1's ``tile_table`` and the eDPD visitor's cutoff tests, the same walk
K1's general variant and K3 run. The numpy copy of that walk
(``test_torch_general_tiles._walk``) must take exactly
``bucket_forces_v3_edpd_plain``'s pairs, and the force and heat the
visitor sums over them in walk order (``ops.edpd.edpd_pair``, the row's
own q(i <- j)) must be the plain version's f and dT/dt. Also: the C entry
points' argument lists against the ctypes signatures the wrappers call
them through (``kernels._build.SIGNATURES``), which only the card could
otherwise show."""

import math
import re

import numpy as np
import pytest
import torch

from meso_tpu_torch.core import rng as rngmod
from meso_tpu_torch.kernels import _build, cell_tiles
from meso_tpu_torch.kernels.pair_dpd_v3 import bucket_forces_v3_edpd_plain
from meso_tpu_torch.ops import edpd as edpdmod
from meso_tpu_torch.ops.edpd import EDPDParams
from test_torch_general_tiles import (F32, _bucket_case, _check_pairs,
                                      _ragged)
from test_torch_imports import one_torch_thread  # noqa: F401

STEP, DT = 12, 0.01


def _params(n_types):
    """The kernel checks' eDPD coefficients; two types with rc_01 = 0.8
    below rc = 1, an asymmetric a and kappa table."""
    if n_types == 1:
        return EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.5,
                                cv=10.0, seed=7)
    return EDPDParams.build(a=[[25.0, 35.0], [30.0, 40.0]],
                            rc=[[1.0, 0.8], [0.8, 1.0]], gamma=4.5,
                            kappa=[[1.5, 1.0], [1.2, 0.5]], cv=10.0, seed=7,
                            n_types=2)


def _walk_sums(bst, cfg, p, params):
    """The walk's pairs (checked against the plain version's) and the
    force and dT/dt the eDPD visitor sums over them in walk order."""
    rows, srcs, dr, _, _, _ = _check_pairs(bst, cfg, p, params)
    t = torch.where(bst.mask, 1.0 + 0.3 * torch.sin(bst.x[:, 0]), 0.0)
    ri, sj = torch.from_numpy(rows), torch.from_numpy(srcs)
    tag = bst.tag
    h = rngmod.particle_hash(tag, STEP, params.seed)
    theta, zeta = edpdmod.noises_from_hash(
        rngmod.combine_symmetric(h[ri], h[sj]), tag[ri], tag[sj])
    nt = params.n_types
    pr = (bst.typ[ri].long() % nt) * nt + bst.typ[sj].long() % nt
    tabs = [getattr(params, n).reshape(-1)[pr]
            for n in ("a", "gamma", "rc", "kappa")]
    f_p, q_p, _ = edpdmod.edpd_pair(
        torch.from_numpy(dr.T.copy()), bst.v[ri] - bst.v[sj], t[ri], t[sj],
        theta, zeta, *tabs, params.mass, 1.0 / math.sqrt(DT))
    nr = bst.x.shape[0]
    f = torch.zeros((nr, 3)).index_add_(0, ri, f_p)
    q = torch.zeros((nr,)).index_add_(0, ri, q_p) / params.cv
    want_f, want_q, _ = bucket_forces_v3_edpd_plain(
        bst.x, bst.v, t, tag, bst.mask, bst.box, STEP, params, DT, cfg,
        typ=bst.typ)
    return rows, (f, q), (want_f, want_q)


@pytest.mark.parametrize("n_types", [1, 2])
@pytest.mark.parametrize("min_image", [False, True])
@pytest.mark.parametrize("spill", [True, False])
def test_edpd_walk_takes_the_plain_pairs(spill, min_image, n_types):
    """One type and two (rc_01 = 0.8), spill and strict, both wrap modes,
    ragged runs of cx, a box 5.6 wide on two axes (raw differences wrap
    within the walk's reach): the walk over K2's plan and table takes
    exactly the plain version's pairs, and the force and heat summed over
    them in walk order are its f and dT/dt."""
    bst, cfg = _bucket_case(spill, min_image)
    params = _params(n_types)
    p = _ragged(cell_tiles.plan(cfg.capacity, 2 if spill else 1, cfg.ncell))
    assert cfg.ncell[0] % p.width and cfg.ncell[1:] == (4, 4)
    _, got, want = _walk_sums(bst, cfg, p, params)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("min_image", [False, True])
def test_edpd_walk_at_k128(min_image):
    """A rho 9 fluid at a capacity of 128 spill (one block an SM, rows with
    more partners than a list holds: the list is evaluated and the walk
    goes on), two types: the same pairs, the same sums."""
    bst, cfg = _bucket_case(True, min_image, l=(7.0, 4.2, 4.2), n=1111,
                            capacity=128)
    p = cell_tiles.plan(cfg.capacity, 2, cfg.ncell)
    assert p.blocks_per_sm() == 1
    rows, got, want = _walk_sums(bst, cfg, p, _params(2))
    assert np.bincount(rows).max() > cell_tiles.LIST_CAP
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,xr", [(238, 2), (397, 1)])
def test_k2_plan_refuses_what_the_tiles_cannot_take(k, xr):
    """K2 takes K1's plan: above 237 slots (spill) or 396 (strict) no tile
    fits a block, and the plan raises rather than fall back to another
    walk."""
    with pytest.raises(ValueError, match=str(k)):
        cell_tiles.plan(k, xr, (50, 50, 50))
    cell_tiles.plan(k - 1, xr, (50, 50, 50))


# C parameter types -> the ctypes types of _build.SIGNATURES
_CTYPES = {"const void*": _build._P, "void*": _build._P, "int": _build._I,
           "float": _build._F, "uint32_t": _build._U}


def _c_entry_points():
    """{name: [parameter type, ...]} of every extern "C" function of the
    CUDA sources."""
    out = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [" ".join(a.split()) for a in m.group(2).split(",")]
            out[m.group(1)] = [re.sub(r"\s*\w+$", "", a) for a in params]
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entry_point_matches_its_ctypes_signature(name):
    """Each entry point the wrappers call has the parameters, in number and
    type, that ctypes passes (a pointer cut to an int, or a float passed
    as an int, would show only as wrong results on the card)."""
    c_params = _c_entry_points()[name]
    assert [_CTYPES[t] for t in c_params] == list(_build.SIGNATURES[name])


def test_every_c_entry_point_has_a_signature():
    assert set(_c_entry_points()) == set(_build.SIGNATURES)
