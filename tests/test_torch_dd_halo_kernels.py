"""The port's halo kernels on the distributed path, K4
(``halo_forces_pallas_fused``) and K6-halo (``halo_forces_pallas_1d``),
against the JAX package's kernels run in interpret mode outside
``shard_map`` (``vma=()``), on the same halo-extended channel planes.

The planes are cut from a global bucket state made with numpy from a seed
and placed by the port: target cells starting at cell 0 on every extended
axis, with halo layers taken across the periodic boundary and their
coordinates pre-shifted by a box length, as the ring exchange hands them
over (``meso_tpu/parallel/domain.py:301-302``). The port's entry points run
their plain version here (CPU tensors); chip_smoke.py holds the CUDA kernel
against that plain version on the card. Cases: K4 on strict buckets with
ext=("x",) and one type (TEA); K4 on spill buckets with ext=("x", "y", "z"),
two types and special-bonds exclusions (fast RNG); K6-halo, strict, fast,
with the hash plane "h" as the JAX package makes it. The eDPD and tDPD
forms of K4 are in tests/test_torch_dd_halo_model.py.

Bounds: the v3 kernel gate (tests/unit/test_pallas_v3.py:40-59): max force
error 2e-5 relative to max |f|, relative virial error 1e-4, pad rows
exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meso_tpu.core import rng as j_rng
from meso_tpu.core.box import Box as JBox
from meso_tpu.kernels.pair_dpd import halo_forces_pallas_1d as j_halo_1d
from meso_tpu.kernels.pair_dpd_fused import \
    halo_forces_pallas_fused as j_halo_fused
from meso_tpu.neighbor.cells import CellConfig as JCellConfig
from meso_tpu.ops.dpd import DPDParams as JDPDParams
from meso_tpu.ops.dpd import build_exclusions as j_build_exclusions
from meso_tpu_torch import bridge
from meso_tpu_torch.kernels.pair_dpd import halo_forces_pallas_1d
from meso_tpu_torch.kernels.pair_dpd_fused import halo_forces_pallas_fused
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.sweep import make_channels
from test_torch_imports import one_torch_thread  # noqa: F401

STEP = 42
SIDE, SKIN, DENSITY = 1.3, 0.3, 2.0
GRID = (8, 5, 5)          # the global cells; targets are 3 x 3 x 3 cells
TARGETS = (3, 3, 3)


def halo_case(spill, ext, seed, n_types=1, t=False, ns=0):
    """Halo-extended planes cut from a global bucket state: returns (port
    planes, the target CellConfig of the port, of JAX, the global box's
    lengths, the valid rows of the targets). Integer planes are int32,
    "valid" float32; with ``t`` a "T" plane, with ``ns`` planes C0.."""
    lens = np.asarray(GRID, float) * SIDE
    n = int(DENSITY * np.prod(lens))
    rs = np.random.RandomState(seed)
    x = (rs.uniform(0.0, 1.0, (n, 3)) * lens).astype(np.float32)
    tag = np.arange(1, n + 1, dtype=np.int32)
    src = dict(x=x, v=rs.normal(0.0, 1.0, (n, 3)).astype(np.float32),
               f=np.zeros((n, 3), np.float32), typ=tag % n_types, tag=tag,
               image=np.zeros((n, 3), np.int32), mask=np.ones(n, bool),
               mol=np.zeros(n, np.int32), lo=np.zeros(3, np.float32),
               hi=lens.astype(np.float32), step=0)
    cap = 12 if spill else 20
    cfg = CellConfig(ncell=GRID, capacity=cap, skin=SKIN, spill=spill)
    bst = to_bucket_state(bridge.state_from(src), cfg)
    drift = (0.04 * bst.v).clamp(-SKIN / 2, SKIN / 2) * bst.mask[:, None]
    bst = bst.replace(x=bst.box.wrap(bst.x + drift)[0])
    extra = {}
    if t:
        extra["T"] = torch.where(bst.mask, 1.0 + 0.3 * torch.sin(bst.x[:, 0]),
                                 0.0)
    for s in range(ns):
        extra[f"C{s}"] = torch.where(
            bst.mask, 1.0 + 0.1 * s + 0.5 * torch.cos(bst.x[:, 0] + s), 0.0)
    ch = make_channels(bst.x, bst.v, bst.tag, bst.mask, None, extra, GRID,
                       cap)
    ch["typ"] = bst.typ.reshape(ch["tag"].shape)
    xr = 2 if spill else 1
    # plane axes (y, z, K, x); the extended ones are cut out with their
    # halo layers across the boundary, coordinates shifted by -L there
    cut = {}
    for axis, dim, name, wide in ((0, 1, "y", 1), (1, 2, "z", 1),
                                  (3, 0, "x", xr)):
        if name in ext:
            idx = torch.arange(-wide, TARGETS[dim] + wide)
            cut[axis] = (idx % GRID[dim], idx < 0, name)
    planes = {}
    for key, p in ch.items():
        for pa, (idx, wrapped, name) in cut.items():
            p = p.index_select(pa, idx)
            if key == name:
                shape = [1] * 4
                shape[pa] = -1
                p = p - float(lens["xyz".index(name)]) * \
                    wrapped.reshape(shape).to(p.dtype)
        planes[key] = p.contiguous()
    tcells = tuple(TARGETS[d] if "xyz"[d] in ext else GRID[d]
                   for d in range(3))
    tcfg = CellConfig(ncell=tcells, capacity=cap, skin=SKIN, spill=spill)
    jcfg = JCellConfig(ncell=tcells, capacity=cap, skin=SKIN, spill=spill)
    ny, nz, k, nx = tcells[1], tcells[2], cap, tcells[0]
    oy, oz = int("y" in ext), int("z" in ext)
    valid = planes["valid"][oy:oy + ny, oz:oz + nz, :, xr:xr + nx] > 0
    return planes, tcfg, jcfg, lens, valid.reshape(-1).numpy()


def jax_planes(planes):
    return {k: jnp.asarray(v.numpy()) for k, v in planes.items()}


def with_jax_hash(planes, seed, rng_mode="fast"):
    """(JAX's planes, the port's): in the fast tier the port's carry the
    per-particle hash plane "h" that the distributed step ships with the
    halo, made by the JAX package's own particle_hash of the tag plane."""
    jpl = jax_planes(planes)
    if rng_mode == "fast":
        h = j_rng.particle_hash(jnp.asarray(planes["tag"].numpy()),
                                jnp.int32(STEP), seed, rounds=8)
        planes = {**planes,
                  "h": torch.from_numpy(np.asarray(h).astype(np.int64))}
    return jpl, planes


def classic_params(n_types, excl_n=0):
    """One type, or two (a_01 1.4 a, a_11 2 a, rc_01 0.8) with exclusions
    along random chains of the first ``excl_n`` tags at weight 0.25."""
    p = JDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77,
                         n_types=n_types)
    if n_types > 1:
        p = p.replace(a=p.a * jnp.asarray([[1.0, 1.4], [1.2, 2.0]]),
                      rc=p.rc * jnp.asarray([[1.0, 0.8], [0.8, 1.0]]))
    if excl_n:
        perm = np.random.RandomState(0).permutation(excl_n) + 1
        bonds = np.asarray([(perm[i], perm[i + 1]) for i in range(excl_n - 1)
                            if (i + 1) % 8], np.int32)
        ex, w = j_build_exclusions(bonds, excl_n, weight=0.25, max_excl=2)
        p = p.replace(excl=ex, excl_w=w)
    return p


def assert_kernel_gate(valid, got, want):
    """Max force error 2e-5 of max |f|, virial 1e-4, pad rows exactly 0."""
    (f_t, vir_t), (f_j, vir_j) = got, want
    fp, fj = np.asarray(f_t), np.asarray(f_j)
    assert fp.shape == fj.shape == (valid.size, 3)
    assert np.isfinite(fp).all()
    assert np.abs(fp[valid] - fj[valid]).max() / np.abs(fj).max() < 2e-5
    assert (~valid).any() and np.abs(fp[~valid]).max() == 0.0
    assert abs(float(vir_t) - float(vir_j)) / abs(float(vir_j)) < 1e-4


@pytest.mark.parametrize("spill,ext,rng_mode,n_types", [
    (False, ("x",), "tea", 1), (True, ("x", "y", "z"), "fast", 2)],
    ids=["strict-x-tea-1type", "spill-xyz-fast-2types-excl"])
def test_k4_plain_matches_jax_interpret(spill, ext, rng_mode, n_types):
    planes, tcfg, jcfg, lens, valid = halo_case(spill, ext, 5, n_types)
    n_all = int(DENSITY * np.prod(lens))
    jp = classic_params(n_types, excl_n=n_all if n_types > 1 else 0)
    n_excl = 0
    if jp.excl is not None:
        n_excl = jp.excl.shape[1]
        ex = torch.from_numpy(np.array(jp.excl))[planes["tag"].long()]
        for e in range(n_excl):
            planes[f"EX{e}"] = ex[..., e].contiguous()
    kw = dict(ext=ext, rng_mode=rng_mode, n_types=n_types, n_excl=n_excl)
    jpl, planes = with_jax_hash(planes, jp.seed, rng_mode)
    want = j_halo_fused(jpl, JBox.orthorhombic(*lens),
                        jnp.int32(STEP), jp, 0.01, jcfg, interpret=True,
                        vma=(), **kw)
    got = halo_forces_pallas_fused(
        planes, bridge.box_from({"lo": np.zeros(3), "hi": lens}), STEP,
        bridge.dpd_params_from(jp), 0.01, tcfg, **kw)
    assert_kernel_gate(valid, got, want)


def test_k6_halo_plain_matches_jax_interpret():
    planes, tcfg, jcfg, lens, valid = halo_case(False, ("x",), 9)
    jp = classic_params(1)
    h = j_rng.particle_hash(jnp.asarray(planes["tag"].numpy()),
                            jnp.int32(STEP), jp.seed, rounds=8)
    jpl = jax_planes(planes)
    jpl["h"] = h
    planes["h"] = torch.from_numpy(np.asarray(h).astype(np.int64))
    want = j_halo_1d(jpl, JBox.orthorhombic(*lens), jnp.int32(STEP), jp,
                     0.01, jcfg, rng_mode="fast", interpret=True, vma=())
    got = halo_forces_pallas_1d(
        planes, bridge.box_from({"lo": np.zeros(3), "hi": lens}), STEP,
        bridge.dpd_params_from(jp), 0.01, tcfg, rng_mode="fast")
    assert_kernel_gate(valid, got, want)


def test_halo_entry_points_check_their_inputs():
    """Counts that disagree with the parameters, a plane of the wrong
    shape, an x window with no target column and, in the fast RNG tier,
    planes with no hash plane "h" are refused."""
    planes, tcfg, _, lens, _ = halo_case(False, ("x",), 9)
    box = bridge.box_from({"lo": np.zeros(3), "hi": lens})
    p = bridge.dpd_params_from(classic_params(1))
    with pytest.raises(ValueError, match="n_types"):
        halo_forces_pallas_fused(planes, box, STEP, p, 0.01, tcfg, n_types=2)
    with pytest.raises(ValueError, match="shape"):
        halo_forces_pallas_fused(planes, box, STEP, p, 0.01, tcfg,
                                 ext=("x", "y"))
    with pytest.raises(ValueError, match="target"):
        halo_forces_pallas_fused(planes, box, STEP, p, 0.01,
                                 tcfg.replace(ncell=(0, 5, 5)))
    with pytest.raises(ValueError, match="hash plane"):
        halo_forces_pallas_fused(planes, box, STEP, p, 0.01, tcfg)
