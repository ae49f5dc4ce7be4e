"""K6 on one card (``kernels/pair_dpd.py::bucket_forces_pallas``), which
reads the strict bucket rows in place, against the brick kernel it
replaced on that path (``_brick.launch("dpd", "pair_banded_dpd", ...)``:
the padded brick, then ``pair_brick_kernel``) on the same rows: f and the
virial bitwise equal. Layouts: the strict cell's (1,029,000 particles at
L = 70: 50^3 cells, K = 28, 3,500,000 rows) and two small strict grids, one
sparse whose capacity is its fullest cell's count (empty and full rows),
one dense (rho 9 at K 192: lists that overflow, one block an SM). Both
RNG tiers, one type and the general case (two types with asymmetric
tables, s_exp 0.5, chain exclusions at weight 0.25). Rows moved since the
rebuild and box-wrapped, so some sit across the boundary from their cells.
And the counters: a strict step builds no brick and launches K6 once,
while K6-halo still builds one brick a call (and, over planes extended by
the periodic copy, gives K6's forces bitwise). Run it on a machine with a
CUDA device:
``python -m pytest tests/test_torch_k6_rows_card.py -m card``; without one
it skips."""

import functools

import numpy as np
import pytest
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import create_random
from meso_tpu_torch.core.system import make_step
from meso_tpu_torch.kernels import _brick, _build, pair_dpd
from meso_tpu_torch.kernels import pair_dpd_v3 as v3
from meso_tpu_torch.models.classic import classic_fluid
from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
from meso_tpu_torch.neighbor.cells import CellConfig
from meso_tpu_torch.ops.dpd import DPDParams, build_exclusions
from meso_tpu_torch.ops.sweep import make_channels
from test_torch_imports import one_torch_thread  # noqa: F401

STEP, DT, SKIN = 42, 0.01, 0.4
# (box length, density, capacity: None from the density, "full" the
# fullest cell's count; 192 takes one block an SM)
LAYOUTS = {"l70": (70.0, 3.0, None), "sparse-full": (8.0, 0.5, "full"),
           "dense": (8.0, 9.0, 192)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def strict_rows(l, rho, capacity, seed=3):
    """Strict bucket rows on the card that moved by <= skin/2 since the
    rebuild and were box-wrapped; types alternate by tag."""
    box = Box.cubic(l, device="cuda")
    n = int(round(rho * l ** 3))
    st = create_random(torch.Generator(device="cuda").manual_seed(seed), n,
                       box)

    def rows(k):
        cfg = CellConfig.for_box([l] * 3, 1.0, rho, skin=SKIN, spill=False,
                                 wrap_at_rebuild=False, capacity=k)
        return to_bucket_state(st, cfg), cfg

    bst, cfg = rows(64 if capacity == "full" else capacity)
    if capacity == "full":
        nx, ny, nz = cfg.ncell
        occ = bst.mask.reshape(ny, nz, 64, nx).sum(2)
        bst, cfg = rows(int(occ.max()))
        assert int(occ.min()) == 0
    x = bst.x + torch.clamp(0.04 * bst.v, -SKIN / 2, SKIN / 2) \
        * bst.mask[:, None]
    return bst.replace(x=box.wrap(x)[0],
                       typ=(bst.tag % 2).to(torch.int32)), cfg


@functools.lru_cache(maxsize=8)
def pair_params(kind, n):
    """One type, or the general case: two types, s_exp 0.5, exclusions of
    chains of 8 tags at weight 0.25."""
    if kind == "one":
        return DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77,
                               device="cuda")
    p = DPDParams.build(a=[[25.0, 35.0], [30.0, 50.0]], gamma=4.5,
                        rc=[[1.0, 0.8], [0.8, 1.0]], kt=1.0, seed=77,
                        n_types=2, s_exp=0.5, device="cuda")
    tags = np.arange(1, n + 1, dtype=np.int32)
    bonds = np.stack([tags[:-1], tags[1:]], 1)[tags[:-1] % 8 != 0]
    ex, w = build_exclusions(bonds, n, weight=0.25, max_excl=2,
                             device="cuda")
    return p.replace(excl=ex, excl_w=w)


@pytest.fixture(scope="module")
def layouts(card):
    return {name: strict_rows(*spec) for name, spec in LAYOUTS.items()}


@pytest.mark.card
@pytest.mark.parametrize("kind", ["one", "general"])
@pytest.mark.parametrize("rng_mode", ["fast", "tea"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_k6_rows_bitwise_the_brick_launch(layouts, layout, rng_mode, kind):
    bst, cfg = layouts[layout]
    if layout == "l70":
        assert cfg.ncell == (50, 50, 50) and cfg.capacity == 28
        assert bst.n == 3_500_000
    n = int(bst.mask.sum())
    p = pair_params(kind, int(bst.tag.max()))
    args = (bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, STEP, p, DT,
            cfg)
    f, vir = pair_dpd.bucket_forces_pallas(*args, rng_mode=rng_mode)
    f_b, _, vir_b = _brick.launch("dpd", "pair_banded_dpd", bst.x, bst.v,
                                  None, bst.typ, bst.tag, bst.mask, bst.box,
                                  STEP, p, DT, cfg, rng_mode, 8)
    torch.cuda.synchronize()
    assert n > 0 and bool(torch.isfinite(f).all())
    assert bool((f[bst.mask] != 0).any())
    assert bool((f[~bst.mask] == 0).all())
    assert torch.equal(f, f_b)
    assert torch.equal(vir, vir_b)


@pytest.mark.card
def test_strict_step_builds_no_brick(card):
    """A strict step: no brick, one K6 launch; K6-halo over the same rows'
    planes, extended by one periodic column a side: one brick a call, and
    K6's forces bitwise."""
    system, params, state = classic_fluid(
        l=8.0, rng_mode="fast", force_path="pallas_banded", rebuild="sort",
        wrap_mode="step", skin=SKIN, rebuild_every=3, device="cuda")
    cfg = system.cells
    assert not cfg.spill
    _build.reset_launch_counts()
    _brick.BUILDS.clear()
    state = make_step(system)(params, state)
    torch.cuda.synchronize()
    assert all(n == 0 for n in _brick.BUILDS.values())
    assert _build.LAUNCHES["pair_banded_dpd"] == 1

    pair = params.pair
    h = v3.launch_hash(state.tag, STEP, pair.seed, 8)
    ch = make_channels(state.x, state.v, state.tag, state.mask, h, {},
                       cfg.ncell, cfg.capacity)
    planes = {k: torch.cat([t[..., -1:], t, t[..., :1]], -1)
              for k, t in ch.items()}
    f_rows, vir_rows = pair_dpd.bucket_forces_pallas(
        state.x, state.v, state.typ, state.tag, state.mask, state.box, STEP,
        pair, system.dt, cfg)
    for call in (1, 2):
        f_halo, vir_halo = pair_dpd.halo_forces_pallas_1d(
            planes, state.box, STEP, pair, system.dt, cfg)
        torch.cuda.synchronize()
        assert _brick.BUILDS["pair_halo_banded_dpd"] == call
        assert _build.LAUNCHES["pair_halo_banded_dpd"] == call
    assert _brick.BUILDS["pair_banded_dpd"] == 0
    assert _build.LAUNCHES["pair_banded_dpd"] == 2
    assert torch.equal(f_rows, f_halo) and torch.equal(vir_rows, vir_halo)
