"""The arithmetic of the row kernels that take the sort rebuild's ends and
the integrator off the host's launch queue (``csrc/bucket_assign.cu``:
cell keys and placement; ``csrc/integrate.cu``: predictor and corrector),
copied into numpy float32 in the kernels' order of operations and
roundings, against the plain torch chains they replace
(``neighbor.bucket_layout.cell_keys_plain`` and ``place_rows_plain``,
``core.integrate.initial_integrate_plain`` and ``final_integrate_plain``),
bit for bit on the CPU. The kernels themselves run on the card
(tests/test_torch_rebuild_card.py, tests/test_torch_integrate_card.py)."""

import numpy as np
import pytest
import torch

from meso_tpu_torch.core import integrate
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.state import PER_PARTICLE, create_random
from meso_tpu_torch.neighbor import bucket_layout as bl
from meso_tpu_torch.neighbor.cells import CellConfig
from test_torch_imports import one_torch_thread  # noqa: F401

F32 = np.float32


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, what):
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)),
                                  err_msg=what)


def _wrap(x, image, lo, hi):
    """The kernels' wrap: l = hi - lo, shift = floor((x - lo) / l)."""
    l = hi - lo
    shift = np.floor((x - lo) / l).astype(np.int32)
    xw = x - shift.astype(F32) * l
    xw = np.where(xw >= hi, lo, xw)
    return xw.astype(F32), image + shift


def _keys_emulated(x, image, mask, lo, hi, ncell, wrap):
    if wrap:
        x, image = _wrap(x, image, lo, hi)
    n = np.asarray(ncell)
    frac = (x - lo) / (hi - lo)
    c = np.clip((frac * n.astype(F32)).astype(np.int32), 0, n - 1)
    c = c.astype(np.int64)
    nx, ny, nz = ncell
    key = np.where(mask, (c[:, 1] * nz + c[:, 2]) * nx + c[:, 0],
                   nx * ny * nz)
    return x, image, key


def _drifted(l=7.0, rho=3.0, k=16, seed=3):
    """Bucket rows of a random start moved by up to 0.6 (some out of the
    box, some by whole box lengths), with edge rows: on hi, on lo, a hair
    below lo, -0.0, several images out."""
    box = Box.cubic(l)
    n = int(round(rho * l ** 3))
    st = create_random(torch.Generator().manual_seed(seed), n, box)
    cfg = CellConfig.for_box([l] * 3, 1.0, rho, skin=0.4, spill=True,
                             capacity=k, rebuild="sort",
                             wrap_at_rebuild=True)
    bst = bl.rebuild_buckets(st, cfg)[0]
    x = bst.x + torch.clamp(0.3 * bst.v, -0.6, 0.6) * bst.mask[:, None]
    live = torch.nonzero(bst.mask).reshape(-1)[:8]
    edge = torch.tensor([[l, 0.0, -0.0], [0.0, l, 1.0], [-1e-7, 2.0, l],
                         [3 * l + 0.5, -2 * l - 0.25, 0.5], [l - 1e-6,
                         l + 1e-6, -l], [1e-30, -1e-30, 2 * l],
                         [35.0, -0.0, 0.0], [-0.0, -0.0, -0.0]],
                        dtype=torch.float32)
    x[live] = edge
    return bst.replace(x=x), cfg


@pytest.mark.parametrize("wrap", [True, False])
def test_cell_keys_arithmetic_matches_the_plain_chain(wrap):
    bst, cfg = _drifted()
    st_p, key_p = bl.cell_keys_plain(bst, cfg, wrap)
    x, image, key = _keys_emulated(
        bst.x.numpy(), bst.image.numpy(), bst.mask.numpy(),
        bst.box.lo.numpy(), bst.box.hi.numpy(), cfg.ncell, wrap)
    _eq(key, key_p.numpy(), "key")
    _eq(x, st_p.x.numpy(), "x")
    _eq(image, st_p.image.numpy(), "image")
    if wrap:
        assert (bst.x.numpy() != x).any()


def _place_emulated(st, order, target, fits, nr, relief):
    """The kernel's placement: inv[target[i]] = i for the rows that fit,
    -1 elsewhere, then every column gathered through it."""
    order, target, fits = order.numpy(), target.numpy(), fits.numpy()
    inv = np.full(nr, -1, np.int64)
    rows = np.nonzero(fits)[0]
    inv[target[rows]] = rows
    live = inv >= 0
    src = np.where(live, order[np.maximum(inv, 0)], 0)
    out = {}
    for name in PER_PARTICLE:
        a = getattr(st, name)
        if a is None:
            continue
        a = a.numpy()
        out[name] = np.where(live.reshape((-1,) + (1,) * (a.ndim - 1)),
                             a[src], np.zeros((), a.dtype))
    if relief is not None:
        cxs, nx = relief[0].numpy(), relief[1]
        j = np.maximum(inv, 0)
        ws = live & (cxs[j] == nx - 1) & (target[j] % nx == 0)
        lx = st.box.hi.numpy()[0] - st.box.lo.numpy()[0]
        out["x"][:, 0] = out["x"][:, 0] + np.where(ws, -lx, F32(0.0))
        out["image"][:, 0] = out["image"][:, 0] + ws.astype(np.int32)
    return out


@pytest.mark.parametrize("relief", [True, False])
def test_placement_arithmetic_matches_the_plain_chain(relief, monkeypatch):
    """On the arguments the rebuild gives place_rows, rows that do not fit
    and wrap-relief rows among them."""
    bst, cfg = _drifted(k=8, seed=5)
    seen = []
    place = bl.place_rows

    def spy(*a, **kw):
        seen.append(a)
        return place(*a, **kw)

    monkeypatch.setattr(bl, "place_rows", spy)
    bl.rebuild_buckets(bst, cfg)
    st, order, target, fits, nr, rel = seen[0]
    assert rel is not None
    rel = rel if relief else None
    want = bl.place_rows_plain(st, order, target, fits, nr, rel)
    got = _place_emulated(st, order, target, fits, nr, rel)
    for name, a in got.items():
        _eq(a, getattr(want, name).numpy(), name)
    assert not bool(fits[st.mask[order]].all())
    if relief:
        plain = _place_emulated(st, order, target, fits, nr, None)
        assert (got["image"][:, 0] - plain["image"][:, 0] == 1).any()


def _motion(n=4000, seed=9, frozen=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3), generator=g) * 7.0 - 0.5
    v = torch.randn((n, 3), generator=g) * 3.0
    f = torch.randn((n, 3), generator=g) * 400.0
    f2 = torch.randn((n, 3), generator=g) * 400.0
    image = torch.randint(-3, 4, (n, 3), generator=g, dtype=torch.int32)
    move = torch.rand(n, generator=g) > (0.2 if frozen else 0.0)
    return x, v, f, f2, image, move


INV_MASS = {"one": lambda n: torch.tensor([1.0]),
            "per_row": lambda n: torch.tensor([1.0, 0.5, 1.0 / 3.0])[
                torch.arange(n) % 3].contiguous()}


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("masses", list(INV_MASS))
@pytest.mark.parametrize("dt,lam", [(0.01, 0.65), (0.005, 0.5)])
def test_integrator_arithmetic_matches_the_plain_chain(wrap, masses, dt,
                                                       lam):
    x, v, f, f2, image, move = _motion()
    box = Box.cubic(6.0)
    im = INV_MASS[masses](x.shape[0])
    xn, imn, vt = integrate.initial_integrate_plain(x, v, f, image, box, dt,
                                                    lam, im, move, wrap)
    v1 = integrate.final_integrate_plain(v, f, f2, dt, im, move)
    a = f.numpy() * im.numpy()[:, None]
    m = move.numpy()[:, None]
    vt_e = np.where(m, v.numpy() + F32(lam * dt) * a, v.numpy())
    xn_e = np.where(m, (x.numpy() + F32(dt) * v.numpy())
                    + F32(0.5 * dt * dt) * a, x.numpy())
    im_e = image.numpy()
    if wrap:
        xn_e, im_e = _wrap(xn_e, im_e, box.lo.numpy(), box.hi.numpy())
    a2 = (f.numpy() + f2.numpy()) * im.numpy()[:, None]
    v1_e = np.where(m, v.numpy() + F32(0.5 * dt) * a2, v.numpy())
    _eq(vt_e, vt.numpy(), "v_tilde")
    _eq(xn_e, xn.numpy(), "x")
    _eq(im_e, imn.numpy(), "image")
    _eq(v1_e, v1.numpy(), "v")
    # the dispatcher takes the plain chain off the card
    got = integrate.initial_integrate(x, v, f, image, box, dt, lam, im,
                                      move, wrap)
    assert all(torch.equal(p, q) for p, q in zip(got, (xn, imn, vt)))
    assert torch.equal(integrate.final_integrate(v, f, f2, dt, im, move),
                       v1)


def test_max_displacement_arithmetic_matches_the_plain_chain():
    """The kernel's d - round(d / l) l, (dx dx + dy dy) + dz dz and maximum
    over the valid rows, with rows moved across the box's edges."""
    from meso_tpu_torch.neighbor.cells import max_displacement_sq_plain
    x, v, _, _, _, move = _motion(seed=13)
    box = Box.cubic(6.0)
    x_ref = x + 0.05 * v
    x_ref[:40] += torch.tensor([6.0, -6.0, 12.0])   # whole images away
    x_ref[40:80] = x[40:80] + 2.999                 # near half a box
    want = max_displacement_sq_plain(x, x_ref, move, box)
    l = (box.hi - box.lo).numpy()
    dr = x.numpy() - x_ref.numpy()
    d = dr - np.rint(dr / l) * l
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    got = np.max(np.where(move.numpy(), d2, F32(0.0)))
    _eq(np.asarray(got, F32), want.numpy(), "max d2")
    # the dispatcher takes the plain chain off the card
    from meso_tpu_torch.neighbor.cells import max_displacement_sq
    assert torch.equal(max_displacement_sq(x, x_ref, move, box), want)
