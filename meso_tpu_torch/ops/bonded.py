"""Bonded forces — FENE polymers and triangulated membranes (port of
``meso_tpu/ops/bonded.py``).

* Topology lives in tag space, so it survives the bucket resort: a
  tag -> row map is rebuilt at every force call (one scatter).
* Pair bonds (FENE, harmonic, WLC-POW) are closed-form forces. On a CUDA
  tensor they are one kernel pair of ``csrc/bonds.cu`` (the tag -> row
  scatter, then a thread a row summing its own bonds in the order of the
  bond list from a per-tag partner table, ``partner_table``, built once
  with the topology): two launches a force call, no atomics on f, the same
  bits from run to run. On a CPU tensor they are the plain torch chain
  (``_bonded_plain``): gathered per bond end and added into rows with
  ``index_add_``. Any other device raises.
* Angles, hinge bending and the membrane's area and volume terms are one
  scalar energy, differentiated with ``torch.autograd.grad`` as the JAX
  package differentiates it with ``jax.grad``, on every device. The
  gradient is taken outside any ``torch.inference_mode()`` or ``no_grad``
  of the caller, on a copy of x, so no graph rides the state.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _build
from meso_tpu_torch.ops.dpd import sqrt32

# Calls of the pair-bond kernels (the tag -> row scatter and the row
# kernel, two launches a call), raised by one at each call and nowhere
# else (parallel/launch.py::counted_launches reads them).
LAUNCHES = {"pair_bonds": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclass(frozen=True)
class BondedParams:
    """Topology and coefficients, as tensors on the simulation device.
    Indices are 1-based tags; a bond whose first tag is 0 is padding."""

    bond_tags: torch.Tensor            # (NB, 2) int32
    bond_type: torch.Tensor            # (NB,) int32 -> coefficient row
    bond_coeffs: torch.Tensor          # (n_btypes, 4): FENE (K, R0, eps,
    #                                    sigma), harmonic (K, r0, 0, 0) or
    #                                    WLC-POW (kT/p, l_max, k_p, m)
    angle_tags: Optional[torch.Tensor] = None    # (NA, 3) int32
    angle_coeffs: Optional[torch.Tensor] = None  # (n_atypes, 2): k, theta0
    angle_type: Optional[torch.Tensor] = None
    tri_tags: Optional[torch.Tensor] = None      # (NT, 3) int32
    tri_mol: Optional[torch.Tensor] = None       # (NT,) molecule id, 0-based
    membrane: Optional[torch.Tensor] = None      # (n_mols, 6): ka_g, A0, kv,
    #                                              V0, ka_local, unused
    tri_a0: Optional[torch.Tensor] = None        # (NT,) rest areas
    hinge_tags: Optional[torch.Tensor] = None    # (NH, 4) int32 (a, b, c, d)
    hinge_coeffs: Optional[torch.Tensor] = None  # (NH, 2): kb, theta0

    def replace(self, **kw) -> "BondedParams":
        return dataclasses.replace(self, **kw)

    @functools.cached_property
    def kernel_tables(self) -> dict:
        """The pair-bond kernel's inputs built for this object, by n_tags
        (``_topology``)."""
        return {}


def inverse_tag_map(tag, mask, n_tags: int) -> torch.Tensor:
    """inv[t] = the row holding tag t (1-based tags; inv[0] is junk)."""
    inv = torch.zeros((n_tags + 1,), dtype=torch.int64, device=tag.device)
    src = torch.where(mask, tag, 0).long()
    inv[src] = torch.arange(tag.shape[0], device=tag.device)
    return inv


def presence_map(tag, mask, n_tags: int) -> torch.Tensor:
    """present[t] = True where some valid row carries tag t; present[0] is
    False."""
    present = torch.zeros((n_tags + 1,), dtype=torch.bool, device=tag.device)
    present[torch.where(mask, tag, 0).long()] = True
    present[0] = False
    return present


# ---------------------------------------------------------------------------
# pair bonds
# ---------------------------------------------------------------------------

def fene_force(dr, k, r0):
    """FENE: U = -1/2 K R0^2 ln(1 - (r/R0)^2); the force on i is
    -K dr / (1 - (r/R0)^2), clamped at r = 0.99 R0."""
    r2 = torch.sum(dr * dr, -1)
    x = torch.clamp(r2 / (r0 * r0), max=0.9801)
    return (-k / (1.0 - x))[..., None] * dr


def harmonic_force(dr, k, r0):
    r = sqrt32(torch.clamp(torch.sum(dr * dr, -1), min=1e-12))
    return (-2.0 * k * (r - r0) / r)[..., None] * dr


def wlc_pow_force(dr, kbt_p, l_max, k_p, m):
    """WLC-POW spring: f_wlc = -(kBT/p) [1/(4(1-x)^2) - 1/4 + x], x =
    r/l_max (clamped at 0.99), plus the repulsion k_p / r^m; the force on i
    along dr."""
    r = sqrt32(torch.clamp(torch.sum(dr * dr, -1), min=1e-12))
    x = torch.clamp(r / l_max, max=0.99)
    f_wlc = -kbt_p * (0.25 / ((1.0 - x) ** 2) - 0.25 + x)
    f_pow = k_p / torch.pow(r, m)
    return ((f_wlc + f_pow) / r)[..., None] * dr


_BOND_FORCES = {"fene": lambda dr, c: fene_force(dr, c[:, 0], c[:, 1]),
                "harmonic": lambda dr, c: harmonic_force(dr, c[:, 0],
                                                         c[:, 1]),
                "wlc_pow": lambda dr, c: wlc_pow_force(dr, c[:, 0], c[:, 1],
                                                       c[:, 2], c[:, 3])}


def _pair_bond_force(dr, params: BondedParams, style: str):
    if style not in _BOND_FORCES:
        raise ValueError(f"unknown bond style {style!r}")
    return _BOND_FORCES[style](dr, params.bond_coeffs[params.bond_type.long()])


# ---------------------------------------------------------------------------
# energies differentiated with autograd
# ---------------------------------------------------------------------------

def _all_present(present, tags):
    return torch.all(present[tags.long()], dim=1)


def angle_energy(x, inv, params: BondedParams, box: Box,
                 present=None) -> torch.Tensor:
    """Harmonic bending in the angle: sum of k (theta - theta0)^2."""
    ta = params.angle_tags.long()
    i, j, k_ = inv[ta[:, 0]], inv[ta[:, 1]], inv[ta[:, 2]]
    valid = ta[:, 0] > 0
    if present is not None:
        valid = valid & _all_present(present, ta)
    r1 = box.min_image(x[i] - x[j])
    r2 = box.min_image(x[k_] - x[j])
    cosang = torch.sum(r1 * r2, -1) * torch.rsqrt(torch.clamp(
        torch.sum(r1 * r1, -1) * torch.sum(r2 * r2, -1), min=1e-12))
    theta = torch.arccos(torch.clamp(cosang, -0.9999, 0.9999))
    c = params.angle_coeffs[params.angle_type.long()]
    e = c[:, 0] * (theta - c[:, 1]) ** 2
    return torch.sum(torch.where(valid, e, torch.zeros_like(e)))


def hinge_bending_energy(x, inv, params: BondedParams, box: Box,
                         present=None) -> torch.Tensor:
    """Bending across adjacent triangles (a,b,c) and (b,a,d) sharing edge
    ab: E = kb (1 - cos(theta - theta0)), theta the angle between their
    normals."""
    h = params.hinge_tags.long()
    a, b, c, d = inv[h[:, 0]], inv[h[:, 1]], inv[h[:, 2]], inv[h[:, 3]]
    valid = h[:, 0] > 0
    if present is not None:
        valid = valid & _all_present(present, h)
    xa = x[a]
    e_ab = box.min_image(x[b] - xa)
    e_ac = box.min_image(x[c] - xa)
    e_ad = box.min_image(x[d] - xa)
    n1 = torch.linalg.cross(e_ab, e_ac)
    n2 = torch.linalg.cross(e_ad, e_ab)   # a flat sheet gives theta = 0
    cosq = torch.sum(n1 * n2, -1) * torch.rsqrt(torch.clamp(
        torch.sum(n1 * n1, -1) * torch.sum(n2 * n2, -1), min=1e-18))
    theta = torch.arccos(torch.clamp(cosq, -0.9999, 0.9999))
    e = params.hinge_coeffs[:, 0] * (1.0 - torch.cos(
        theta - params.hinge_coeffs[:, 1]))
    return torch.sum(torch.where(valid, e, torch.zeros_like(e)))


def _tri_geometry(xu, inv, params: BondedParams, valid):
    """(area, signed-volume share) of each triangle from unwrapped
    coordinates x + image L, exact for a closed mesh that straddles the
    periodic box."""
    tri = params.tri_tags.long()
    p0 = xu[inv[tri[:, 0]]]
    cross = torch.linalg.cross(xu[inv[tri[:, 1]]] - p0,
                               xu[inv[tri[:, 2]]] - p0)
    zero = torch.zeros((), dtype=xu.dtype, device=xu.device)
    area_t = 0.5 * sqrt32(torch.clamp(torch.sum(cross * cross, -1),
                                      min=1e-18))
    area_t = torch.where(valid, area_t, zero)
    v_t = torch.where(valid, torch.sum(p0 * cross, -1) / 6.0, zero)
    return area_t, v_t


def _tri_valid(present, params: BondedParams):
    tri = params.tri_tags.long()
    return (tri[:, 0] > 0) & _all_present(present, tri)


def membrane_scalars(xu, inv, present, owner, params: BondedParams,
                     n_mols: int):
    """Per-molecule (area, signed volume) sums over the triangles whose
    first tag this rank owns."""
    valid = _tri_valid(present, params) & owner[params.tri_tags[:, 0].long()]
    area_t, v_t = _tri_geometry(xu, inv, params, valid)
    mol = params.tri_mol.long()
    z = torch.zeros((n_mols,), dtype=xu.dtype, device=xu.device)
    return z.index_add(0, mol, area_t), z.index_add(0, mol, v_t)


def membrane_energy(xu, inv, present, params: BondedParams, n_mols: int,
                    area_g, vol_g) -> torch.Tensor:
    """Membrane energy given the global per-molecule area and volume: the
    global penalties enter linearised with multipliers lambda = dE/dA held
    fixed (detached), plus the per-triangle local area term when
    ``tri_a0`` is set."""
    valid = _tri_valid(present, params)
    area_t, v_t = _tri_geometry(xu, inv, params, valid)
    mol = params.tri_mol.long()
    c = params.membrane
    ka, a0, kv, v0 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    lam_a = (ka * (area_g - a0) / torch.clamp(a0, min=1e-9)).detach()
    lam_v = (kv * (torch.abs(vol_g) - v0) / torch.clamp(v0, min=1e-9)
             * torch.sign(vol_g)).detach()
    e = torch.sum(lam_a[mol] * area_t) + torch.sum(lam_v[mol] * v_t)
    if params.tri_a0 is not None:
        a0_t = torch.clamp(params.tri_a0, min=1e-9)
        e_loc = c[:, 4][mol] * (area_t - params.tri_a0) ** 2 / (2.0 * a0_t)
        e = e + torch.sum(torch.where(valid, e_loc, torch.zeros_like(e_loc)))
    return e


def _count_missing(present, owned, tags) -> torch.Tensor:
    """Terms with an owned participant whose partner is not resolvable."""
    t = tags.long()
    relevant = (t[:, 0] > 0) & torch.any(owned[t], dim=1)
    resolved = torch.all(present[t] | (t == 0), dim=1)
    return torch.sum(relevant & ~resolved).to(torch.int32)


def bonded_forces_ext(x, tag, mask, box: Box, params: BondedParams,
                      style: str, n_tags: int, n_mols: int = 0, image=None,
                      owner_mask=None, reduce_sum=None):
    """Total bonded force and the count of unresolvable terms.

    Single rank: every tag is present. ``owner_mask`` (the rows whose
    forces this rank owns) and ``reduce_sum`` (a sum of the per-molecule
    membrane scalars across ranks) belong to the domain-decomposed path
    (``parallel/domain.py``, over its local and ghost rows), applied as
    the JAX package applies them. Returns (f (N, 3), missing)."""
    return _bonded(x, tag, mask, box, params, style, n_tags, n_mols, image,
                   owner_mask, reduce_sum, count_missing=True)


def _bonded(x, tag, mask, box: Box, params: BondedParams, style: str,
            n_tags: int, n_mols: int, image, owner_mask, reduce_sum,
            count_missing: bool, add_to=None):
    """bonded_forces_ext; without ``count_missing`` the checked invariant
    is not counted (missing is None), which saves the step its launches.
    With ``add_to`` the result is add_to plus the bonded force, and
    add_to's storage may hold it (the CUDA route adds into it in place
    where there are pair bonds alone): the caller gives add_to up."""
    if x.device.type == "cpu":
        f, missing = _bonded_plain(x, tag, mask, box, params, style, n_tags,
                                   n_mols, image, owner_mask, reduce_sum,
                                   count_missing)
        return (f if add_to is None else add_to + f), missing
    terms = [t for t in (params.angle_tags, params.hinge_tags,
                         params.tri_tags) if t is not None]
    if not terms:
        return pair_bonds(x, tag, mask, box, params, style, n_tags,
                          owner_mask, count_missing, add_to)
    # angles, hinges and the membrane: the pair bonds' kernel, then the
    # energy's gradient by autograd and the owner mask, as the plain chain
    f, missing = pair_bonds(x, tag, mask, box, params, style, n_tags,
                            owner_mask, count_missing)
    owner_rows = mask if owner_mask is None else (mask & owner_mask)
    inv = inverse_tag_map(tag, mask, n_tags)
    present = presence_map(tag, mask, n_tags)
    owned = (present if owner_mask is None
             else presence_map(tag, owner_rows, n_tags))
    if count_missing:
        for t in terms:
            missing = missing + _count_missing(present, owned, t)
    f = f - _energy_grad(x, image, inv, present, owned, box, params, n_mols,
                         reduce_sum)
    f = torch.where(owner_rows[:, None], f, torch.zeros_like(f))
    return (f if add_to is None else add_to + f), missing


def _bonded_plain(x, tag, mask, box: Box, params: BondedParams, style: str,
                  n_tags: int, n_mols: int, image, owner_mask, reduce_sum,
                  count_missing: bool):
    """The plain torch chain of the bonded terms (the CPU route, on any
    device's tensors): (f, missing), missing None unless counted."""
    owner_rows = mask if owner_mask is None else (mask & owner_mask)
    inv = inverse_tag_map(tag, mask, n_tags)
    present = presence_map(tag, mask, n_tags)
    owned = (present if owner_mask is None
             else presence_map(tag, owner_rows, n_tags))

    bt = params.bond_tags.long()
    resolved = (bt[:, 0] > 0) & _all_present(present, bt)
    missing = _count_missing(present, owned, bt) if count_missing else None
    bi, bj = inv[bt[:, 0]], inv[bt[:, 1]]
    f_i = _pair_bond_force(box.min_image(x[bi] - x[bj]), params, style)
    f_i = torch.where(resolved[:, None], f_i, torch.zeros_like(f_i))
    f = torch.zeros_like(x)
    f.index_add_(0, bi, f_i)
    f.index_add_(0, bj, -f_i)

    terms = [t for t in (params.angle_tags, params.hinge_tags,
                         params.tri_tags) if t is not None]
    if terms:
        if count_missing:
            for t in terms:
                missing = missing + _count_missing(present, owned, t)
        f = f - _energy_grad(x, image, inv, present, owned, box, params,
                             n_mols, reduce_sum)
    return torch.where(owner_rows[:, None], f, torch.zeros_like(f)), missing


# ---------------------------------------------------------------------------
# the pair bonds' kernel (csrc/bonds.cu)
# ---------------------------------------------------------------------------

_STYLES = {"fene": 0, "harmonic": 1, "wlc_pow": 2}
def _topology(params: BondedParams, n_tags: int):
    """(partner table, width, coefficients) of ``params``' bonds, built on
    the bonds' device at the first call for this object and ``n_tags``
    (one host sync) and kept on it (``BondedParams.kernel_tables``) while
    its bond tensors are unchanged."""
    bt, ty, co = params.bond_tags, params.bond_type, params.bond_coeffs
    versions = (bt._version, ty._version, co._version)
    hit = params.kernel_tables.get(n_tags)
    if hit is not None and hit[0] == versions:
        return hit[1:]
    if co.dim() != 2 or co.shape[1] != 4:
        raise ValueError("bond_coeffs must be (bond types, 4)")
    dev = bt.device
    b = bt.long()
    keep = torch.nonzero((b[:, 0] > 0) & (b[:, 1] > 0)).reshape(-1)
    nb = int(keep.numel())
    b, typ = b[keep], ty[keep].long()
    ends = torch.cat([b[:, 0], b[:, 1]])
    other = torch.cat([b[:, 1], b[:, 0]])
    typ = torch.cat([typ, typ])
    # each tag's entries in bond order, the bond's first end before its
    # second
    j = torch.arange(nb, device=dev)
    _, order = torch.sort(ends * (2 * nb) + torch.cat([2 * j, 2 * j + 1]))
    ends = ends[order]
    rank = torch.arange(2 * nb, device=dev) - torch.searchsorted(
        ends, ends, side="left")
    width = int(rank.max()) + 1 if nb else 1
    table = torch.zeros((n_tags + 1, width, 2), dtype=torch.int32, device=dev)
    table[ends, rank, 0] = other[order].to(torch.int32)
    table[ends, rank, 1] = typ[order].to(torch.int32)
    coeffs = co.to(device=dev, dtype=torch.float32).contiguous()
    params.kernel_tables[n_tags] = (versions, table, width, coeffs)
    return table, width, coeffs


def partner_table(params: BondedParams, n_tags: int):
    """(table, width): each tag's bond partners, in the order of
    ``params.bond_tags``, as int32 (n_tags + 1, width, 2) rows of
    (partner tag, bond type) padded with partner 0; width is the most
    bonds a tag has (at least 1). Bonds with a tag 0 are padding and left
    out. Built once for this object and kept (``_topology``)."""
    return _topology(params, n_tags)[:2]


def _check_rows(n: int, dev, x, tag, mask, add_to, owner_mask) -> None:
    """Raise unless each given tensor is contiguous, on ``dev``, of the
    kernel's dtype and of n rows."""
    for name, t, dtype, width in (
            ("x", x, torch.float32, 3), ("tag", tag, torch.int32, 0),
            ("mask", mask, torch.bool, 0), ("add_to", add_to, torch.float32,
                                            3),
            ("owner_mask", owner_mask, torch.bool, 0)):
        if t is None:
            continue
        shape = (n, width) if width else (n,)
        if (t.dtype != dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"pair_bonds: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {dev}")


def pair_bonds(x, tag, mask, box: Box, params: BondedParams, style: str,
               n_tags: int, owner_mask=None, count_missing: bool = False,
               add_to=None):
    """The pair bonds' force on CUDA tensors through ``meso_pair_bonds``
    (two launches, adding one to ``LAUNCHES["pair_bonds"]``): on the rows
    this rank owns (the valid rows, and of them those in ``owner_mask``
    where given), the sum of the row's bonds in the order of the bond
    list; 0 on every other row. With ``add_to`` (float32 (N, 3)) the sum
    is added into add_to in place and add_to is returned; else a new
    tensor. ``missing`` (with ``count_missing``, else None): an int32
    0-d tensor, the owned rows' partners that no valid row holds (the
    plain chain's count where tags are unique). Returns (f, missing)."""
    if style not in _STYLES:
        raise ValueError(f"unknown bond style {style!r}")
    lib = _build.load_library()
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"pair_bonds takes CUDA tensors (the CPU's are the "
                         f"plain chain's), not {dev}")
    n = x.shape[0]
    _check_rows(n, dev, x, tag, mask, add_to, owner_mask)
    table, width, coeffs = _topology(params, n_tags)
    if table.device != dev:
        raise ValueError(f"pair_bonds: the bonds are on {table.device}, the "
                         f"rows on {dev}")
    inv = torch.empty(n_tags + 1, dtype=torch.int32, device=dev)
    f = torch.empty_like(x) if add_to is None else add_to
    missing = (torch.empty((), dtype=torch.int32, device=dev)
               if count_missing else None)
    lo = box.lo.to(device=dev, dtype=torch.float32).contiguous()
    hi = box.hi.to(device=dev, dtype=torch.float32).contiguous()
    code = lib.meso_pair_bonds(
        x.data_ptr(), tag.data_ptr(), mask.data_ptr(),
        None if owner_mask is None else owner_mask.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), table.data_ptr(), width,
        coeffs.data_ptr(), inv.data_ptr(), f.data_ptr(),
        None if missing is None else missing.data_ptr(), n, n_tags,
        _STYLES[style], int(add_to is None),
        _build.stream_of(dev))
    _build.check(code, "pair_bonds")
    LAUNCHES["pair_bonds"] += 1
    return f, missing


def _energy_grad(x, image, inv, present, owned, box: Box,
                 params: BondedParams, n_mols: int, reduce_sum):
    """d(angle + membrane + hinge energy)/dx by autograd, taken in normal
    mode on clones: the caller may run under inference_mode or no_grad, and
    tensors made there (the state's, or the parameters') cannot be saved
    for a backward pass."""
    with torch.inference_mode(False), torch.enable_grad():
        xx = x.clone().requires_grad_(True)
        inv, present, owned = inv.clone(), present.clone(), owned.clone()
        box = Box(lo=box.lo.clone(), hi=box.hi.clone())
        params = BondedParams(**{
            f.name: None if getattr(params, f.name) is None
            else getattr(params, f.name).clone()
            for f in dataclasses.fields(BondedParams)})
        img = (torch.zeros_like(xx) if image is None
               else image.to(xx.dtype) * box.lengths)
        e = torch.zeros((), dtype=xx.dtype, device=xx.device)
        if params.angle_tags is not None:
            e = e + angle_energy(xx, inv, params, box, present=present)
        if params.tri_tags is not None:
            xu = xx.detach() + img
            area_p, vol_p = membrane_scalars(xu, inv, present, owned, params,
                                             n_mols)
            if reduce_sum is not None:
                area_p, vol_p = reduce_sum(area_p), reduce_sum(vol_p)
            e = e + membrane_energy(xx + img, inv, present, params, n_mols,
                                    area_p, vol_p)
        if params.hinge_tags is not None:
            e = e + hinge_bending_energy(xx, inv, params, box,
                                         present=present)
        (grad,) = torch.autograd.grad(e, xx)
    return grad


def bonded_forces(x, tag, mask, box: Box, params: BondedParams, style: str,
                  n_tags: int, n_mols: int = 0, image=None,
                  add_to=None) -> torch.Tensor:
    """Single-rank bonded force (every tag resolvable by construction).
    With ``add_to`` (the step's pair force, which the caller gives up):
    add_to plus the bonded force, in add_to's storage where the CUDA
    route can add in place."""
    f, _ = _bonded(x, tag, mask, box, params, style, n_tags, n_mols, image,
                   None, None, count_missing=False, add_to=add_to)
    return f
