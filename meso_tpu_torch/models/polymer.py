"""Config 5 — FENE polymer chains and a membrane vesicle in DPD solvent
(port of ``meso_tpu/models/polymer.py``; BASELINE.json configs[4]), and
the block-copolymer melt of Groot and Madden.

Polymers: chains of FENE beads (K=30, R0=1.5) started as compact random
walks, solvent filling up to the density. Membrane: an icosphere vesicle
whose edges carry WLC-POW springs, with global and local area and volume
penalties and hinge bending.

Positions and topology come from ``np.random.RandomState(init_seed)`` in
the JAX package's order, so the port's builders give the same positions,
bonds, exclusion table, triangles and hinges as JAX's for the same
arguments. Velocities come from the port's ``maxwell_velocities`` and
differ from JAX's.

``block_copolymer_melt`` has no JAX counterpart: A_nB_m chains filling
the box with no solvent (R. D. Groot and T. J. Madden, J. Chem. Phys.
108, 8713 (1998)), their random walks drawn for all chains at once.
"""

from __future__ import annotations

import numpy as np
import torch

from meso_tpu_torch.core.box import Box
from meso_tpu_torch.core.rng import maxwell_velocities
from meso_tpu_torch.core.state import State, zeros_state
from meso_tpu_torch.core.system import (System, SystemParams, fit_capacity,
                                        setup)
from meso_tpu_torch.ops.bonded import BondedParams
from meso_tpu_torch.ops.dpd import DPDParams, build_exclusions


def _random_walk_chain(rs, start, nbeads, step_len, l):
    pos = [np.asarray(start, float)]
    for _ in range(nbeads - 1):
        d = rs.normal(size=3)
        d *= step_len / np.linalg.norm(d)
        pos.append(pos[-1] + d)
    return np.asarray(pos) % l


def _start(x: np.ndarray, mol: np.ndarray, l: float, kt: float,
           init_seed: int, device) -> State:
    """N-row state at positions x (float64, rounded to float32 as JAX
    rounds them), tags 1..N, molecule ids, Maxwell velocities."""
    n = x.shape[0]
    box = Box.cubic(l, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(init_seed)
    v = maxwell_velocities(gen, n, kt, 1.0, device=device)
    return zeros_state(n, box).replace(
        x=torch.from_numpy(x.astype(np.float32)).to(device), v=v,
        tag=torch.arange(1, n + 1, dtype=torch.int32, device=device),
        mask=torch.ones(n, dtype=torch.bool, device=device),
        mol=torch.from_numpy(mol).to(device))


def _system(l, rc, density, dt, skin, rng_mode, force_path, **kw) -> System:
    system = System.for_fluid([l] * 3, rc=rc, density=density, dt=dt,
                              skin=skin, rng_mode=rng_mode,
                              spill=force_path == "pallas")
    return system.replace(force_path=force_path, **kw)


def polymer_melt(l: float = 10.0, density: float = 3.0, n_chains: int = 10,
                 chain_len: int = 20, kt: float = 1.0, a: float = 25.0,
                 gamma: float = 4.5, rc: float = 1.0, fene_k: float = 30.0,
                 fene_r0: float = 1.5, dt: float = 0.01, seed: int = 551,
                 init_seed: int = 5, force_path: str = "nlist",
                 rng_mode: str = "fast", skin: float = 0.3,
                 special_weight: float | None = None,
                 device="cuda") -> tuple[System, SystemParams, State]:
    """FENE chains + solvent. Returns (system, params, state), forces set,
    on ``device`` (the card unless the caller asks for another).

    special_weight: if set, bonded pairs get their DPD pair force scaled by
    it (``special_bonds``; two exclusions per bead), which K1's general
    variant applies on force_path "pallas"."""
    device = torch.device(device)
    rs = np.random.RandomState(init_seed)
    n_poly = n_chains * chain_len
    n_total = int(round(density * l ** 3))
    n_solvent = n_total - n_poly
    if n_solvent <= 0:
        raise ValueError("the chains fill the box: no solvent left")
    chains = [_random_walk_chain(rs, rs.uniform(0, l, 3), chain_len, 0.9, l)
              for _ in range(n_chains)]
    x = np.concatenate(chains + [rs.uniform(0, l, (n_solvent, 3))])
    mol = np.zeros(n_total, np.int32)
    mol[:n_poly] = np.repeat(np.arange(1, n_chains + 1, dtype=np.int32),
                             chain_len)
    state = _start(x, mol, l, kt, init_seed, device)

    # consecutive beads, 1-based tags
    base = np.arange(n_chains)[:, None] * chain_len + 1
    first = (base + np.arange(chain_len - 1)[None, :]).reshape(-1)
    bonds = np.stack([first, first + 1], 1).astype(np.int32)
    bonded = BondedParams(
        bond_tags=torch.from_numpy(bonds).to(device),
        bond_type=torch.zeros(len(bonds), dtype=torch.int32, device=device),
        bond_coeffs=torch.tensor([[fene_k, fene_r0, 0.0, 0.0]],
                                 dtype=torch.float32, device=device))
    pair = DPDParams.build(a=a, gamma=gamma, rc=rc, kt=kt, seed=seed,
                           device=device)
    if special_weight is not None:
        excl, w = build_exclusions(bonds, n_total, weight=special_weight,
                                   max_excl=2, device=device)
        pair = pair.replace(excl=excl, excl_w=w)
    params = SystemParams.build(pair).replace(bonded=bonded)
    system = _system(l, rc, density, dt, skin, rng_mode, force_path,
                     bond_style="fene", n_tags=n_total)
    system = fit_capacity(system, state)
    return system, params, setup(system, params, state)


# slots fit_capacity may add for a start of chain walks: chains crowd
# their beads into a few cells, so the start needs far more than the K the
# density gives (at l = 70, skin 0.4, chains of 10: K 20-28 for spill
# buckets against 16, over 20 seeds), which the first steps relax
_WALK_EXTRA_SLOTS = 24


def chain_walks(rng: np.random.Generator, n_chains: int, chain_len: int,
                step_len: float, l: float) -> np.ndarray:
    """(n_chains * chain_len, 3) float64 positions in [0, l): chain c's
    beads at rows c * chain_len ..., a random walk of steps of length
    ``step_len`` in uniformly random directions from a uniform random
    start, every chain drawn at once (one call for the starts, one for the
    steps)."""
    starts = rng.uniform(0.0, l, (n_chains, 1, 3))
    steps = rng.normal(size=(n_chains, chain_len - 1, 3))
    steps *= step_len / np.linalg.norm(steps, axis=-1, keepdims=True)
    walks = np.concatenate([np.zeros((n_chains, 1, 3)),
                            np.cumsum(steps, axis=1)], axis=1)
    return ((starts + walks) % l).reshape(-1, 3)


def block_copolymer_melt(l: float = 10.0, density: float = 3.0,
                         chain_len: int = 10, n_a: int = 5,
                         a=((25.0, 40.0), (40.0, 25.0)),
                         gamma=((4.5, 4.5), (4.5, 4.5)), rc: float = 1.0,
                         kt: float = 1.0, bond_style: str = "harmonic",
                         bond_coeffs=(2.0, 0.0, 0.0, 0.0), dt: float = 0.01,
                         lam: float = 0.65, skin: float = 0.3,
                         rng_mode: str = "fast", seed: int = 771,
                         init_seed: int = 7, force_path: str = "nlist",
                         device="cuda") -> tuple[System, SystemParams, State]:
    """A_nB_m chains filling the box with no solvent (Groot and Madden,
    J. Chem. Phys. 108, 8713 (1998)). Returns (system, params, state),
    forces set, on ``device`` (the card unless the caller asks for another).

    round(density l^3 / chain_len) chains of ``chain_len`` beads (102,900
    at l = 70, density 3, chain_len 10: 1,029,000 beads). Chain c holds
    tags c * chain_len + 1 ... (c + 1) * chain_len, its first ``n_a``
    beads type A (0) and the rest type B (1); bonds join consecutive tags
    of a chain. ``a`` and ``gamma`` are the 2 x 2 type tables, every pair
    (bonded ones included, at full weight) feels the DPD pair force.
    ``bond_coeffs`` is one row of the bond style's coefficients
    (``ops.bonded.BondedParams``): harmonic (K, r0) with E = K (r - r0)^2,
    so Groot and Madden's spring F = -C r is K = C / 2, r0 = 0. Starts:
    random walks of step 0.9 (``chain_walks``, a numpy generator seeded
    with ``init_seed``), velocities Maxwell at kt."""
    device = torch.device(device)
    if not 0 <= n_a <= chain_len or chain_len < 2:
        raise ValueError(f"chains of {chain_len} beads with {n_a} A beads")
    n_chains = int(round(density * l ** 3 / chain_len))
    n_total = n_chains * chain_len
    x = chain_walks(np.random.default_rng(init_seed), n_chains, chain_len,
                    0.9, l)
    mol = np.repeat(np.arange(1, n_chains + 1, dtype=np.int32), chain_len)
    state = _start(x, mol, l, kt, init_seed, device)
    bead = torch.arange(n_total, device=device) % chain_len
    state = state.replace(typ=(bead >= n_a).to(torch.int32))

    # consecutive beads of each chain, 1-based tags
    base = np.arange(n_chains)[:, None] * chain_len + 1
    first = (base + np.arange(chain_len - 1)[None, :]).reshape(-1)
    bonds = np.stack([first, first + 1], 1).astype(np.int32)
    coeffs = np.zeros((1, 4), np.float32)
    coeffs[0, :len(bond_coeffs)] = bond_coeffs
    bonded = BondedParams(
        bond_tags=torch.from_numpy(bonds).to(device),
        bond_type=torch.zeros(len(bonds), dtype=torch.int32, device=device),
        bond_coeffs=torch.from_numpy(coeffs).to(device))
    pair = DPDParams.build(a=a, gamma=gamma, rc=rc, kt=kt, seed=seed,
                           n_types=2, device=device)
    params = SystemParams.build(pair).replace(bonded=bonded)
    system = _system(l, rc, n_total / l ** 3, dt, skin, rng_mode, force_path,
                     bond_style=bond_style, n_tags=n_total, lam=lam)
    system = fit_capacity(system, state, extra=_WALK_EXTRA_SLOTS)
    return system, params, setup(system, params, state)


def icosphere(subdiv: int = 1):
    """Unit icosphere: returns (vertices (V, 3), triangles (F, 3) int)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = np.asarray([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], float)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], int)
    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (vlist[i] + vlist[j]) / 2
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        nf = []
        for (i, j, k) in faces:
            ij, jk, ki = mid(i, j), mid(j, k), mid(k, i)
            nf += [[i, ij, ki], [j, jk, ij], [k, ki, jk], [ij, jk, ki]]
        verts = np.asarray(vlist)
        faces = np.asarray(nf, int)
    return verts, faces


def build_hinges(faces) -> np.ndarray:
    """(NH, 4) hinges (a, b, c, d): triangles (a,b,c) and (b,a,d) share
    edge ab; c and d are the opposite vertices. 0-based vertex indices."""
    edge_map = {}
    hinges = []
    for i, j, k in faces:
        for a, b, opp in ((i, j, k), (j, k, i), (k, i, j)):
            key = (min(a, b), max(a, b))
            if key in edge_map:
                a0, b0, c0 = edge_map.pop(key)
                hinges.append((a0, b0, c0, opp))
            else:
                edge_map[key] = (a, b, opp)
    return np.asarray(hinges, np.int64)


def membrane_suspension(l: float = 12.0, density: float = 3.0,
                        radius: float = 3.0, subdiv: int = 2,
                        kt: float = 1.0, a: float = 25.0, gamma: float = 4.5,
                        rc: float = 1.0, dt: float = 0.01,
                        kbt_p: float = 50.0, k_p: float = 0.2,
                        m_pow: float = 2.0, ka: float = 500.0,
                        kv: float = 500.0, kb: float = 20.0,
                        ka_local: float = 100.0, seed: int = 661,
                        init_seed: int = 6, force_path: str = "nlist",
                        rng_mode: str = "fast", skin: float = 0.3,
                        device="cuda"):
    """One icosphere vesicle (type 0, like the solvent) in DPD solvent:
    WLC-POW edges, global and per-triangle local area conservation, a
    volume penalty and hinge bending. Returns (system, params, state,
    mesh_info), on ``device``."""
    device = torch.device(device)
    rs = np.random.RandomState(init_seed)
    verts, faces = icosphere(subdiv)
    x_mem = verts * radius + l / 2
    n_mem = len(x_mem)
    n_total = int(round(density * l ** 3))
    # solvent outside the vesicle shell
    x_solv = []
    while len(x_solv) < n_total - n_mem:
        cand = rs.uniform(0, l, (4096, 3))
        r = np.linalg.norm(cand - l / 2, axis=1)
        x_solv.extend(cand[np.abs(r - radius) > 0.4].tolist())
    x_solv = np.asarray(x_solv[: n_total - n_mem])
    mol = np.zeros(n_total, np.int32)
    mol[:n_mem] = 1
    state = _start(np.concatenate([x_mem, x_solv]), mol, l, kt, init_seed,
                   device)

    # unique edges of the faces, 1-based tags; l_max at 2.2x the mean edge
    edges = set()
    for i, j, k in faces:
        for e in ((i, j), (j, k), (k, i)):
            edges.add((min(e) + 1, max(e) + 1))
    edges = np.asarray(sorted(edges), np.int32)
    el = np.linalg.norm(x_mem[edges[:, 0] - 1] - x_mem[edges[:, 1] - 1],
                        axis=1)
    l_max = float(el.mean() * 2.2)

    # rest area and volume of the icosphere
    p = x_mem
    cr = np.cross(p[faces[:, 1]] - p[faces[:, 0]],
                  p[faces[:, 2]] - p[faces[:, 0]])
    tri_a0 = 0.5 * np.linalg.norm(cr, axis=1)
    area0 = float(tri_a0.sum())
    vol0 = float(np.abs((p[faces[:, 0]] * cr).sum() / 6.0))

    # hinges, with the icosphere's rest dihedral as theta0
    hinges = build_hinges(faces)
    ha, hb, hc, hd = (x_mem[hinges[:, c]] for c in range(4))
    n1 = np.cross(hb - ha, hc - ha)
    n2 = np.cross(hd - ha, hb - ha)
    cos0 = (n1 * n2).sum(1) / np.sqrt((n1 * n1).sum(1) * (n2 * n2).sum(1))
    theta0 = np.arccos(np.clip(cos0, -1, 1))
    hinge_coeffs = np.stack([np.full(len(hinges), kb), theta0], 1)

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)

    bonded = BondedParams(
        bond_tags=tensor(edges, np.int32),
        bond_type=torch.zeros(len(edges), dtype=torch.int32, device=device),
        bond_coeffs=tensor([[kbt_p, l_max, k_p, m_pow]], np.float32),
        tri_tags=tensor(faces + 1, np.int32),
        tri_mol=torch.zeros(len(faces), dtype=torch.int32, device=device),
        membrane=tensor([[ka, area0, kv, vol0, ka_local, 0.0]], np.float32),
        tri_a0=tensor(tri_a0, np.float32),
        hinge_tags=tensor(hinges + 1, np.int32),
        hinge_coeffs=tensor(hinge_coeffs, np.float32))
    params = SystemParams.build(
        DPDParams.build(a=a, gamma=gamma, rc=rc, kt=kt, seed=seed,
                        device=device)).replace(bonded=bonded)
    system = _system(l, rc, density, dt, skin, rng_mode, force_path,
                     bond_style="wlc_pow", n_tags=n_total, n_mols=1)
    system = fit_capacity(system, state)
    mesh_info = {"area0": area0, "vol0": vol0, "n_mem": n_mem,
                 "faces": faces, "l_max": l_max}
    return system, params, setup(system, params, state), mesh_info
