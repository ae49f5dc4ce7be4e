"""The block-copolymer melt (``models.polymer.block_copolymer_melt``), the
builder decks' [engine], [neighbor] and [integrate] keys, and the pair
bonds' kernel design, on the CPU.

- The builder at L = 6 (65 chains of 10 beads): tags, types, bonds, no
  solvent, the density; its random walks' bond lengths.
- The port's forces and one 3-step bucket chunk of the spill cell's
  layout against the benchmark's plain reference
  (``benchmark/reference/diblock.py``) on seeded starts at L = 8. The
  tolerances: both sides are float32 and sum each bead's pairs in
  different orders (the port's K1 visits candidates by cell tile, the
  reference by its own cell list) with rsqrt and division rounded
  differently, so a component differs by some ulps of the largest pair
  terms; 2e-4 of the root mean square force and velocity is 30 times the
  widest gap of 24 starts on a CPU (6.5e-6 of the force, 6.1e-7 of
  the velocity after the chunk; 1.6e-6 of the force at set-up) and far
  below what each control leaves (the springs at half K 0.25 and 0.067,
  the springs off 0.50 and 0.13, the pair arithmetic in bfloat16 0.053
  and 0.0074, the least of 3 starts).
- The kernel's walk (``csrc/bonds.cu``: each row's partners from
  ``ops.bonded.partner_table`` in table order, each bond's force computed
  from its own bead) emulated in torch against the plain chain, for the
  three styles, with an owner mask and missing partners.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from meso_tpu_torch.core.system import (_post_forces, compute_forces,
                                        run_bucket_chunked)
from meso_tpu_torch.io.deck import build_from_deck
from meso_tpu_torch.models.polymer import (block_copolymer_melt,
                                           chain_walks, membrane_suspension,
                                           polymer_melt)
from meso_tpu_torch.ops import bonded
from test_torch_imports import one_torch_thread  # noqa: F401

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import diblock  # noqa: E402

GAP_TOL = 2e-4
# the spill cell's engine (benchmark/traffic/spill.json)
SPILL = {"force_path": "pallas", "pair_kernel": "v3", "spill": True,
         "rebuild": "sort", "wrap_mode": "rebuild"}


def _melt_deck(l, init_seed, seed, engine=SPILL, **neighbor):
    """The benchmark's diblock_melt_l70 deck at box edge ``l`` with the
    spill traffic's [engine] and cadence."""
    return {"model": {"builder": "block_copolymer_melt",
                      "args": {"chain_len": 10, "n_a": 5,
                               "bond_style": "harmonic",
                               "bond_coeffs": [2.0, 0.0, 0.0, 0.0],
                               "init_seed": init_seed}},
            "box": {"l": l},
            "pair": {"dpd": {"a": [[25.0, 40.0], [40.0, 25.0]],
                             "gamma": [[4.5, 4.5], [4.5, 4.5]], "rc": 1.0,
                             "kt": 1.0, "seed": seed}},
            "integrate": {"dt": 0.01, "lambda_": 0.65},
            "rng": {"mode": "fast"},
            "engine": dict(engine),
            "neighbor": {"skin": 0.4, "rebuild_every": 3, **neighbor}}


def _phys(l, seed):
    return diblock.Physics(
        lengths=(l, l, l), a=((25.0, 40.0), (40.0, 25.0)),
        gamma=((4.5, 4.5), (4.5, 4.5)), rc=1.0, kt=1.0, dt=0.01, lam=0.65,
        chain_len=10, n_a=5, bond_k=2.0, bond_r0=0.0, seed=seed)


def _in_tag_order(state, t):
    m = state.mask
    return t[m][torch.argsort(state.tag[m])]


def test_builder_tags_types_bonds_density():
    system, params, state = block_copolymer_melt(l=6.0, device="cpu")
    m = state.mask
    tags = torch.sort(state.tag[m]).values
    n = int(m.sum())
    assert n == 650 and abs(n - 3.0 * 6.0 ** 3) <= 5     # 65 chains
    assert torch.equal(tags, torch.arange(1, n + 1, dtype=torch.int32))
    typ = _in_tag_order(state, state.typ)
    bead = torch.arange(n) % 10
    assert torch.equal(typ, (bead >= 5).to(torch.int32))
    mol = _in_tag_order(state, state.mol)
    assert torch.equal(mol, torch.arange(n, dtype=torch.int32) // 10 + 1)
    assert bool((mol > 0).all())                           # no solvent
    bt = params.bonded.bond_tags
    first = torch.tensor([c * 10 + k + 1 for c in range(65)
                          for k in range(9)], dtype=torch.int32)
    assert torch.equal(bt, torch.stack([first, first + 1], 1))
    assert params.pair.n_types == 2
    assert params.pair.a.tolist() == [[25.0, 40.0], [40.0, 25.0]]
    assert params.bonded.bond_coeffs.tolist() == [[2.0, 0.0, 0.0, 0.0]]
    assert (system.bond_style, system.n_tags, system.lam) == \
        ("harmonic", 650, 0.65)


@pytest.mark.parametrize("seed,chain_len", [(0, 10), (1, 10), (2, 32),
                                            (3, 2)])
def test_walks_have_bonds_of_0_9(seed, chain_len):
    """chain_walks' steps, under the minimum image, are 0.9 long, in float64
    and as the builder stores them in float32."""
    l = 6.0
    x = chain_walks(np.random.default_rng(seed), 40, chain_len, 0.9, l)
    assert x.shape == (40 * chain_len, 3)
    assert (x >= 0).all() and (x < l).all()
    w = x.reshape(40, chain_len, 3)
    d = w[:, 1:] - w[:, :-1]
    d -= np.round(d / l) * l
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 0.9, atol=1e-12)
    d32 = torch.from_numpy(w.astype(np.float32))
    d32 = d32[:, 1:] - d32[:, :-1]
    d32 -= torch.round(d32 / l) * l
    np.testing.assert_allclose(torch.linalg.norm(d32, dim=-1).numpy(), 0.9,
                               atol=2e-6)


def _gap(a, b):
    return float(torch.max(torch.abs(a - b))) / float(
        torch.sqrt(torch.mean(b.double() ** 2)))


@pytest.mark.parametrize("init_seed,seed", [(11, 2**31 + 5), (12, 77)])
def test_forces_match_the_reference(init_seed, seed):
    """compute_forces (K1's general variant, its plain CPU version) with
    the bonds of _post_forces at the set-up start against the reference's
    pair term and springs; springs at half K would be caught."""
    system, params, state, _ = build_from_deck(
        _melt_deck(8.0, init_seed, seed), device="cpu")
    assert system.cells.spill and params.pair.n_types == 2
    f, _ = compute_forces(system, params, state, state.x, state.v,
                          state.step)
    f = _post_forces(system, params, state, state.x, state.v, f)
    phys = _phys(8.0, seed)
    tag = torch.arange(1, int(state.mask.sum()) + 1, dtype=torch.int32)
    x, v = (_in_tag_order(state, t) for t in (state.x, state.v))
    want, n_pairs = diblock.forces(x, v, tag, state.step, phys)
    assert n_pairs > 10 * tag.numel()
    assert _gap(_in_tag_order(state, f), want) < GAP_TOL
    assert torch.equal(_in_tag_order(state, state.f), _in_tag_order(state, f))
    half, _ = diblock.forces(x, v, tag, state.step, phys, "springs_half_k")
    assert _gap(half, want) > 20 * GAP_TOL


@pytest.mark.parametrize("init_seed,seed", [(21, 3_000_000_007), (22, 9)])
def test_chunk_matches_the_reference(init_seed, seed):
    """One rebuild and 3 steps of the port's bucket loop on the spill
    layout, judged by the reference's numbers as the benchmark judges a
    window's last chunk; each control is caught."""
    system, params, state, _ = build_from_deck(
        _melt_deck(8.0, init_seed, seed), device="cpu")
    state, _ = run_bucket_chunked(system, params, state, 3, 3,
                                  thermo_trace=False)
    snap = {"x": state.x.clone(), "v": state.v.clone(),
            "f": state.f.clone(), "tag": state.tag.clone(),
            "mask": state.mask.clone(), "step": int(state.step)}
    end, diag = run_bucket_chunked(system, params, state, 1, 3,
                                   thermo_trace=False)
    assert int(diag["bucket_overflow"]) == 0
    c = system.cells
    lay = diblock.Layout(ncell=tuple(c.ncell), capacity=c.capacity,
                         spill=c.spill, wrap_at_rebuild=c.wrap_at_rebuild,
                         rebuild_every=c.rebuild_every)
    final = {k: getattr(end, k) for k in ("tag", "mask", "f", "v")}
    phys = _phys(8.0, seed)
    got, _ = diblock.numbers(final, snap, [], phys, lay)
    assert got["placement_miss"] == 0
    assert got["force_gap"] < GAP_TOL and got["velocity_gap"] < GAP_TOL
    for control in diblock.CONTROLS:
        bad, _ = diblock.numbers(final, snap, [], phys, lay, control)
        assert bad["force_gap"] > 20 * GAP_TOL, control
        assert bad["velocity_gap"] > 5 * GAP_TOL, control


def test_reference_rejects_an_unknown_control():
    system, params, state, _ = build_from_deck(_melt_deck(8.0, 1, 2),
                                               device="cpu")
    snap = {k: getattr(state, k) for k in ("x", "v", "f", "tag", "mask")}
    snap["step"] = 0
    c = system.cells
    lay = diblock.Layout(ncell=tuple(c.ncell), capacity=c.capacity,
                         spill=c.spill, wrap_at_rebuild=c.wrap_at_rebuild,
                         rebuild_every=c.rebuild_every)
    with pytest.raises(ValueError, match="unknown control"):
        diblock.numbers({}, snap, [], _phys(8.0, 2), lay, "springs_twice")


# --- builder decks ----------------------------------------------------------

def test_builder_deck_takes_engine_neighbor_and_integrate():
    """The keys the builder takes reach it as arguments ([box] l, the
    [pair.dpd] tables, lambda_ as lam, skin, [rng] mode, force_path); the
    engine keys it does not take are set on the built system, and the
    start is set up again on that layout."""
    deck = _melt_deck(6.0, 3, 4, skin=0.35)
    deck["integrate"] = {"lambda_": 0.5, "dt": 0.005}
    system, params, state, _ = build_from_deck(deck, device="cpu")
    c = system.cells
    assert (system.force_path, system.pair_kernel, system.wrap_mode) == \
        ("pallas", "v3", "rebuild")
    assert (c.skin, c.rebuild_every, c.rebuild, c.wrap_at_rebuild) == \
        (0.35, 3, "sort", True)
    assert (system.lam, system.dt, system.rng_mode) == (0.5, 0.005, "fast")
    assert params.pair.a.tolist() == [[25.0, 40.0], [40.0, 25.0]]
    assert params.pair.seed == 4
    # bucket rows of the new layout, the start set up on it
    assert state.n == c.n_cells * c.capacity
    assert int(state.mask.sum()) == 650
    want, _, want_state = block_copolymer_melt(
        l=6.0, init_seed=3, seed=4, lam=0.5, dt=0.005, skin=0.35,
        force_path="pallas", rng_mode="fast", device="cpu")
    assert torch.equal(_in_tag_order(state, state.x),
                       _in_tag_order(want_state, want_state.x))


def test_builder_deck_settings_a_builder_does_not_take():
    """polymer_melt takes no lam, cadence, rebuild or wrap: the deck's go
    onto the built system, its fitted capacity kept."""
    deck = {"model": {"builder": "polymer_melt",
                      "args": {"l": 6.0, "n_chains": 3, "chain_len": 8}},
            "integrate": {"lambda_": 0.7},
            "neighbor": {"skin": 0.4, "rebuild_every": 4},
            "engine": {"force_path": "pallas", "rebuild": "sort",
                       "wrap_mode": "rebuild"}}
    system, params, state, _ = build_from_deck(deck, device="cpu")
    built, _, _ = polymer_melt(l=6.0, n_chains=3, chain_len=8,
                               force_path="pallas", skin=0.4, device="cpu")
    assert system == built.replace(
        lam=0.7, wrap_mode="rebuild", cells=built.cells.replace(
            rebuild_every=4, rebuild="sort", wrap_at_rebuild=True))
    assert int(state.mask.sum()) == int(3.0 * 6.0 ** 3)


def test_builder_deck_spill_set_on_the_system():
    """The melt's builder takes no spill: the deck's goes onto the built
    system (the builder's default follows the force path)."""
    system, _, _, _ = build_from_deck(
        _melt_deck(8.0, 3, 4, engine={"force_path": "pallas"}), device="cpu")
    assert system.force_path == "pallas" and system.cells.spill
    system, _, _, _ = build_from_deck(
        _melt_deck(8.0, 3, 4, engine={"force_path": "pallas",
                                      "spill": False}), device="cpu")
    assert not system.cells.spill


def test_builder_deck_without_the_sections_is_the_builders():
    deck = {"model": {"builder": "block_copolymer_melt",
                      "args": {"l": 6.0, "force_path": "pallas",
                               "skin": 0.4}}}
    system, _, state, _ = build_from_deck(deck, device="cpu")
    want, _, want_state = block_copolymer_melt(l=6.0, force_path="pallas",
                                               skin=0.4, device="cpu")
    assert system == want
    assert torch.equal(state.x, want_state.x)


@pytest.mark.parametrize("section,key,want", [
    ("engine", "spil", "[engine] spil"),
    ("neighbor", "every", "[neighbor] every"),
    ("integrate", "gamma", "[integrate] gamma"),
    ("rng", "rounds", "[rng] rounds"), ("atoms", "n", "[atoms]"),
    ("pair", "coeff", "[pair.coeff]"),
    ("model", "skin", "[neighbor] skin (also [model.args] skin)")])
def test_builder_deck_raises_on_what_it_cannot_apply(section, key, want):
    deck = _melt_deck(6.0, 3, 4)
    if section == "model":
        deck["model"]["args"][key] = 0.3
    else:
        deck.setdefault(section, {})[key] = 1.0
    with pytest.raises(ValueError, match=want.replace("[", r"\[")
                       .replace("]", r"\]").replace("(", r"\(")
                       .replace(")", r"\)")):
        build_from_deck(deck, device="cpu")


# --- the pair bonds' kernel walk --------------------------------------------

def _kernel_walk(x, tag, mask, box, params, style, n_tags, owner=None):
    """ops.bonded.pair_bonds' kernel pair in torch: inv[tag] = row, then
    each owned row's partners in partner_table order, each checked and its
    bond's force computed from the row's own side. Returns (f, missing)."""
    table, width = bonded.partner_table(params, n_tags)
    n = x.shape[0]
    inv = torch.full((n_tags + 1,), -1, dtype=torch.int64)
    rows = torch.nonzero(mask).reshape(-1)
    inv[tag[rows].long()] = rows
    own = mask if owner is None else mask & owner
    f = torch.zeros_like(x)
    missing = 0
    coeffs = params.bond_coeffs
    for i in torch.nonzero(own).reshape(-1).tolist():
        s = torch.zeros(3)
        for p, typ in table[int(tag[i])].tolist():
            if p == 0:
                break
            r = int(inv[p])
            if r < 0 or not bool(mask[r]) or int(tag[r]) != p:
                missing += 1
                continue
            d = box.min_image(x[i] - x[r])[None]
            s = s + bonded._BOND_FORCES[style](d, coeffs[[typ]])[0]
        f[i] = s
    return f, missing


def _shuffled(state, seed):
    """The state's rows in a random order: bucket rows keep tags in cell
    order, the kernel walks whatever order the rows are in."""
    perm = torch.randperm(state.n, generator=torch.Generator().manual_seed(
        seed))
    return state.replace(**{k: getattr(state, k)[perm]
                            for k in ("x", "tag", "mask")})


BONDED_CASES = {
    "fene": lambda: polymer_melt(l=6.0, n_chains=6, chain_len=8,
                                 force_path="dense", device="cpu"),
    "harmonic": lambda: block_copolymer_melt(l=5.0, force_path="dense",
                                             device="cpu"),
    "wlc_pow": lambda: membrane_suspension(l=8.0, radius=2.0, subdiv=1,
                                           force_path="dense",
                                           device="cpu")[:3],
}


@pytest.mark.parametrize("style", list(BONDED_CASES))
def test_kernel_walk_matches_the_plain_chain(style):
    system, params, state = BONDED_CASES[style]()
    assert system.bond_style == style
    st = _shuffled(state, 5)
    pair_only = params.bonded.replace(tri_tags=None, tri_mol=None,
                                      membrane=None, tri_a0=None,
                                      hinge_tags=None, hinge_coeffs=None)
    want, _ = bonded._bonded_plain(st.x, st.tag, st.mask, st.box, pair_only,
                                   style, system.n_tags, 0, None, None, None,
                                   False)
    got, missing = _kernel_walk(st.x, st.tag, st.mask, st.box, pair_only,
                                style, system.n_tags)
    assert missing == 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(
        want.abs().max()))
    assert float(want.abs().max()) > 0


def test_kernel_walk_owner_rows_and_missing_partners():
    """With an owner mask and some partners absent (the distributed path's
    ghost rows), the walk gives the plain chain's owned rows and its
    missing count."""
    system, params, state = BONDED_CASES["fene"]()
    st = _shuffled(state, 6)
    g = torch.Generator().manual_seed(3)
    mask = st.mask & (torch.rand(st.n, generator=g) > 0.1)
    owner = torch.rand(st.n, generator=g) > 0.5
    want, want_missing = bonded._bonded_plain(
        st.x, st.tag, mask, st.box, params.bonded, "fene", system.n_tags, 0,
        None, owner, None, True)
    got, missing = _kernel_walk(st.x, st.tag, mask, st.box, params.bonded,
                                "fene", system.n_tags, owner)
    assert missing == int(want_missing) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(
        want.abs().max()))


def test_partner_table_order_and_cache():
    """Each tag's partners in bond order (a middle bead: the bond to its
    predecessor first), padded with 0; one table per object and bonds."""
    params = bonded.BondedParams(
        bond_tags=torch.tensor([[1, 2], [2, 3], [0, 0], [3, 4], [5, 3]],
                               dtype=torch.int32),
        bond_type=torch.tensor([0, 1, 0, 0, 1], dtype=torch.int32),
        bond_coeffs=torch.zeros((2, 4)))
    table, width = bonded.partner_table(params, 6)
    assert width == 3 and table.shape == (7, 3, 2)
    assert table[3].tolist() == [[2, 1], [4, 0], [5, 1]]
    assert table[2].tolist() == [[1, 0], [3, 1], [0, 0]]
    assert table[6].tolist() == [[0, 0]] * 3 and table[0].sum() == 0
    assert bonded.partner_table(params, 6)[0] is table
    params.bond_tags[4, 0] = 6       # edited in place: a new table
    assert bonded.partner_table(params, 6)[0][6].tolist()[0] == [3, 1]
    # kept on the object: another object of the same bonds builds its own
    other = params.replace()
    assert bonded.partner_table(other, 6)[0] is not \
        bonded.partner_table(params, 6)[0]


def test_bonded_forces_add_to_on_the_cpu():
    """add_to on a CPU tensor: the pair force plus the plain chain's, and
    add_to left as it was."""
    system, params, state = BONDED_CASES["fene"]()
    f0 = torch.randn(state.f.shape, generator=torch.Generator().manual_seed(
        1))
    keep = f0.clone()
    plain = bonded.bonded_forces(state.x, state.tag, state.mask, state.box,
                                 params.bonded, "fene", system.n_tags)
    got = bonded.bonded_forces(state.x, state.tag, state.mask, state.box,
                               params.bonded, "fene", system.n_tags,
                               add_to=f0)
    assert torch.equal(got, f0 + plain) and torch.equal(f0, keep)
