"""External configuration input, the ``read_data`` analog (port of
``meso_tpu/io/data.py``).

Reads LAMMPS-style text data files (the reference's ``read_data`` format,
``src/read_data.cpp``) and .npz snapshots, so that externally prepared
configurations (positions, velocities, types, molecule ids, bonds,
angles) run without writing Python. Decks reference it via

    [atoms]
    create = "read_data"
    file = "config.data"          # or .npz

Supported text sections: header counts (``N atoms/bonds/angles``,
``N atom/bond/angle types``, ``xlo xhi`` bounds), ``Masses``, ``Atoms``
(styles ``atomic``: id type x y z [ix iy iz]; ``molecular``/``bond``:
id mol type x y z [ix iy iz]), ``Velocities`` (id vx vy vz), ``Bonds``
(id type a b), ``Angles`` (id type a b c). Unknown sections are skipped
with their bodies. npz keys: x (N,3) required; v, typ, mol, image, bonds
(NB,2 tags), bond_type, angles (NA,3), angle_type optional.

The parsing is numpy, the same as the JAX package's; ``state_from_data``
builds the port's State on a device.
"""

from __future__ import annotations

import numpy as np

_HEADER_COUNTS = {
    "atoms": "n_atoms", "bonds": "n_bonds", "angles": "n_angles",
    "atom types": "n_atom_types", "bond types": "n_bond_types",
    "angle types": "n_angle_types",
}
_SECTIONS = ("Masses", "Atoms", "Velocities", "Bonds", "Angles",
             "Dihedrals", "Impropers", "Pair Coeffs", "Bond Coeffs",
             "Angle Coeffs")


def read_data(path: str) -> dict:
    """Parse a configuration file into plain numpy arrays.

    Returns a dict with keys: n, box_lo (3,), box_hi (3,), x (N,3),
    v (N,3), typ (N,) 0-based, mol (N,), image (N,3), tag (N,) 1-based,
    masses (T,) or None, bonds (NB,2 tags) or None, bond_type (NB,) 0-based,
    angles/angle_type likewise.
    """
    if path.endswith(".npz"):
        return _read_npz(path)
    return _read_lammps_text(path)


def _read_npz(path: str) -> dict:
    z = np.load(path)
    x = np.asarray(z["x"], np.float32)
    n = len(x)
    out = {
        "n": n,
        "box_lo": np.asarray(z.get("box_lo", np.zeros(3)), np.float32),
        "box_hi": np.asarray(z["box_hi"], np.float32) if "box_hi" in z
        else np.ceil(x.max(0) + 1e-3).astype(np.float32),
        "x": x,
        "v": np.asarray(z.get("v", np.zeros_like(x)), np.float32),
        "typ": np.asarray(z.get("typ", np.zeros(n)), np.int32),
        "mol": np.asarray(z.get("mol", np.zeros(n)), np.int32),
        "image": np.asarray(z.get("image", np.zeros((n, 3))), np.int32),
        "tag": np.asarray(z.get("tag", np.arange(1, n + 1)), np.int32),
        "masses": np.asarray(z["masses"], np.float32) if "masses" in z
        else None,
        "bonds": np.asarray(z["bonds"], np.int32) if "bonds" in z else None,
        "bond_type": np.asarray(z.get("bond_type",
                                      np.zeros(len(z["bonds"]))), np.int32)
        if "bonds" in z else None,
        "angles": np.asarray(z["angles"], np.int32) if "angles" in z
        else None,
        "angle_type": np.asarray(z.get("angle_type",
                                       np.zeros(len(z["angles"]))),
                                 np.int32) if "angles" in z else None,
        "has_velocities": "v" in z,
    }
    return out


def _strip(line: str) -> str:
    return line.split("#", 1)[0].strip()


def _read_lammps_text(path: str) -> dict:
    with open(path) as f:
        lines = f.readlines()
    counts = {v: 0 for v in _HEADER_COUNTS.values()}
    lo = np.zeros(3, np.float32)
    hi = np.ones(3, np.float32)
    i = 1  # first line is a comment/title
    # --- header ---
    while i < len(lines):
        s = _strip(lines[i])
        if not s:
            i += 1
            continue
        if any(s.startswith(sec) for sec in _SECTIONS):
            break
        parts = s.split()
        matched = False
        for key, name in _HEADER_COUNTS.items():
            if s.endswith(key) and len(parts) == len(key.split()) + 1:
                counts[name] = int(parts[0])
                matched = True
                break
        if not matched:
            for d, (klo, khi) in enumerate((("xlo", "xhi"), ("ylo", "yhi"),
                                            ("zlo", "zhi"))):
                if s.endswith(f"{klo} {khi}"):
                    lo[d], hi[d] = float(parts[0]), float(parts[1])
                    matched = True
                    break
        if not matched and not any(c.isalpha() for c in s):
            pass  # tolerate bare numeric header lines
        i += 1

    n = counts["n_atoms"]
    out = {
        "n": n, "box_lo": lo, "box_hi": hi,
        "x": np.zeros((n, 3), np.float32),
        "v": np.zeros((n, 3), np.float32),
        "typ": np.zeros(n, np.int32), "mol": np.zeros(n, np.int32),
        "image": np.zeros((n, 3), np.int32),
        "tag": np.arange(1, n + 1, dtype=np.int32),
        "masses": None, "bonds": None, "bond_type": None,
        "angles": None, "angle_type": None,
        "has_velocities": False,
    }

    def body(start, count):
        rows = []
        j = start
        while j < len(lines) and len(rows) < count:
            s = _strip(lines[j])
            if s and any(s.startswith(sec) for sec in _SECTIONS):
                break  # tolerate short sections (e.g. partial Velocities)
            j += 1
            if s:
                rows.append(s.split())
        return rows, j

    while i < len(lines):
        s = _strip(lines[i])
        if not s:
            i += 1
            continue
        section = s
        raw_line = lines[i]  # keeps the style hint comment: 'Atoms # atomic'
        if section.startswith("Masses"):
            rows, i = body(i + 1, counts["n_atom_types"])
            m = np.ones(counts["n_atom_types"], np.float32)
            for r in rows:
                m[int(r[0]) - 1] = float(r[1])
            out["masses"] = m
        elif section.startswith("Atoms"):
            rows, i = body(i + 1, n)
            # LAMMPS writes the atom style as a comment ('Atoms # atomic'),
            # which _strip removed from `section` — read it from the raw
            # line; absent a hint, infer from the column count (atomic rows
            # have 5 or 8 values, molecular 6 or 9)
            if "#" in raw_line:
                molecular = "atomic" not in raw_line.split("#", 1)[1]
            elif rows:
                molecular = len(rows[0]) in (6, 9)
            else:
                molecular = True
            for r in rows:
                idx = int(r[0]) - 1
                if molecular:
                    out["mol"][idx] = int(r[1])
                    out["typ"][idx] = int(r[2]) - 1
                    vals = r[3:]
                else:
                    out["typ"][idx] = int(r[1]) - 1
                    vals = r[2:]
                out["x"][idx] = [float(vals[0]), float(vals[1]),
                                 float(vals[2])]
                if len(vals) >= 6:
                    out["image"][idx] = [int(vals[3]), int(vals[4]),
                                         int(vals[5])]
        elif section.startswith("Velocities"):
            rows, i = body(i + 1, n)
            out["has_velocities"] = True
            for r in rows:
                out["v"][int(r[0]) - 1] = [float(r[1]), float(r[2]),
                                           float(r[3])]
        elif section.startswith("Bonds"):
            rows, i = body(i + 1, counts["n_bonds"])
            bonds = np.zeros((counts["n_bonds"], 2), np.int32)
            btype = np.zeros(counts["n_bonds"], np.int32)
            for r in rows:
                k = int(r[0]) - 1
                btype[k] = int(r[1]) - 1
                bonds[k] = [int(r[2]), int(r[3])]
            out["bonds"], out["bond_type"] = bonds, btype
        elif section.startswith("Angles"):
            rows, i = body(i + 1, counts["n_angles"])
            angles = np.zeros((counts["n_angles"], 3), np.int32)
            atype = np.zeros(counts["n_angles"], np.int32)
            for r in rows:
                k = int(r[0]) - 1
                atype[k] = int(r[1]) - 1
                angles[k] = [int(r[2]), int(r[3]), int(r[4])]
            out["angles"], out["angle_type"] = angles, atype
        else:
            # skip unknown section bodies until the next recognized header
            i += 1
            while i < len(lines):
                s2 = _strip(lines[i])
                if s2 and any(s2.startswith(sec) for sec in _SECTIONS):
                    break
                i += 1
            continue
    return out


def state_from_data(data: dict, kt_init: float | None = None,
                    init_seed: int = 0, device="cuda"):
    """Build (box, State) from a parsed data dict, on ``device`` (the card
    unless the caller names another).

    Maxwell velocities are drawn only when the file carries no Velocities
    section: a deliberately cold start (v = 0 given) stays cold even though
    the deck path always passes kt_init. Older dicts without the presence
    flag fall back to the all-zero test. The draws come from a
    ``torch.Generator`` seeded with ``init_seed`` on ``device`` and differ
    from the JAX package's."""
    import torch

    from meso_tpu_torch.core.box import Box
    from meso_tpu_torch.core.rng import maxwell_velocities
    from meso_tpu_torch.core.state import zeros_state

    device = torch.device(device)
    n = data["n"]
    lengths = data["box_hi"] - data["box_lo"]
    box = Box.orthorhombic(*[float(v) for v in lengths], device=device)

    def tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    x = tensor(data["x"] - data["box_lo"], np.float32)
    has_v = data.get("has_velocities", bool(np.any(data["v"])))
    if kt_init is not None and not has_v:
        masses = data["masses"]
        m = 1.0 if masses is None else masses[data["typ"]]
        gen = torch.Generator(device=device)
        gen.manual_seed(init_seed)
        v = maxwell_velocities(gen, n, kt_init, m, device=device)
    else:
        v = tensor(data["v"], np.float32)
    state = zeros_state(n, box).replace(
        x=x, v=v, typ=tensor(data["typ"], np.int32),
        mol=tensor(data["mol"], np.int32),
        image=tensor(data["image"], np.int32),
        tag=tensor(data["tag"], np.int32),
        mask=torch.ones(n, dtype=torch.bool, device=device))
    return box, state
