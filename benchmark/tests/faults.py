"""Faults planted in the timed path underneath an otherwise unchanged
run: each is a ``monkeypatch`` context's setup, and ``broken_window``
plants one in the harness's window only."""

from __future__ import annotations

import torch

from benchlib import window


def broken_window(monkeypatch, fault):
    """Replace the harness's window by one that runs with ``fault``
    planted in the program for its duration."""
    inner = window.run_window

    def broken(*a, **kw):
        with monkeypatch.context() as m:
            fault(m)
            return inner(*a, **kw)

    monkeypatch.setattr(window, "run_window", broken)


def _unchanged(m):
    from meso_tpu_torch.core import system
    m.setattr(system, "make_step",
              lambda sy, with_aux=False: (lambda params, state, *a: state))


def _half_moved(m):
    from meso_tpu_torch.core import system
    ii, fi = system.initial_integrate, system.final_integrate

    def half(mask):
        keep = torch.arange(mask.shape[0], device=mask.device) \
            < mask.shape[0] // 2
        return mask & keep

    m.setattr(system, "initial_integrate",
              lambda x, v, f, image, box, dt, lam, inv_m, move, wrap=True:
              ii(x, v, f, image, box, dt, lam, inv_m, half(move), wrap))
    m.setattr(system, "final_integrate",
              lambda v, f0, f1, dt, inv_m, move:
              fi(v, f0, f1, dt, inv_m, half(move)))


def _force_altered(m):
    from meso_tpu_torch.core import system
    cf = system.compute_forces

    def altered(sy, params, state, *a, **kw):
        f, aux = cf(sy, params, state, *a, **kw)
        row = int(torch.nonzero(state.mask)[0])
        f = f.clone()
        f[row, 0] += 1.0
        return f, aux

    m.setattr(system, "compute_forces", altered)


def _rows_swapped(m):
    from meso_tpu_torch.core.state import PER_PARTICLE
    from meso_tpu_torch.neighbor import bucket_layout
    rb = bucket_layout.rebuild_buckets

    def swapped(state, cfg):
        state, overflow = rb(state, cfg)
        a, b = torch.nonzero(state.mask)[:2, 0].tolist()
        idx = torch.arange(state.n, device=state.mask.device)
        idx[a], idx[b] = b, a
        return state.replace(**{k: getattr(state, k)[idx]
                                for k in PER_PARTICLE
                                if getattr(state, k) is not None}), overflow

    m.setattr(bucket_layout, "rebuild_buckets", swapped)


FAULTS = [(_unchanged, "force_gap"), (_half_moved, "velocity_gap"),
          (_force_altered, "force_gap"), (_rows_swapped, "placement_miss")]
FAULT_IDS = ["state_unchanged", "half_the_particles_left_out",
             "one_force_altered", "rows_swapped"]
