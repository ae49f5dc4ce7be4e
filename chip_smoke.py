#!/usr/bin/env python3
"""Smoke run of meso_tpu_torch on one NVIDIA card (built for the H100).

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. environment: torch, CUDA, nvcc, CUDA_HOME, triton, the card and its
   power limit; a card is required;
2. build: compile meso_tpu_torch/csrc/*.cu with nvcc for sm_90a;
3. kernels against their plain torch versions on the card: the hash kernel
   bitwise; the pair kernel at l=8 in every covered case (fast/tea RNG x
   spill/strict x min-image/no-min-image x virial on/off) and at the
   1M-particle main-path shape (L=70, 2,000,000 bucket rows), with both
   times;
4. main path: classic_fluid(l=70) through run_bucket_chunked, 399
   equilibration steps, 201 timed steps, then a traced window, in rounds
   of 300 steps, until the kT average has at least 10 effective samples;
   checks launch counts, overflow (every window), skin ratio (the timed
   window, as bench.py checks it; the others are reported), finiteness
   and kT within 1% of 1 at 3 sigma.

The last three lines are the kernels' JSON record, the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}. Every
number is also written to build/chip_smoke.json.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
L_MAIN = 70.0
SKIN, EVERY, LAM = 0.4, 3, 0.65
EQUIL_CHUNKS, TIMED_CHUNKS, TRACE_CHUNKS = 133, 67, 100
MAX_TRACE_ROUNDS = 20
MIN_N_EFF = 10.0


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def say(phase, **kw):
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def timed_ms(fn, reps, warmup=1):
    """Mean device time of fn() in ms, from CUDA events around reps calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kt_stats(kts):
    """Mean, standard error and effective sample count of a kT trace, with
    the lag-1 autocorrelation correction bench.py uses."""
    import numpy as np
    dk = kts - kts.mean()
    acf1 = float((dk[:-1] * dk[1:]).mean() / max(dk.var(), 1e-30))
    tau = (1 + acf1) / max(1 - acf1, 1e-3)
    n_eff = max(kts.size / (2 * tau), 1.0)
    return float(kts.mean()), float(kts.std(ddof=1) / np.sqrt(n_eff)), n_eff


def bucket_case(l, n, spill, min_image, rebuild="sort", seed=3):
    """A bucket state on the card whose rows moved since the rebuild:
    unwrapped by <= skin/2 (no-min-image layout) or box-wrapped (min-image
    layout, so rows that crossed the boundary sit in their old cells)."""
    import torch
    from meso_tpu_torch.core.box import Box
    from meso_tpu_torch.core.state import create_random
    from meso_tpu_torch.neighbor.bucket_layout import to_bucket_state
    from meso_tpu_torch.neighbor.cells import CellConfig
    box = Box.cubic(l, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    st = create_random(gen, n, box)
    cfg = CellConfig.for_box([l] * 3, 1.0, n / l ** 3, skin=SKIN, spill=spill,
                             rebuild_every=EVERY, rebuild=rebuild,
                             wrap_at_rebuild=not min_image)
    bst = to_bucket_state(st, cfg)
    x = bst.x + torch.clamp(0.04 * bst.v, -SKIN / 2, SKIN / 2) \
        * bst.mask[:, None]
    if min_image:
        x = box.wrap(x)[0]
    return bst.replace(x=x), cfg


def compare_forces(f_k, vir_k, f_p, vir_p, mask, min_image, label):
    """Kernel vs plain version: the bounds of the JAX v3 tests."""
    import torch
    err = (f_k - f_p)[mask].abs().max().item()
    rel = err / f_p[mask].abs().max().item()
    pad = f_k[~mask].abs().max().item() if bool((~mask).any()) else 0.0
    vrel = abs(vir_k.item() - vir_p.item()) / abs(vir_p.item())
    tol, vtol = (2e-5, 1e-4) if min_image else (5e-5, 1e-3)
    ok = (bool(torch.isfinite(f_k).all()) and rel < tol and pad == 0.0
          and vrel < vtol)
    if not ok:
        raise AssertionError(f"{label}: rel {rel:.3g} (< {tol}), pad {pad}, "
                             f"virial rel {vrel:.3g} (< {vtol})")
    return err, rel, vrel


def phase_env():
    import torch
    from torch.utils import cpp_extension
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing to run", file=sys.stderr)
        sys.exit(2)
    from meso_tpu_torch.kernels import _build
    nvcc = run([_build.find_nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc, "CUDA_HOME": cpp_extension.CUDA_HOME,
            "triton": triton_version, "card": card,
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "python": sys.version.split()[0]}
    say("env", **info)
    return info


def phase_build():
    from meso_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    say("build", seconds=round(secs, 3), library=str(path.relative_to(ROOT)),
        ptxas=ptxas)
    return {"seconds": secs, "ptxas": ptxas}


def phase_kernels():
    import torch
    from meso_tpu_torch.core import rng
    from meso_tpu_torch.kernels.pair_dpd_v3 import (bucket_forces_pallas_v3,
                                                    bucket_forces_v3_plain,
                                                    particle_hash_v3)
    from meso_tpu_torch.neighbor.bucket_layout import rebuild_buckets
    from meso_tpu_torch.ops.dpd import DPDParams, dense_forces
    out = {"l8": []}
    params = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77,
                             device=DEVICE)
    step = 42

    # hash kernel, bitwise, including tags near 2^24 and 2^31 and seeds
    # >= 2^31
    edge = torch.tensor([0, 1, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1,
                         2 ** 31 - 1], dtype=torch.int32, device=DEVICE)
    for seed in (0, 928459, 2 ** 31, 2 ** 32 - 1):
        for hstep in (0, 1, 2 ** 31 - 1):
            if not torch.equal(particle_hash_v3(edge, hstep, seed),
                               rng.particle_hash(edge, hstep, seed)):
                raise AssertionError(f"hash kernel != plain (seed {seed})")

    # pair kernel at l = 8 in every covered case
    for spill in (True, False):
        for min_image in (False, True):
            bst, cfg = bucket_case(8.0, 1536, spill, min_image)
            m = bst.mask
            idx = torch.nonzero(m).squeeze(1)
            for rng_mode in ("fast", "tea"):
                args = (bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box,
                        step, params, 0.01, cfg)
                f_k, vir_k = bucket_forces_pallas_v3(*args, rng_mode=rng_mode)
                f_k2, vir_off = bucket_forces_pallas_v3(
                    *args, rng_mode=rng_mode, need_virial=False)
                torch.cuda.synchronize()
                f_p, vir_p = bucket_forces_v3_plain(
                    bst.x, bst.v, bst.tag, bst.mask, bst.box, step, params,
                    0.01, cfg, rng_mode)
                label = f"l8 {rng_mode} spill={spill} min_image={min_image}"
                err, rel, vrel = compare_forces(f_k, vir_k, f_p, vir_p, m,
                                                min_image, label)
                if not torch.equal(f_k, f_k2) or vir_off.item() != 0.0:
                    raise AssertionError(f"{label}: need_virial=False "
                                         "changed the forces")
                # and the port's dense O(N^2) oracle over the valid rows
                f_d, vir_d, _ = dense_forces(
                    bst.x[idx], bst.v[idx], bst.typ[idx], bst.tag[idx],
                    bst.mask[idx], bst.box, step, params, 0.01,
                    rng_mode=rng_mode)
                f_k_valid = f_k[idx]
                drel = ((f_k_valid - f_d).abs().max()
                        / f_d.abs().max()).item()
                if drel > (2e-5 if min_image else 5e-5):
                    raise AssertionError(f"{label}: vs dense rel {drel:.3g}")
                out["l8"].append({"case": label, "max_abs_err": err,
                                  "rel": rel, "virial_rel": vrel,
                                  "dense_rel": drel})
    say("kernels-l8", cases=len(out["l8"]),
        worst_rel=max(c["rel"] for c in out["l8"]),
        worst_dense_rel=max(c["dense_rel"] for c in out["l8"]))

    # the main-path shape: L = 70, spill, fast, no min-image
    n = int(round(3.0 * L_MAIN ** 3))
    bst, cfg = bucket_case(L_MAIN, n, True, False)
    args = (bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, step, params,
            0.01, cfg)
    f_k, vir_k = bucket_forces_pallas_v3(*args, rng_mode="fast")
    f_p, vir_p = bucket_forces_v3_plain(bst.x, bst.v, bst.tag, bst.mask,
                                        bst.box, step, params, 0.01, cfg)
    err, rel, vrel = compare_forces(f_k, vir_k, f_p, vir_p, bst.mask, False,
                                    "L70")
    h_k = particle_hash_v3(bst.tag, step, params.seed)
    h_p = rng.particle_hash(bst.tag, step, params.seed)
    hash_err = (h_k - h_p).abs().max().item()
    if hash_err != 0:
        raise AssertionError("hash kernel != plain at the main-path shape")
    ms = {
        "pair_ms": timed_ms(lambda: bucket_forces_pallas_v3(
            *args, rng_mode="fast", need_virial=False), 20),
        "pair_virial_ms": timed_ms(lambda: bucket_forces_pallas_v3(
            *args, rng_mode="fast"), 20),
        "pair_plain_ms": timed_ms(lambda: bucket_forces_v3_plain(
            bst.x, bst.v, bst.tag, bst.mask, bst.box, step, params, 0.01,
            cfg, need_virial=False), 3),
        "hash_ms": timed_ms(lambda: particle_hash_v3(bst.tag, step,
                                                     params.seed), 50),
        "hash_plain_ms": timed_ms(lambda: rng.particle_hash(
            bst.tag, step, params.seed), 20),
        "rebuild_sort_ms": timed_ms(lambda: rebuild_buckets(bst, cfg), 10),
    }
    out["l70"] = {"n": n, "nr": bst.n, "ncell": list(cfg.ncell),
                  "capacity": cfg.capacity, "max_abs_err": err, "rel": rel,
                  "virial_rel": vrel, "hash_max_abs_err": hash_err, **ms}
    say("kernels-l70", **out["l70"])
    return out


def phase_main_path():
    import numpy as np
    import torch
    from meso_tpu_torch.core.system import run_bucket_chunked
    from meso_tpu_torch.kernels.pair_dpd_v3 import (LAUNCHES,
                                                    reset_launch_counts)
    from meso_tpu_torch.models.classic import classic_fluid
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    system, params, state = classic_fluid(
        l=L_MAIN, rng_mode="fast", force_path="pallas", pair_kernel="v3",
        rebuild="sort", wrap_mode="rebuild", skin=SKIN, rebuild_every=EVERY,
        device=DEVICE)
    system = system.replace(lam=LAM)
    n = int(state.n_valid())
    force_evals = 1
    diags = {"equil": [], "timed": [], "traced": []}

    def advance(s, chunks, window):
        nonlocal force_evals
        s, d = run_bucket_chunked(system, params, s, chunks, EVERY,
                                  thermo_trace=window == "traced")
        force_evals += chunks * EVERY
        diags[window].append(d)
        return s, d

    state, _ = advance(state, EQUIL_CHUNKS, "equil")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, _ = advance(state, TIMED_CHUNKS, "timed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    setup_equil_s = t1 - t0
    kts = []
    for _ in range(MAX_TRACE_ROUNDS):
        state, d = advance(state, TRACE_CHUNKS, "traced")
        kts.append(d["kt_trace"].cpu().numpy())
        kt_mean, kt_sem, n_eff = kt_stats(np.concatenate(kts))
        if n_eff >= MIN_N_EFF:
            break
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    timed_steps = TIMED_CHUNKS * EVERY
    overflow = max(int(d["bucket_overflow"])
                   for ds in diags.values() for d in ds)
    skin = {w: max(float(d["worst_skin_ratio"]) for d in ds)
            for w, ds in diags.items()}
    skin_ratio = skin["timed"]
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.x, state.v, state.f))
    res = {"n_particles": n, "rows": state.n, "steps": force_evals - 1,
           "timed_steps": timed_steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / timed_steps,
           "particle_steps_per_s": n * timed_steps / wall,
           "setup_and_equil_s": setup_equil_s,
           "kT_mean": kt_mean, "kT_sem": kt_sem, "kT_3sig": 3 * kt_sem,
           "kT_n_eff": n_eff, "kT_trace_steps": int(sum(k.size for k in kts)),
           "bucket_overflow": overflow, "worst_skin_ratio": skin_ratio,
           "worst_skin_ratio_equil": skin["equil"],
           "worst_skin_ratio_traced": skin["traced"],
           "force_evals": force_evals, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    say("main-path", **res)
    checks = {
        "pair launches == force evaluations":
            launches["pair_dpd_v3"] == force_evals,
        "hash launches == force evaluations":
            launches["particle_hash"] == force_evals,
        "bucket_overflow == 0": overflow == 0,
        "worst_skin_ratio < 1": skin_ratio < 1.0,
        "state finite": finite,
        "kT_n_eff >= 10": n_eff >= MIN_N_EFF,
        "|kT - 1| + 3 sigma <= 0.01": abs(kt_mean - 1.0) + 3 * kt_sem <= 0.01,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path failed: {failed}")
    return res


def main(argv):
    import torch
    info = phase_env()
    record = {"env": info, "build": phase_build()}
    record["kernels"] = phase_kernels()
    if "--kernels-only" not in argv:
        record["main_path"] = phase_main_path()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    if "--kernels-only" in argv:
        return 0
    l70 = record["kernels"]["l70"]
    launches = record["main_path"]["launches"]
    src = "meso_tpu_torch/csrc/pair_dpd_v3.cu"
    print(json.dumps({"kernels": [
        {"name": "pair_dpd_v3", "route": "cuda", "source": src,
         "replaces": "meso_tpu/kernels/pair_dpd_v3.py:75",
         "launches": launches["pair_dpd_v3"],
         "max_abs_err": l70["max_abs_err"], "ms": l70["pair_ms"],
         "plain_ms": l70["pair_plain_ms"]},
        {"name": "particle_hash", "route": "cuda", "source": src,
         "replaces": "meso_tpu/kernels/pair_dpd_v3.py:161",
         "launches": launches["particle_hash"],
         "max_abs_err": l70["hash_max_abs_err"], "ms": l70["hash_ms"],
         "plain_ms": l70["hash_plain_ms"]}]}), flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
