#!/usr/bin/env python3
"""Smoke run of meso_tpu_torch on one NVIDIA card (built for the H100).

    python3 chip_smoke.py [--kernels-only | --dd-only | --sweep-only |
                           --cli-only | --bricks-only | --bonds-only |
                           --decay-from FILE | --ab PARENT_DIR]

Phases, one line of output each (any failure raises and exits non-zero):

1. environment: torch, CUDA, nvcc, CUDA_HOME, triton, the card and its
   power limit; a card is required;
2. build: compile meso_tpu_torch/csrc/*.cu with nvcc for sm_90a, one nvcc
   per source, all at once;
3. kernels against their plain torch versions on the card: the hash kernel
   bitwise (edge tags, the 2,000,000 main-path rows, and 2,000,003 rows,
   not a multiple of its 4 rows a thread, with 8 and 5 rounds and from an
   unaligned pointer), timed alone at both counts, its bound from its
   instructions counted by pipe in the built library; the classic pair
   kernel K1 (on cell tiles) at l=8 in every covered case (fast/tea RNG x spill/strict x min-image/no-min-image x
   virial on/off), with a ragged last run of cx (l=41) and in dense
   fluids whose rows fill their in-range lists (rho 9 and 32, and
   capacities of 128 spill and 192 strict, which take one block an SM),
   and at the 1M-particle main-path shape (L=70, 2,000,000 bucket rows),
   with both times, its tile plan and its slot tests a valid row, and the
   spill rebuild's slot-assignment kernel bitwise against its plain
   version there (with and without the wrap, and on a brick's rows),
   timed with its plain version; then at L=70 through the TEA tier and
   on strict buckets;
4. kernels-transport-l8: the uniform_stream device helper bitwise; the eDPD
   and tDPD kernels K2 and K3 against their plain versions and the port's
   dense oracles in every covered case (fast/tea x spill/strict x
   min-image/no-min-image), K3 both with two species (rcc 0.8, s1 2) and
   with one species, rcc = rc = 1, s1 = 1, as the tDPD path runs it; then
   K2's and K3's cell tiles (EDPD_TILE_CASES, TDPD_TILE_CASES): ragged
   runs of cx (l=41), dense fluids that fill the lists (rho 9 at K 128
   spill and 192 strict, rho 32 at K 216, one block an SM), TEA, both wrap
   modes, one type and two (eDPD with an asymmetric kappa), ten species
   with one and two types;
5. kernels-transport-l70: K2 and both K3 cases at the 1M shape against
   their plain versions, with their times, the plain times and K1's time
   on the same rows; then K2 and K3 on each 1M path's own inputs (its
   builder's state at set-up, its capacity and its coefficients), whose
   numbers the kernels' record reports with their tile plans, slot tests
   a valid row and the registers ptxas gave each instance;
6. main path: classic_fluid(l=70) through run_bucket_chunked, 399
   equilibration steps, 201 timed steps (timed in TIMED_BLOCKS blocks, each
   block's ms/step reported), then a traced window, in rounds
   of 300 steps, until the kT average has at least 10 effective samples;
   checks launch counts (the slot assignment once a rebuild on spill
   buckets), overflow (every window), skin ratio (the timed
   window, as bench.py checks it; the others are reported), finiteness
   and kT within 1% of 1 at 3 sigma;
7. transport-physics: the JAX package's eDPD/tDPD physics gates
   (tests/physics/test_transport.py) at its sizes, through the kernels:
   energy conservation of a free eDPD fluid, the Fourier slab profile, the
   decay of a tDPD cosine mode from six starts (its rate held against the
   JAX dense path's) and sum C under the random flux;
8. transport-full: edpd_slab(l=70) and tdpd_diffusion(l=70) from their
   default starts, 1,029,000 particles each, 100 equilibration and 200
   timed steps each, a sort rebuild every 2 steps, with launch counts,
   overflow, skin ratio, finiteness, T within (0.3, 3) and the drift of
   sum C checked;
9. kernels-general-l8: K1's general variant (pair_dpd_v3_general: more
   than one type, s_exp != 1, special-bonds exclusions, debug_pairs)
   against its plain version in every covered combination (fast/tea x
   spill/strict x min-image/no-min-image, two types with an asymmetric a
   table and rc_01 = 0.8, s_exp = 0.5, exclusions E = 2 at weight 0.25),
   plus the two 1M paths' own combinations, then its cell tiles
   (GENERAL_TILE_CASES: ragged l=41, rho 9 at K 128/192 and rho 32 at K
   216, TEA, both wrap modes, E = 6 exclusions); forces within the JAX v3
   tests' bounds, debug_pairs bitwise;
10. kernels-general-l70: the general variant on each new 1M path's inputs
   at set-up (walls-full, polymer-full), with its time, the plain time,
   K1's one-type time on the same rows, the bound, the tile plan, the slot
   tests a valid row and the registers ptxas gave each instance; K1's
   one-type time at the main-path shape below PR 6's on the same card;
11. walls-physics: the gates of tests/physics/test_walls.py at their deck
   sizes through the kernels and run_bucket (Poiseuille parabola and
   viscosity, Couette profile, frozen walls, Mueller-Plathe viscosity on
   force_path "pallas");
12. bonded-physics: the gates of tests/physics/test_polymer.py (FENE
   chains, also with special_weight 0.5; the membrane vesicle);
13. walls-full and polymer-full: poiseuille(lx=h=lz=70) and
   polymer_melt(l=70, 3200 chains of 16, special_weight 0.5), 1,029,000
   particles each, 300 steps of run_bucket then 200 timed steps of
   run_bucket_chunked at the first of 3 or 2 steps per rebuild that keeps
   the skin ratio below 1, every force evaluation through the general
   variant, with each path's gates;
14. kernels-selectors-l8: the fused (K5: pair_fused_dpd/_edpd/_tdpd) and
   banded (K6: pair_banded_dpd; K7: pair_banded_edpd/_tdpd) entry points,
   all on csrc/pair_brick.cu but K6, which reads the bucket rows on K1's
   general variant, against their plain versions at l=8: fast and
   TEA, spill (K5) and strict, one type and two with asymmetric tables,
   s_exp 0.5 and exclusions (classic), one, three and ten species (tDPD),
   a row that crossed the box mid-window; then K2 and K3 with two types and
   ten species (fast/TEA x spill/strict x min-image on/off); then
   kernels-brick-tiles: the brick kernel's cell tiles (BRICK_TILE_CASES)
   on ragged runs of cx (l=41), dense fluids that fill the lists (rho 9 at
   K 128 spill and 192 strict; rho 32 at one block an SM), TEA, two types
   with exclusions, ten tDPD species, and K4's and K6-halo's edge calls
   (ncx = xr);
15. kernels-selectors-l70: each of those entry points on its own 1M path's
   inputs at set-up (spill rows for the fused, strict rows, K=28 and
   3,500,000 of them, for the banded), and the fused classic kernel on the
   wall and polymer paths' inputs, with times (through the wrapper, the
   brick's build included, and the kernel alone on the built brick; K6's
   kernel alone on its rows, and the brick kernel on the same inputs as
   brick_kernel_ms), plain times, bounds, the tile plan and the slot tests
   a valid row;
16. the classic, eDPD and tDPD paths at 1,029,000 particles through each
   selector (v2-classic, v2-edpd, v2-tdpd, banded-classic, banded-edpd,
   banded-tdpd), with the main path's and transport-full's steps and
   gates, every force evaluation through the selector's kernel;
17. banded-physics: the eDPD slab gate and the tDPD decay from one start
   at deck size through force_path "pallas_banded";
18. profile: torch.profiler over 10 chunks of each 1M path (the six new
   ones included), device time per kernel (the hash's listed on every
   path that launches it) and the card's busy share;
19. dd-kernels-l8: the halo kernels of the 1-D domain decomposition, K4
   (pair_halo_dpd/_edpd/_tdpd) and K6-halo (pair_halo_banded_dpd), all on
   csrc/pair_brick.cu, against their plain versions at l=8 on
   halo-extended bricks: fast and TEA, spill (K4) and strict, ext ("x",),
   ("x", "y") and ("x", "y", "z"), the edge and interior calls of the border/inner
   split, K5-K7's type, s_exp, exclusion and species cases;
20. dd-ring-of-one: the classic 1M start as one rank in-process, halos
   from its own far side: one force evaluation against the single-card
   K5, and 15 steps by tag against the single-card path;
21. dd-paths: two ranks sharing the card (gloo, halos staged through host
   memory), 25 of the 50 cell columns each, five paths at 1,029,000
   particles from their builders' starts after the single-card
   equilibration: classic through K4 with the border/inner split, classic
   through K6-halo on strict buckets, eDPD and tDPD through K4, and the
   FENE polymer with special bonds and bonded ghost rows; each path's
   kernel first on rank 0's extended planes against its plain version
   (dd-kernels-l70, timed through the wrapper and alone on the built
   brick, with its tile plan), then the run with its gates, the ranks'
   launch counts summed, and torch.profiler on rank 0 (its busy share and its idle time
   inside the host-staged exchanges). Two ranks on one card give no
   scaling figure.

22. probes: the TPU probes T1-T4 (``meso_tpu_torch/probes``, on
   csrc/probes.cu) as each probe's own run counts them, every kernel
   against its plain version (T1, T3, T4 bitwise; T2's products within
   1e-5 of max |ref|, its pair tile within 4x the float32 plain version's
   error against float64), then their times: T2 at 8,192 tiles beside
   torch.bmm with TF32 off and K1's time per candidate test (the pair tile
   also alone, with its own design's bound beside the row's), T3 through
   its wrapper and alone, T4 at K1's 1M view for zc 1, 5, 10 and 25 (the
   card's streaming rate, which gives each byte-bound kernel's measured
   floor in the kernels' record);
23. nlist-path: classic_fluid(l=70) with the JAX package's defaults
   (force_path "nlist", skin 0.3, cells and lists rebuilt every 10 steps,
   the TEA tier) from the main path's end state, through ``run``: ms/step,
   the list build's ms, overflow, kT within 1% at 3 sigma with 10
   effective samples; the skin check reported;
24. bucket-paths: the sweep (force_path "bucket") at 1M for classic,
   eDPD and tDPD through ``run_bucket_fixed`` from their paths' end
   states, with transport-full's gates; ``run_adaptive`` on the neighbour
   lists from the classic end state;
25. dd-bucket: the classic sweep under the 1-D decomposition on two gloo
   ranks sharing the card, with dd-paths' harness and gates;
26. cli: ``meso_tpu_torch.__main__.main`` in this process (the launch
   counts set to 0 after each deck's build, just before its loop, and
   read just after), every run's output under build/cli/: the 8 golden
   decks as shipped at their own run.steps, then copies on the kernels
   (force_path "pallas") with every force evaluation through K1, K1
   general, K2 or K3 and ``--validate`` within 1e-4 on JAX's six
   validate decks; the classic pallas copy once more through ``python -m
   meso_tpu_torch`` in a subprocess; the main path at L=70 through a deck
   (900 steps, a row every 150, kT within 1% of 1 from step 600, K1's
   launches equal to the steps, a dump, a binary frame and a restart;
   ms/step from the footer beside phase 6's); that restart resumed
   bitwise by tag (30 steps straight against 15, save, load, 15);
   ``--dd 2`` on the membrane deck (bonded_missing 0, N and tags kept);
   ``--autotune`` on a relaxed L=20 start read with ``create =
   "read_data"`` (its choice inside its skin); ``--profile``; rdf (20,000
   particles), msd and pressure_profile at the 1M end state against a
   CPU copy (computed meanwhile in a process pinned to all but two
   cores), within 1e-5;
27. bricks: the 2-D and 3-D bricks, the replica ensemble and the dry run,
   the ranks sharing the card through gloo, from the two-rank paths'
   starts (phase 21's, kept): classic-2d (2 x 2 ranks, 25 x 25 x 50
   cells a brick) and classic-3d (2 x 2 x 2) through K4 with ext ("x",
   "y") and ("x", "y", "z"), polymer-2d through K4 with exclusions and
   bonded ghost rows, edpd-2d and tdpd-2d through the sweep (strict,
   K=28), each with the two-rank paths' gates (K4 launched once a step a
   rank; kT within 1% of 1 over the traced chunks, without phase 21's
   effective-sample count) and K4 held against its plain version on rank
   0's real extended planes and timed; DP x SP (2 replicas x 2 slabs
   through K4); run_ensemble (2 replicas on K1, replica 0 bitwise the
   single-card run); ``dryrun_multichip(8)``;
28. bond-kernels (after 15): the pair bonds' kernel (``csrc/bonds.cu``)
   against the plain chain within 1e-6 of the largest force, bitwise from
   call to call and in place as stored, with an owner mask and missing
   partners as the plain chain, two launches a call: FENE on the polymer
   path's set-up, harmonic on the 1M A5B5 melt's, WLC-POW on a vesicle's
   edges (and the whole membrane force within 1e-5); timed through its
   wrapper, alone and against its bytes bound; the melt path (1,029,000
   beads, 926,100 bonds, K1's general variant) profiled over 10 chunks:
   the kernels' time a call in path and their calls a step.

Phases 9, 10, 14, 15 and 22 run after phase 5, phases 26 and 11-13 and
16-17 after phase 8, phases 20-21 after 17, phases 27 and 23-25 after
21.
``--kernels-only`` stops after phase 19; ``--dd-only`` runs phases 1, 2
and 19-21; ``--sweep-only`` runs phases 1-3, 22, 6, 8 (for the end
states) and 23-25; ``--cli-only`` runs phases 1, 2 and 26;
``--bricks-only`` runs phases 1, 2 and 27 (building the two-rank starts
itself); ``--bonds-only`` runs phases 1, 2 and 28.
``--decay-from FILE`` runs only the tDPD decay from the JAX package's
starts in FILE, against the JAX rates stored beside them (see
phase_decay_from). ``--ab PARENT_DIR`` runs only phases 1-2 and
phase_ab: this tree and the one at PARENT_DIR (an unpacked checkout of
another commit inside the repository, e.g. ``git archive HEAD~1`` under
build/) alternating, a process a run, each timing the main path in
blocks, the eDPD path, K1 and the brick kernel alone and K1's general
variant, K2 and K3 through their wrappers, the bonded force and the steps
of the polymer path, and saving the outputs of all but K2, which must
agree bitwise, but the bonded force, within 1e-6 of its largest value
(the plain chain's atomic sums are not bitwise).

Launch counts are set to 0 just before each path (6, each model of 8, each
path of 13 and 16, phase 17, each rank of each path of 21 and 27, the
probes' runs of 22, each path of 23-25 and each deck's loop of 26) is
driven and read just after. The
last three lines are the kernels' JSON record, the card's name and power
limit from nvidia-smi, and
{"ok": true, "device": {...}}. Every number is also written to
build/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
L_MAIN = 70.0
SKIN, EVERY, LAM = 0.4, 3, 0.65
EQUIL_CHUNKS, TIMED_CHUNKS, TRACE_CHUNKS = 133, 67, 100
TIMED_BLOCKS = 4
MAX_TRACE_ROUNDS = 20
MIN_N_EFF = 10.0
# transport-full: 50 + 100 chunks of 2 steps = 100 + 200 steps. With
# EVERY = 3 the eDPD run's worst skin ratio in its timed window was 1.035
# on an H100 (PERF.md): the energy-conserving fluid's internal
# temperatures spread as T^2/cv and fatten the velocity tail, so its full
# runs rebuild every 2 steps.
TRANSPORT_EVERY = 2
TRANSPORT_EQUIL_CHUNKS, TRANSPORT_TIMED_CHUNKS = 50, 100
PROFILE_CHUNKS = 10
# transport-physics, tDPD decay: tdpd_diffusion(l=8, kappa_c=2) from these
# starts. Its decay rate per 100 steps is held against the JAX package's
# dense path on a CPU: 0.3591, the mean over JAX init_seeds 0-11 (standard
# deviation 0.0037, range 0.354-0.367), which the slow test
# tests/test_torch_transport_decay.py recomputes, beside the port's rate
# from one of those starts. Tolerances: 5% per start, 3% in the mean.
TDPD_DECAY_SEEDS = (0, 1, 2, 3, 4, 5)
TDPD_DECAY_RATE_JAX = 0.3591
TDPD_DECAY_RATE_TOL, TDPD_DECAY_MEAN_TOL = 0.05, 0.03
# --decay-from: the card's rate against JAX's from the same start
DECAY_SAME_START_TOL = 0.02
# K1's one-type time through the wrapper at the main-path shape before its
# cell tiles (the fastest of PR 6's runs, PERF.md) and the card it was
# taken on: on that card the tile kernel must take less
K1_PR6_MS = 2.288
K1_PR6_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# walls-full and polymer-full: equilibration with run_bucket, then a timed
# window of run_bucket_chunked in blocks, at the first rebuild cadence
# whose worst skin ratio stays below 1
FULL_EQUIL_STEPS, FULL_TIMED_STEPS, FULL_BLOCKS = 300, 200, 4
FULL_CADENCES = (3, 2)
POLYMER_CHAINS, POLYMER_CHAIN_LEN = 3200, 16

# The least time a kernel could take (bound_ms): the larger of its bytes
# (each input read once, each output written once; for a pair kernel over
# bucket rows, the per-particle inputs of the valid rows only, the mask and
# the outputs of every row, and one scalar virial: row_bound) over the
# card's memory rate and its operations over their rates (Ops): fp32 over
# the fp32 rate outside the tensor cores (the NVIDIA H100 SXM data sheet);
# integer instructions over the SM's issue rate; and, where the compiled
# code was counted by pipe, its ALU and IMAD instructions over their
# pipes' rates. Per SM and clock an H100 (sm_90) issues one warp
# instruction from each of its 4 schedulers (128 lanes), and has 64 lanes
# of the ALU pipe (LOP3, LEA, IADD3, SHF, ISETP: integer work other than
# IMAD) and 64 of the FMA-heavy pipe (IMAD, and fp32 FMA beside the
# FMA-lite pipe's 64): NVIDIA's Hopper architecture white paper (64 INT32,
# 128 FP32 units an SM) and the Nsight Compute profiling guide (its pipe
# descriptions). The clock is the one the data sheet's fp32 rate implies:
# 67e12 = 2 (an FMA) x 128 lanes x 132 SMs x 1.98 GHz. Operations per
# in-range pair, counted from the CUDA sources (arithmetic after the
# cutoff test; the candidate tests are not counted): K1 33 fp32 + 11
# integer (the hash mix); K2 74 fp32 (with 3 divisions, 2 sqrt) + 33
# integer (mix and two streams); K3 34 fp32 + 22 integer, plus, inside
# rcc, 4 fp32 and per species 10 fp32 + 11 integer. The integer counts
# are C operations at the issue rate (any pipe); the compiler fuses some
# (three xors into one LOP3), so they may exceed the instructions, and
# they set no pair kernel's bound: bytes do. The hash's instructions are
# counted by pipe from the built library (hash_sass_ops).
# K1's general variant: 38 fp32 (K1's, with r2 summed again, rc^2 and
# 1/rc per pair) + 12 integer per pair, and 2 integer per exclusion slot.
# the pair kernel each selector runs, by model: force_path "pallas" with
# pair_kernel "v3" (K1-K3) or "v2" (the fused K5), and "pallas_banded" (K6,
# K7); K5 and K7 are one CUDA kernel family, csrc/pair_brick.cu, and K6
# (K6_ROWS) reads the bucket rows on K1's general variant
SELECTOR_KERNELS = {
    "v3": {"dpd": "pair_dpd_v3", "edpd": "pair_edpd_v3",
           "tdpd": "pair_tdpd_v3"},
    "v2": {"dpd": "pair_fused_dpd", "edpd": "pair_fused_edpd",
           "tdpd": "pair_fused_tdpd"},
    "banded": {"dpd": "pair_banded_dpd", "edpd": "pair_banded_edpd",
               "tdpd": "pair_banded_tdpd"}}
# the selector entry point whose kernel reads the bucket rows in place on
# one card (K1's general variant under the minimum image, on K1's plan):
# no brick
K6_ROWS = "pair_banded_dpd"
# the brick kernels' operations per in-range pair, counted from
# csrc/pair_brick.cu as for K1-K3 above: classic as K1's general variant
# (r2 summed again, per-pair tables), eDPD as K2, tDPD as K3
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SMS = 132
SM_CLOCK_HZ = FP32_OPS_PER_S / (2 * 128 * SMS)
ISSUE_PER_S = 128 * SMS * SM_CLOCK_HZ
ALU_PER_S = IMAD_PER_S = 64 * SMS * SM_CLOCK_HZ
# the MUFU (rsqrt, sqrt, exp): 16 lanes an SM a clock
MUFU_PER_S = 16 * SMS * SM_CLOCK_HZ
# the tensor cores' dense TF32 rate (the same data sheet): the probe T2's
# products run there, three or six TF32 products for each float32 one
TF32_OPS_PER_S = 495e12


class Ops(tuple):
    """(fp32, integer, alu, imad) operation counts: fp32 operations,
    integer instructions (on any pipe), and of those the ones known to
    run on the ALU pipe and on the FMA-heavy pipe (IMAD). ``+`` adds
    them, ``*`` by a number scales all four."""

    def __new__(cls, fp=0.0, integer=0.0, alu=0.0, imad=0.0):
        return super().__new__(cls, (fp, integer, alu, imad))

    def __add__(self, other):
        return Ops(*(a + b for a, b in zip(self, other)))

    def __sub__(self, other):
        return Ops(*(a - b for a, b in zip(self, other)))

    def __mul__(self, n):
        return Ops(*(a * n for a in self))

    __rmul__ = __mul__


BRICK_OPS = {"dpd": Ops(38, 12), "edpd": Ops(74, 33)}
OPS_PER_PAIR = {"pair_dpd_v3": Ops(33, 11), "pair_edpd_v3": Ops(74, 33),
                "pair_dpd_v3_general": Ops(38, 12)}
OPS_PER_EXCL_SLOT = Ops(0, 2)
TDPD_OPS_PER_PAIR, TDPD_OPS_PER_RCC_PAIR, TDPD_OPS_PER_SPECIES = (
    Ops(34, 22), Ops(4, 0), Ops(10, 11))


# rows a thread of the hash kernel takes (kHashRows, csrc/pair_dpd_v3.cu)
HASH_ROWS_A_THREAD = 4
# SASS opcodes the bound puts on a pipe (Nsight Compute's pipe
# descriptions): the ALU's, and IMAD on the FMA-heavy pipe; the other
# integer opcodes (VIADD, whose pipe NVIDIA does not document) count at
# the issue rate only
ALU_OPCODES = ("LOP3", "LEA", "IADD3", "SHF", "ISETP", "SEL")
INT_OPCODES = ALU_OPCODES + ("IMAD", "VIADD")


def hash_sass_ops():
    """(Ops of one row of particle_hash_kernel<8>, the opcode counts) from
    the built library's SASS (cuobjdump beside nvcc): the longest straight
    run of integer instructions in the kernel, which is the unrolled TEA
    block of a thread's HASH_ROWS_A_THREAD rows (the xor that makes v1, then
    a half-round of each row's 8 rounds as LEA, VIADD, LEA.HI, LOP3 and
    IMAD.IADD), over its rows. Loads, stores, address and loop arithmetic
    are left out: the count is the least the function needs."""
    import collections
    import re
    from meso_tpu_torch.kernels import _build
    nvcc = _build.find_nvcc()
    sass = run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                str(_build.library_path(nvcc))])
    (body,) = [f for f in sass.split("Function : ")
               if f.startswith("_ZN") and "particle_hash_kernelILi8E" in
               f.split(None, 1)[0]]
    run_, best = [], []
    opcode = r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
    for op in re.findall(opcode, body):
        base = op.split(".")[0]
        if base in ("BSSY", "BSYNC", "NOP"):
            continue
        if base in INT_OPCODES and not op.startswith("IMAD.WIDE"):
            run_.append(op)
            continue
        best, run_ = max(best, run_, key=len), []
    best = max(best, run_, key=len)
    counts = collections.Counter(best)
    alu = sum(c for op, c in counts.items()
              if op.split(".")[0] in ALU_OPCODES)
    imad = sum(c for op, c in counts.items() if op.startswith("IMAD"))
    r = HASH_ROWS_A_THREAD
    return Ops(0, len(best) / r, alu / r, imad / r), dict(counts)


def reset_launches():
    """Every kernel's launch count (``_build.LAUNCHES``) and every brick
    build count (``_brick.BUILDS``) to 0."""
    from meso_tpu_torch.kernels import _brick, _build
    _build.reset_launch_counts()
    _brick.BUILDS.clear()


def read_launches():
    """Every kernel's launch count since the last reset, by name (0 for a
    kernel not launched)."""
    from meso_tpu_torch.kernels import _build
    return _build.LAUNCHES.copy()


def brick_builds():
    """The bricks built for CUDA launches since the last reset, by entry
    point, where any were (``_brick.BUILDS``)."""
    from meso_tpu_torch.kernels import _brick
    return {k: n for k, n in _brick.BUILDS.items() if n}


# the pair kernels among the launch counters (the hash, the
# uniform_stream probe, the rebuild's kernels, the displacement check, the
# bonds and the integrator are not pair kernels)
def pair_launches(launches):
    return {k: n for k, n in launches.items()
            if k not in ("particle_hash", "uniform_stream", "spill_assign",
                         "bucket_keys", "bucket_place", "bucket_rebuild",
                         "max_displacement", "pair_bonds",
                         "initial_integrate", "final_integrate")}


# the integrator's two halves, one launch each a step on every path
# (csrc/integrate.cu)
INTEGRATOR = ("initial_integrate", "final_integrate")


def only_integrator(launches, steps):
    """That a path launched no kernel but the integrator's two halves, one
    each a step, and the displacement check (the plain torch paths: nlist
    and adaptive)."""
    return (not any(n for k, n in launches.items()
                    if k not in INTEGRATOR + ("max_displacement",))
            and all(launches[k] == steps for k in INTEGRATOR))


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


def bucket_case(l, n, spill, min_image, rebuild="sort", seed=3,
                capacity=None):
    """A bucket state on the card whose rows moved since the rebuild:
    unwrapped by <= skin/2 (no-min-image layout) or box-wrapped (min-image
    layout, so rows that crossed the boundary sit in their old cells).
    ``capacity`` overrides the builder's K, as a user may."""
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
                             wrap_at_rebuild=not min_image,
                             capacity=capacity)
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


def bound(tensors_in, tensors_out, ops, tc_ops=0.0):
    """(bound_ms, bound_by) of a kernel from its inputs, outputs and
    operation counts."""
    return bytes_bound(sum(t.numel() * t.element_size()
                           for t in list(tensors_in) + list(tensors_out)), ops,
                       tc_ops)


def row_bound(mask, per_particle, tensors_out, ops, virial=False):
    """(bound_ms, bound_by) of a pair kernel over bucket rows: the mask of
    every row read once and each per-particle input (x, v, tag, h, the
    field, typ, the exclusion rows: tensors whose first axis runs over rows
    or tags) read once for the valid rows only; each output written once
    over every row (pad rows are written, as zeros), and one scalar virial
    where the function returns one (its per-row partial sums are how the
    kernel sums it, not its output)."""
    nv = int(mask.sum())
    nbytes = mask.numel() * mask.element_size() + (4 if virial else 0)
    nbytes += nv * sum(t.numel() // t.shape[0] * t.element_size()
                       for t in per_particle)
    nbytes += sum(t.numel() * t.element_size() for t in tensors_out)
    return bytes_bound(nbytes, ops)


def bytes_bound(nbytes, ops, tc_ops=0.0):
    """(bound_ms, bound_by): the larger of nbytes over the memory rate and
    the operations over their rates: ``ops`` (an Ops, or a number of fp32
    operations) at the fp32 rate plus tc_ops (tensor-core products) at the
    TF32 rate, its integer instructions at the issue rate, its ALU and
    IMAD instructions at their pipes' rates, whichever is longest."""
    fp, integer, alu, imad = ops if isinstance(ops, Ops) else Ops(ops)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * max(fp / FP32_OPS_PER_S + tc_ops / TF32_OPS_PER_S,
                      integer / ISSUE_PER_S, alu / ALU_PER_S,
                      imad / IMAD_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_counts(bst, cfg, rcc=None):
    """Ordered pairs inside rc (and inside rcc) that this state's rows
    give the kernels: the plain versions' own candidate walk."""
    from meso_tpu_torch.kernels.pair_dpd_v3 import _stencil_pairs
    n_rc = n_rcc = 0
    for _, _, _, r2 in _stencil_pairs(bst.x, bst.mask, bst.box, cfg, 1.0):
        n_rc += int(r2.numel())
        if rcc is not None:
            n_rcc += int((r2 < rcc * rcc).sum())
    return n_rc, n_rcc


def with_fields(bst):
    """The state with the transport tests' fields: T = 1 + 0.3 sin x and
    two species C = (1 + 0.5 cos x, 0.5 + 0.2 sin y), zero on pad rows."""
    import torch
    m = bst.mask
    t = torch.where(m, 1.0 + 0.3 * torch.sin(bst.x[:, 0]), 0.0)
    c = torch.stack([1.0 + 0.5 * torch.cos(bst.x[:, 0]),
                     0.5 + 0.2 * torch.sin(bst.x[:, 1])], -1)
    return bst.replace(T=t.contiguous(),
                       C=torch.where(m[:, None], c, 0.0).contiguous())


def mode_amplitudes(x0, c, l):
    """The cosine mode's amplitude along x of one species' C, two ways:
    2<(C - mean C) cos kx>, and the JAX test's 2<C cos kx>
    (tests/physics/test_transport.py:77-80). The second carries
    2 mean(C) <cos kx>, a sampling term of the random positions alone of
    size sqrt(2/N) ~ 0.036 at N = 1536: as large as the mode itself after
    600 steps. The first drops that term exactly."""
    import numpy as np
    cos_kx = np.cos(2 * np.pi * x0 / l)
    return (float(2 * np.mean((c - c.mean()) * cos_kx)),
            float(2 * np.mean(c * cos_kx)))


def decay_fit(amps):
    """The JAX test's decay assertions on an amplitude series sampled every
    100 steps (test_transport.py:84-98): (they hold, the decay rate per 100
    steps from the log-linear fit, the fit's largest residual)."""
    import numpy as np
    amps = np.asarray(amps, dtype=float)
    tt = np.arange(len(amps), dtype=float)
    log_a = np.log(np.maximum(amps, 1e-9))
    k, b = np.polyfit(tt, log_a, 1)
    resid = float(np.abs(log_a - (k * tt + b)).max())
    ok = bool(amps[0] > 0.3 and (np.diff(amps) < 0).all()
              and amps[-1] < 0.5 * amps[0] and resid < 0.25)
    return ok, float(-k), resid


def transport_path(model, selector="v3"):
    """The 1M transport path through its builder, as transport-full runs it:
    edpd_slab or tdpd_diffusion at L=70 from the default start (with the
    capacity fit_capacity gives that start), the sort rebuild, and the
    selector's kernel: force_path "pallas" with pair_kernel "v3" (K2, K3)
    or "v2" (K5), both on the builders' spill buckets, or "pallas_banded"
    (K7), on the builders' strict buckets. Returns (system, params, state)
    at set-up."""
    from meso_tpu_torch.models.transport import edpd_slab, tdpd_diffusion
    force_path = "pallas_banded" if selector == "banded" else "pallas"
    if model == "edpd":
        system, params, state = edpd_slab(
            l=L_MAIN, kappa=2.0, cv=30.0, t_hot=1.3, t_cold=0.7,
            force_path=force_path, skin=SKIN, device=DEVICE,
            pair_kernel="v2" if selector == "v2" else "v3")
    else:
        system, params, state = tdpd_diffusion(
            l=L_MAIN, kappa_c=2.0, force_path=force_path, skin=SKIN,
            device=DEVICE, pair_kernel="v2" if selector == "v2" else "v3")
    return (system.replace(cells=system.cells.replace(rebuild="sort")),
            params, state)


def transport_params():
    """The kernel checks' coefficients: the JAX transport tests' eDPD and
    two-species tDPD (rcc 0.8, s1 2), and "tdpd_1species", the layout
    and branch the tDPD path gives K3: one species, rcc = rc = 1, s1 = 1,
    tdpd_diffusion's kappa_c and seed, with the random flux on (eps_c 0.3,
    as the random-flux run of transport-physics)."""
    from meso_tpu_torch.ops.edpd import EDPDParams
    from meso_tpu_torch.ops.tdpd import TDPDParams
    return {"edpd": EDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kappa=1.5,
                                     cv=10.0, seed=7, device=DEVICE),
            "tdpd": TDPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0,
                                     kappa_c=[1.0, 0.5], eps_c=[0.1, 0.05],
                                     rcc=0.8, s1=2.0, seed=5, device=DEVICE),
            "tdpd_1species": TDPDParams.build(
                a=25.0, gamma=4.5, rc=1.0, kt=1.0, kappa_c=[2.0],
                eps_c=[0.3], rcc=1.0, seed=441, device=DEVICE)}


def transport_fns(model):
    """(kernel wrapper, plain version, dense oracle, the state's input to
    the kernel: T, both species of C, or the first species alone)."""
    from meso_tpu_torch.kernels import pair_dpd_v3 as kern
    from meso_tpu_torch.ops.edpd import dense_forces_edpd
    from meso_tpu_torch.ops.tdpd import dense_forces_tdpd
    if model == "edpd":
        return (kern.bucket_forces_pallas_v3_edpd,
                kern.bucket_forces_v3_edpd_plain, dense_forces_edpd,
                lambda bst: bst.T)
    return (kern.bucket_forces_pallas_v3_tdpd,
            kern.bucket_forces_v3_tdpd_plain, dense_forces_tdpd,
            (lambda bst: bst.C) if model == "tdpd"
            else (lambda bst: bst.C[:, :1].contiguous()))


def compare_transport(got, want, mask, min_image, label, species_sum=True):
    """K2/K3 against a reference (f, flux, virial) with the JAX transport
    tests' bounds: f 2e-5 (5e-5 without min-image), flux 5e-5, virial 1e-4
    (1e-3), pad rows exactly 0, and per-species sum of dC/dt over max
    |dC/dt| below 5e-5 (tDPD, where ``species_sum``: not on a halo brick,
    whose fluxes to halo rows belong to other ranks)."""
    import torch
    (f_k, q_k, vir_k), (f_p, q_p, vir_p) = got, want
    rel = ((f_k - f_p)[mask].abs().max() / f_p[mask].abs().max()).item()
    q_scale = q_p[mask].abs().max().item()
    qrel = (q_k - q_p)[mask].abs().max().item() / q_scale
    pad = (max(f_k[~mask].abs().max().item(),
               q_k[~mask].abs().max().item())
           if bool((~mask).any()) else 0.0)
    vrel = abs(vir_k.item() - vir_p.item()) / abs(vir_p.item())
    qsum = (q_k[mask].sum(0).abs().max().item() / q_scale
            if q_k.ndim == 2 and species_sum else 0.0)
    tol, vtol = (2e-5, 1e-4) if min_image else (5e-5, 1e-3)
    finite = bool(torch.isfinite(f_k).all() and torch.isfinite(q_k).all())
    if not (finite and rel < tol and qrel < 5e-5 and pad == 0.0
            and vrel < vtol and qsum < 5e-5):
        raise AssertionError(
            f"{label}: f rel {rel:.3g} (< {tol}), flux rel {qrel:.3g} "
            f"(< 5e-5), pad {pad}, virial rel {vrel:.3g} (< {vtol}), "
            f"species sum {qsum:.3g} (< 5e-5), finite {finite}")
    return {"max_abs_err": max((f_k - f_p)[mask].abs().max().item(),
                               (q_k - q_p)[mask].abs().max().item()),
            "rel": rel, "flux_rel": qrel, "virial_rel": vrel,
            "species_sum_rel": qsum}


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


def ptxas_report(log):
    """One line per kernel instantiation from nvcc's -Xptxas -v output: its
    mangled name (the template arguments show in it), its registers and
    its spill stores and loads."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.split(",", 1)[1].strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spill}")
            name = None
    return out


def phase_build():
    from meso_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log")
    ptxas = ptxas_report(log.read_text()) if log.exists() else []
    say("build", seconds=round(secs, 3), library=str(path.relative_to(ROOT)),
        ptxas=ptxas)
    return {"seconds": secs, "ptxas": ptxas}


def phase_kernels(ptxas=()):
    """The hash and K1 against their plain versions (phase 3); ``ptxas``
    is the build's register report, whose K1 lines the record keeps."""
    import dataclasses

    import torch
    from meso_tpu_torch.core import rng
    from meso_tpu_torch.kernels import _build, cell_tiles
    from meso_tpu_torch.kernels import pair_dpd_v3 as v3
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

    # pair kernel at l = 8 in every covered case, then the cases of K1's
    # cell tiles: a ragged last run of cx (l = 41: ncx 29, runs of 15 and
    # 14 columns), and dense fluids whose rows have more in-range partners
    # than a thread's list holds (the flush path): rho 9 (K 64 and 72), a
    # user capacity of 128 spill and 192 strict at rho 9, and rho 32 (K 216
    # spill); capacities that large take one block an SM
    cases = [(8.0, 1536, spill, min_image, rng_mode, "l8", None)
             for spill in (True, False) for min_image in (False, True)
             for rng_mode in ("fast", "tea")]
    cases += [(41.0, 206763, True, False, "fast", "ragged", None),
              (41.0, 206763, False, True, "tea", "ragged", None),
              (8.0, 4608, True, False, "fast", "dense", None),
              (8.0, 4608, False, True, "tea", "dense", None),
              (8.0, 4608, True, False, "tea", "dense", 128),
              (8.0, 4608, False, False, "fast", "dense", 192),
              (8.0, 16384, True, True, "fast", "dense", None)]
    for l, n_p, spill, min_image, rng_mode, kind, capacity in cases:
        bst, cfg = bucket_case(l, n_p, spill, min_image, capacity=capacity)
        m = bst.mask
        idx = torch.nonzero(m).squeeze(1)
        args = (bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box,
                step, params, 0.01, cfg)
        f_k, vir_k = bucket_forces_pallas_v3(*args, rng_mode=rng_mode)
        f_k2, vir_off = bucket_forces_pallas_v3(
            *args, rng_mode=rng_mode, need_virial=False)
        torch.cuda.synchronize()
        f_p, vir_p = bucket_forces_v3_plain(
            bst.x, bst.v, bst.tag, bst.mask, bst.box, step, params,
            0.01, cfg, rng_mode)
        label = (f"{kind} l={l:g} n={n_p} K={cfg.capacity} {rng_mode} "
                 f"spill={spill} min_image={min_image}")
        err, rel, vrel = compare_forces(f_k, vir_k, f_p, vir_p, m,
                                        min_image, label)
        if not torch.equal(f_k, f_k2) or vir_off.item() != 0.0:
            raise AssertionError(f"{label}: need_virial=False "
                                 "changed the forces")
        plan = cell_tiles.plan(cfg.capacity, 2 if spill else 1, cfg.ncell)
        rec = {"case": label, "max_abs_err": err, "rel": rel,
               "virial_rel": vrel, "capacity": cfg.capacity,
               "ncell": list(cfg.ncell), "width": plan.width,
               "runs": plan.n_xtiles, "blocks_per_sm": plan.blocks_per_sm(),
               "max_partners": max_partners(bst, cfg)}
        if kind == "ragged" and cfg.ncell[0] % plan.width == 0:
            raise AssertionError(f"{label}: no ragged run ({plan})")
        if kind == "dense" and rec["max_partners"] <= plan.list_cap:
            raise AssertionError(f"{label}: no row fills its list")
        if cfg.capacity >= 128 and plan.blocks_per_sm() != 1:
            raise AssertionError(f"{label}: not one block an SM ({plan})")
        if l == 8.0 and n_p <= 4608:
            # and the port's dense O(N^2) oracle over the valid rows
            f_d, vir_d, _ = dense_forces(
                bst.x[idx], bst.v[idx], bst.typ[idx], bst.tag[idx],
                bst.mask[idx], bst.box, step, params, 0.01,
                rng_mode=rng_mode)
            rec["dense_rel"] = ((f_k[idx] - f_d).abs().max()
                                / f_d.abs().max()).item()
            if rec["dense_rel"] > (2e-5 if min_image else 5e-5):
                raise AssertionError(f"{label}: vs dense rel "
                                     f"{rec['dense_rel']:.3g}")
        out["l8"].append(rec)
    say("kernels-l8", cases=len(out["l8"]),
        worst_rel=max(c["rel"] for c in out["l8"]),
        worst_dense_rel=max(c.get("dense_rel", 0.0) for c in out["l8"]),
        tiles=[{k: c[k] for k in ("case", "width", "runs", "blocks_per_sm",
                                  "max_partners")}
               for c in out["l8"][8:]])

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
    # and at a tag count that is not a multiple of the kernel's 4 rows a
    # thread (its scalar tail), with 8 rounds and with 5 (the generic
    # instance), and from a tag pointer 4 bytes off 16-byte alignment
    tag_odd = torch.cat([bst.tag, bst.tag[:3]])
    for tags, rounds in ((tag_odd, 8), (tag_odd, 5), (tag_odd[1:], 8)):
        if not torch.equal(particle_hash_v3(tags, step, params.seed, rounds),
                           rng.particle_hash(tags, step, params.seed,
                                             rounds=rounds)):
            raise AssertionError(f"hash kernel != plain at {tags.numel()} "
                                 f"tags, {rounds} rounds")
    from meso_tpu_torch.neighbor import bucket_layout as bl
    assign_args = check_assign(bst, cfg)
    assign_out = bl.spill_assign(*assign_args)
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
        # the hash as the paths call it (launch_hash: the kernel and its
        # output's allocation; particle_hash_v3 above adds the int64
        # copy the plain RNG's form needs), at the main-path rows and at
        # a count that is not a multiple of 4
        "hash_kernel_ms": timed_ms(lambda: v3.launch_hash(
            bst.tag, step, params.seed, 8), 200),
        "hash_odd_kernel_ms": timed_ms(lambda: v3.launch_hash(
            tag_odd, step, params.seed, 8), 200),
        "hash_plain_ms": timed_ms(lambda: rng.particle_hash(
            bst.tag, step, params.seed), 20),
        "rebuild_sort_ms": timed_ms(lambda: rebuild_buckets(bst, cfg), 10),
        # the slot assignment on the sort rebuild's inputs: the kernel
        # (a memset and one launch) and its plain torch version
        "assign_ms": timed_ms(lambda: bl.spill_assign(*assign_args), 50),
        "assign_plain_ms": timed_ms(
            lambda: bl.spill_assign_plain(*assign_args), 10),
    }
    n_rc, _ = pair_counts(bst, cfg)
    candidates = stencil_candidates(bst, cfg)
    # K1 as timed (need_virial off): the mask, and x, v, tag and h of the
    # valid rows in, f out; the hash: tag in, h out
    pair_bound = row_bound(bst.mask, [bst.x, bst.v, bst.tag, bst.tag],
                           [f_k], OPS_PER_PAIR["pair_dpd_v3"] * n_rc)
    hash_ops, hash_sass = hash_sass_ops()
    hash_bound = bound([bst.tag], [bst.tag], bst.n * hash_ops)
    hash_odd_bound = bound([tag_odd], [tag_odd], tag_odd.numel() * hash_ops)
    # the slot assignment: base, cx and valid read, target and fits written
    assign_bound = bound(assign_args[:3], assign_out[:2], 0)
    plan = cell_tiles.plan(cfg.capacity, 2, cfg.ncell)
    n_valid = int(bst.mask.sum())
    out["l70"] = {"n": n, "nr": bst.n, "ncell": list(cfg.ncell),
                  "capacity": cfg.capacity, "pairs_in_rc": n_rc,
                  "candidates": candidates,
                  # slot tests a valid row: the tile walk's (occupied
                  # slots only) and the former one-thread-a-row walk's
                  # (all 45 K slots)
                  "tests_per_valid_row": (candidates + n_valid) / n_valid,
                  "slot_tests_per_row_pr6": 45 * cfg.capacity,
                  "plan": dataclasses.asdict(plan),
                  "blocks_per_sm": plan.blocks_per_sm(),
                  "ptxas": [ln for ln in ptxas
                            if "pair_dpd_v3_kernel" in ln],
                  "max_abs_err": err, "rel": rel,
                  "virial_rel": vrel, "hash_max_abs_err": hash_err, **ms,
                  "pair_bound_ms": pair_bound[0],
                  "pair_bound_by": pair_bound[1],
                  "hash_ops_per_row": dict(zip(
                      ("fp", "integer", "alu", "imad"), hash_ops)),
                  "hash_sass_opcodes": hash_sass,
                  "hash_bound_ms": hash_bound[0],
                  "hash_bound_by": hash_bound[1],
                  "hash_odd_rows": tag_odd.numel(),
                  "hash_odd_bound_ms": hash_odd_bound[0],
                  "assign_rows": assign_args[3],
                  "assign_segments": assign_args[6],
                  "assign_bound_ms": assign_bound[0],
                  "assign_bound_by": assign_bound[1]}
    say("kernels-l70", **out["l70"])
    del f_p, f_k, bst, assign_args, assign_out

    # L = 70 through the TEA tier, and on strict buckets (K 28)
    for label, spill, rng_mode in (("L70 tea", True, "tea"),
                                   ("L70 strict", False, "fast")):
        bst, cfg = bucket_case(L_MAIN, n, spill, False)
        args = (bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, step,
                params, 0.01, cfg)
        f_k, vir_k = bucket_forces_pallas_v3(*args, rng_mode=rng_mode)
        f_p, vir_p = bucket_forces_v3_plain(bst.x, bst.v, bst.tag, bst.mask,
                                            bst.box, step, params, 0.01, cfg,
                                            rng_mode)
        err, rel, vrel = compare_forces(f_k, vir_k, f_p, vir_p, bst.mask,
                                        False, label)
        plan = cell_tiles.plan(cfg.capacity, 2 if spill else 1, cfg.ncell)
        out[label.replace(" ", "_")] = {
            "capacity": cfg.capacity, "max_abs_err": err, "rel": rel,
            "virial_rel": vrel, "plan": dataclasses.asdict(plan),
            "ms": timed_ms(lambda: bucket_forces_pallas_v3(
                *args, rng_mode=rng_mode, need_virial=False), 20)}
        say(f"kernels-{label.replace(' ', '-')}",
            **out[label.replace(" ", "_")])
        del f_k, f_p, bst
    return out


def assign_inputs(bst, cfg, brick=False):
    """spill_assign's arguments (but wrap) as ``slot_targets`` gives them
    for a bucket state, or, with ``brick``, as a brick's rebuild
    (``parallel/bricks.py::rebuild_brick``) gives them for the left half of
    the box's x cells: those rows keyed from the brick's origin, the rest
    masked. The keys are sorted in the order ``slot_targets`` gives."""
    import torch
    from meso_tpu_torch.neighbor.bucket_layout import (cell_keys,
                                                       slot_targets)
    nx, ny, nz = cfg.ncell
    if not brick:
        _, key = cell_keys(bst, cfg, False)
    else:
        frac = (bst.x - bst.box.lo) / bst.box.lengths
        cx, cy, cz = (torch.clamp((frac[:, d] * float(n)).to(torch.int32),
                                  0, n - 1).to(torch.int64)
                      for d, n in enumerate(cfg.ncell))
        nx //= 2
        cfg = cfg.replace(ncell=(nx, ny, nz))
        key = torch.where(bst.mask & (cx < nx), (cy * nz + cz) * nx + cx,
                          nx * ny * nz)
    key_s = key[slot_targets(key, cfg, wrap=not brick)[0]]
    base = key_s // nx
    return (base, key_s - base * nx, key_s < nx * ny * nz, bst.n, nx,
            cfg.capacity, ny * nz)


def check_assign(bst, cfg):
    """The slot-assignment kernel against its plain version on the card,
    bitwise (target, fits, overflow), on the sort rebuild's inputs with and
    without the wrap and on a brick's; one launch a call. Returns the
    sort rebuild's inputs."""
    import torch
    from meso_tpu_torch.kernels import _build
    from meso_tpu_torch.neighbor import bucket_layout as bl
    args = assign_inputs(bst, cfg)
    for brick, wrap in ((False, True), (False, False), (True, False)):
        a = assign_inputs(bst, cfg, brick) if brick else args
        before = _build.LAUNCHES["spill_assign"]
        got = bl.spill_assign(*a, wrap=wrap)
        if _build.LAUNCHES["spill_assign"] != before + 1:
            raise AssertionError("spill_assign: not one launch a call")
        want = bl.spill_assign_plain(*a, wrap=wrap)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"spill_assign kernel != plain (brick "
                                 f"{brick}, wrap {wrap})")
    return args


def max_partners(bst, cfg):
    """The most in-range partners (rc = 1) any valid row has."""
    import torch
    from meso_tpu_torch.kernels.pair_dpd_v3 import _stencil_pairs
    counts = torch.zeros(bst.n, dtype=torch.int64, device=bst.x.device)
    for row, _, _, _ in _stencil_pairs(bst.x, bst.mask, bst.box, cfg, 1.0):
        counts.index_add_(0, row, torch.ones_like(row))
    return int(counts.max())


def tile_case_inputs(model, coef, bst, params):
    """(state, coefficients, the kernel's field) of a transport tile case:
    eDPD "1type" (the transport checks') or "2types" (edpd_two_types),
    T from with_fields; tDPD "S2" (two
    species), "S1" (the tDPD path's one), "S10" or "S10-2types" (ten)."""
    if model == "edpd":
        bst = with_fields(bst)
        return bst, params["edpd"] if coef == "1type" else \
            edpd_two_types(), bst.T
    if coef == "S2":
        bst, p = with_fields(bst), params["tdpd"]
    elif coef == "S1":
        bst, p = with_fields(bst), params["tdpd_1species"]
        bst = bst.replace(C=bst.C[:, :1].contiguous())
    else:
        bst = with_species(bst, 10)
        p = tdpd_params(10, coef == "S10-2types")
    return bst, p, bst.C


def phase_transport_kernels(ptxas=()):
    """K2 and K3 against their plain versions and the port's dense oracles
    at l=8, on their cell tiles' cases (EDPD_TILE_CASES, TDPD_TILE_CASES),
    then at the 1M shape with their times and K1's on the same rows;
    ``ptxas`` is the build's register report, whose K2 and K3 lines the
    paths' records keep."""
    import torch
    from meso_tpu_torch.core import rng
    from meso_tpu_torch.kernels.pair_dpd_v3 import (bucket_forces_pallas_v3,
                                                    bucket_forces_v3_plain,
                                                    uniform_stream_v3)
    from meso_tpu_torch.ops.dpd import DPDParams
    out = {"l8": []}
    params = transport_params()
    step = 12

    # the device uniform_stream helper, bitwise, on random and edge hashes
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    h = torch.cat([torch.randint(0, 2 ** 32, (1 << 20,), generator=gen,
                                 dtype=torch.int64, device=DEVICE),
                   torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                                dtype=torch.int64, device=DEVICE)])
    for salt in range(10):
        if not torch.equal(uniform_stream_v3(h, salt).view(torch.int32),
                           rng.uniform_stream(h, salt).view(torch.int32)):
            raise AssertionError(f"uniform_stream kernel != plain (salt "
                                 f"{salt})")

    for spill in (True, False):
        for min_image in (False, True):
            l, n = (8.0, 1536) if spill else (5.0, 500)
            bst, cfg = bucket_case(l, n, spill, min_image)
            bst = with_fields(bst)
            m = bst.mask
            idx = torch.nonzero(m).squeeze(1)
            for model in params:
                fn, plain, dense, field = transport_fns(model)
                fld = field(bst)
                for rng_mode in ("fast", "tea"):
                    label = (f"{model} l{l:g} {rng_mode} spill={spill} "
                             f"min_image={min_image}")
                    got = fn(bst.x, bst.v, fld, bst.typ, bst.tag, m, bst.box,
                             step, params[model], 0.01, cfg,
                             rng_mode=rng_mode)
                    torch.cuda.synchronize()
                    want = plain(bst.x, bst.v, fld, bst.tag, m, bst.box, step,
                                 params[model], 0.01, cfg, rng_mode)
                    rec = compare_transport(got, want, m, min_image, label)
                    # and the port's dense oracle over the valid rows
                    f_d, q_d, vir_d = dense(
                        bst.x[idx], bst.v[idx], fld[idx], bst.typ[idx],
                        bst.tag[idx], m[idx], bst.box, step, params[model],
                        0.01, rng_mode=rng_mode)
                    dense_rec = compare_transport(
                        (got[0][idx], got[1][idx], got[2]),
                        (f_d, q_d, vir_d), m[idx], min_image,
                        label + " vs dense")
                    out["l8"].append({"case": label, **rec,
                                      "dense_rel": dense_rec["rel"],
                                      "dense_flux_rel":
                                          dense_rec["flux_rel"]})
    say("kernels-transport-l8", cases=len(out["l8"]),
        worst_rel=max(c["rel"] for c in out["l8"]),
        worst_flux_rel=max(c["flux_rel"] for c in out["l8"]),
        worst_dense_rel=max(c["dense_rel"] for c in out["l8"]),
        worst_dense_flux_rel=max(c["dense_flux_rel"] for c in out["l8"]))

    # K2's and K3's cell tiles (EDPD_TILE_CASES, TDPD_TILE_CASES)
    out["tiles"] = []
    for model, cases in (("edpd", EDPD_TILE_CASES),
                         ("tdpd", TDPD_TILE_CASES)):
        fn, plain, _, _ = transport_fns(model)
        for l, n, spill, min_image, rng_mode, capacity, coef, kind in cases:
            bst, cfg = bucket_case(l, n, spill, min_image, capacity=capacity)
            bst, p, fld = tile_case_inputs(model, coef, bst, params)
            bst = bst.replace(typ=(bst.tag % p.n_types).to(torch.int32))
            label = (f"{model} {kind} {coef} l={l:g} n={n} "
                     f"K={cfg.capacity} {rng_mode} spill={spill} "
                     f"min_image={min_image}")
            got = fn(bst.x, bst.v, fld, bst.typ, bst.tag, bst.mask, bst.box,
                     step, p, 0.01, cfg, rng_mode=rng_mode)
            torch.cuda.synchronize()
            want = plain(bst.x, bst.v, fld, bst.tag, bst.mask, bst.box, step,
                         p, 0.01, cfg, rng_mode, typ=bst.typ)
            rec = {"case": label, "model": model,
                   "species": getattr(p, "n_species", 0),
                   **compare_transport(got, want, bst.mask, min_image,
                                       label),
                   "max_partners": max_partners(bst, cfg),
                   **row_tile_fields(bst, cfg)}
            check_tile_case(label, kind, cfg, rec)
            out["tiles"].append(rec)
            del bst, fld, got, want
    say("kernels-transport-tiles", cases=len(out["tiles"]),
        worst_rel=max(c["rel"] for c in out["tiles"]),
        worst_flux_rel=max(c["flux_rel"] for c in out["tiles"]),
        worst_virial_rel=max(c["virial_rel"] for c in out["tiles"]),
        tiles=[{k: c[k] for k in ("case", "width", "runs", "blocks_per_sm",
                                  "max_partners")} for c in out["tiles"]])

    # the 1M shape of the transport builders: spill, fast, min-image
    n = int(round(3.0 * L_MAIN ** 3))
    bst, cfg = bucket_case(L_MAIN, n, True, True)
    bst = with_fields(bst)
    rcc = params["tdpd"].rcc
    n_rc, n_rcc_2sp = pair_counts(bst, cfg, rcc=rcc)
    n_rcc = {rcc: n_rcc_2sp, 1.0: n_rc}
    rec = {"n": n, "nr": bst.n, "pairs_in_rc": n_rc,
           "pairs_in_rcc": n_rcc_2sp}
    for model in params:
        fn, plain, _, field = transport_fns(model)
        fld = field(bst)
        args = (bst.x, bst.v, fld, bst.typ, bst.tag, bst.mask, bst.box, step,
                params[model], 0.01, cfg)
        got = fn(*args)
        want = plain(bst.x, bst.v, fld, bst.tag, bst.mask, bst.box, step,
                     params[model], 0.01, cfg)
        rec[model] = compare_transport(got, want, bst.mask, True,
                                       f"{model} L70")
        rec[model]["ms"] = timed_ms(lambda: fn(*args), 20)
        rec[model]["plain_ms"] = timed_ms(
            lambda: plain(bst.x, bst.v, fld, bst.tag, bst.mask, bst.box,
                          step, params[model], 0.01, cfg), 3)
        # inputs: the mask, and x, v, the field, tag and h (int32, the
        # size of tag) of the valid rows
        ins = [bst.x, bst.v, fld, bst.tag, bst.tag]
        if model == "edpd":
            ops = OPS_PER_PAIR["pair_edpd_v3"] * n_rc
        else:
            ns = params[model].n_species
            ops = (TDPD_OPS_PER_PAIR * n_rc
                   + (TDPD_OPS_PER_RCC_PAIR + TDPD_OPS_PER_SPECIES * ns)
                   * n_rcc[params[model].rcc])
        # outputs: f, the flux and the virial
        rec[model]["bound_ms"], rec[model]["bound_by"] = row_bound(
            bst.mask, ins, [got[0], got[1]], ops, virial=True)
    # each path's own inputs at set-up: its builder's state and capacity
    # and its coefficients, at the first step's counter; the kernels'
    # record reads these
    for model in ("edpd", "tdpd"):
        system, sparams, st = transport_path(model)
        fn, plain, _, _ = transport_fns(model)
        fld = st.T if model == "edpd" else st.C
        cfg_p = system.cells
        args = (st.x, st.v, fld, st.typ, st.tag, st.mask, st.box, 1,
                sparams.pair, system.dt, cfg_p)
        got = fn(*args)
        want = plain(st.x, st.v, fld, st.tag, st.mask, st.box, 1,
                     sparams.pair, system.dt, cfg_p)
        prec = compare_transport(got, want, st.mask, True, f"{model} path")
        prec["ms"] = timed_ms(lambda: fn(*args), 20)
        prec["plain_ms"] = timed_ms(
            lambda: plain(st.x, st.v, fld, st.tag, st.mask, st.box, 1,
                          sparams.pair, system.dt, cfg_p), 3)
        p_rc, _ = pair_counts(st, cfg_p)
        ops = (OPS_PER_PAIR["pair_edpd_v3"] * p_rc if model == "edpd" else
               (TDPD_OPS_PER_PAIR + TDPD_OPS_PER_RCC_PAIR
                + TDPD_OPS_PER_SPECIES * sparams.pair.n_species) * p_rc)
        prec["bound_ms"], prec["bound_by"] = row_bound(
            st.mask, [st.x, st.v, fld, st.tag, st.tag], [got[0], got[1]],
            ops, virial=True)
        prec.update(nr=st.n, capacity=cfg_p.capacity, pairs_in_rc=p_rc,
                    **row_tile_fields(st, cfg_p),
                    ptxas=ptxas_of(ptxas, f"pair_{model}_v3_kernel"))
        rec[f"{model}_path"] = prec
        del system, sparams, st, fld, got, want, args
    dpd = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77,
                          device=DEVICE)
    k1_args = (bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, step, dpd,
               0.01, cfg)
    rec["k1_ms"] = timed_ms(lambda: bucket_forces_pallas_v3(
        *k1_args, rng_mode="fast", need_virial=False), 20)
    f_k1, _ = bucket_forces_pallas_v3(*k1_args, rng_mode="fast")
    f_p1, _ = bucket_forces_v3_plain(bst.x, bst.v, bst.tag, bst.mask,
                                     bst.box, step, dpd, 0.01, cfg)
    rec["k1_rel"] = ((f_k1 - f_p1)[bst.mask].abs().max()
                     / f_p1[bst.mask].abs().max()).item()
    out["l70"] = rec
    say("kernels-transport-l70", **rec)
    return out


def advance(system, params, state, steps, every=EVERY):
    """run_bucket_chunked over `steps` steps in chunks of `every` (and one
    shorter chunk for the remainder). Returns (state, [diagnostics])."""
    from meso_tpu_torch.core.system import run_bucket_chunked
    diags = []
    full, rest = divmod(steps, every)
    for chunks, per in ((full, every), (1 if rest else 0, rest)):
        if chunks:
            state, d = run_bucket_chunked(system, params, state, chunks, per,
                                          thermo_trace=False)
            diags.append(d)
    return state, diags


def edpd_slab_gate(kw, note):
    """The eDPD Fourier slab of test_transport.py:40-67 at its deck size
    (l=8, kappa 2, cv 30, T_hot 1.3, T_cold 0.7): 1200 steps, then the T
    profile averaged over 10 samples 30 steps apart. Returns (record, the
    JAX test's assertions hold)."""
    import numpy as np
    from meso_tpu_torch.models.transport import edpd_slab
    from meso_tpu_torch.obs.profiles import field_profile
    system, params, state = edpd_slab(l=8.0, cv=30.0, kappa=2.0, t_hot=1.3,
                                      t_cold=0.7, **kw)
    state, diags = advance(system, params, state, 1200)
    note(diags)
    nb = 16
    acc = np.zeros(nb)
    cnt_acc = np.zeros(nb)
    for _ in range(10):
        state, diags = advance(system, params, state, 30)
        note(diags)
        xc, tbar, cnt = field_profile(state, state.T[:, None], axis=0,
                                      nbins=nb)
        acc += tbar[:, 0].cpu().numpy() * cnt.cpu().numpy()
        cnt_acc += cnt.cpu().numpy()
    tprof = acc / np.maximum(cnt_acc, 1)
    xc = xc.cpu().numpy()
    grad = np.diff(tprof[(xc > 0.8) & (xc < 4.2)])
    mid = float(tprof[(xc > 2.2) & (xc < 2.8)].mean())
    rec = {"profile": tprof.tolist(), "t_first": tprof[0],
           "t_cold_bin": tprof[8], "max_grad": float(grad.max()), "mid": mid,
           "capacity": system.cells.capacity, "spill": system.cells.spill}
    return rec, bool(tprof[0] > 1.2 and tprof[8] < 0.8
                     and (grad < 0.05).all() and abs(mid - 1.0) < 0.08)


def phase_transport_physics():
    """The deck-size physics gates of tests/physics/test_transport.py on the
    card, through K2 and K3 (force_path "pallas", skin 0.4)."""
    import numpy as np
    import torch
    from meso_tpu_torch.models.transport import edpd_slab, tdpd_diffusion
    from meso_tpu_torch.obs import kinetic_energy, potential_energy_dense
    kw = dict(force_path="pallas", skin=SKIN, device=DEVICE)
    res = {}
    overflow = 0

    def note(diags):
        nonlocal overflow
        overflow = max([overflow] + [int(d["bucket_overflow"])
                                     for d in diags])

    # eDPD energy conservation (test_transport.py:14-37)
    system, params, state = edpd_slab(l=5.0, cv=20.0, kappa=0.5, **kw)
    system = system.replace(fixes=())
    pair = params.pair

    def total_e(s):
        m = s.mask
        return float(kinetic_energy(s.v, params.mass[:1], m)
                     + pair.cv * torch.sum(s.T[m])
                     + potential_energy_dense(s.x[m], s.typ[m], m[m], s.box,
                                              pair.a, pair.rc))

    e0 = total_e(state)
    state, diags = advance(system, params, state, 300)
    note(diags)
    e1 = total_e(state)
    t = state.T[state.mask]
    res["edpd_energy"] = {"e0": e0, "e1": e1, "rel_drift": abs(e1 - e0)
                          / abs(e0), "t_min": float(t.min()),
                          "t_max": float(t.max())}
    ok_energy = (res["edpd_energy"]["rel_drift"] < 0.01
                 and bool(torch.isfinite(t).all()) and float(t.min()) > 0.3
                 and float(t.max()) < 3.0)

    # eDPD Fourier slab (test_transport.py:40-67)
    res["edpd_slab"], ok_slab = edpd_slab_gate(kw, note)

    # tDPD mode decay and mass (test_transport.py:70-100), from each start
    # of TDPD_DECAY_SEEDS (the builder's default, 4, among them)
    runs = []
    for init_seed in TDPD_DECAY_SEEDS:
        system, params, state = tdpd_diffusion(
            l=8.0, kappa_c=2.0, eps_c=0.0, init_seed=init_seed, **kw)
        runs.append({"init_seed": init_seed,
                     **tdpd_decay(system, params, state, note)})
    rates = np.asarray([r["rate"] for r in runs])
    res["tdpd_decay"] = {
        "runs": runs, "rate_mean": float(rates.mean()),
        "rate_reference": TDPD_DECAY_RATE_JAX,
        "passes": sum(r["passes"] for r in runs),
        "jax_estimator_passes": sum(r["jax_estimator_passes"] for r in runs),
        "starts": len(runs)}
    ok_decay = all(r["passes"] and r["c_min"] > -0.05
                   and r["c_rel_drift"] < 1e-4 for r in runs)
    ok_rate = (abs(rates / TDPD_DECAY_RATE_JAX - 1.0).max()
               < TDPD_DECAY_RATE_TOL
               and abs(rates.mean() / TDPD_DECAY_RATE_JAX - 1.0)
               < TDPD_DECAY_MEAN_TOL)

    # tDPD random flux conserves sum C (test_transport.py:103-110)
    system, params, state = tdpd_diffusion(l=5.0, kappa_c=1.0, eps_c=0.3,
                                           **kw)
    c0 = float(torch.sum(state.C[state.mask, 0]))
    state, diags = advance(system, params, state, 200)
    note(diags)
    c1 = float(torch.sum(state.C[state.mask, 0]))
    res["tdpd_random_flux"] = {"c_rel_drift": abs(c1 - c0) / abs(c0)}
    ok_flux = res["tdpd_random_flux"]["c_rel_drift"] < 1e-4
    res["bucket_overflow"] = overflow
    say("transport-physics", **res)
    checks = {"eDPD energy within 1%, 0.3 < T < 3": ok_energy,
              "Fourier slab profile": ok_slab,
              "tDPD mode decay and mass, every start": ok_decay,
              "tDPD decay rate within 5% of the JAX dense path's (3% in "
              "the mean)": ok_rate,
              "tDPD random flux conserves sum C": ok_flux,
              "bucket_overflow == 0": overflow == 0}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"transport physics failed: {failed}")
    return res


def tdpd_decay(system, params, state, note=None):
    """600 steps of a tDPD cosine-mode run at l=8, sampled every 100: both
    amplitude estimators, their decay_fit verdicts and rates, min C and the
    drift of sum C. note(diags) sees every chunk's diagnostics."""
    import numpy as np

    def species0(s):
        # a rebuild moves rows: the mask is read anew each time
        return (s.x[s.mask, 0].cpu().numpy(),
                s.C[s.mask, 0].cpu().numpy().astype(np.float64))

    x0, c = species0(state)
    c_tot0 = c.sum()
    amps = [mode_amplitudes(x0, c, 8.0)]
    for _ in range(6):
        state, diags = advance(system, params, state, 100)
        if note is not None:
            note(diags)
        x0, c = species0(state)
        amps.append(mode_amplitudes(x0, c, 8.0))
    amps, amps_jax = (np.asarray(a) for a in zip(*amps))
    ok, rate, resid = decay_fit(amps)
    ok_jax, rate_jax, resid_jax = decay_fit(amps_jax)
    return {"amps": amps.tolist(), "rate": rate, "resid": resid,
            "passes": ok, "amps_jax_estimator": amps_jax.tolist(),
            "rate_jax_estimator": rate_jax,
            "resid_jax_estimator": resid_jax,
            "jax_estimator_passes": ok_jax, "c_min": float(c.min()),
            "c_rel_drift": abs(c.sum() - c_tot0) / abs(c_tot0)}


def phase_decay_from(path):
    """--decay-from FILE: the tDPD decay on the card from the JAX package's
    own starts. FILE is written by the slow test
    tests/test_torch_transport_decay.py on a CPU: each start as bridge
    arrays ("<i>/x", "<i>/v", ...) and the JAX dense path's rate from it
    ("<i>/rate"). Every card rate must lie within DECAY_SAME_START_TOL of
    JAX's from the same start. The verdicts of both amplitude estimators
    are reported: the card's, and the JAX dense run's own with the JAX
    test's estimator ("<i>/jax_estimator_passes")."""
    import numpy as np
    from meso_tpu_torch import bridge
    from meso_tpu_torch.core.system import fit_capacity, setup
    from meso_tpu_torch.models.transport import tdpd_diffusion
    data = np.load(path)
    starts = sorted({int(k.split("/")[0]) for k in data.files})
    runs = []
    for i in starts:
        src = {k.split("/", 1)[1]: data[k] for k in data.files
               if k.split("/")[0] == str(i)}
        st = bridge.state_from(src, device=DEVICE)
        system, params, _ = tdpd_diffusion(
            l=8.0, kappa_c=2.0, eps_c=0.0, force_path="pallas", skin=SKIN,
            device=DEVICE)
        system = fit_capacity(system, st)
        rec = tdpd_decay(system, params, setup(system, params, st))
        runs.append({"start": i, "rate": rec["rate"],
                     "jax_rate": float(src["rate"]),
                     "ratio": rec["rate"] / float(src["rate"]),
                     "passes": rec["passes"],
                     "jax_estimator_passes": rec["jax_estimator_passes"],
                     "jax_dense_jax_estimator_passes":
                         bool(src["jax_estimator_passes"])})
    ratios = np.asarray([r["ratio"] for r in runs])
    res = {"runs": runs, "worst": float(abs(ratios - 1.0).max()),
           "mean_ratio": float(ratios.mean()),
           "rate_mean": float(np.mean([r["rate"] for r in runs])),
           **{k: sum(r[k] for r in runs) for k in (
               "passes", "jax_estimator_passes",
               "jax_dense_jax_estimator_passes")},
           "starts": len(runs)}
    say("decay-from-jax-starts", **res)
    if res["worst"] >= DECAY_SAME_START_TOL:
        raise AssertionError(f"tDPD decay rate off JAX's from the same start "
                             f"by {res['worst']:.3g} (< "
                             f"{DECAY_SAME_START_TOL})")
    return res


def phase_transport_full(model, selector="v3"):
    """One transport model at 1,029,000 particles through the normal entry
    points and the selector's kernel, launch counts set to 0 just before it
    is built and read just after its timed window."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    system, params, state = transport_path(model, selector)
    n = int(state.n_valid())
    c0 = float(torch.sum(state.C[state.mask])) if model == "tdpd" else None
    state, d_eq = advance(system, params, state,
                          TRANSPORT_EQUIL_CHUNKS * TRANSPORT_EVERY,
                          TRANSPORT_EVERY)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, d_timed = advance(system, params, state,
                             TRANSPORT_TIMED_CHUNKS * TRANSPORT_EVERY,
                             TRANSPORT_EVERY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_launches()
    if selector == "v3":
        FINAL_STATES[model] = state
    steps = (TRANSPORT_EQUIL_CHUNKS + TRANSPORT_TIMED_CHUNKS) \
        * TRANSPORT_EVERY
    force_evals = 1 + steps
    timed_steps = TRANSPORT_TIMED_CHUNKS * TRANSPORT_EVERY
    overflow = max(int(d["bucket_overflow"]) for d in d_eq + d_timed)
    skin_timed = max(float(d["worst_skin_ratio"]) for d in d_timed)
    skin_equil = max(float(d["worst_skin_ratio"]) for d in d_eq)
    fields = (state.x, state.v, state.f) + (
        (state.T, state.dTdt) if model == "edpd" else (state.C, state.dCdt))
    finite = all(bool(torch.isfinite(t).all()) for t in fields)
    kernel = SELECTOR_KERNELS[selector][model]
    res = {"model": model, "selector": selector,
           "force_path": system.force_path,
           "pair_kernel": system.pair_kernel, "n_particles": n,
           "rows": state.n, "capacity": system.cells.capacity,
           "spill": system.cells.spill, "rebuild": system.cells.rebuild,
           "steps_per_rebuild": TRANSPORT_EVERY, "steps": steps,
           "timed_steps": timed_steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / timed_steps,
           "particle_steps_per_s": n * timed_steps / wall,
           "setup_and_equil_s": t1 - t0, "bucket_overflow": overflow,
           "worst_skin_ratio": skin_timed,
           "worst_skin_ratio_equil": skin_equil,
           "force_evals": force_evals, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    checks = {f"{kernel} launches == force evaluations, no other pair "
              "kernel": pair_launches(launches) == {
                  **{k: 0 for k in pair_launches(launches)},
                  kernel: force_evals},
              "hash launches == force evaluations":
              launches["particle_hash"] == force_evals,
              "bucket_overflow == 0": overflow == 0,
              "worst_skin_ratio < 1": skin_timed < 1.0,
              "state finite": finite}
    if model == "edpd":
        t = state.T[state.mask]
        res["t_min"], res["t_max"] = float(t.min()), float(t.max())
        checks["0.3 < T < 3"] = res["t_min"] > 0.3 and res["t_max"] < 3.0
    else:
        c1 = float(torch.sum(state.C[state.mask]))
        res["c_rel_drift"] = abs(c1 - c0) / abs(c0)
        checks["sum C drift < 1e-4"] = res["c_rel_drift"] < 1e-4
    label = (f"transport-full-{model}" if selector == "v3"
             else f"{selector}-{model}-full")
    say(label, **res)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} failed: {failed}")
    return res


def classic_path(selector="v3"):
    """The classic 1M path at set-up: config 1 as the main path runs it
    (a 25, gamma 4.5, dt 0.01, lambda 0.65, fast RNG, skin 0.4, sort
    rebuild every 3), with the selector's kernel: "v3" (K1) and "v2" (the
    fused K5) on spill buckets under the deferred wrap, "banded" (K6) on
    strict buckets with the box wrapped every step."""
    from meso_tpu_torch.models.classic import classic_fluid
    banded = selector == "banded"
    system, params, state = classic_fluid(
        l=L_MAIN, rng_mode="fast",
        force_path="pallas_banded" if banded else "pallas",
        pair_kernel="v2" if selector == "v2" else "v3", rebuild="sort",
        wrap_mode="step" if banded else "rebuild", skin=SKIN,
        rebuild_every=EVERY, device=DEVICE)
    return system.replace(lam=LAM), params, state


def timed_blocks():
    """The chunks of each of the TIMED_BLOCKS blocks of the main path's
    timed window of TIMED_CHUNKS chunks, each block timed on its own
    (synchronised on both sides), so that a slow run shows which part of
    the window was slow."""
    return [TIMED_CHUNKS * (b + 1) // TIMED_BLOCKS - TIMED_CHUNKS * b
            // TIMED_BLOCKS for b in range(TIMED_BLOCKS)]


def phase_main_path(selector="v3"):
    """The classic path at 1,029,000 particles (the main path with "v3"),
    launch counts set to 0 just before it is built and read just after the
    traced window."""
    import numpy as np
    import torch
    from meso_tpu_torch.core.system import run_bucket_chunked
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    system, params, state = classic_path(selector)
    # the rebuild's launches, one each a rebuild: the spill layout's one
    # host call (its slot assignment inside), the strict layout's keys and
    # placement
    rebuild_kernels = (("bucket_rebuild",) if system.cells.spill
                       else ("bucket_keys", "bucket_place"))
    setup_rebuild = {k: read_launches()[k] for k in rebuild_kernels}
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
    block_ms = []
    for chunks in timed_blocks():
        tb = time.perf_counter()
        state, _ = advance(state, chunks, "timed")
        torch.cuda.synchronize()
        block_ms.append(1e3 * (time.perf_counter() - tb) / (chunks * EVERY))
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
    launches = read_launches()
    builds = brick_builds()
    if selector == "v3":
        FINAL_STATES["classic"] = state

    timed_steps = TIMED_CHUNKS * EVERY
    overflow = max(int(d["bucket_overflow"])
                   for ds in diags.values() for d in ds)
    skin = {w: max(float(d["worst_skin_ratio"]) for d in ds)
            for w, ds in diags.items()}
    skin_ratio = skin["timed"]
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.x, state.v, state.f))
    kernel = SELECTOR_KERNELS[selector]["dpd"]
    res = {"selector": selector, "force_path": system.force_path,
           "pair_kernel": system.pair_kernel,
           "wrap_mode": system.wrap_mode, "spill": system.cells.spill,
           "n_particles": n, "rows": state.n,
           "capacity": system.cells.capacity, "steps": force_evals - 1,
           "timed_steps": timed_steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / timed_steps,
           "block_ms_per_step": block_ms,
           "particle_steps_per_s": n * timed_steps / wall,
           "setup_and_equil_s": setup_equil_s,
           "kT_mean": kt_mean, "kT_sem": kt_sem, "kT_3sig": 3 * kt_sem,
           "kT_n_eff": n_eff, "kT_trace_steps": int(sum(k.size for k in kts)),
           "bucket_overflow": overflow, "worst_skin_ratio": skin_ratio,
           "worst_skin_ratio_equil": skin["equil"],
           "worst_skin_ratio_traced": skin["traced"],
           "force_evals": force_evals, "launches": launches,
           "brick_builds": builds,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    label = "main-path" if selector == "v3" else f"{selector}-classic"
    say(label, **res)
    checks = {
        f"{kernel} launches == force evaluations, no other pair kernel":
            pair_launches(launches) == {
                **{k: 0 for k in pair_launches(launches)},
                kernel: force_evals},
        "hash launches == force evaluations":
            launches["particle_hash"] == force_evals,
        "a brick built a K5 launch, none for K1 and K6":
            builds == ({kernel: force_evals} if selector == "v2" else {}),
        "rebuild launches == rebuilds": all(
            launches[k] - setup_rebuild[k] == (force_evals - 1) // EVERY
            for k in rebuild_kernels),
        "bucket_overflow == 0": overflow == 0,
        "worst_skin_ratio < 1": skin_ratio < 1.0,
        "state finite": finite,
        "kT_n_eff >= 10": n_eff >= MIN_N_EFF,
        "|kT - 1| + 3 sigma <= 0.01": abs(kt_mean - 1.0) + 3 * kt_sem <= 0.01,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} failed: {failed}")
    return res


def phase_profile(full_cadence):
    """torch.profiler over PROFILE_CHUNKS chunks of each 1M path, after a
    short warm-up from its builder: device time per chunk by kernel, and
    the card's busy share of the window's wall time (one stream, so kernel
    times add up); the numbers back PERF.md's breakdowns. The wall and
    polymer paths run at the cadence their full runs chose
    (``full_cadence``) and list their 20 costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    paths = {
        "classic": (classic_path, EVERY),
        "edpd": (lambda: transport_path("edpd"), TRANSPORT_EVERY),
        "tdpd": (lambda: transport_path("tdpd"), TRANSPORT_EVERY),
        "walls": (walls_path, full_cadence["walls"]),
        "polymer": (polymer_path, full_cadence["polymer"])}
    for sel in ("v2", "banded"):
        paths[f"{sel}-classic"] = (lambda sel=sel: classic_path(sel), EVERY)
        for model in ("edpd", "tdpd"):
            paths[f"{sel}-{model}"] = (
                lambda sel=sel, model=model: transport_path(model, sel),
                TRANSPORT_EVERY)
    out = {}
    for name, (build, every) in paths.items():
        system, params, state = build()
        system = system.replace(cells=system.cells.replace(rebuild="sort"))
        state, _ = advance(system, params, state, 30 * every, every)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = advance(system, params, state,
                               PROFILE_CHUNKS * every, every)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = device_times(prof, PROFILE_CHUNKS)
        busy = sum(ms for ms, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[
            :20 if name in full_cadence else 12]
        out[name] = {"steps_per_chunk": every,
                     "wall_ms_per_chunk": wall_ms / PROFILE_CHUNKS,
                     "device_ms_per_chunk": busy,
                     "busy_share": busy * PROFILE_CHUNKS / wall_ms,
                     "kernel_launches_per_chunk":
                         sum(c for _, c in kernels.values())
                         / PROFILE_CHUNKS,
                     "top": [{"kernel": k, "ms_per_chunk": ms,
                              "calls": c} for k, (ms, c) in top],
                     # the kernels of the kernels line (the hash on every
                     # fast-RNG path among them), in the top or not
                     "port": [{"kernel": k, "ms_per_chunk": ms, "calls": c}
                              for k, (ms, c) in kernels.items()
                              if k.startswith(PORT_KERNELS)]}
        if name in full_cadence:
            out[name]["hooks_per_step"] = profile_hooks(system, params,
                                                        state)
        say(f"profile-{name}", **out[name])
    return out




def device_times(prof, reps):
    """{kernel name: (device ms per rep, launches)} of a profiler window."""
    import torch
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key[:80]] = (us / 1e3 / reps, e.count)
    return kernels


def profile_hooks(system, params, state, reps=10):
    """Device time and launches per step of what the wall and polymer paths
    add to the step around the pair kernel: the bonded terms and post_force
    fixes (``_post_forces``) and the end_of_step fixes, called ``reps``
    times on the path's state."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from meso_tpu_torch.core.system import _post_forces
    f0 = torch.zeros_like(state.f)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            _post_forces(system, params, state, state.x, state.v, f0,
                         image=state.image)
            for fx in system.fixes:
                if hasattr(fx, "end_of_step"):
                    fx.end_of_step(system, params, state)
        torch.cuda.synchronize()
    kernels = device_times(prof, reps)
    return {"device_ms": sum(ms for ms, _ in kernels.values()),
            "launches": sum(c for _, c in kernels.values()) / reps}


def deferred_wrap(system):
    """The system with the main path's rebuild and wrap: the sort rebuild
    and the box wrap deferred to rebuild time (K1's no-min-image kernels)."""
    return system.replace(wrap_mode="rebuild", cells=system.cells.replace(
        rebuild="sort", wrap_at_rebuild=True))


def walls_path():
    """walls-full at set-up: the Poiseuille channel at 1,029,000 particles
    (29,400 of them frozen type-1 wall beads), under the deferred wrap (R5
    is no fault: tests/test_torch_walls_r5.py)."""
    from meso_tpu_torch.models.walls import poiseuille
    system, params, state = poiseuille(
        lx=L_MAIN, h=L_MAIN, lz=L_MAIN, wall_width=1.0, g=0.1,
        force_path="pallas", rng_mode="fast", skin=SKIN, dt=0.01,
        device=DEVICE)
    return deferred_wrap(system), params, state


def polymer_path():
    """polymer-full at set-up: 3,200 FENE chains of 16 beads (51,200 beads,
    48,000 bonds) in solvent, 1,029,000 particles, special-bonds weight
    0.5 (exclusion table (1,029,001, 2)), under the deferred wrap."""
    from meso_tpu_torch.models.polymer import polymer_melt
    system, params, state = polymer_melt(
        l=L_MAIN, n_chains=POLYMER_CHAINS, chain_len=POLYMER_CHAIN_LEN,
        special_weight=0.5,
        force_path="pallas", rng_mode="fast", skin=SKIN, dt=0.01,
        device=DEVICE)
    return deferred_wrap(system), params, state


def melt_path():
    """The Groot-Madden A5B5 melt at set-up, as the benchmark's
    diblock_melt_l70 cell runs it: 102,900 chains of 10 beads (1,029,000,
    926,100 harmonic bonds, K 2, r0 0), a_AB 40, lambda 0.65, the sort
    rebuild every EVERY steps under the deferred wrap."""
    from meso_tpu_torch.models.polymer import block_copolymer_melt
    system, params, state = block_copolymer_melt(
        l=L_MAIN, force_path="pallas", rng_mode="fast", skin=SKIN, dt=0.01,
        lam=LAM, device=DEVICE)
    system = system.replace(cells=system.cells.replace(rebuild="sort",
                                                       rebuild_every=EVERY))
    return deferred_wrap(system), params, state


def membrane_bonds_case():
    """A vesicle of WLC-POW edges (degree 5 and 6 on an icosphere of
    subdivision 3: 642 vertices, 1,920 edges) in a 16^3 box of solvent."""
    from meso_tpu_torch.models.polymer import membrane_suspension
    system, params, state, _ = membrane_suspension(
        l=16.0, radius=5.0, subdiv=3, force_path="pallas", rng_mode="fast",
        skin=SKIN, device=DEVICE)
    return system, params, state


def pair_bonds_only(b):
    """The bonded parameters with their pair bonds alone."""
    return b.replace(angle_tags=None, angle_coeffs=None, angle_type=None,
                     tri_tags=None, tri_mol=None, membrane=None, tri_a0=None,
                     hinge_tags=None, hinge_coeffs=None)


BOND_CASES = {"fene": lambda: polymer_path(), "harmonic": lambda: melt_path(),
              "wlc_pow": lambda: membrane_bonds_case()}
# a kernel output within this share of the plain chain's largest force
BOND_REL_TOL = 1e-6


def bond_bound(params):
    """(bound_ms, bound_by, bytes) of the pair bonds, as
    benchmark/roofline/bonds.py counts them: each bonded bead's x and tag
    read (16 B) and f read and written (24 B), each bond's two tags (8 B)."""
    import torch
    bt = params.bonded.bond_tags
    beads = int(torch.unique(bt[bt > 0]).numel())
    nbytes = beads * 40 + int((bt[:, 0] > 0).sum()) * 8
    ms, by = bytes_bound(nbytes, Ops())
    return ms, by, nbytes


def check_bonds(system, params, state, time_it=True):
    """The pair bonds' kernel (ops.bonded.pair_bonds) against the plain
    chain on the same CUDA tensors and on CPU copies, within BOND_REL_TOL
    of the largest plain force; bitwise equal from call to call; added in
    place bitwise as stored; with an owner mask and a tenth of the rows
    dropped, the plain chain's owned rows and missing count; two kernel
    launches a call (torch.profiler) and one count in LAUNCHES. With
    ``time_it``: through the wrapper, alone (profiler), the plain chain,
    and the bound. Returns the record, its checks under "checks"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from meso_tpu_torch.ops import bonded
    b = pair_bonds_only(params.bonded)
    style, n_tags = system.bond_style, system.n_tags
    args = (state.x, state.tag, state.mask, state.box, b, style, n_tags)

    def plain(x, tag, mask, box, bp, owner=None, count=False):
        return bonded._bonded_plain(x, tag, mask, box, bp, style, n_tags, 0,
                                    None, owner, None, count)

    before = read_launches()["pair_bonds"]
    got, _ = bonded.pair_bonds(*args)
    again, _ = bonded.pair_bonds(*args)
    counted = read_launches()["pair_bonds"] - before
    want, _ = plain(*args[:5])
    cpu = [t.cpu() for t in args[:3]]
    cbox = type(state.box)(lo=state.box.lo.cpu(), hi=state.box.hi.cpu())
    cb = bonded.BondedParams(bond_tags=b.bond_tags.cpu(),
                             bond_type=b.bond_type.cpu(),
                             bond_coeffs=b.bond_coeffs.cpu())
    want_cpu, _ = plain(*cpu, cbox, cb)
    scale = float(want_cpu.abs().max())
    f0 = torch.randn(got.shape, device=got.device,
                     generator=torch.Generator(device=got.device).manual_seed(1))
    added = bonded.bonded_forces(*args, add_to=f0.clone())
    g = torch.Generator(device=got.device).manual_seed(2)
    mask2 = state.mask & (torch.rand(state.n, device=got.device,
                                     generator=g) > 0.1)
    owner = torch.rand(state.n, device=got.device, generator=g) > 0.5
    got_o, miss_o = bonded._bonded(state.x, state.tag, mask2, state.box, b,
                                   style, n_tags, 0, None, owner, None, True)
    want_o, miss_w = plain(state.x, state.tag, mask2, state.box, b, owner,
                           True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bonded.pair_bonds(*args)
        torch.cuda.synchronize()
    ops = device_times(prof, 1)
    rec = {"style": style, "rows": state.n,
           "bonds": int(b.bond_tags.shape[0]),
           "partners_width": bonded.partner_table(b, n_tags)[1],
           "max_rel_err_cuda_plain":
               float((got - want).abs().max()) / scale,
           "max_rel_err_cpu_plain":
               float((got.cpu() - want_cpu).abs().max()) / scale,
           "bitwise_cpu_plain": bool(torch.equal(got.cpu(), want_cpu)),
           "bitwise_repeat": bool(torch.equal(got, again)),
           "add_in_place_bitwise": bool(torch.equal(added, f0 + got)),
           "owner_max_rel_err":
               float((got_o - want_o).abs().max()) / max(
                   float(want_o.abs().max()), 1e-30),
           "owner_missing": [int(miss_o), int(miss_w)],
           "launches_a_call": sum(c for _, c in ops.values()),
           "counted_a_call": counted / 2,
           "device_ops": sorted(ops)}
    if time_it:
        rec["ms"] = timed_ms(lambda: bonded.pair_bonds(*args), 20)
        rec["kernel_ms"] = profiled_kernel_ms(
            lambda: bonded.pair_bonds(*args), "pair_bonds_kernel<", 20)
        rec["tag_rows_ms"] = profiled_kernel_ms(
            lambda: bonded.pair_bonds(*args), "tag_rows_kernel<", 20)
        rec["plain_ms"] = timed_ms(lambda: plain(*args[:5]), 5)
        rec["bound_ms"], rec["bound_by"], rec["bound_bytes"] = bond_bound(
            params)
    rec["checks"] = {
        f"{style}: within {BOND_REL_TOL} of the plain chain (card, CPU)":
            max(rec["max_rel_err_cuda_plain"],
                rec["max_rel_err_cpu_plain"]) <= BOND_REL_TOL,
        f"{style}: bitwise from call to call": rec["bitwise_repeat"],
        f"{style}: added in place as stored": rec["add_in_place_bitwise"],
        f"{style}: owner rows and missing as the plain chain":
            rec["owner_max_rel_err"] <= BOND_REL_TOL
            and miss_o is not None and int(miss_o) == int(miss_w),
        f"{style}: two kernel launches, one count a call":
            rec["launches_a_call"] == 2 and rec["counted_a_call"] == 1}
    return rec


def phase_bond_kernels():
    """check_bonds on each style's inputs: FENE on the polymer path's
    set-up (48,000 bonds among 1,029,000 particles), harmonic on the
    melt's (926,100 bonds), WLC-POW on a vesicle's edges (and the whole
    membrane force, areas, volume and hinges by autograd, against the
    plain chain); then the melt path, relaxed for 900 steps and moved to
    the K the density gives (16, as the benchmark's cell runs it), its
    steps under the profiler: the kernels' device time a force call in
    path and their calls a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from meso_tpu_torch.ops import bonded
    out, failed = {}, []
    for style, build in BOND_CASES.items():
        system, params, state = build()
        rec = check_bonds(system, params, state,
                          time_it=style != "wlc_pow")
        if style == "wlc_pow":
            got = bonded.bonded_forces(state.x, state.tag, state.mask,
                                       state.box, params.bonded, style,
                                       system.n_tags, system.n_mols,
                                       image=state.image)
            want, _ = bonded._bonded_plain(
                state.x, state.tag, state.mask, state.box, params.bonded,
                style, system.n_tags, system.n_mols, state.image, None,
                None, False)
            rec["membrane_max_rel_err"] = float(
                (got - want).abs().max()) / float(want.abs().max())
            rec["checks"]["wlc_pow: the membrane within 1e-5 of the plain "
                          "chain"] = rec["membrane_max_rel_err"] <= 1e-5
        if style == "harmonic":
            # the walk start relaxed, then on the cell's K from the density
            from meso_tpu_torch.neighbor.bucket_layout import rebuild_buckets
            from meso_tpu_torch.neighbor.cells import CellConfig
            state, _ = advance(system, params, state, 900)
            k = CellConfig.for_box([L_MAIN] * 3, system.rc_max, 3.0,
                                   skin=SKIN, spill=True).capacity
            system = system.replace(cells=system.cells.replace(capacity=k))
            state, overflow = rebuild_buckets(state, system.cells)
            rec["path_capacity"] = k
            rec["path_relayout_overflow"] = int(overflow)
            rec["checks"]["harmonic: the relaxed melt fits the density's "
                          "K"] = int(overflow) == 0
            state, _ = advance(system, params, state, 30 * EVERY)
            torch.cuda.synchronize()
            reset_launches()
            steps = PROFILE_CHUNKS * EVERY
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, _ = advance(system, params, state, steps)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels = device_times(prof, 1)
            calls = read_launches()["pair_bonds"]
            for key, name in (("in_path_ms", "pair_bonds_kernel<"),
                              ("tag_rows_in_path_ms", "tag_rows_kernel<")):
                rec[key] = sum(ms for k, (ms, _) in kernels.items()
                               if name in k) / calls
            rec["calls_a_step"] = calls / steps
            rec["path_kernel_launches_a_step"] = sum(
                c for _, c in kernels.values()) / steps
            rec["path_device_ms_a_step"] = sum(
                ms for ms, _ in kernels.values()) / steps
            rec["path_wall_ms_a_step"] = 1e3 * wall / steps
            rec["path_top"] = sorted(
                ([k, ms / steps] for k, (ms, _) in kernels.items()),
                key=lambda kv: -kv[1])[:12]
        failed += [k for k, ok in rec["checks"].items() if not ok]
        out[style] = rec
        say(f"bond-kernels-{style}", **rec)
        del system, params, state
    if failed:
        raise AssertionError(f"bond kernels failed: {failed}")
    return out


def general_params(n, two_types=True, s_exp=0.5, excl=True, weight=0.25,
                   max_excl=2):
    """K1's general case as kernels-general-l8 checks it: two types with an
    asymmetric a table and rc_01 = 0.8 < rc = 1, s_exp, and exclusions
    (E = ``max_excl``, ``weight``) along random chains of 8 tags among
    1..n: each bead's neighbours along its chain up to E / 2 beads away
    (E = 6 is more than the kernels keep in registers)."""
    import numpy as np
    import torch
    from meso_tpu_torch.ops.dpd import DPDParams, build_exclusions
    p = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77,
                        n_types=2 if two_types else 1, s_exp=s_exp,
                        device=DEVICE)
    if two_types:
        p = p.replace(
            a=p.a * torch.tensor([[1.0, 1.4], [1.2, 2.0]], device=DEVICE),
            rc=p.rc * torch.tensor([[1.0, 0.8], [0.8, 1.0]], device=DEVICE))
    if excl:
        perm = np.random.RandomState(0).permutation(n) + 1
        bonds = np.asarray([(perm[i], perm[i + 1]) for i in range(n - 1)
                            if (i + 1) % 8], np.int32)
        # and, for E = 2 d, the d-th neighbours along the chain: a middle
        # bead then has E exclusions
        for d in range(2, max_excl // 2 + 1):
            bonds = np.concatenate([bonds, np.asarray(
                [(perm[i], perm[i + d]) for i in range(n - d)
                 if i % 8 + d < 8], np.int32)])
        ex, w = build_exclusions(bonds, n, weight=weight, max_excl=max_excl,
                                 device=DEVICE)
        p = p.replace(excl=ex, excl_w=w)
    return p


def general_pair_count(st, cfg, params):
    """Ordered pairs inside their own rc_ij that these rows give K1's
    general variant."""
    import torch
    from meso_tpu_torch.kernels.pair_dpd_v3 import _stencil_pairs
    nt = params.n_types
    rc2 = (params.rc * params.rc).reshape(-1)
    total = 0
    for row, src, _, r2 in _stencil_pairs(st.x, st.mask, st.box, cfg,
                                          torch.max(rc2)):
        p = st.typ[row].long() * nt + st.typ[src].long()
        total += int((r2 < rc2[p]).sum())
    return total


def general_bound(st, f, params, n_pairs):
    """(bound_ms, bound_by) of K1's general variant as timed (no virial):
    the mask, and x, v, tag, typ, h and the exclusion row of the valid
    rows in, f out."""
    ins = [st.x, st.v, st.tag, st.typ, st.tag]
    e = 0
    if params.excl is not None:
        ins.append(params.excl)
        e = params.excl.shape[1]
    return row_bound(st.mask, ins, [f], (OPS_PER_PAIR["pair_dpd_v3_general"]
                                         + OPS_PER_EXCL_SLOT * e) * n_pairs)


# the cell tiles' cases of K1's general variant and of K3: (l, particles,
# spill, min-image, RNG tier, capacity (None: the builder's), coefficients,
# kind); kinds "ragged" (a short last run of cx), "dense" (rows whose
# in-range sources overflow a thread's list), "one-block" (a capacity that
# takes one block an SM), "l8"
GENERAL_TILE_CASES = (
    (41.0, 206763, True, False, "fast", None, "two_types", "ragged"),
    (41.0, 206763, False, True, "tea", None, "general", "ragged"),
    (8.0, 4608, True, False, "tea", 128, "excl6", "dense"),
    (8.0, 4608, False, True, "fast", 192, "general", "dense"),
    (8.0, 16384, True, True, "fast", None, "excl6", "one-block"),
    (8.0, 16384, True, False, "tea", None, "two_types", "one-block"),
    (8.0, 1536, True, True, "tea", None, "excl6", "l8"),
    (8.0, 1536, False, False, "fast", None, "excl6", "l8"))
EDPD_TILE_CASES = (
    (41.0, 206763, True, False, "fast", None, "1type", "ragged"),
    (41.0, 206763, False, True, "tea", None, "2types", "ragged"),
    (8.0, 4608, True, True, "tea", 128, "1type", "dense"),
    (8.0, 4608, False, False, "fast", 192, "2types", "dense"),
    (8.0, 16384, True, True, "fast", None, "1type", "one-block"),
    (8.0, 16384, True, False, "tea", None, "2types", "one-block"),
    (8.0, 1536, True, False, "fast", None, "2types", "l8"),
    (8.0, 1536, False, True, "tea", None, "1type", "l8"))
TDPD_TILE_CASES = (
    (41.0, 206763, True, False, "fast", None, "S1", "ragged"),
    (41.0, 206763, False, True, "tea", None, "S10", "ragged"),
    (8.0, 4608, True, True, "tea", 128, "S10", "dense"),
    (8.0, 4608, False, False, "fast", 192, "S2", "dense"),
    (8.0, 16384, True, True, "fast", None, "S1", "one-block"),
    (8.0, 16384, True, False, "tea", None, "S10-2types", "one-block"),
    (8.0, 1536, True, False, "fast", None, "S10-2types", "l8"),
    (8.0, 1536, False, True, "tea", None, "S10", "l8"))


def general_coefs(coef, n):
    """GENERAL_TILE_CASES' coefficients: "general" (two types, s_exp 0.5,
    E = 2 at weight 0.25), "two_types" (the walls' form), "excl6" (two
    types, E = 6 at weight 0.5)."""
    return {"general": lambda: general_params(n),
            "two_types": lambda: general_params(n, s_exp=1.0, excl=False),
            "excl6": lambda: general_params(n, s_exp=1.0, weight=0.5,
                                            max_excl=6)}[coef]()


def row_tile_fields(bst, cfg):
    """The bucket-row tile plan (K1's, which K1's general variant, K2 and
    K3 share) for these cells and the slot tests a valid row its walk makes
    on these rows (the valid slots of its stencil, itself included)."""
    from meso_tpu_torch.kernels import cell_tiles
    p = cell_tiles.plan(cfg.capacity, 2 if cfg.spill else 1, cfg.ncell)
    n_valid = int(bst.mask.sum())
    return {"width": p.width, "runs": p.n_xtiles, "threads": p.threads,
            "smem_bytes": p.smem_bytes, "blocks_per_sm": p.blocks_per_sm(),
            "tests_per_valid_row":
                (stencil_candidates(bst, cfg) + n_valid) / n_valid}


def check_tile_case(label, kind, cfg, rec):
    """That a tile case is the case it names (rec: row_tile_fields and
    max_partners)."""
    from meso_tpu_torch.kernels import cell_tiles
    failed = {
        "ragged": kind == "ragged" and cfg.ncell[0] % rec["width"] == 0,
        "fills its list": kind == "dense"
        and rec["max_partners"] <= cell_tiles.LIST_CAP,
        "one block an SM": kind in ("dense", "one-block")
        and rec["blocks_per_sm"] != 1}
    if any(failed.values()):
        raise AssertionError(f"{label}: not the case it names "
                             f"({[k for k, v in failed.items() if v]})")


def ptxas_of(ptxas, kernel):
    """The build's register report lines of one kernel's instances."""
    return [ln for ln in ptxas if kernel in ln]


def phase_general_kernels(k1_ms, card, ptxas=()):
    """K1's general variant against its plain version: at l=8 in every
    covered combination, then on each new 1M path's own inputs, with its
    time, the plain time, K1's one-type time on the same rows and the
    bound. ``k1_ms`` is K1's one-type time at the main-path shape (phase
    3): on the card PR 6 measured it on (``card``, from nvidia-smi) it must
    be below PR 6's, the one-thread-a-row kernel's."""
    import torch
    from meso_tpu_torch.kernels.pair_dpd_v3 import (bucket_forces_pallas_v3,
                                                    bucket_forces_v3_plain)
    from meso_tpu_torch.ops.dpd import DPDParams
    out = {"l8": []}
    step = 42
    cases = [("general", general_params(1536))]
    # the two paths' own combinations: two types alone (walls), one type
    # with exclusions (polymers)
    cases += [("two_types", general_params(1536, s_exp=1.0, excl=False)),
              ("excl", general_params(1536, two_types=False, s_exp=1.0))]
    for spill in (True, False):
        for min_image in (False, True):
            bst0, cfg = bucket_case(8.0, 1536, spill, min_image)
            m = bst0.mask
            for name, p in cases:
                # types alternate by tag where the table has two
                bst = bst0.replace(typ=(bst0.tag % p.n_types)
                                   .to(torch.int32))
                for rng_mode in ("fast", "tea"):
                    if name != "general" and (rng_mode, spill) != ("fast",
                                                                   True):
                        continue
                    args = (bst.x, bst.v, bst.typ, bst.tag, m, bst.box, step,
                            p, 0.01, cfg)
                    kw = dict(rng_mode=rng_mode, s_exp=p.s_exp)
                    label = (f"l8 {name} {rng_mode} spill={spill} "
                             f"min_image={min_image}")
                    f_k, vir_k = bucket_forces_pallas_v3(*args, **kw)
                    f_k2, vir_off = bucket_forces_pallas_v3(
                        *args, need_virial=False, **kw)
                    d_k, dvir_k = bucket_forces_pallas_v3(
                        *args, debug_pairs=True, **kw)
                    torch.cuda.synchronize()
                    plain_args = (bst.x, bst.v, bst.tag, m, bst.box, step, p,
                                  0.01, cfg, rng_mode)
                    f_p, vir_p = bucket_forces_v3_plain(*plain_args,
                                                        typ=bst.typ)
                    d_p, _ = bucket_forces_v3_plain(*plain_args, typ=bst.typ,
                                                    debug_pairs=True)
                    err, rel, vrel = compare_forces(f_k, vir_k, f_p, vir_p, m,
                                                    min_image, label)
                    if not torch.equal(f_k, f_k2) or vir_off.item() != 0.0:
                        raise AssertionError(f"{label}: need_virial=False "
                                             "changed the forces")
                    if not torch.equal(d_k, d_p) or dvir_k.item() != 0.0:
                        bad = int((d_k != d_p).any(1).sum())
                        raise AssertionError(f"{label}: debug_pairs differs "
                                             f"from the plain version on "
                                             f"{bad} rows")
                    out["l8"].append({"case": label, "max_abs_err": err,
                                      "rel": rel, "virial_rel": vrel,
                                      "pairs": int(d_k[:, 0].sum())})
    say("kernels-general-l8", cases=len(out["l8"]),
        worst_rel=max(c["rel"] for c in out["l8"]),
        worst_virial_rel=max(c["virial_rel"] for c in out["l8"]),
        debug_pairs="bitwise")

    # the cell tiles' cases (GENERAL_TILE_CASES)
    out["tiles"] = []
    for l, n, spill, min_image, rng_mode, capacity, coef, kind in \
            GENERAL_TILE_CASES:
        bst, cfg = bucket_case(l, n, spill, min_image, capacity=capacity)
        p = general_coefs(coef, n)
        bst = bst.replace(typ=(bst.tag % p.n_types).to(torch.int32))
        m = bst.mask
        args = (bst.x, bst.v, bst.typ, bst.tag, m, bst.box, step, p, 0.01,
                cfg)
        kw = dict(rng_mode=rng_mode, s_exp=p.s_exp)
        label = (f"{kind} {coef} l={l:g} n={n} K={cfg.capacity} {rng_mode} "
                 f"spill={spill} min_image={min_image}")
        f_k, vir_k = bucket_forces_pallas_v3(*args, **kw)
        d_k, _ = bucket_forces_pallas_v3(*args, debug_pairs=True, **kw)
        torch.cuda.synchronize()
        plain_args = (bst.x, bst.v, bst.tag, m, bst.box, step, p, 0.01, cfg,
                      rng_mode)
        f_p, vir_p = bucket_forces_v3_plain(*plain_args, typ=bst.typ)
        d_p, _ = bucket_forces_v3_plain(*plain_args, typ=bst.typ,
                                        debug_pairs=True)
        err, rel, vrel = compare_forces(f_k, vir_k, f_p, vir_p, m, min_image,
                                        label)
        if not torch.equal(d_k, d_p):
            raise AssertionError(f"{label}: debug_pairs differs from the "
                                 f"plain version on "
                                 f"{int((d_k != d_p).any(1).sum())} rows")
        rec = {"case": label, "max_abs_err": err, "rel": rel,
               "virial_rel": vrel, "pairs": int(d_k[:, 0].sum()),
               "max_partners": max_partners(bst, cfg),
               **row_tile_fields(bst, cfg)}
        check_tile_case(label, kind, cfg, rec)
        out["tiles"].append(rec)
        del bst, f_k, f_p, d_k, d_p
    say("kernels-general-tiles", cases=len(out["tiles"]),
        worst_rel=max(c["rel"] for c in out["tiles"]),
        worst_virial_rel=max(c["virial_rel"] for c in out["tiles"]),
        debug_pairs="bitwise",
        tiles=[{k: c[k] for k in ("case", "width", "runs", "blocks_per_sm",
                                  "max_partners")} for c in out["tiles"]])

    rec = {"k1_main_shape_ms": k1_ms, "k1_pr6_ms": K1_PR6_MS,
           "k1_change": k1_ms / K1_PR6_MS - 1.0,
           "k1_pr6_card": K1_PR6_CARD, "card": card}
    for name, build in (("walls", walls_path), ("polymer", polymer_path)):
        system, sparams, st = build()
        cfg, pair = system.cells, sparams.pair
        args = (st.x, st.v, st.typ, st.tag, st.mask, st.box, 1, pair,
                system.dt, cfg)
        plain_args = (st.x, st.v, st.tag, st.mask, st.box, 1, pair,
                      system.dt, cfg)
        f_k, vir_k = bucket_forces_pallas_v3(*args, rng_mode="fast")
        f_p, vir_p = bucket_forces_v3_plain(*plain_args, typ=st.typ)
        err, rel, vrel = compare_forces(f_k, vir_k, f_p, vir_p, st.mask,
                                        False, f"{name} path")
        d_k, _ = bucket_forces_pallas_v3(*args, rng_mode="fast",
                                         debug_pairs=True)
        d_p, _ = bucket_forces_v3_plain(*plain_args, typ=st.typ,
                                        debug_pairs=True)
        if not torch.equal(d_k, d_p):
            raise AssertionError(f"{name} path: debug_pairs differs")
        n_pairs = general_pair_count(st, cfg, pair)
        prec = {"nr": st.n, "capacity": cfg.capacity,
                "n_types": pair.n_types,
                "excl": None if pair.excl is None
                else list(pair.excl.shape),
                "pairs_in_rc": n_pairs, "max_abs_err": err, "rel": rel,
                "virial_rel": vrel,
                "ms": timed_ms(lambda: bucket_forces_pallas_v3(
                    *args, rng_mode="fast", need_virial=False), 20),
                "plain_ms": timed_ms(lambda: bucket_forces_v3_plain(
                    *plain_args, typ=st.typ, need_virial=False), 3)}
        # K1's one-type kernel on the same rows: the path's own a, gamma
        # and rc for type 0, no exclusions
        one = DPDParams.build(a=float(pair.a[0, 0]),
                              gamma=float(pair.gamma[0, 0]),
                              rc=float(pair.rc[0, 0]), kt=pair.kt,
                              seed=pair.seed, device=DEVICE)
        prec["k1_same_rows_ms"] = timed_ms(lambda: bucket_forces_pallas_v3(
            *args[:7], one, *args[8:], rng_mode="fast", need_virial=False),
            20)
        prec["bound_ms"], prec["bound_by"] = general_bound(st, f_k, pair,
                                                           n_pairs)
        prec.update(row_tile_fields(st, cfg))
        rec[name] = prec
        del system, sparams, st, f_k, f_p, d_k, d_p, args, plain_args
    rec["ptxas"] = ptxas_of(ptxas, "pair_dpd_v3_general_kernel")
    out["l70"] = rec
    say("kernels-general-l70", **rec)
    if card == K1_PR6_CARD and k1_ms >= K1_PR6_MS:
        raise AssertionError(f"K1's one-type time {k1_ms:.4f} ms is not "
                             f"below PR 6's {K1_PR6_MS} ms on the same card")
    return out


def run_full_path(label, build):
    """One 1M path through its builder: FULL_EQUIL_STEPS with run_bucket,
    then FULL_TIMED_STEPS of run_bucket_chunked, synchronised on both
    sides, in FULL_BLOCKS blocks with the observables sampled on the
    device between them. The timed window runs at the first cadence of
    FULL_CADENCES whose worst skin ratio stays below 1 (from the
    equilibrated state each time). Launch counts are set to 0 just before
    the builder and read just after the last window. Returns (record, the
    state at set-up, the final state, the per-block samples)."""
    import torch
    from meso_tpu_torch.core.system import run_bucket
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    system, params, start = build()
    t_built = time.perf_counter()
    state, d_eq = run_bucket(system, params, start, FULL_EQUIL_STEPS)
    torch.cuda.synchronize()
    t_eq = time.perf_counter()
    force_evals = 1 + FULL_EQUIL_STEPS
    windows = []
    for every in FULL_CADENCES:
        s = state
        samples, diags = [], []
        per_block = FULL_TIMED_STEPS // FULL_BLOCKS
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(FULL_BLOCKS):
            s, d = advance(system, params, s, per_block, every)
            diags += d
            samples.append(SAMPLERS[label](params, s))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        force_evals += FULL_TIMED_STEPS
        win = {"steps_per_rebuild": every, "wall_s": wall,
               "ms_per_step": 1e3 * wall / FULL_TIMED_STEPS,
               "worst_skin_ratio": max(float(d["worst_skin_ratio"])
                                       for d in diags),
               "bucket_overflow": max(int(d["bucket_overflow"])
                                      for d in diags)}
        windows.append(win)
        if win["worst_skin_ratio"] < 1.0:
            break
    launches = read_launches()
    n = int(start.n_valid())
    win = windows[-1]
    res = {"path": label, "n_particles": n, "rows": s.n,
           "capacity": system.cells.capacity,
           "rebuild": system.cells.rebuild, "wrap_mode": system.wrap_mode,
           "n_types": params.pair.n_types,
           "build_s": t_built - t0, "equil_s": t_eq - t_built,
           "equil_steps": FULL_EQUIL_STEPS,
           "equil_rebuilds": d_eq["n_rebuilds"],
           "equil_worst_disp_at_rebuild":
               float(d_eq["worst_disp_at_rebuild"]),
           "timed_steps": FULL_TIMED_STEPS,
           "steps_per_rebuild": win["steps_per_rebuild"],
           "ms_per_step": win["ms_per_step"],
           "particle_steps_per_s": 1e3 * n / win["ms_per_step"],
           "worst_skin_ratio": win["worst_skin_ratio"],
           "windows": windows,
           "bucket_overflow": max([int(d_eq["bucket_overflow"])]
                                  + [w["bucket_overflow"] for w in windows]),
           "force_evals": force_evals, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    finite = all(bool(torch.isfinite(t).all()) for t in (s.x, s.v, s.f))
    checks = {
        "every force evaluation through pair_dpd_v3_general":
            pair_launches(launches) == {
                **{k: 0 for k in pair_launches(launches)},
                "pair_dpd_v3_general": force_evals},
        "hash launches == force evaluations":
            launches["particle_hash"] == force_evals,
        "pair_bonds calls == force evaluations (0 without bonds)":
            launches["pair_bonds"] == (force_evals
                                       if system.bond_style else 0),
        "bucket_overflow == 0": res["bucket_overflow"] == 0,
        "worst_skin_ratio < 1": win["worst_skin_ratio"] < 1.0,
        "state finite": finite}
    return res, checks, (system, params, start, s, samples)


def by_tag(state, values):
    """values (N, ...) of the valid rows, in tag order."""
    import torch
    m = state.mask
    return values[m][torch.argsort(state.tag[m])]


def sample_walls(params, state):
    """Between walls-full's timed blocks: the fluid's kT in the flow frame
    (temperature_profile over type 0, 70 bins along y) and its mean x
    velocity, as device scalars."""
    import torch
    from meso_tpu_torch.obs.profiles import temperature_profile
    mass = params.mass[state.typ.long()]
    _, kt, cnt = temperature_profile(state, mass, axis=1, nbins=70, typ=0,
                                     subtract_flow=True)
    fluid = state.mask & (state.typ == 0)
    return (torch.sum(kt * cnt) / torch.sum(cnt),
            torch.sum(torch.where(fluid, state.v[:, 0], 0.0))
            / torch.sum(fluid))


def sample_polymer(params, state):
    """Between polymer-full's timed blocks: kT and the total momentum."""
    from meso_tpu_torch.obs import kinetic_temperature, total_momentum
    mass = params.mass[state.typ.long()]
    return (kinetic_temperature(state.v, mass, state.mask),
            total_momentum(state.v, mass, state.mask))


SAMPLERS = {"walls": sample_walls, "polymer": sample_polymer}


def bond_lengths(state, bond_tags, n_tags):
    """Minimum-image length of each bond, from the rows holding its tags."""
    import torch
    from meso_tpu_torch.ops.bonded import inverse_tag_map
    inv = inverse_tag_map(state.tag, state.mask, n_tags)
    bt = bond_tags.long()
    d = state.box.min_image(state.x[inv[bt[:, 0]]] - state.x[inv[bt[:, 1]]])
    return torch.sqrt(torch.sum(d * d, -1))


def phase_walls_full():
    import numpy as np
    import torch
    res, checks, (system, params, start, s, samples) = run_full_path(
        "walls", walls_path)
    kts = np.asarray([float(k) for k, _ in samples])
    vxs = [float(v) for _, v in samples]
    steps = system.dt * (FULL_EQUIL_STEPS + FULL_TIMED_STEPS)
    wall0 = start.typ == 1
    lens = start.box.lengths
    x0 = by_tag(start, torch.remainder(start.x, lens))
    x1 = by_tag(s, torch.remainder(s.x, lens))
    wall = by_tag(start, wall0)
    fluid_y = s.x[s.mask & (s.typ == 0), 1]
    fix = next(f for f in system.fixes if type(f).__name__ ==
               "FixBounceBack")
    res.update(n_wall_beads=int(wall0.sum()), kT_fluid_flow_frame=kts.tolist(),
               kT_mean=float(kts.mean()), mean_fluid_vx=vxs,
               g_t=0.1 * steps,
               fluid_y_min=float(fluid_y.min()),
               fluid_y_max=float(fluid_y.max()),
               wall_max_move=float((x1[wall] - x0[wall]).abs().max()))
    say("walls-full", **res)
    checks.update({
        "wall beads unmoved (by tag)": torch.equal(x1[wall], x0[wall]),
        "no fluid bead beyond the bounce-back planes by > 0.2":
            res["fluid_y_min"] > fix.lo - 0.2
            and res["fluid_y_max"] < fix.hi + 0.2,
        "fluid kT (flow frame) within 3% of 1":
            abs(res["kT_mean"] - 1.0) < 0.03})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"walls-full failed: {failed}")
    return res


def phase_polymer_full():
    import numpy as np
    import torch
    from meso_tpu_torch.obs import total_momentum
    res, checks, (system, params, start, s, samples) = run_full_path(
        "polymer", polymer_path)
    kts = np.asarray([float(k) for k, _ in samples])
    mass0 = params.mass[start.typ.long()]
    p0 = total_momentum(start.v, mass0, start.mask)
    drift = max(float((p - p0).abs().max()) for _, p in samples)
    bl = bond_lengths(s, params.bonded.bond_tags, system.n_tags)
    res.update(n_bonds=int(bl.numel()),
               excl_shape=list(params.pair.excl.shape),
               kT=kts.tolist(), kT_mean=float(kts.mean()),
               momentum_drift=drift, bond_max=float(bl.max()),
               bond_mean=float(bl.mean()))
    say("polymer-full", **res)
    checks.update({
        "bond max < 1.45": res["bond_max"] < 1.45,
        "0.30 < bond mean < 0.75": 0.30 < res["bond_mean"] < 0.75,
        "momentum drift < 5e-2": drift < 5e-2,
        "kT within 2% of 1": abs(res["kT_mean"] - 1.0) < 0.02})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"polymer-full failed: {failed}")
    return res


def averaged_profile(system, params, state, nsteps_equil, nsamples,
                     sample_every, nbins):
    """tests/physics/test_walls.py::_averaged_profile through run_bucket:
    (state, bin centres, mean fluid x velocity per bin, counts, overflow)."""
    import numpy as np
    from meso_tpu_torch.core.system import run_bucket
    from meso_tpu_torch.obs.profiles import velocity_profile
    state, d = run_bucket(system, params, state, nsteps_equil)
    overflow = int(d["bucket_overflow"])
    acc = np.zeros(nbins)
    cnt_acc = np.zeros(nbins)
    for _ in range(nsamples):
        state, d = run_bucket(system, params, state, sample_every)
        overflow = max(overflow, int(d["bucket_overflow"]))
        y, u, cnt = velocity_profile(state, axis=1, flow_axis=0,
                                     nbins=nbins, typ=0)
        cnt = cnt.cpu().numpy()
        acc += u.cpu().numpy() * cnt
        cnt_acc += cnt
    return (state, y.cpu().numpy(), acc / np.maximum(cnt_acc, 1.0), cnt_acc,
            overflow)


def phase_walls_physics():
    """The deck-size gates of tests/physics/test_walls.py on the card,
    through K1's general variant and run_bucket (the JAX tests use
    run_adaptive, which is the nlist path's loop)."""
    import numpy as np
    from meso_tpu_torch.core.system import run_bucket
    from meso_tpu_torch.models.classic import classic_fluid
    from meso_tpu_torch.models.walls import couette, poiseuille
    from meso_tpu_torch.obs.viscosity import run_viscosity_mp
    kw = dict(force_path="pallas", device=DEVICE)
    g, h, w = 0.1, 6.0, 1.0
    res = {}
    checks = {}

    # Poiseuille parabola and viscosity (test_walls.py:32-65)
    system, params, state = poiseuille(g=g, h=h, wall_width=w, **kw)
    state, y, u, cnt, of_p = averaged_profile(system, params, state, 1500,
                                              40, 25, 24)
    sel = (y > w + 0.15) & (y < h - w - 0.15) & (cnt > 0)
    ys, us = y[sel], u[sel]
    a_mat = np.stack([np.ones_like(ys), ys, ys * ys], 1)
    coef = np.linalg.lstsq(a_mat, us, rcond=None)[0]
    u_max = float(us.max())
    rms = float(np.sqrt(np.mean((us - a_mat @ coef) ** 2)))
    eta = float(-3.0 * g / (2 * coef[2]))
    y_vertex = float(-coef[1] / (2 * coef[2]))
    m = state.mask
    yf = state.x[m & (state.typ == 0), 1]
    res["poiseuille"] = {"profile": u.tolist(), "u_max": u_max,
                         "rms_over_umax": rms / u_max, "curvature": coef[2],
                         "eta": eta, "y_vertex": y_vertex,
                         "fluid_y_min": float(yf.min()),
                         "fluid_y_max": float(yf.max()),
                         "bucket_overflow": of_p}
    checks["Poiseuille: flow developed, parabolic, concave"] = (
        u_max > 0.2 and rms / u_max < 0.08 and coef[2] < 0)
    checks["Poiseuille: 0.5 < eta < 2"] = 0.5 < eta < 2.0
    checks["Poiseuille: vertex within 0.4 of h/2"] = \
        abs(y_vertex - h / 2) < 0.4
    checks["Poiseuille: fluid inside [w - 0.2, h - w + 0.2]"] = (
        res["poiseuille"]["fluid_y_min"] > w - 0.2
        and res["poiseuille"]["fluid_y_max"] < h - w + 0.2)

    # Couette linear profile (test_walls.py:68-85)
    system, params, state = couette(u=1.0, h=h, wall_width=w, **kw)
    state, y, u, cnt, of_c = averaged_profile(system, params, state, 1500,
                                              40, 25, 24)
    sel = (y > w + 0.15) & (y < h - w - 0.15) & (cnt > 0)
    ys, us = y[sel], u[sel]
    a_mat = np.stack([np.ones_like(ys), ys], 1)
    coef = np.linalg.lstsq(a_mat, us, rcond=None)[0]
    slope_expect = 1.0 / (h - 2 * w)
    rms = float(np.sqrt(np.mean((us - a_mat @ coef) ** 2)))
    res["couette"] = {"profile": u.tolist(), "slope": float(coef[1]),
                      "slope_expected": slope_expect, "rms": rms,
                      "centre": float(coef[0] + coef[1] * h / 2),
                      "bucket_overflow": of_c}
    checks["Couette: slope within 25%"] = \
        abs(coef[1] - slope_expect) / slope_expect < 0.25
    checks["Couette: rms < 0.1 U"] = rms < 0.1
    checks["Couette: antisymmetric"] = abs(res["couette"]["centre"]) < 0.1

    # frozen wall beads, by tag (test_walls.py:88-113)
    system, params, start = poiseuille(g=g, **kw)
    state, d = run_bucket(system, params, start, 100)
    wall = by_tag(start, start.typ == 1)
    moved = float((by_tag(state, state.x) - by_tag(start, start.x))[wall]
                  .abs().max())
    res["frozen_walls"] = {"max_move": moved,
                           "bucket_overflow": int(d["bucket_overflow"])}
    checks["frozen wall beads do not move"] = moved == 0.0

    # Mueller-Plathe viscosity (test_walls.py:116-131) on the pallas path:
    # the JAX test's force_path "bucket" is not ported (ROADMAP Queue 1
    # item 13)
    system, params, state = classic_fluid(l=8.0, skin=0.4, **kw)
    eta_mp, det = run_viscosity_mp(system, params, state, nswaps=150,
                                   swap_every=10)
    res["muller_plathe"] = {"eta": eta_mp, "flux": det["flux"],
                            "slope": det["slope"],
                            "force_path": system.force_path}
    checks["Mueller-Plathe: flux > 0, 0.6 < eta < 1.6"] = (
        det["flux"] > 0 and 0.6 < eta_mp < 1.6)
    checks["bucket_overflow == 0"] = max(of_p, of_c, int(d[
        "bucket_overflow"])) == 0
    say("walls-physics", **res)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"walls physics failed: {failed}")
    return res


def phase_bonded_physics():
    """The deck-size gates of tests/physics/test_polymer.py on the card,
    through K1 (general variant where exclusions are on) and run_bucket;
    the FENE gates also on the polymer_special deck's special_weight=0.5."""
    import numpy as np
    import torch
    from meso_tpu_torch.core.system import run_bucket
    from meso_tpu_torch.models.polymer import (membrane_suspension,
                                               polymer_melt)
    from meso_tpu_torch.obs import total_momentum
    kw = dict(force_path="pallas", device=DEVICE)
    res, checks = {}, {}
    for name, sw in (("fene", None), ("fene_special", 0.5)):
        system, params, state = polymer_melt(l=6.0, n_chains=3,
                                             chain_len=10, special_weight=sw,
                                             **kw)
        p0 = total_momentum(state.v, params.mass[state.typ.long()],
                            state.mask)
        state, d = run_bucket(system, params, state, 400)
        bl = bond_lengths(state, params.bonded.bond_tags, system.n_tags)
        drift = float((total_momentum(state.v, params.mass[state.typ.long()],
                                      state.mask) - p0).abs().max())
        res[name] = {"bond_max": float(bl.max()),
                     "bond_mean": float(bl.mean()), "momentum_drift": drift,
                     "bucket_overflow": int(d["bucket_overflow"]),
                     "finite": bool(torch.isfinite(state.x).all())}
        r = res[name]
        checks[f"{name}: bonds below 1.45, mean in (0.30, 0.75)"] = (
            r["bond_max"] < 1.45 and 0.30 < r["bond_mean"] < 0.75)
        checks[f"{name}: finite, momentum drift < 5e-2, overflow 0"] = (
            r["finite"] and drift < 5e-2 and r["bucket_overflow"] == 0)

    # the vesicle (test_polymer.py:46-71)
    system, params, state, mesh = membrane_suspension(
        l=10.0, radius=2.5, subdiv=1, density=3.0, **kw)
    state, d = run_bucket(system, params, state, 300)
    n_mem = mesh["n_mem"]
    pos = by_tag(state, state.x).cpu().numpy()[:n_mem].astype(np.float64)
    faces = mesh["faces"]
    p0 = pos[faces[:, 0]]
    cr = np.cross(pos[faces[:, 1]] - p0, pos[faces[:, 2]] - p0)
    area = float(0.5 * np.linalg.norm(cr, axis=1).sum())
    vol = float(abs((p0 * cr).sum() / 6.0))
    bl = bond_lengths(state, params.bonded.bond_tags, system.n_tags)
    res["membrane"] = {"area": area, "area0": mesh["area0"], "volume": vol,
                       "volume0": mesh["vol0"], "edge_max": float(bl.max()),
                       "l_max": mesh["l_max"],
                       "bucket_overflow": int(d["bucket_overflow"])}
    checks["membrane: area and volume within 10%, edges below l_max"] = (
        abs(area - mesh["area0"]) / mesh["area0"] < 0.10
        and abs(vol - mesh["vol0"]) / mesh["vol0"] < 0.10
        and float(bl.max()) < mesh["l_max"]
        and res["membrane"]["bucket_overflow"] == 0)
    say("bonded-physics", **res)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bonded physics failed: {failed}")
    return res


def selector_fn(name):
    """The wrapper of a fused or banded entry point."""
    from meso_tpu_torch.kernels import pair_dpd, pair_dpd_fused, \
        pair_multiphysics
    fu, mp = pair_dpd_fused, pair_multiphysics
    return {"pair_fused_dpd": fu.bucket_forces_pallas_fused,
            "pair_fused_edpd": fu.bucket_forces_pallas_edpd_fused,
            "pair_fused_tdpd": fu.bucket_forces_pallas_tdpd_fused,
            "pair_banded_dpd": pair_dpd.bucket_forces_pallas,
            "pair_banded_edpd": mp.bucket_forces_pallas_edpd,
            "pair_banded_tdpd": mp.bucket_forces_pallas_tdpd}[name]


def run_entry(name, plain, st, fld, step, params, dt, cfg, rng_mode="fast"):
    """One call of a fused or banded entry point in its own argument order,
    or (``plain``) of the plain version of all six,
    ``_brick.brick_forces_plain``, on the same inputs. Returns (f, virial)
    or (f, flux, virial)."""
    model = name.rsplit("_", 1)[1]
    if plain:
        from meso_tpu_torch.kernels._brick import brick_forces_plain
        out = brick_forces_plain(model, st.x, st.v, fld, st.typ, st.tag,
                                 st.mask, st.box, step, params, dt, cfg,
                                 rng_mode)
        return (out[0], out[2]) if model == "dpd" else out
    args = (st.x, st.v) + ((fld,) if model != "dpd" else ()) + (
        st.typ, st.tag, st.mask, st.box, step, params, dt, cfg)
    kw = {"rng_mode": rng_mode}
    if name == "pair_fused_dpd":
        kw["s_exp"] = params.s_exp
    return selector_fn(name)(*args, **kw)


def compare_entry(name, got, want, mask, label):
    """A fused or banded kernel against its plain version: the classic
    bounds of compare_forces, the transport ones of compare_transport (both
    with the minimum image, which these kernels always take)."""
    if name.endswith("_dpd"):
        err, rel, vrel = compare_forces(*got, *want, mask, True, label)
        return {"max_abs_err": err, "rel": rel, "virial_rel": vrel}
    return compare_transport(got, want, mask, True, label)


TWO_TYPES = dict(a=[[25.0, 35.0], [30.0, 40.0]], rc=[[1.0, 0.8], [0.8, 1.0]],
                 n_types=2)


def tdpd_params(ns, two_types):
    """tDPD with ``ns`` species (kappa_c 0.5-1.5, eps_c 0.05-0.2, rcc 0.8,
    s1 2), one type or TWO_TYPES' tables."""
    import numpy as np
    from meso_tpu_torch.ops.tdpd import TDPDParams
    kw = TWO_TYPES if two_types else dict(a=25.0, rc=1.0)
    return TDPDParams.build(gamma=4.5, kt=1.0,
                            kappa_c=list(np.linspace(0.5, 1.5, ns)),
                            eps_c=list(np.linspace(0.05, 0.2, ns)), rcc=0.8,
                            s1=2.0, seed=5, device=DEVICE, **kw)


def edpd_two_types():
    """eDPD over TWO_TYPES' tables with an asymmetric kappa."""
    from meso_tpu_torch.ops.edpd import EDPDParams
    return EDPDParams.build(gamma=4.5, kappa=[[1.5, 1.0], [1.2, 0.5]],
                            cv=10.0, seed=7, device=DEVICE, **TWO_TYPES)


def selector_params():
    """The selector checks' coefficients by model: (label, params, uses two
    types, species) cases. Classic: one type, and K1's general case
    (general_params: two types, s_exp 0.5, exclusions). eDPD: the transport
    checks' one-type case and TWO_TYPES with an asymmetric kappa. tDPD:
    one species (tdpd_diffusion's rcc = rc = 1), three with two types and
    ten with one."""
    from meso_tpu_torch.ops.dpd import DPDParams
    tp = transport_params()
    return {"dpd": [("1type", DPDParams.build(a=25.0, gamma=4.5, rc=1.0,
                                              kt=1.0, seed=77,
                                              device=DEVICE), False, 0),
                    ("general", general_params(1536), True, 0)],
            "edpd": [("1type", tp["edpd"], False, 0),
                     ("2types", edpd_two_types(), True, 0)],
            "tdpd": [("S1", tp["tdpd_1species"], False, 1),
                     ("S3-2types", tdpd_params(3, True), True, 3),
                     ("S10", tdpd_params(10, False), False, 10)]}


def with_species(bst, ns=10):
    """T = 1 + 0.3 sin x and ``ns`` species C_s = 1 + 0.1 s + 0.5 cos(x +
    s), zero on pad rows."""
    import torch
    m = bst.mask
    t = torch.where(m, 1.0 + 0.3 * torch.sin(bst.x[:, 0]), 0.0)
    s = torch.arange(ns, device=bst.x.device, dtype=torch.float32)
    c = 1.0 + 0.1 * s + 0.5 * torch.cos(bst.x[:, :1] + s)
    return bst.replace(T=t.contiguous(),
                       C=torch.where(m[:, None], c, 0.0).contiguous())


def phase_selector_kernels():
    """8a at l=8: every fused (K5) and banded (K6, K7) entry point against
    its plain version, in every covered case: fast and TEA, spill (K5 only)
    and strict, one type and two (asymmetric tables), s_exp 0.5 and
    exclusions (classic), one, three and ten species (tDPD); a row that
    crossed the box mid-window (K5, K6); and K2/K3 with two types and ten
    species (fast/TEA x spill/strict x min-image on/off)."""
    import torch
    from meso_tpu_torch.kernels import pair_dpd_v3 as v3
    out = {"l8": [], "k23_l8": []}
    cases = selector_params()
    step = 42
    for spill in (True, False):
        bst0, cfg = bucket_case(8.0, 1536, spill, True)
        bst0 = with_species(bst0)
        bst2 = bst0.replace(typ=(bst0.tag % 2).to(torch.int32))
        m = bst0.mask
        for rng_mode in ("fast", "tea"):
            for sel in ("v2", "banded"):
                if sel == "banded" and spill:
                    continue
                for model, mcases in cases.items():
                    name = SELECTOR_KERNELS[sel][model]
                    for label, p, two, ns in mcases:
                        st = bst2 if two else bst0
                        fld = (None if model == "dpd" else st.T
                               if model == "edpd" else
                               st.C[:, :ns].contiguous())
                        got = run_entry(name, False, st, fld, step, p, 0.01,
                                        cfg, rng_mode)
                        torch.cuda.synchronize()
                        want = run_entry(name, True, st, fld, step, p, 0.01,
                                         cfg, rng_mode)
                        case = (f"{name} {label} {rng_mode} "
                                f"spill={spill}")
                        out["l8"].append({"case": case, **compare_entry(
                            name, got, want, m, case)})
    # a row whose x wrapped the box while its bucket is stale
    bst, cfg = bucket_case(8.0, 1536, False, True)
    r = int(torch.nonzero(bst.mask)[17])
    x = bst.x.clone()
    x[r, 0] += -8.0 if float(x[r, 0]) > 4.0 else 8.0
    bst = bst.replace(x=x)
    p = cases["dpd"][0][1]
    for name in ("pair_fused_dpd", "pair_banded_dpd"):
        got = run_entry(name, False, bst, None, 7, p, 0.01, cfg)
        want = run_entry(name, True, bst, None, 7, p, 0.01, cfg)
        case = f"{name} wrap-crosser"
        out["l8"].append({"case": case, **compare_entry(name, got, want,
                                                        bst.mask, case)})
    say("kernels-selectors-l8", cases=len(out["l8"]),
        worst_rel=max(c["rel"] for c in out["l8"]),
        worst_flux_rel=max(c.get("flux_rel", 0.0) for c in out["l8"]),
        worst_virial_rel=max(c["virial_rel"] for c in out["l8"]))

    # K2 and K3 with two-type tables and ten species
    k23 = {"edpd": cases["edpd"][1],
           "tdpd": ("S10-2types", tdpd_params(10, True), True, 10)}
    for spill in (True, False):
        for min_image in (True, False):
            bst, cfg = bucket_case(8.0, 1536, spill, min_image)
            bst = with_species(bst)
            bst = bst.replace(typ=(bst.tag % 2).to(torch.int32))
            for model, (label, p, _, ns) in k23.items():
                fn = (v3.bucket_forces_pallas_v3_edpd if model == "edpd"
                      else v3.bucket_forces_pallas_v3_tdpd)
                plain = (v3.bucket_forces_v3_edpd_plain if model == "edpd"
                         else v3.bucket_forces_v3_tdpd_plain)
                fld = bst.T if model == "edpd" else bst.C
                for rng_mode in ("fast", "tea"):
                    args = (bst.x, bst.v, fld, bst.typ, bst.tag, bst.mask,
                            bst.box, 12, p, 0.01, cfg)
                    got = fn(*args, rng_mode=rng_mode)
                    torch.cuda.synchronize()
                    want = plain(bst.x, bst.v, fld, bst.tag, bst.mask,
                                 bst.box, 12, p, 0.01, cfg, rng_mode,
                                 typ=bst.typ)
                    case = (f"{model} {label} {rng_mode} spill={spill} "
                            f"min_image={min_image}")
                    out["k23_l8"].append({"case": case, **compare_transport(
                        got, want, bst.mask, min_image, case)})
    say("kernels-k23-multitype-l8", cases=len(out["k23_l8"]),
        worst_rel=max(c["rel"] for c in out["k23_l8"]),
        worst_flux_rel=max(c["flux_rel"] for c in out["k23_l8"]))
    return out


# the brick kernel's tile cases: (entry point, l, particles, spill, RNG
# tier, capacity (None: the builder's), coefficients, kind); kinds
# "ragged" (a short last run of cx), "dense" (rows whose in-range sources
# overflow a thread's list), "one-block" (a capacity that takes one block
# an SM), "halo-edge" (a halo entry point's edge call, ncx = xr)
BRICK_TILE_CASES = (
    ("pair_fused_dpd", 41.0, 206763, True, "fast", None, "1type", "ragged"),
    ("pair_banded_dpd", 41.0, 206763, False, "tea", None, "1type", "ragged"),
    ("pair_fused_dpd", 41.0, 206763, True, "fast", None, "2types-excl",
     "ragged"),
    ("pair_fused_edpd", 41.0, 206763, True, "tea", None, "1type", "ragged"),
    ("pair_banded_tdpd", 41.0, 206763, False, "fast", None, "S10",
     "ragged"),
    ("pair_fused_dpd", 8.0, 4608, True, "fast", 128, "1type", "dense"),
    ("pair_banded_dpd", 8.0, 4608, False, "tea", 192, "1type", "dense"),
    ("pair_fused_tdpd", 8.0, 4608, True, "tea", 128, "S10", "dense"),
    ("pair_banded_edpd", 8.0, 4608, False, "fast", 192, "1type", "dense"),
    ("pair_fused_dpd", 8.0, 16384, True, "fast", None, "2types-excl",
     "one-block"),
    ("pair_halo_dpd", 8.0, 4608, True, "fast", 128, "2types-excl",
     "halo-edge"),
    ("pair_halo_banded_dpd", 8.0, 4608, False, "tea", 192, "1type",
     "halo-edge"))


def phase_brick_tiles(keep=None):
    """The brick kernel's cell tiles (BRICK_TILE_CASES) against the plain
    version, each with compare_forces' or compare_transport's bounds:
    ragged runs of cx (l=41: ncx 29) on every model, fused and banded;
    dense fluids (rho 9 at a capacity of 128 spill and 192 strict) whose
    rows fill their lists, classic, eDPD and tDPD; rho 32 on spill buckets
    (K 216), one block an SM; two types with exclusions (the polymer form,
    weight 0.5); tDPD with ten species (two species blocks); and the halo
    edge calls (ncx = xr) of K4 and K6-halo on the dense fluids. ``keep``,
    a dict, receives each case's kernel outputs by label."""
    import torch
    from meso_tpu_torch.kernels import cell_tiles
    from meso_tpu_torch.kernels.common import halo_window
    transport = transport_params()
    p_one = selector_params()["dpd"][0][1]
    states = {}
    out = []
    step = 42
    for name, l, n, spill, rng_mode, capacity, coef, kind in \
            BRICK_TILE_CASES:
        key = (l, n, spill, capacity)
        if key not in states:
            bst, cfg = bucket_case(l, n, spill, True, capacity=capacity)
            states[key] = (with_species(bst), cfg, max_partners(bst, cfg))
        bst, cfg, partners = states[key]
        if coef == "1type":
            model = name.rsplit("_", 1)[1]
            p = p_one if model == "dpd" else transport[model]
        elif coef == "2types-excl":
            p = general_params(n, s_exp=1.0, weight=0.5)
            bst = bst.replace(typ=(bst.tag % 2).to(torch.int32))
        else:
            p = tdpd_params(10, False)
        label = (f"{name} {kind} {coef} l={l:g} n={n} K={cfg.capacity} "
                 f"{rng_mode}")
        xr = 2 if spill else 1
        if name in HALO_KERNELS:
            planes, tcfg, valid = halo_planes(bst, cfg, ("x",), (xr, 0, 0))
            planes = with_hash(with_excl(planes, p), step, p.seed)
            args = (planes, bst.box, step, p, 0.01, tcfg, ("x",), rng_mode)
            got = run_halo(name, False, *args)
            torch.cuda.synchronize()
            rec = compare_halo(name, got, run_halo(name, True, *args), valid,
                               label)
            if halo_window(tcfg, ("x",), rng_mode) != tcfg.ncell[0]:
                raise AssertionError(f"{label}: not an edge call")
        else:
            model = name.rsplit("_", 1)[1]
            fld = (None if model == "dpd" else bst.T if model == "edpd"
                   else bst.C)
            got = run_entry(name, False, bst, fld, step, p, 0.01, cfg,
                            rng_mode)
            torch.cuda.synchronize()
            rec = compare_entry(name, got, run_entry(
                name, True, bst, fld, step, p, 0.01, cfg, rng_mode),
                bst.mask, label)
            tcfg = cfg
        if keep is not None:
            keep[label] = got
        plan = tile_plan(name, tcfg, xr)
        rec.update(case=label, max_partners=partners, ncell=list(tcfg.ncell),
                   **tile_fields(tcfg, xr, name))
        failed = {
            "ragged": kind == "ragged" and tcfg.ncell[0] % plan.width == 0,
            "fills its list": kind == "dense"
            and partners <= plan.list_cap,
            "one block an SM": kind == "one-block"
            and plan.blocks_per_sm() != 1}
        if any(failed.values()):
            raise AssertionError(f"{label}: not the case it names "
                                 f"({[k for k, v in failed.items() if v]},"
                                 f" {plan})")
        out.append(rec)
    say("kernels-brick-tiles", cases=len(out),
        worst_rel=max(c["rel"] for c in out),
        worst_flux_rel=max(c.get("flux_rel", 0.0) for c in out),
        worst_virial_rel=max(c["virial_rel"] for c in out),
        tiles=[{k: c[k] for k in ("case", "width", "runs", "blocks_per_sm",
                                  "max_partners")} for c in out])
    return out


def selector_bound(model, st, fld, got, params, n_rc):
    """(bound_ms, bound_by) of a brick kernel on these rows: the mask, and
    x, v, the field, tag and h (and typ, and the exclusion rows where
    present) of the valid rows read once; f and the flux written once over
    every row, and the one virial; the in-range pairs' operations (n_rc
    pairs inside rc; tDPD: rcc = rc on the paths)."""
    ins = [st.x, st.v, st.tag, st.tag]
    if fld is not None:
        ins.append(fld)
    if params.n_types > 1:
        ins.append(st.typ)
    excl = getattr(params, "excl", None)
    e = 0
    if excl is not None:
        e = excl.shape[1]
        ins.append(excl)
    outs = [got[0]] + ([got[1]] if len(got) == 3 else [])
    if model == "tdpd":
        ops = (TDPD_OPS_PER_PAIR + TDPD_OPS_PER_RCC_PAIR
               + TDPD_OPS_PER_SPECIES * params.n_species) * n_rc
    else:
        ops = (BRICK_OPS[model] + OPS_PER_EXCL_SLOT * e) * n_rc
    return row_bound(st.mask, ins, outs, ops, virial=True)


def tile_plan(name, cfg, xr):
    """The tile plan the kernel behind entry point ``name`` runs on for
    these cells: K1's for K6 on one card (K6_ROWS), which reads the bucket
    rows, else the brick kernel's."""
    from meso_tpu_torch.kernels import cell_tiles
    plan = cell_tiles.plan if name == K6_ROWS else cell_tiles.brick_plan
    return plan(cfg.capacity, xr, cfg.ncell)


def tile_fields(cfg, xr, name=None):
    """The tile plan of the kernel behind entry point ``name`` (the brick
    kernel's by default; ``tile_plan``) for these cells: W, runs of cx,
    threads, shared bytes and blocks an SM."""
    p = tile_plan(name, cfg, xr)
    return {"width": p.width, "runs": p.n_xtiles, "threads": p.threads,
            "smem_bytes": p.smem_bytes, "blocks_per_sm": p.blocks_per_sm()}


def brick_tests_per_row(brick, cfg):
    """Slot tests a valid row of the brick kernel's walk on this brick:
    for every valid target, the valid slots of its stencil box (itself
    included), summed and divided by the valid targets."""
    import torch
    nx, ny, nz = cfg.ncell
    xr = brick.xr
    occ = (brick.ib[1] != 0).sum(2).to(torch.int64)
    win = sum(occ[dy:dy + ny, dz:dz + nz, dx:dx + nx] for dy in range(3)
              for dz in range(3) for dx in range(2 * xr + 1))
    tgt = occ[1:ny + 1, 1:nz + 1, xr:xr + nx]
    return float((tgt * win).sum()) / float(tgt.sum())


def entry_brick(name, st, fld, step, params, cfg, rng_mode="fast"):
    """The brick a fused or banded entry point builds from these rows
    (``_brick.card_brick``)."""
    from meso_tpu_torch.kernels import _brick
    model = name.rsplit("_", 1)[1]
    return _brick.card_brick(model, st.x, st.v, fld, st.typ, st.tag,
                             st.mask, st.box, step, params, cfg, rng_mode, 8)


def kernel_alone_ms(name, brick, box, step, params, dt, cfg,
                    rng_mode="fast"):
    """The brick kernel's time alone (``_brick.launch_brick`` on a built
    brick: the launch, its outputs' allocation and the virial's sum), over
    20 calls."""
    from meso_tpu_torch.kernels import _brick
    model = name.rsplit("_", 1)[1]
    return timed_ms(lambda: _brick.launch_brick(
        model, name, brick, box, step, params, dt, cfg, rng_mode, 8), 20)


def k6_alone_ms(st, step, params, dt, cfg):
    """K6's kernel alone on one card (``pair_dpd_v3.launch_general`` under
    the minimum image on K1's plan, fast tier, on a hash made beforehand:
    the launch, its outputs' allocation and the virial's sum, as
    ``kernel_alone_ms`` times a brick kernel), over 20 calls."""
    import torch
    from meso_tpu_torch.kernels import pair_dpd_v3 as v3
    plan = tile_plan(K6_ROWS, cfg, 1)
    h = v3.launch_hash(st.tag, step, params.seed, 8)

    def call():
        f, vir_rows = v3.launch_general(
            K6_ROWS, plan, h, st.x, st.v, st.typ, st.tag, st.mask, st.box,
            step, params, dt, "fast", 8, True)
        return f, torch.sum(vir_rows)
    return timed_ms(call, 20)


def phase_selector_kernels_l70():
    """8a at the 1M shape: each fused and banded entry point on the inputs
    of its own 1M path at set-up (the v2 paths on spill buckets, K=16-18;
    the banded ones on strict buckets, K from fit_capacity), against its
    plain version, with its time, the plain time and its bound; and the
    fused classic kernel on the wall and polymer paths' inputs (two types;
    exclusions)."""
    import torch
    out = {}
    builds = [(f"{sel}-{model}", sel, model,
               (lambda sel=sel: classic_path(sel)) if model == "dpd" else
               (lambda sel=sel, model=model: transport_path(model, sel)))
              for sel in ("v2", "banded") for model in ("dpd", "edpd", "tdpd")]
    builds += [("v2-walls", "v2", "dpd", walls_path),
               ("v2-polymer", "v2", "dpd", polymer_path)]
    for label, sel, model, build in builds:
        system, sparams, st = build()
        cfg, p = system.cells, sparams.pair
        name = SELECTOR_KERNELS[sel][model]
        fld = (None if model == "dpd" else st.T if model == "edpd"
               else st.C)
        got = run_entry(name, False, st, fld, 1, p, system.dt, cfg)
        want = run_entry(name, True, st, fld, 1, p, system.dt, cfg)
        rec = compare_entry(name, got, want, st.mask, f"{label} path")
        rec.update(
            kernel=name, nr=st.n, capacity=cfg.capacity, spill=cfg.spill,
            n_types=p.n_types,
            ms=timed_ms(lambda: run_entry(name, False, st, fld, 1, p,
                                          system.dt, cfg), 20),
            plain_ms=timed_ms(lambda: run_entry(name, True, st, fld, 1, p,
                                                system.dt, cfg), 3))
        n_rc = (general_pair_count(st, cfg, p) if p.n_types > 1
                else pair_counts(st, cfg)[0])
        rec["pairs_in_rc"] = n_rc
        rec["bound_ms"], rec["bound_by"] = selector_bound(
            model, st, fld, got, p, n_rc)
        brick = entry_brick(name, st, fld, 1, p, cfg)
        ms = kernel_alone_ms(name, brick, st.box, 1, p, system.dt, cfg)
        if name == K6_ROWS:
            # the brick kernel K6 ran on before, on the same inputs
            rec["kernel_ms"] = k6_alone_ms(st, 1, p, system.dt, cfg)
            rec["brick_kernel_ms"] = ms
            rec.update(row_tile_fields(st, cfg))
        else:
            rec["kernel_ms"] = ms
            rec["tests_per_valid_row"] = brick_tests_per_row(brick, cfg)
            rec.update(tile_fields(cfg, brick.xr))
        del brick
        out[label] = rec
        say(f"kernels-selectors-l70-{label}", **rec)
        del system, sparams, st, fld, got, want
        torch.cuda.empty_cache()
    return out


def phase_banded_physics():
    """8c: the eDPD slab gate and the tDPD cosine-mode decay from one
    start (the builder's default, 4) at deck size through
    force_path "pallas_banded" (strict buckets, K7), with the rate held
    within TDPD_DECAY_RATE_TOL of the JAX dense path's mean."""
    from meso_tpu_torch.models.transport import tdpd_diffusion
    kw = dict(force_path="pallas_banded", skin=SKIN, device=DEVICE)
    overflow = 0

    def note(diags):
        nonlocal overflow
        overflow = max([overflow] + [int(d["bucket_overflow"])
                                     for d in diags])

    reset_launches()
    res = {}
    res["edpd_slab"], ok_slab = edpd_slab_gate(kw, note)
    system, params, state = tdpd_diffusion(l=8.0, kappa_c=2.0, eps_c=0.0,
                                           **kw)
    res["tdpd_decay"] = tdpd_decay(system, params, state, note)
    d = res["tdpd_decay"]
    res["bucket_overflow"] = overflow
    res["launches"] = read_launches()
    say("banded-physics", **res)
    checks = {
        "Fourier slab profile": ok_slab,
        "tDPD mode decay and mass": d["passes"] and d["c_min"] > -0.05
        and d["c_rel_drift"] < 1e-4,
        "tDPD decay rate within 5% of the JAX dense path's mean":
            abs(d["rate"] / TDPD_DECAY_RATE_JAX - 1.0) < TDPD_DECAY_RATE_TOL,
        "bucket_overflow == 0": overflow == 0,
        "only the banded kernels ran": set(
            k for k, n in pair_launches(res["launches"]).items() if n) == {
                "pair_banded_edpd", "pair_banded_tdpd"}}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"banded physics failed: {failed}")
    return res


# ---------------------------------------------------------------------------
# the 1-D domain decomposition (parallel/domain.py): K4, K6-halo, the ring of
# one and two ranks sharing the card
# ---------------------------------------------------------------------------

# the halo entry points by launch counter: (module, function, model)
HALO_KERNELS = {
    "pair_halo_dpd": ("pair_dpd_fused", "halo_forces_pallas_fused", "dpd"),
    "pair_halo_edpd": ("pair_dpd_fused", "halo_forces_pallas_model_fused",
                       "edpd"),
    "pair_halo_tdpd": ("pair_dpd_fused", "halo_forces_pallas_model_fused",
                       "tdpd"),
    "pair_halo_banded_dpd": ("pair_dpd", "halo_forces_pallas_1d", "dpd")}
HALO_REPLACES = {"pair_halo_dpd": "meso_tpu/kernels/pair_dpd_fused.py:457",
                 "pair_halo_edpd": "meso_tpu/kernels/pair_dpd_fused.py:457",
                 "pair_halo_tdpd": "meso_tpu/kernels/pair_dpd_fused.py:457",
                 "pair_halo_banded_dpd": "meso_tpu/kernels/pair_dpd.py:370"}
DD_RANKS = 2
# The two-rank paths start from their builder's state after the steps of
# DD_PRE_STEPS on one card (the single-card paths' equilibration: the
# random start's Poisson occupancy would otherwise ask the slabs for K=22
# to 26, and its heat would leave kT 1% high for 1,000 steps), then run
# 50 equilibration steps, 100 timed ones and rounds of 200 traced ones
# (kT and momentum after each chunk; the classic and banded paths repeat
# rounds until their kT average has 10 effective samples, which took the
# single-card classic path 4,800 steps), rebuilding every 2 steps (the
# transport paths' cadence; the classic single-card path's 3 leaves a skin
# ratio near 1), and a profiled window on rank 0
DD_EVERY = 2
DD_PRE_STEPS = {"classic": 400, "banded": 400, "edpd": 300, "tdpd": 300,
                "polymer": 300}
DD_EQUIL_CHUNKS, DD_TIMED_CHUNKS, DD_TRACE_CHUNKS = 25, 50, 100
DD_MAX_TRACE_ROUNDS, DD_PROFILE_CHUNKS = 30, 10
DD_RING1_STEPS = 15
# slots the spill slabs take beyond the least capacity that places the
# start: their last column has no right neighbour to spill into
DD_EXTRA_SLOTS = 2
DD_SPAWN_TIMEOUT_S, DD_OP_TIMEOUT_S = 600.0, 120.0


def halo_planes(bst, cfg, ext, targets):
    """Halo-extended channel planes cut from a global bucket state, as the
    ring exchange hands them to the halo kernels: ``targets`` cells from
    cell 0 on each axis in ``ext`` with their halo layers (x: the
    half-window; y, z: one) taken across the periodic boundary, their
    coordinates shifted by -L there; the other axes whole. Returns (planes
    with typ, T and C0.. of the state where present, the target
    CellConfig, the valid target rows)."""
    import torch
    from meso_tpu_torch.ops.sweep import make_channels
    nx, ny, nz = cfg.ncell
    extra = {}
    if bst.T is not None:
        extra["T"] = bst.T
    if bst.C is not None:
        extra.update({f"C{s}": bst.C[:, s] for s in range(bst.C.shape[1])})
    ch = make_channels(bst.x, bst.v, bst.tag, bst.mask, None, extra,
                       cfg.ncell, cfg.capacity)
    ch["typ"] = bst.typ.reshape(ch["tag"].shape)
    xr = 2 if cfg.spill else 1
    lens = bst.box.lengths
    cuts = {}
    for axis, dim, name, wide in ((0, 1, "y", 1), (1, 2, "z", 1),
                                  (3, 0, "x", xr)):
        if name in ext:
            idx = torch.arange(-wide, targets[dim] + wide, device=bst.device)
            cuts[axis] = (idx % cfg.ncell[dim], idx < 0, dim, name)
    planes = {}
    for key, p in ch.items():
        for axis, (idx, wrapped, dim, name) in cuts.items():
            p = p.index_select(axis, idx)
            if key == name:
                shape = [1] * 4
                shape[axis] = -1
                p = p - lens[dim] * wrapped.reshape(shape).to(p.dtype)
        planes[key] = p.contiguous()
    tcells = tuple(targets[d] if "xyz"[d] in ext else cfg.ncell[d]
                   for d in range(3))
    oy, oz = int("y" in ext), int("z" in ext)
    ox = xr if "x" in ext else 0
    valid = planes["valid"][oy:oy + tcells[1], oz:oz + tcells[2], :,
                            ox:ox + tcells[0]] > 0
    return planes, cfg.replace(ncell=tcells), valid.reshape(-1)


def run_halo(name, plain, planes, box, step, params, dt, cfg, ext=("x",),
             rng_mode="fast"):
    """One call of a halo entry point (``name``: its launch counter) in its
    own argument order, or (``plain``) of its plain version,
    ``_brick.halo_forces_plain``, on the same planes. Returns (f, virial)
    or (f, flux, virial)."""
    import importlib
    from meso_tpu_torch.kernels._brick import halo_forces_plain
    mod, fn, model = HALO_KERNELS[name]
    ns = params.n_species if model == "tdpd" else 0
    fields, n_excl = halo_fields(name, params)
    if plain:
        out = halo_forces_plain(
            model, planes, box, step, params, dt, cfg, ext, rng_mode, 8,
            fields=fields, n_excl=n_excl)
        return (out[0], out[2]) if model == "dpd" else out
    entry = getattr(importlib.import_module(
        f"meso_tpu_torch.kernels.{mod}"), fn)
    kw = dict(rng_mode=rng_mode, n_types=params.n_types)
    if name == "pair_halo_dpd":
        kw.update(ext=ext, s_exp=params.s_exp, n_excl=n_excl)
    elif model != "dpd":
        kw.update(ext=ext, model=model, ns=ns)
    return entry(planes, box, step, params, dt, cfg, **kw)


def halo_fields(name, params):
    """(the field planes, the exclusion tags a row) a halo entry point
    reads: T (eDPD), C0 .. (tDPD) or none; E with exclusions."""
    model = HALO_KERNELS[name][2]
    fields = (("T",) if model == "edpd" else
              tuple(f"C{s}" for s in range(params.n_species))
              if model == "tdpd" else ())
    n_excl = 0 if getattr(params, "excl", None) is None \
        else params.excl.shape[1]
    return fields, n_excl


def halo_brick_of(name, planes, params, cfg, ext=("x",), rng_mode="fast"):
    """The brick a halo entry point builds from these planes
    (``_brick.halo_brick``, as ``_brick.halo_forces`` calls it)."""
    from meso_tpu_torch.kernels import _brick
    from meso_tpu_torch.kernels.common import halo_window
    fields, n_excl = halo_fields(name, params)
    return _brick.halo_brick(
        planes, cfg, halo_window(cfg, ext, rng_mode), ext, fields,
        planes.get("h") if rng_mode == "fast" else None,
        params.n_types > 1, n_excl)


def compare_halo(name, got, want, valid, label):
    """A halo kernel against its plain version: the kernel gate (forces
    2e-5 of max |f|, virial 1e-4, pad rows 0) and, for eDPD and tDPD, the
    flux bound (5e-5). Per-species sums are not held: the fluxes to halo
    rows belong to the neighbouring ranks."""
    if HALO_KERNELS[name][2] == "dpd":
        err, rel, vrel = compare_forces(*got, *want, valid, True, label)
        return {"max_abs_err": err, "rel": rel, "virial_rel": vrel}
    return compare_transport(got, want, valid, True, label,
                             species_sum=False)


def with_excl(planes, params):
    """The planes with the exclusion tags of each row's particle."""
    from meso_tpu_torch.kernels._brick import exclusion_rows
    if getattr(params, "excl", None) is None:
        return planes
    tag = planes["tag"]
    ex = exclusion_rows(tag.reshape(-1), params)
    return {**planes, **{f"EX{e}": ex[:, e].reshape(tag.shape).contiguous()
                         for e in range(ex.shape[1])}}


def with_hash(planes, step, seed):
    """The planes with the per-particle hash "h" that the halo kernels read
    in the fast RNG tier (the distributed path ships it through the
    halo)."""
    from meso_tpu_torch.kernels.pair_dpd_v3 import particle_hash_v3
    tag = planes["tag"]
    return {**planes, "h": particle_hash_v3(tag.reshape(-1).contiguous(),
                                            step, seed).reshape(tag.shape)}


def phase_dd_kernels():
    """K4 (pair_halo_dpd/_edpd/_tdpd) and K6-halo (pair_halo_banded_dpd)
    against their plain versions at l=8 on halo-extended bricks cut from a
    moved bucket state: fast and TEA, spill (K4) and strict, ext ("x",)
    with 3 target columns, with the edge calls' xr columns and the
    interior call's whole local planes, ext ("x", "y") with 3 x 3 target
    cells and ext ("x", "y", "z") with 3 x 3 x 3; classic with one type,
    with K1's general case (two types, s_exp 0.5, exclusions; K6-halo
    without exclusions) and in the polymer path's form (one type, two
    exclusions a tag at weight 0.5), eDPD with one and two types, tDPD
    with one, three (two types) and ten species."""
    import torch
    cases = selector_params()
    cases["dpd"] = cases["dpd"] + [("1type-excl", general_params(
        1536, two_types=False, s_exp=1.0, weight=0.5), False, 0)]
    out = []
    step = 42
    for spill in (True, False):
        bst0, cfg = bucket_case(8.0, 1536, spill, True)
        bst0 = with_species(bst0)
        bst2 = bst0.replace(typ=(bst0.tag % 2).to(torch.int32))
        xr = 2 if spill else 1
        nx = cfg.ncell[0]
        cuts = [(("x",), (3, 0, 0)), (("x",), (xr, 0, 0)),
                (("x", "y"), (3, 3, 0)), (("x", "y", "z"), (3, 3, 3))]
        for rng_mode in ("fast", "tea"):
            for ext, targets in cuts:
                for model, mcases in cases.items():
                    name = f"pair_halo_{model}"
                    for label, p, two, ns in mcases:
                        st = bst2 if two else bst0
                        if ns:
                            st = st.replace(C=st.C[:, :ns].contiguous())
                        planes, tcfg, valid = halo_planes(st, cfg, ext,
                                                          targets)
                        planes = with_hash(with_excl(planes, p), step,
                                           p.seed)
                        args = (planes, st.box, step, p, 0.01, tcfg, ext,
                                rng_mode)
                        got = run_halo(name, False, *args)
                        torch.cuda.synchronize()
                        want = run_halo(name, True, *args)
                        case = (f"{name} {label} {rng_mode} spill={spill} "
                                f"ext={''.join(ext)} targets={targets}")
                        out.append({"case": case, **compare_halo(
                            name, got, want, valid, case)})
            # the interior call of the border/inner split: the local
            # planes alone, nx - 2 xr target columns
            p = cases["dpd"][0][1]
            planes, _, _ = halo_planes(bst0, cfg, (), (0, 0, 0))
            planes = with_hash(planes, step, p.seed)
            icfg = cfg.replace(ncell=(nx - 2 * xr,) + cfg.ncell[1:])
            valid = planes["valid"][..., xr:nx - xr].reshape(-1) > 0
            args = (planes, bst0.box, step, p, 0.01, icfg, ("x",), rng_mode)
            got = run_halo("pair_halo_dpd", False, *args)
            want = run_halo("pair_halo_dpd", True, *args)
            case = f"pair_halo_dpd interior {rng_mode} spill={spill}"
            out.append({"case": case, **compare_halo(
                "pair_halo_dpd", got, want, valid, case)})
            if spill:
                continue
            p_types = general_params(1536, excl=False)
            for label, p, st in (("1type", p, bst0),
                                 ("2types-s_exp", p_types, bst2)):
                planes, tcfg, valid = halo_planes(st, cfg, ("x",),
                                                  (3, 0, 0))
                planes = with_hash(planes, step, p.seed)
                args = (planes, st.box, step, p, 0.01, tcfg, ("x",),
                        rng_mode)
                got = run_halo("pair_halo_banded_dpd", False, *args)
                want = run_halo("pair_halo_banded_dpd", True, *args)
                case = f"pair_halo_banded_dpd {label} {rng_mode}"
                out.append({"case": case, **compare_halo(
                    "pair_halo_banded_dpd", got, want, valid, case)})
    say("dd-kernels-l8", cases=len(out),
        worst_rel=max(c["rel"] for c in out),
        worst_flux_rel=max(c.get("flux_rel", 0.0) for c in out),
        worst_virial_rel=max(c["virial_rel"] for c in out))
    return {"l8": out}


def dd_path(label):
    """A two-rank path's global start on the card, at set-up, built as its
    single-card path is but with the box wrapped every step (migration
    reads wrapped positions; K4 takes the minimum image) and a rebuild
    every DD_EVERY steps: classic (config 1, spill K=16, K4 with the
    border/inner split), banded (strict buckets, K6-halo), eDPD and tDPD
    (their builders' spill buckets, K4's model form) and polymer (3,200
    FENE chains of 16 with special bonds, K4 with exclusions and the
    bonded ghost rows). The start is the builder's after DD_PRE_STEPS of
    its single-card path. Returns (system, params, state); ``dd_domain``
    fits the slabs' capacity."""
    from meso_tpu_torch.models.classic import classic_fluid
    from meso_tpu_torch.models.polymer import polymer_melt
    kw = dict(skin=SKIN, device=DEVICE)
    if label in ("classic", "banded"):
        system, params, state = classic_fluid(
            l=L_MAIN, rng_mode="fast", rebuild="sort", wrap_mode="step",
            force_path="pallas_banded" if label == "banded" else "pallas",
            pair_kernel="v2", rebuild_every=DD_EVERY, **kw)
        system = system.replace(lam=LAM)
    elif label == "polymer":
        system, params, state = polymer_melt(
            l=L_MAIN, n_chains=POLYMER_CHAINS, chain_len=POLYMER_CHAIN_LEN,
            special_weight=0.5, force_path="pallas", rng_mode="fast",
            dt=0.01, **kw)
    else:
        system, params, state = transport_path(label, "v2")
    state, _ = advance(system, params, state, DD_PRE_STEPS[label], DD_EVERY)
    return system.replace(dd_overlap=True), params, state


# the two-rank paths' starts (dd_path), kept on the host for the brick
# paths (phase_bricks) of the same run
DD_STARTS = {}


def dd_start(label):
    """``dd_path(label)`` on the card, built once a run (later calls take
    the host copy that the first one kept)."""
    from meso_tpu_torch.parallel import launch
    if label not in DD_STARTS:
        system, params, state = dd_path(label)
        DD_STARTS[label] = (system, launch.params_on(params, "cpu"),
                            launch.on_device(state, "cpu"))
    system, params, state = DD_STARTS[label]
    return (system, launch.params_on(params, DEVICE),
            launch.on_device(state, DEVICE))


def dd_domain(system, state, n_dev):
    """(system, DomainConfig) of ``n_dev`` slabs for this start, with the
    least capacity from the builder's own up that places it
    (``fit_slab_capacity``), and on spill buckets DD_EXTRA_SLOTS more: a
    spill slab's last column cannot spill into its first."""
    from meso_tpu_torch.parallel import build_domain
    from meso_tpu_torch.parallel.domain import fit_slab_capacity
    cells = fit_slab_capacity(system, state, n_dev, L_MAIN).cells
    if cells.spill:
        cells = cells.replace(capacity=cells.capacity + DD_EXTRA_SLOTS)
    system = system.replace(cells=cells)
    return system, build_domain(system, n_dev, lx_global=L_MAIN,
                                rebuild_every=DD_EVERY)


def dd_kernel_of(label):
    return {"classic": "pair_halo_dpd", "banded": "pair_halo_banded_dpd",
            "edpd": "pair_halo_edpd", "tdpd": "pair_halo_tdpd",
            "polymer": "pair_halo_dpd"}[label]


def rank0_planes(system, params, slabs, dcfg, step):
    """Rank 0's extended planes at P = 2, as the ring hands them over:
    [rank 1's last xr columns (x shifted by -L) | rank 0's slab | rank 1's
    first xr columns], with the fields, types, exclusion tags and the hash
    that the path's kernel reads."""
    import torch
    from meso_tpu_torch.ops.sweep import make_channels
    cfg = dcfg.cells
    xr = 2 if cfg.spill else 1

    def chans(st):
        extra = {}
        if st.T is not None:
            extra["T"] = st.T
        if st.C is not None:
            extra.update({f"C{s}": st.C[:, s] for s in range(st.C.shape[1])})
        ch = make_channels(st.x, st.v, st.tag, st.mask, None, extra,
                           cfg.ncell, cfg.capacity)
        if params.pair.n_types > 1:
            ch["typ"] = st.typ.reshape(ch["tag"].shape)
        return ch

    c0, c1 = chans(slabs[0]), chans(slabs[1])
    planes = {}
    for nm in c0:
        hl = c1[nm][..., -xr:]
        if nm == "x":
            hl = hl - dcfg.lx_global
        planes[nm] = torch.cat([hl, c0[nm], c1[nm][..., :xr]],
                               dim=-1).contiguous()
    planes = with_excl(planes, params.pair)
    if system.rng_mode == "fast":
        planes = with_hash(planes, step, params.pair.seed)
    valid = c0["valid"].reshape(-1) > 0
    return planes, valid


def halo_bound(name, planes, got, params, n_rc):
    """(bound_ms, bound_by) of a halo kernel on these planes (row_bound):
    the valid plane of every row of the extended brick, and the per-row
    inputs (x, v, tag, and the hash, the field, typ and exclusion tags
    where the call reads them) of its valid rows, read once; f and the
    flux written once over every target row, and the one virial; the
    in-range pairs' operations."""
    import torch
    model = HALO_KERNELS[name][2]
    valid = planes["valid"].reshape(-1) > 0
    per_row = [torch.stack([planes[c].reshape(-1) for c in
                            ("x", "y", "z", "vx", "vy", "vz")], -1),
               planes["tag"].reshape(-1)]
    for c in sorted(planes):
        if c == "h" or c == "typ" or c == "T" or c.startswith("C") \
                or c.startswith("EX"):
            per_row.append(planes[c].reshape(-1))
    outs = [got[0]] + ([got[1]] if len(got) == 3 else [])
    if model == "tdpd":
        ops = (TDPD_OPS_PER_PAIR + TDPD_OPS_PER_RCC_PAIR
               + TDPD_OPS_PER_SPECIES * params.n_species) * n_rc
    else:
        e = 0 if getattr(params, "excl", None) is None \
            else params.excl.shape[1]
        ops = (BRICK_OPS[model] + OPS_PER_EXCL_SLOT * e) * n_rc
    return row_bound(valid, per_row, outs, ops, virial=True)


def halo_pair_count(planes, params, box, cfg, ext):
    """Ordered pairs inside rc_ij that these planes give the halo kernel:
    the plain version's own walk over the same brick."""
    import torch
    from meso_tpu_torch.kernels import _brick
    xr = 2 if cfg.spill else 1
    brick = _brick.halo_brick(planes, cfg, xr, ext, (), None,
                              params.n_types > 1, 0, idtype=torch.int64)
    ib = brick.ib.reshape(brick.ib.shape[0], -1)
    rc = params.rc.reshape(-1)
    n = 0
    for _, tb, sb, _, r2 in _brick._brick_pairs(brick, cfg, box,
                                                torch.max(rc) ** 2):
        if params.n_types > 1:
            p = ib[brick.ch_typ, tb] * params.n_types + ib[brick.ch_typ, sb]
            n += int((r2 < rc[p] * rc[p]).sum())
        else:
            n += int(r2.numel())
    return n


def dd_kernel_check(label, system, params, state, slabs, dcfg):
    """The path's kernel (K4 or K6-halo) on its own inputs: rank 0's
    extended planes (``rank0_planes``: exclusion tags and hash included)
    of the two-rank split of its start, in one call over the slab (25 of
    50 columns), against the plain version, with its time through the
    wrapper, the plain time and the bound. On a K4 path also the
    border/inner split that the path runs (``domain._split_calls``: the
    interior call and both edge calls, stitched along x), held against the
    plain version's same three calls and against the one call, and
    timed."""
    import torch
    from meso_tpu_torch.parallel.comm import Pending
    from meso_tpu_torch.parallel.domain import _split_calls
    planes, valid = rank0_planes(system, params, slabs, dcfg, 1)
    name = dd_kernel_of(label)
    p, cfg, box = params.pair, dcfg.cells, state.box
    args = (planes, box, 1, p, system.dt, cfg)
    got = run_halo(name, False, *args)
    torch.cuda.synchronize()
    want = run_halo(name, True, *args)
    rec = compare_halo(name, got, want, valid, f"{label} rank 0")
    n_rc = halo_pair_count(planes, p, box, cfg, ("x",))
    rec.update(
        kernel=name, path=label, rows=int(valid.numel()),
        valid_rows=int(valid.sum()), capacity=cfg.capacity,
        spill=cfg.spill, n_excl=0 if getattr(p, "excl", None) is None
        else p.excl.shape[1],
        pairs_in_rc=n_rc,
        ms=timed_ms(lambda: run_halo(name, False, *args), 20),
        plain_ms=timed_ms(lambda: run_halo(name, True, *args), 3))
    rec["bound_ms"], rec["bound_by"] = halo_bound(name, planes, got, p, n_rc)
    brick = halo_brick_of(name, planes, p, cfg)
    rec["kernel_ms"] = kernel_alone_ms(name, brick, box, 1, p, system.dt,
                                       cfg)
    rec["tests_per_valid_row"] = brick_tests_per_row(brick, cfg)
    rec.update(tile_fields(cfg, brick.xr))
    del brick
    if name != "pair_halo_banded_dpd":
        xr = 2 if cfg.spill else 1
        nx = cfg.ncell[0]
        local = {k: t[..., xr:xr + nx] for k, t in planes.items()}
        halos = ({k: t[..., :xr] for k, t in planes.items()},
                 {k: t[..., xr + nx:] for k, t in planes.items()})

        def split(plain):
            return _split_calls(
                lambda ch, c_cfg: run_halo(name, plain, ch, box, 1, p,
                                           system.dt, c_cfg),
                local, cfg, xr, Pending(lambda: halos), True)

        got_s = split(False)
        torch.cuda.synchronize()
        want_s = split(True)
        vs_plain = compare_halo(name, got_s, want_s, valid,
                                f"{label} rank 0 split")
        vs_one = compare_halo(name, got_s, got, valid,
                              f"{label} rank 0 split against one call")
        rec.update(split={"vs_plain": vs_plain, "vs_one_call": vs_one,
                          "ms": timed_ms(lambda: split(False), 20)})
    say(f"dd-kernels-l70-{label}", **rec)
    return rec


def phase_dd_ring_of_one():
    """The classic 1M start as one rank, in-process (``Ring.single()``),
    halos from its own far side: one force evaluation through K4 (the
    border/inner split) against the single-card K5 on the same positions,
    within the kernel gate, by tag; then DD_RING1_STEPS steps, a rebuild
    every step (so the comparison misses no pair), by tag against the
    single-card path through K5 at the same cadence: x < 2e-4, v < 2e-3."""
    import torch
    from meso_tpu_torch.core.system import run_bucket_chunked
    from meso_tpu_torch.kernels.pair_dpd_fused import \
        bucket_forces_pallas_fused
    from meso_tpu_torch.parallel import (Ring, distribute_state,
                                         run_distributed)
    from meso_tpu_torch.parallel.domain import _halo_forces_pallas
    single, params, state = dd_start("classic")
    system, dcfg = dd_domain(single, state, 1)
    dcfg = dcfg.__class__(**{**dcfg.__dict__, "rebuild_every": 1})
    (slab,) = distribute_state(state, dcfg, device=DEVICE)
    ring = Ring.single()
    reset_launches()
    f_dd, vir_dd = _halo_forces_pallas(slab, system, params, dcfg, ring, 1,
                                       slab.x, slab.v)
    launches_force = read_launches()
    f_k5, vir_k5 = bucket_forces_pallas_fused(
        state.x, state.v, state.typ, state.tag, state.mask, state.box, 1,
        params.pair, single.dt, single.cells, rng_mode="fast",
        s_exp=single.s_exp)
    f_a, f_b = by_tag(slab, f_dd), by_tag(state, f_k5)
    err = float((f_a - f_b).abs().max())
    rel = err / float(f_b.abs().max())
    vrel = abs(float(vir_dd) - float(vir_k5)) / abs(float(vir_k5))
    pad = float(f_dd[~slab.mask].abs().max())
    reset_launches()
    out, diag = run_distributed(system, params, slab, DD_RING1_STEPS, ring,
                                dcfg)
    launches_dd = read_launches()
    ref, d_ref = run_bucket_chunked(single, params, state, DD_RING1_STEPS, 1,
                                    thermo_trace=False)
    dx = float((by_tag(out, out.x) - by_tag(ref, ref.x)).abs().max())
    dv = float((by_tag(out, out.v) - by_tag(ref, ref.v)).abs().max())
    res = {"n_particles": int(state.n_valid()), "rows": slab.n,
           "ncx_local": dcfg.ncx_local, "capacity": dcfg.cells.capacity,
           "force_max_abs_err": err, "force_rel": rel, "virial_rel": vrel,
           "pad_max": pad, "launches_one_evaluation":
               {k: n for k, n in launches_force.items() if n},
           "steps": DD_RING1_STEPS, "x_max_diff": dx, "v_max_diff": dv,
           "overflow": int(diag["overflow"]),
           "worst_skin_ratio": float(diag["worst_skin_ratio"]),
           "single_worst_skin_ratio": float(d_ref["worst_skin_ratio"]),
           "launches": {k: n for k, n in launches_dd.items() if n}}
    say("dd-ring-of-one", **res)
    checks = {
        "one evaluation within the kernel gate":
            rel < 2e-5 and vrel < 1e-4 and pad == 0.0,
        "three K4 launches (interior and two edges)":
            launches_force["pair_halo_dpd"] == 3
            and sum(pair_launches(launches_force).values()) == 3,
        "x within 2e-4, v within 2e-3 by tag": dx < 2e-4 and dv < 2e-3,
        "overflow == 0": res["overflow"] == 0,
        "worst_skin_ratio < 1": res["worst_skin_ratio"] < 1.0,
        "every step's forces through K4":
            launches_dd["pair_halo_dpd"] == 3 * DD_RING1_STEPS and sum(
                pair_launches(launches_dd).values())
            == 3 * DD_RING1_STEPS}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dd-ring-of-one failed: {failed}")
    return res


def dd_observe(ring, system, params, state, dcfg, label, chunks):
    """What a two-rank path runs after ``launch.slab_run``'s warm-up and
    timed chunks: rounds of ``chunks["trace"]`` traced chunks (kT and total
    momentum summed over the ring after each; the classic and banded
    paths repeat rounds, at most ``chunks["rounds"]``, until their kT
    average has MIN_N_EFF effective samples), then ``chunks["profile"]``
    chunks under torch.profiler on rank 0. Returns (the state, the traces,
    the traced chunks' worst diag, the chunks run here and the profile's
    numbers)."""
    import numpy as np
    import torch
    from meso_tpu_torch.parallel import launch
    run_distributed = launch.domain_runner(dcfg)
    res = {"kts": [], "moms": []}
    traced = []
    for _ in range(chunks["rounds"]):
        for _ in range(chunks["trace"]):
            state, d = run_distributed(system, params, state, 1, ring, dcfg)
            traced.append(d)
            m = state.mask
            mass = params.mass[state.typ.long()]
            mv = torch.where(m[:, None], mass[:, None] * state.v, 0.0)
            tot = ring.all_sum(torch.stack([
                torch.sum(mv * state.v), torch.sum(m.to(torch.float32)),
                *torch.sum(mv, 0)]).to(torch.float64))
            res["kts"].append(float(tot[0] / (3.0 * (tot[1] - 1.0))))
            res["moms"].append([float(t) for t in tot[2:5]])
        if label not in ("classic", "banded") or kt_stats(
                np.asarray(res["kts"]))[2] >= MIN_N_EFF:
            break
    res["traced_diag"] = {k: max(float(d[k]) for d in traced)
                          for k in traced[0]}
    res["observed_chunks"] = len(traced) + chunks["profile"]
    if chunks["profile"]:
        res["profile"] = dd_profiled_chunks(
            ring, system, params, state, dcfg, chunks["profile"],
            state.device.type == "cuda")
        state = res["profile"].pop("state")
    return state, res


def dd_profiled_chunks(ring, system, params, state, dcfg, nchunks, cuda):
    """``nchunks`` chunks, under torch.profiler on rank 0 (rank 1 runs
    them unprofiled): the card's busy share of the window's wall time as
    rank 0's kernels fill it (rank 1's kernels run in their own process
    and are not seen), the pair kernel's device time and launches, and the
    host time spent in the ring exchanges ("ring_exchange" spans) with
    the part of it in which none of rank 0's kernels ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from meso_tpu_torch.parallel import launch
    run_distributed = launch.domain_runner(dcfg)
    steps = nchunks * dcfg.rebuild_every
    if ring.rank != 0:
        state, _ = run_distributed(system, params, state, nchunks, ring,
                                   dcfg)
        return {"state": state}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run_distributed(system, params, state, nchunks, ring,
                                   dcfg)
        if cuda:
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # the "ring_exchange" annotation shows on the device's timeline too;
    # it is no kernel
    kernels = {k: v for k, v in device_times(prof, steps).items()
               if k != "ring_exchange"}
    busy = sum(ms for ms, _ in kernels.values())
    pair = [(ms, c) for k, (ms, c) in kernels.items() if "pair_brick" in k]
    spans, intervals = [], []
    cuda_t = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        if e.name == "ring_exchange":
            if e.device_type != cuda_t:
                spans.append((e.time_range.start, e.time_range.end))
        elif e.device_type == cuda_t:
            intervals.append((e.time_range.start, e.time_range.end))
    intervals.sort()
    union = []
    for s, t in intervals:
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    in_span = idle = 0.0
    for s, t in spans:
        covered = sum(max(0.0, min(t, b) - max(s, a)) for a, b in union)
        in_span += t - s
        idle += t - s - covered
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"state": state, "steps": steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy,
            "busy_share": busy * steps / wall_ms,
            "pair_kernel_ms_per_step": sum(ms for ms, _ in pair),
            "pair_kernel_launches_per_step":
                sum(c for _, c in pair) / steps,
            "exchanges_per_step": len(spans) / steps,
            "exchange_host_ms_per_step": in_span / 1e3 / steps,
            "idle_in_exchange_ms_per_step": idle / 1e3 / steps,
            "top": [{"kernel": k, "ms_per_step": ms, "calls": c}
                    for k, (ms, c) in top]}


def phase_dd_paths():
    """Two ranks sharing one card (gloo, host-staged halos), each holding
    25 of the 50 cell columns: classic (K4 with the border/inner split),
    banded (K6-halo, strict buckets), eDPD and tDPD (K4's model form) and
    polymer (K4 with exclusions, bonded ghost rows). The parent builds the
    kernel library and each path's start, distributes it, checks the
    path's kernel on rank 0's inputs (``dd_kernel_check``), and spawns the
    two ranks once for all paths (``launch.slab_runs``: warm-up, timed
    chunks, then ``dd_observe``); the ranks only load the library. Gates
    on each path: overflow 0, bonded_missing 0, N conserved and tags
    unique, the state finite, the worst skin ratio (over both ranks) below
    1 after equilibration, every force evaluation through K4 or K6-halo by
    the ranks' launch counts summed here, and the single-card path's
    physics gates. Times are of two ranks sharing one card: not a scaling
    figure."""
    import numpy as np
    import torch
    from meso_tpu_torch.kernels import _build
    from meso_tpu_torch.obs import total_momentum
    from meso_tpu_torch.parallel import (collect_state, distribute_state,
                                         launch)
    _build.build()
    labels = ("classic", "banded", "edpd", "tdpd", "polymer")
    jobs, starts = [], {}
    kernels = {}
    for label in labels:
        system, params, state = dd_start(label)
        system, dcfg = dd_domain(system, state, DD_RANKS)
        slabs = distribute_state(state, dcfg, device=DEVICE)
        kernels[label] = dd_kernel_check(label, system, params, state, slabs,
                                         dcfg)
        mass = params.mass[state.typ.long()]
        starts[label] = {
            "n": int(state.n_valid()),
            "c_sum": float(torch.sum(state.C[state.mask]))
            if state.C is not None else None,
            "momentum": total_momentum(state.v, mass, state.mask).cpu()}
        jobs.append(dict(
            system=system, params=launch.params_on(params, "cpu"),
            states=[launch.on_device(s, "cpu") for s in slabs], dcfg=dcfg,
            nchunks=DD_TIMED_CHUNKS, warmup=DD_EQUIL_CHUNKS,
            then=dd_observe, then_args=(label, dict(
                trace=DD_TRACE_CHUNKS, rounds=DD_MAX_TRACE_ROUNDS,
                profile=DD_PROFILE_CHUNKS))))
        del system, params, state, slabs
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(launch.slab_runs, DD_RANKS,
                         ROOT / "build" / "dd_ranks",
                         args=(jobs,), device=DEVICE,
                         timeout_s=DD_SPAWN_TIMEOUT_S,
                         op_timeout_s=DD_OP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    out, failures = {}, {}
    for j, job in enumerate(jobs):
        label, system, dcfg = labels[j], job["system"], job["dcfg"]
        per = [r[j] for r in ranks]
        final = collect_state([p["state"] for p in per])
        launches = {k: sum(p["launches"][k] for p in per)
                    for k in per[0]["launches"]}
        steps = DD_EVERY * (job["warmup"] + job["nchunks"]
                            + per[0]["observed_chunks"])
        evals = DD_RANKS * steps
        kernel = dd_kernel_of(label)
        calls = 1 if kernel == "pair_halo_banded_dpd" else 3
        timed_steps = job["nchunks"] * DD_EVERY
        timed_s = max(p["seconds"] for p in per)
        m = final.mask
        tags = final.tag[m]
        n = int(m.sum())
        kts = np.asarray(per[0]["kts"])
        diags = {"equil": per[0]["warmup_diag"], "timed": per[0]["diag"],
                 "traced": per[0]["traced_diag"]}
        res = {"path": label, "ranks": DD_RANKS, "n_particles": n,
               "rows_per_rank": job["states"][0].n,
               "ncx_local": dcfg.ncx_local, "capacity": dcfg.cells.capacity,
               "spill": dcfg.cells.spill, "steps_per_rebuild": DD_EVERY,
               "steps": steps, "timed_steps": timed_steps,
               "ms_per_step_two_ranks_sharing_one_card":
                   1e3 * timed_s / timed_steps,
               "particle_steps_per_s": n * timed_steps / timed_s,
               "diags": diags, "launches": launches,
               "force_evaluations": evals, "kT_mean": float(kts.mean())}
        checks = {
            f"{kernel} launches == {calls} x force evaluations, no other "
            "pair kernel": pair_launches(launches) == {
                **{k: 0 for k in pair_launches(launches)},
                kernel: calls * evals},
            "one hash launch per force evaluation":
                launches["particle_hash"] == evals,
            "overflow == 0": all(d["overflow"] == 0 for d in diags.values()),
            "bonded_missing == 0":
                all(d["bonded_missing"] == 0 for d in diags.values()),
            "worst_skin_ratio < 1 after equilibration": max(
                diags[w]["worst_skin_ratio"] for w in ("timed", "traced"))
            < 1.0,
            "N conserved, tags unique": n == starts[label]["n"] and int(
                torch.unique(tags).numel()) == n,
            "state finite": all(bool(torch.isfinite(t).all())
                                for t in (final.x, final.v, final.f))}
        if label in ("classic", "banded"):
            kt_mean, kt_sem, n_eff = kt_stats(kts)
            res.update(kT_sem=kt_sem, kT_n_eff=n_eff)
            checks["kT_n_eff >= 10"] = n_eff >= MIN_N_EFF
            checks["|kT - 1| + 3 sigma <= 0.01"] = \
                abs(kt_mean - 1.0) + 3 * kt_sem <= 0.01
        elif label == "edpd":
            t = final.T[m]
            res["t_min"], res["t_max"] = float(t.min()), float(t.max())
            checks["0.3 < T < 3"] = res["t_min"] > 0.3 and res["t_max"] < 3
        elif label == "tdpd":
            c0 = starts[label]["c_sum"]
            res["c_rel_drift"] = abs(float(final.C[m].sum()) - c0) / abs(c0)
            checks["sum C drift < 1e-4"] = res["c_rel_drift"] < 1e-4
        else:
            bl = bond_lengths(final, job["params"].bonded.bond_tags,
                              system.n_tags)
            p0 = starts[label]["momentum"].numpy()
            drift = max(float(np.abs(np.asarray(p) - p0).max())
                        for p in per[0]["moms"])
            res.update(bond_max=float(bl.max()), bond_mean=float(bl.mean()),
                       momentum_drift=drift)
            checks.update({
                "bond max < 1.45": res["bond_max"] < 1.45,
                "0.30 < bond mean < 0.75": 0.30 < res["bond_mean"] < 0.75,
                "momentum drift < 5e-2": drift < 5e-2,
                "kT within 2% of 1": abs(res["kT_mean"] - 1.0) < 0.02})
        if "profile" in per[0]:
            res["profile_rank0"] = per[0]["profile"]
        out[label] = res
        say(f"dd-{label}", **res)
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            failures[label] = failed
    if failures:
        raise AssertionError(f"dd paths failed: {failures}")
    out["spawn_s"] = spawn_s
    return out, kernels


# ---------------------------------------------------------------------------
# the 2-D and 3-D bricks, the replica ensemble and the dry run
# (parallel/domain2d.py, domain3d.py, ensemble.py, dryrun.py): ranks sharing
# the card
# ---------------------------------------------------------------------------

# each brick path: its start (dd_start's label), its mesh, and its warm-up,
# timed and traced chunks of DD_EVERY steps. The classic and polymer paths
# run K4 over the extended brick, eDPD and tDPD the sweep (as the JAX
# package routes every model but classic DPD on force_path "pallas") on
# strict buckets of BRICK_SWEEP_K slots, for few steps: the sweep costs
# about 2 s a step at 1M particles.
BRICK_PATHS = {
    "classic-2d": ("classic", (2, 2), (10, 50, 50)),
    "polymer-2d": ("polymer", (2, 2), (10, 50, 50)),
    "edpd-2d": ("edpd", (2, 2), (1, 2, 0)),
    "tdpd-2d": ("tdpd", (2, 2), (1, 2, 0)),
    "classic-3d": ("classic", (2, 2, 2), (10, 50, 50))}
BRICK_SWEEP_K = 28
# run_ensemble: 2 replicas of the classic 1M start on K1, its steps; DP x
# SP: 2 replicas x 2 slabs through K4, its chunks; the dry run's ranks
ENSEMBLE_REPLICAS, ENSEMBLE_STEPS = 2, 300
DPSP_SLABS, DPSP_CHUNKS = 2, 30
DRYRUN_RANKS = 8
BRICK_SPAWN_TIMEOUT_S = 900.0
BRICKS_DIR = ROOT / "build" / "brick_ranks"


def brick_domain(label, system, state):
    """(system, Domain2D or Domain3D) of a brick path on its start: strict
    buckets of BRICK_SWEEP_K slots on the sweep paths; the least capacity
    that places the start (``fit_brick_capacity_2d``/``_3d``) and, on
    spill buckets, DD_EXTRA_SLOTS more, as the slabs take."""
    from meso_tpu_torch.parallel import build_domain2d, build_domain3d
    from meso_tpu_torch.parallel.domain2d import fit_brick_capacity_2d
    from meso_tpu_torch.parallel.domain3d import fit_brick_capacity_3d
    _, devs, _ = BRICK_PATHS[label]
    if system.model != "dpd":
        system = system.replace(cells=system.cells.replace(
            spill=False, capacity=BRICK_SWEEP_K))
    fit = fit_brick_capacity_2d if len(devs) == 2 else fit_brick_capacity_3d
    cells = fit(system, state, *devs).cells
    if cells.spill:
        cells = cells.replace(capacity=cells.capacity + DD_EXTRA_SLOTS)
    system = system.replace(cells=cells)
    if len(devs) == 2:
        return system, build_domain2d(system, *devs, L_MAIN, L_MAIN,
                                      rebuild_every=DD_EVERY)
    return system, build_domain3d(system, *devs, L_MAIN, L_MAIN, L_MAIN,
                                  rebuild_every=DD_EVERY)


def brick_observe(mesh, system, params, state, dcfg, label, chunks):
    """``dd_observe``'s traced chunks on the bricks, then, on a K4 path,
    the halo exchange of the channel planes once more (every rank takes
    part): rank 0 returns its extended planes (positions, velocities,
    tags, validity, types; its exclusion tags and hash are made from them
    in the parent) and the step they belong to."""
    from meso_tpu_torch.ops.sweep import make_channels
    from meso_tpu_torch.parallel.bricks import exchange_halos
    state, res = dd_observe(mesh, system, params, state, dcfg, label, chunks)
    cfg = dcfg.cells
    ch = make_channels(state.x, state.v, state.tag, state.mask, None, {},
                       cfg.ncell, cfg.capacity)
    if params.pair.n_types > 1:
        ch["typ"] = state.typ.reshape(ch["tag"].shape)
    planes = exchange_halos(ch, dcfg, mesh)
    if mesh.rank == 0:
        res["planes"] = {k: t.cpu() for k, t in planes.items()}
        res["planes_step"] = state.step + 1
    return state, res


def brick_kernel_check(label, planes, step, system, params, dcfg, box):
    """K4 on rank 0's real extended planes of a brick path (ext the
    decomposed axes; exclusion tags and the hash added here), against its
    plain version within compare_halo's gate, with its time through the
    wrapper, alone on the built brick, the plain time and the bound."""
    import torch
    from meso_tpu_torch.kernels import _build
    name, p, cfg, ext = "pair_halo_dpd", params.pair, dcfg.cells, dcfg.axes
    planes = {k: t.to(DEVICE) for k, t in planes.items()}
    planes = with_hash(with_excl(planes, p), step, p.seed)
    nx, ny, nz = cfg.ncell
    xr = 2 if cfg.spill else 1
    oy, oz = int("y" in ext), int("z" in ext)
    valid = (planes["valid"][oy:oy + ny, oz:oz + nz, :, xr:xr + nx] > 0
             ).reshape(-1)
    args = (planes, box, step, p, system.dt, cfg, ext)
    got = run_halo(name, False, *args)
    torch.cuda.synchronize()
    want = run_halo(name, True, *args)
    rec = compare_halo(name, got, want, valid, f"{label} rank 0")
    n_rc = halo_pair_count(planes, p, box, cfg, ext)
    rec.update(
        kernel=name, path=label, ext="".join(ext), rows=int(valid.numel()),
        valid_rows=int(valid.sum()), capacity=cfg.capacity, spill=cfg.spill,
        n_excl=0 if getattr(p, "excl", None) is None else p.excl.shape[1],
        pairs_in_rc=n_rc, step=step,
        ms=timed_ms(lambda: run_halo(name, False, *args), 20),
        plain_ms=timed_ms(lambda: run_halo(name, True, *args), 3))
    rec["bound_ms"], rec["bound_by"] = halo_bound(name, planes, got, p, n_rc)
    brick = halo_brick_of(name, planes, p, cfg, ext)
    rec["kernel_ms"] = kernel_alone_ms(name, brick, box, step, p, system.dt,
                                       cfg)
    rec["tests_per_valid_row"] = brick_tests_per_row(brick, cfg)
    rec.update(tile_fields(cfg, brick.xr))
    say(f"bricks-kernel-{label}", **rec)
    return rec


def brick_path_checks(label, job, per, start):
    """The gates and numbers of one brick path from its ranks' results:
    overflow 0, bonded_missing 0, N conserved with unique tags, a finite
    state, the worst skin ratio below 1 after the warm-up, every force
    evaluation through K4 (classic, polymer; the sweep paths through no
    pair kernel) with one hash launch each, and the single-card path's own
    physics gates (classic: kT within 1% of 1 over the traced chunks;
    eDPD: T within (0.3, 3); tDPD: sum C drift below 1e-4; polymer: the
    bond lengths, the momentum drift and kT within 2%). Returns (result,
    failed checks)."""
    import numpy as np
    import torch
    from meso_tpu_torch.parallel import collect_state
    system, dcfg = job["system"], job["dcfg"]
    ranks = len(per)
    final = collect_state([r["state"] for r in per])
    launches = {k: sum(r["launches"][k] for r in per)
                for k in per[0]["launches"]}
    observed = per[0].get("observed_chunks", 0)
    steps = DD_EVERY * (job["warmup"] + job["nchunks"] + observed)
    evals = ranks * steps
    timed_steps = job["nchunks"] * DD_EVERY
    timed_s = max(r["seconds"] for r in per)
    m = final.mask
    n = int(m.sum())
    diags = {"equil": per[0]["warmup_diag"], "timed": per[0]["diag"]}
    if "traced_diag" in per[0]:
        diags["traced"] = per[0]["traced_diag"]
    k4 = system.model == "dpd"
    res = {"path": label, "ranks": ranks, "mesh": list(dcfg.devs),
           "n_particles": n, "rows_per_rank": job["states"][0].n,
           "ncell_local": list(dcfg.cells.ncell),
           "capacity": dcfg.cells.capacity, "spill": dcfg.cells.spill,
           "route": "K4 ext=" + "".join(dcfg.axes) if k4 else "sweep",
           "steps_per_rebuild": DD_EVERY, "steps": steps,
           "timed_steps": timed_steps,
           "ms_per_step_ranks_sharing_one_card":
               1e3 * timed_s / timed_steps,
           "particle_steps_per_s": n * timed_steps / timed_s,
           "diags": diags, "launches": launches,
           "force_evaluations": evals}
    want_pairs = {k: 0 for k in pair_launches(launches)}
    if k4:
        want_pairs["pair_halo_dpd"] = evals
    checks = {
        ("K4 launches == ranks x steps, no other pair kernel" if k4 else
         "no pair kernel launched (the sweep)"):
            pair_launches(launches) == want_pairs,
        "one hash launch per force evaluation":
            launches["particle_hash"] == evals,
        "overflow == 0": all(d["overflow"] == 0 for d in diags.values()),
        "bonded_missing == 0":
            all(d["bonded_missing"] == 0 for d in diags.values()),
        "worst_skin_ratio < 1 after warm-up": max(
            d["worst_skin_ratio"] for w, d in diags.items() if w != "equil")
        < 1.0,
        "N conserved, tags unique": n == start["n"] and int(
            torch.unique(final.tag[m]).numel()) == n,
        "state finite": all(bool(torch.isfinite(t).all())
                            for t in (final.x, final.v, final.f))}
    if system.model == "edpd":
        t = final.T[m]
        res["t_min"], res["t_max"] = float(t.min()), float(t.max())
        checks["0.3 < T < 3"] = res["t_min"] > 0.3 and res["t_max"] < 3
    elif system.model == "tdpd":
        res["c_rel_drift"] = abs(float(final.C[m].sum()) - start["c_sum"]) \
            / abs(start["c_sum"])
        checks["sum C drift < 1e-4"] = res["c_rel_drift"] < 1e-4
    elif system.bond_style is not None:
        kts = np.asarray(per[0]["kts"])
        bl = bond_lengths(final, job["params"].bonded.bond_tags,
                          system.n_tags)
        p0 = start["momentum"].numpy()
        drift = max(float(np.abs(np.asarray(q) - p0).max())
                    for q in per[0]["moms"])
        res.update(bond_max=float(bl.max()), bond_mean=float(bl.mean()),
                   momentum_drift=drift, kT_mean=float(kts.mean()))
        checks.update({
            "bond max < 1.45": res["bond_max"] < 1.45,
            "0.30 < bond mean < 0.75": 0.30 < res["bond_mean"] < 0.75,
            "momentum drift < 5e-2": drift < 5e-2,
            "kT within 2% of 1": abs(res["kT_mean"] - 1.0) < 0.02})
    else:
        kt_mean, kt_sem, n_eff = kt_stats(np.asarray(per[0]["kts"]))
        res.update(kT_mean=kt_mean, kT_sem=kt_sem, kT_n_eff=n_eff)
        checks["kT within 1% of 1"] = abs(kt_mean - 1.0) < 0.01
    return res, [k for k, ok in checks.items() if not ok]


def brick_jobs(labels):
    """Each brick path's job for ``launch.slab_runs`` (its mesh named, its
    bricks on the host) and its start's N, sum C and momentum."""
    import torch
    from meso_tpu_torch.obs import total_momentum
    from meso_tpu_torch.parallel import (distribute_state_2d,
                                         distribute_state_3d, launch)
    jobs, starts = [], {}
    for label in labels:
        base, devs, (warmup, timed, trace) = BRICK_PATHS[label]
        system, params, state = dd_start(base)
        system, dcfg = brick_domain(label, system, state)
        dist = distribute_state_2d if len(devs) == 2 else distribute_state_3d
        bricks = dist(state, dcfg, device=DEVICE)
        mass = params.mass[state.typ.long()]
        starts[label] = {
            "n": int(state.n_valid()),
            "c_sum": float(torch.sum(state.C[state.mask]))
            if state.C is not None else None,
            "momentum": total_momentum(state.v, mass, state.mask).cpu()}
        job = dict(system=system, params=launch.params_on(params, "cpu"),
                   states=[launch.on_device(b, "cpu") for b in bricks],
                   dcfg=dcfg, nchunks=timed, warmup=warmup,
                   mesh=(devs, dcfg.axes))
        if trace:
            job.update(then=brick_observe, then_args=(label, dict(
                trace=trace, rounds=1, profile=0)))
        jobs.append(job)
        del system, params, state, bricks
        torch.cuda.empty_cache()
    return jobs, starts


def dpsp_job():
    """DP x SP: the classic two-rank start, ENSEMBLE_REPLICAS replicas
    (tags reseeded) x DPSP_SLABS slabs through K4 with the border/inner
    split, as the 1-D classic path runs."""
    from meso_tpu_torch.parallel import distribute_ensemble_spatial, launch
    from meso_tpu_torch.parallel.ensemble import ensemble_spatial_rank
    system, params, state = dd_start("classic")
    system, dcfg = dd_domain(system, state, DPSP_SLABS)
    reps = distribute_ensemble_spatial(state, ENSEMBLE_REPLICAS, dcfg,
                                       device=DEVICE)
    reps = [[launch.on_device(s, "cpu") for s in slabs] for slabs in reps]
    return (ensemble_spatial_rank,
            (system, launch.params_on(params, "cpu"), reps, dcfg,
             DPSP_CHUNKS)), int(state.n_valid())


def dpsp_checks(per, n):
    """DP x SP's gates: per replica N conserved with its own tags, no
    overflow, a finite state, the worst skin ratio below 1, and K4's three
    calls (interior and two edges) a step on every rank with one hash
    launch a step."""
    import torch
    from meso_tpu_torch.parallel import collect_state
    ranks = len(per)
    steps = DPSP_CHUNKS * DD_EVERY
    launches = {k: sum(r["launches"][k] for r in per)
                for k in per[0]["launches"]}
    seconds = max(r["seconds"] for r in per)
    res = {"ranks": ranks, "replicas": ENSEMBLE_REPLICAS,
           "slabs": DPSP_SLABS, "steps": steps, "launches": launches,
           "diag": per[0]["diag"],
           "ms_per_step_ranks_sharing_one_card": 1e3 * seconds / steps}
    checks = {
        "K4 launches == 3 x ranks x steps, no other pair kernel":
            pair_launches(launches) == {
                **{k: 0 for k in pair_launches(launches)},
                "pair_halo_dpd": 3 * ranks * steps},
        "one hash launch per force evaluation":
            launches["particle_hash"] == ranks * steps,
        "overflow == 0": per[0]["diag"]["overflow"] == 0,
        "worst_skin_ratio < 1": per[0]["diag"]["worst_skin_ratio"] < 1.0}
    for r in range(ENSEMBLE_REPLICAS):
        final = collect_state([q["state"] for q in
                               per[r * DPSP_SLABS:(r + 1) * DPSP_SLABS]])
        m = final.mask
        tags = torch.sort(final.tag[m]).values
        checks[f"replica {r}: N conserved, its own tags"] = int(
            m.sum()) == n and bool(torch.equal(
                tags, torch.arange(1, n + 1, dtype=tags.dtype) + r * n))
        checks[f"replica {r}: state finite"] = bool(
            torch.isfinite(final.x).all() and torch.isfinite(final.v).all())
    return res, [k for k, ok in checks.items() if not ok]


def phase_ensemble():
    """run_ensemble: ENSEMBLE_REPLICAS replicas (tags reseeded) of the
    classic two-rank start on K1 (spill buckets, the builder's capacity,
    a rebuild every DD_EVERY steps), one a rank, ENSEMBLE_STEPS steps;
    against ``run_bucket_fixed`` of the same start in this process.
    Gates: replica 0 bitwise equal to the single-card run, K1 and the hash
    launched once a step on every rank and no other pair kernel, no
    overflow, the worst skin ratio below 1, every replica finite with its
    own tags, replica 1 decorrelated (max |dx| by tag, the minimum image,
    above 0.1)."""
    import torch
    from meso_tpu_torch.core.system import run_bucket_fixed
    from meso_tpu_torch.parallel import launch, replicate_state
    from meso_tpu_torch.parallel.ensemble import ensemble_rank
    system, params, state = dd_start("classic")
    system = system.replace(pair_kernel="v3")
    nchunks = ENSEMBLE_STEPS // DD_EVERY
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single, _ = run_bucket_fixed(system, params, state, nchunks, DD_EVERY)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_launches = read_launches()
    reps = [launch.on_device(r, "cpu")
            for r in replicate_state(state, ENSEMBLE_REPLICAS)]
    t0 = time.perf_counter()
    per = launch.spawn(ensemble_rank, ENSEMBLE_REPLICAS,
                       BRICKS_DIR / "ensemble",
                       args=(system, launch.params_on(params, "cpu"), reps,
                             nchunks * DD_EVERY),
                       device=DEVICE, timeout_s=BRICK_SPAWN_TIMEOUT_S,
                       op_timeout_s=DD_OP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    single = launch.on_device(single, "cpu")
    steps = nchunks * DD_EVERY
    launches = {k: sum(r["launches"][k] for r in per)
                for k in per[0]["launches"]}
    r0, r1 = per[0]["state"], per[1]["state"]
    n = int(state.n_valid())
    x0, x1 = by_tag(r0, r0.x), by_tag(r1, r1.x)
    res = {"replicas": ENSEMBLE_REPLICAS, "n_particles": n, "steps": steps,
           "capacity": system.cells.capacity, "launches": launches,
           "diags": [r["diag"] for r in per], "ke_mean": per[0]["ke_mean"],
           "ms_per_step_replicas_sharing_one_card":
               1e3 * max(r["seconds"] for r in per) / steps,
           "single_ms_per_step": 1e3 * single_s / steps,
           "replica1_max_dx": float(torch.remainder(
               x1 - x0 + 0.5 * L_MAIN, L_MAIN).sub(0.5 * L_MAIN).abs().max()),
           "spawn_s": spawn_s}
    checks = {
        "replica 0 bitwise equal to the single-card run": all(
            torch.equal(getattr(r0, f), getattr(single, f))
            for f in ("x", "v", "f", "tag", "mask", "image")),
        "K1 and the hash once a step on every rank, no other pair kernel":
            pair_launches(launches) == {
                **{k: 0 for k in pair_launches(launches)},
                "pair_dpd_v3": ENSEMBLE_REPLICAS * steps}
            and launches["particle_hash"] == ENSEMBLE_REPLICAS * steps
            and single_launches["pair_dpd_v3"] == steps,
        "overflow == 0": all(r["diag"]["bucket_overflow"] == 0
                             for r in per),
        "worst_skin_ratio < 1": all(r["diag"]["worst_skin_ratio"] < 1.0
                                    for r in per),
        "replicas finite, their own tags": all(
            bool(torch.isfinite(r["state"].x).all())
            and int(r["state"].mask.sum()) == n for r in per)
            and int(r1.tag[r1.mask].min()) == n + 1,
        "replica 1 decorrelated": res["replica1_max_dx"] > 0.1}
    say("bricks-ensemble", **res)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bricks-ensemble failed: {failed}")
    return res


def phase_bricks():
    """The 2-D and 3-D bricks, the replica ensemble and the dry run at
    1,029,000 particles, the ranks sharing the card through gloo. Four
    ranks (one start of the processes, ``launch.slab_runs``): classic-2d
    and polymer-2d through K4 with ext ("x", "y") (the polymer with
    exclusions and bonded ghost rows), edpd-2d and tdpd-2d through the
    sweep, and DP x SP; eight ranks: classic-3d through K4 with ext ("x",
    "y", "z"); then run_ensemble on two ranks and
    ``dryrun_multichip(DRYRUN_RANKS)``. Each K4 path's kernel is held
    against its plain version on rank 0's real extended planes and timed
    (``brick_kernel_check``). ms/step are of ranks sharing one card: not a
    scaling figure."""
    import torch
    from meso_tpu_torch.kernels import _build
    from meso_tpu_torch.parallel import launch
    from meso_tpu_torch.parallel.dryrun import dryrun_multichip
    _build.build()
    t_phase = time.perf_counter()
    out, kernels, failures = {}, {}, {}
    for labels, extra in ((("classic-2d", "polymer-2d", "edpd-2d",
                            "tdpd-2d"), True), (("classic-3d",), False)):
        t0 = time.perf_counter()
        jobs, starts = brick_jobs(labels)
        if extra:
            job, n_dpsp = dpsp_job()
            jobs.append(job)
        n_ranks = len(jobs[0]["states"])
        ranks = launch.spawn(launch.slab_runs, n_ranks,
                             BRICKS_DIR / f"ranks{n_ranks}", args=(jobs,),
                             device=DEVICE,
                             timeout_s=BRICK_SPAWN_TIMEOUT_S,
                             op_timeout_s=DD_OP_TIMEOUT_S)
        for j, label in enumerate(labels):
            per = [r[j] for r in ranks]
            res, failed = brick_path_checks(label, jobs[j], per,
                                            starts[label])
            if "planes" in per[0]:
                box = jobs[j]["states"][0].box
                kernels[label] = brick_kernel_check(
                    label, per[0]["planes"], per[0]["planes_step"],
                    jobs[j]["system"],
                    launch.params_on(jobs[j]["params"], DEVICE),
                    jobs[j]["dcfg"], box.replace(lo=box.lo.to(DEVICE),
                                                 hi=box.hi.to(DEVICE)))
            out[label] = res
            say(f"bricks-{label}", **res)
            if failed:
                failures[label] = failed
        if extra:
            res, failed = dpsp_checks([r[len(labels)] for r in ranks],
                                      n_dpsp)
            out["dpsp"] = res
            say("bricks-dpsp", **res)
            if failed:
                failures["dpsp"] = failed
        out[f"spawn_{n_ranks}_ranks_s"] = time.perf_counter() - t0
        say("bricks-ranks", ranks=n_ranks,
            seconds=out[f"spawn_{n_ranks}_ranks_s"])
        del ranks, jobs
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"brick paths failed: {failures}")
    out["ensemble"] = phase_ensemble()
    t0 = time.perf_counter()
    report = dryrun_multichip(DRYRUN_RANKS, device=DEVICE)
    out["dryrun"] = {"seconds": time.perf_counter() - t0, **{
        name: {k: v for k, v in leg.items() if k != "diags"}
        for name, leg in report.items()}}
    say("bricks-dryrun", **out["dryrun"])
    k4 = report["slabs_k4"]["launches"].get("pair_halo_dpd", 0)
    if k4 == 0:
        raise AssertionError("the dry run's K4 leg launched no K4")
    out["seconds"] = time.perf_counter() - t_phase
    say("bricks", seconds=out["seconds"])
    return out, kernels


# ---------------------------------------------------------------------------
# the TPU probes T1-T4 on the card
# ---------------------------------------------------------------------------

# T2 is timed on this many independent tiles (1,048,576 i-rows x 128 j);
# T4 at K1's 1M view over these grid splits of z
PROBE_BATCH = 8192
T4_ZCS = (1, 5, 10, 25)
PROBE_SRC = "meso_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {"probe_dynroll": "tools/toy_dynroll.py:32",
                  "probe_cond": "tools/toy_dynroll.py:58",
                  "probe_dot_a": "tools/toy_mxu_tile.py:43",
                  "probe_dot_b": "tools/toy_mxu_tile.py:57",
                  "probe_tile": "tools/toy_mxu_tile.py:71",
                  "probe_dot_c": "tools/toy_mxu_tile.py:97",
                  "probe_tea_roll": "tools/toy_tea_roll.py:64",
                  "probe_null_stage": "tools/r5a_stage.py:74"}


def stencil_candidates(bst, cfg):
    """The candidate tests K1 makes on these rows: for every valid row, the
    valid rows of its slot-cell window (3 x 3 in y and z, 2 xr + 1 in x)."""
    import torch
    nx, ny, nz = cfg.ncell
    xr = 2 if cfg.spill else 1
    occ = bst.mask.reshape(ny, nz, cfg.capacity, nx).sum(2).to(torch.int64)
    win = torch.zeros_like(occ)
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            for dx in range(-xr, xr + 1):
                win += torch.roll(occ, (dy, dz, dx), (0, 1, 2))
    return int((occ * win).sum()) - int(bst.mask.sum())


def probe_record(name, launches, err, ms, plain_ms, bnd, library_ms=None,
                 **extra):
    return {"name": name, "route": "cuda", "source": PROBE_SRC,
            "replaces": PROBE_REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms,
            **extra}


def tile_design_bound(pairs):
    """(ms, by) of T2c's n-body design on ``pairs`` pairs, counted from its
    source (csrc/probes.cu::tile_kernel): per pair 13 instructions on the
    CUDA cores (3 differences, r^2 in a multiply and two FMAs, two cutoff
    compares and a select, rsqrt - 1, three force FMAs) and one MUFU
    rsqrt, and a quarter of a shared load (one float4 broadcast for a
    lane's four rows); instructions at the issue rate (one warp
    instruction a clock for each of an SM's four schedulers), the rsqrt at
    the MUFU's 16 a clock an SM."""
    t_issue = 1e3 * pairs * (13 + 1 + 0.25) / ISSUE_PER_S
    t_mufu = 1e3 * pairs / MUFU_PER_S
    return (t_issue, "issue") if t_issue >= t_mufu else (t_mufu, "mufu")


def profiled_kernel_ms(fn, kernel, reps):
    """Device ms a launch of the kernels whose name holds ``kernel``, from
    torch.profiler over ``reps`` calls of fn() (the kernel alone, without
    the host work of its wrapper)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [(ms, c) for k, (ms, c) in device_times(prof, 1).items()
            if kernel in k]
    calls = sum(c for _, c in hits)
    if not calls:
        raise AssertionError(f"the profile lists no {kernel}")
    return sum(ms for ms, _ in hits) / calls


def phase_probes(k1):
    """T1-T4 on the card. Each probe's own run (its module's ``run``, as
    ``python -m meso_tpu_torch.probes.<name>`` runs it) with the launch
    counts set to 0 just before and read just after: every kernel against
    its plain version (T1, T3, T4 bitwise; T2's products within 1e-5 of
    max |ref|; T2's tile within max(1e-5, 4x the float32 plain version's
    error) of its float64 plain version). Then the times: T1 and T3 at the
    probes' shapes, through their wrappers and alone (the kernel's device
    time, torch.profiler); T2 at PROBE_BATCH tiles against its plain
    version and
    torch.bmm (TF32 off), with the tile's ns per candidate pair beside K1's
    per candidate test (``k1``: K1's time and candidate count at the
    main-path shape); T4 at K1's 1M view for every zc of T4_ZCS, its
    achieved streaming rate and its cost per grid cell."""
    import numpy as np
    import torch
    from meso_tpu_torch.probes import (r5a_stage, toy_dynroll, toy_mxu_tile,
                                       toy_tea_roll)
    # the plain versions' and the library's products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launches()
    runs = {"toy_dynroll": toy_dynroll.run(DEVICE),
            "toy_mxu_tile": toy_mxu_tile.run(DEVICE),
            "toy_tea_roll": toy_tea_roll.run(DEVICE),
            "r5a_stage": r5a_stage.run(DEVICE)}
    torch.cuda.synchronize()
    launches = {name: read_launches()[name] for name in PROBE_REPLACES}
    failed = [f"{p}/{k}" for p, res in runs.items() for k, r in res.items()
              if not r.get("ok", r.get("bitwise"))]
    failed += [f"{name} not launched" for name, n in launches.items()
               if n == 0]
    if failed:
        raise AssertionError(f"probes failed: {failed}: {runs}")
    say("probes-run", launches=launches, **runs)
    rows = []

    # T1 at the probe's shape
    (x0, offs), (x1, jm) = toy_dynroll.inputs(DEVICE)
    for name, fn, plain, args, ops in (
            ("probe_dynroll", toy_dynroll.dynroll, toy_dynroll.dynroll_plain,
             (x0, offs), x0.numel() * offs.numel()),
            ("probe_cond", toy_dynroll.cond, toy_dynroll.cond_plain,
             (x1, jm), x1.numel() * (14 * int((jm > 4).sum()) + 1))):
        out = fn(*args)
        kernel = {"probe_dynroll": "dynroll_kernel",
                  "probe_cond": "cond_kernel"}[name]
        rows.append(probe_record(
            name, launches,
            runs["toy_dynroll"][name.split("_")[1]]["max_abs_err"],
            timed_ms(lambda: fn(*args), 200), timed_ms(lambda: plain(*args),
                                                       50),
            bound(args, [out], ops),
            kernel_ms=profiled_kernel_ms(lambda: fn(*args), kernel, 50)))

    # T2 at PROBE_BATCH tiles
    batch = toy_mxu_tile.inputs(PROBE_BATCH, seed=1, device=DEVICE)
    library = {"dot_a": lambda a, b: torch.bmm(a, b),
               "dot_b": lambda a, b: torch.bmm(a, b),
               "dot_c": lambda a, b: torch.bmm(a.transpose(1, 2), b)}
    t2 = {}
    for key in ("dot_a", "dot_b", "tile", "dot_c"):
        fn, plain = toy_mxu_tile.FUNCS[key]
        args = batch[key]
        got = fn(*args)
        want = plain(*args)
        rec = {"rel": toy_mxu_tile.rel_err(got, want),
               "max_abs_err": float((got - want).abs().max())}
        extra = {}
        if key == "tile":
            rec.update(toy_mxu_tile.tile_check(got, *args))
            m, n = 128, 128
            # the bound as counted for the tensor-core design, kept as the
            # yardstick of both designs: its two products in 6xTF32 (six
            # TF32 products a float32 one) and 12 fp32 operations a pair
            tc = 6 * (2 * m * n * 3 + 2 * m * 5 * n) * PROBE_BATCH
            bnd = bound(args, [got], 12 * m * n * PROBE_BATCH, tc)
            rec["design_bound_ms"], rec["design_bound_by"] = \
                tile_design_bound(m * n * PROBE_BATCH)
            rec["kernel_ms"] = profiled_kernel_ms(lambda: fn(*args),
                                                  "tile_kernel", 20)
            extra = {k: rec[k] for k in ("rel_f64", "plain_rel_f64",
                                         "design_bound_ms",
                                         "design_bound_by", "kernel_ms")}
        else:
            rec["ok"] = rec["rel"] < toy_mxu_tile.TOL
            (bsz, r, s), n = args[0].shape, args[1].shape[2]
            m, k = (s, r) if key == "dot_c" else (r, s)
            bnd = bound(args, [got], 0, 3 * 2 * m * n * k * bsz)
        if not rec["ok"]:
            raise AssertionError(f"T2 {key} at {PROBE_BATCH} tiles: {rec}")
        ms = timed_ms(lambda: fn(*args), 20)
        lib = timed_ms(lambda: library[key](*args), 20) \
            if key in library else None
        run_err = runs["toy_mxu_tile"][key]["max_abs_err"]
        rows.append(probe_record(
            f"probe_{key}", launches, max(run_err, rec["max_abs_err"]), ms,
            timed_ms(lambda: plain(*args), 3), bnd, lib, batch=PROBE_BATCH,
            **extra))
        t2[key] = {**rec, "ms": ms, "library_ms": lib,
                   "vs_library": None if lib is None else ms / lib}
    pairs = PROBE_BATCH * 128 * 128
    t2["tile_ns_per_candidate_pair"] = 1e6 * t2["tile"]["ms"] / pairs
    t2["k1_ns_per_candidate_test"] = 1e6 * k1["pair_ms"] / k1["candidates"]
    t2["k1_candidates_per_valid_row"] = k1["candidates"] / k1["n"]
    say("probes-t2", batch=PROBE_BATCH, **t2)

    # T3 at the probe's shape, the base variant timed through its wrapper
    # (a host-to-device copy of its offsets a call) and alone (the
    # profiler's device time of its kernel); its bound counts a site's
    # 8-round TEA as a hash row's instructions less the xor that makes the
    # hash's v1 (T3 takes v1 from the other tag)
    stack, iscal = toy_tea_roll.inputs(DEVICE)
    out = toy_tea_roll.tea_roll(stack, iscal, "base")
    n_sites = stack.shape[-1] * stack.shape[-2] * len(toy_tea_roll.OFFS)
    t3_alone = profiled_kernel_ms(
        lambda: toy_tea_roll.tea_roll(stack, iscal, "base"),
        "tea_roll_kernel", 50)
    rows.append(probe_record(
        "probe_tea_roll", launches,
        max(r["max_abs_err"] for r in runs["toy_tea_roll"].values()),
        timed_ms(lambda: toy_tea_roll.tea_roll(stack, iscal, "base"), 200),
        timed_ms(lambda: toy_tea_roll.tea_roll_plain(stack, iscal, "base"),
                 5),
        bound([stack, iscal], [out],
              n_sites * (Ops(**k1["hash_ops_per_row"]) - Ops(0, 1, 1))),
        variants=len(toy_tea_roll.VARIANTS), kernel_ms=t3_alone))

    # T4 at K1's 1M view
    t4 = {}
    for zc in T4_ZCS:
        view = r5a_stage.view_1m(zc, device=DEVICE)
        got = r5a_stage.null_stage(view)
        want = r5a_stage.null_stage_plain(view)
        if not torch.equal(got, want):
            raise AssertionError(f"T4 at zc={zc} != its plain version")
        ms = timed_ms(lambda: r5a_stage.null_stage(view), 50)
        nbytes = r5a_stage.bytes_moved(view)
        plane4 = view.shape[3] * view.shape[4] // 4
        blocks = (view.shape[1] - 2) * zc * -(-plane4 // 1024)
        t4[zc] = {"ms": ms, "plain_ms": timed_ms(
            lambda: r5a_stage.null_stage_plain(view), 10),
            "bytes": nbytes, "rate_bytes_per_s": nbytes / (ms * 1e-3),
            "blocks": blocks,
            "bound": (1e3 * nbytes / HBM_BYTES_PER_S, "bytes")}
        del view, got, want
    zs = list(T4_ZCS)
    # the time against the number of grid cells (cy, cb), ny * zc, as the
    # JAX tool read its dispatch slope
    slope = np.polyfit([(r5a_stage.NY * z) for z in zs],
                       [t4[z]["ms"] for z in zs], 1)[0]
    rate = max(t4[z]["rate_bytes_per_s"] for z in zs)
    base = t4[5]
    rows.append(probe_record(
        "probe_null_stage", launches,
        max(r["max_abs_err"] for r in runs["r5a_stage"].values()),
        base["ms"], base["plain_ms"], base["bound"], zc=5,
        rate_bytes_per_s=base["rate_bytes_per_s"]))
    out = {"runs": runs, "launches": launches, "rows": rows, "t2": t2,
           "t4": {"by_zc": {str(z): {k: v for k, v in t4[z].items()
                                     if k != "bound"} for z in zs},
                  "best_rate_bytes_per_s": rate,
                  "us_per_grid_cell": 1e3 * slope}}
    say("probes-t4", **out["t4"])
    say("probes", kernels=[r["name"] for r in rows])
    return out


# ---------------------------------------------------------------------------
# the paths on XLA code in the JAX package: neighbour lists and the sweep
# ---------------------------------------------------------------------------

# the equilibrated end states of the 1M paths (the main path's classic
# fluid, transport-full's eDPD and tDPD), from which the neighbour-list,
# sweep and dd-bucket paths start: the random start's relaxation would
# take thousands of their slower steps
FINAL_STATES = {}
# nlist-path: the JAX defaults' cadence; NL_EQUIL_CHUNKS chunks of 10
# steps from the main path's fluid (this cadence runs it 0.8% hotter:
# the transient would stretch the kT trace's correlation), NL_TIMED_CHUNKS
# timed, then rounds of NL_TRACE_CHUNKS chunks with kT after each, until
# its average has MIN_N_EFF effective samples (1,600 steps gave 7.9 on an
# H100)
NL_EQUIL_CHUNKS, NL_TIMED_CHUNKS = 20, 5
NL_TRACE_CHUNKS, NL_MAX_TRACE_ROUNDS = 20, 12
# bucket-paths: the sweep from the equilibrated starts, chunks of
# SWEEP_EVERY steps; run_adaptive on the neighbour lists for ADAPTIVE_STEPS
SWEEP_EVERY, SWEEP_TIMED_CHUNKS, ADAPTIVE_STEPS = 2, 2, 40
# dd-bucket: the classic sweep on two ranks, chunks of DD_EVERY steps
DD_SWEEP_WARMUP, DD_SWEEP_CHUNKS = 1, 3


def resume(state, box=None):
    """The valid rows of a bucket state, box-wrapped, as a compact state
    (what a builder's setup takes)."""
    import torch
    idx = torch.nonzero(state.mask).squeeze(1)
    rows = {f: None if getattr(state, f) is None else getattr(state, f)[idx]
            for f in ("x", "v", "f", "typ", "tag", "image", "mol", "T",
                      "dTdt", "C", "dCdt")}
    x, image = state.box.wrap(rows["x"], rows["image"])
    return state.replace(**{**rows, "x": x, "image": image,
                            "mask": state.mask[idx]})


def kt_of(params, state):
    from meso_tpu_torch.obs import kinetic_temperature
    mass = params.mass[state.typ.long()]
    return kinetic_temperature(state.v, mass, state.mask)


def phase_nlist_path():
    """classic_fluid(l=70) with the JAX package's defaults (force_path
    "nlist", skin 0.3, cells and lists rebuilt every 10 steps, the TEA
    tier, 1,029,000 particles), from the main path's equilibrated
    particles, driven through ``run``: NL_EQUIL_CHUNKS chunks, then
    NL_TIMED_CHUNKS timed, then kT after each chunk until its average has
    MIN_N_EFF effective samples;
    the list build timed alone. Gates: cell and list overflow 0, every
    value finite, kT within 1% of 1 at 3 sigma, and no kernel launched
    but the integrator's halves, once a step (the forces and lists are
    plain torch, as they were XLA code in JAX). The skin check
    is reported: at this cadence the fastest of a million particles
    outruns skin/2 within every chunk (JAX's own fixed-cadence test runs
    skin 0.5 and a rebuild every 3 steps)."""
    import numpy as np
    import torch
    from meso_tpu_torch.core.system import rebuild, run, setup
    from meso_tpu_torch.models.classic import classic_fluid
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    system, params, _ = classic_fluid(l=L_MAIN, device=DEVICE)
    state = setup(system, params, resume(FINAL_STATES["classic"]))
    n = int(state.n_valid())
    build_ms = timed_ms(lambda: rebuild(system, state), 3)
    state, equil = run(system, params, state, NL_EQUIL_CHUNKS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, timed = run(system, params, state, NL_TIMED_CHUNKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    kts, traced = [], []
    for _ in range(NL_MAX_TRACE_ROUNDS):
        for _ in range(NL_TRACE_CHUNKS):
            state, d = run(system, params, state, 1)
            traced.append(d)
            kts.append(kt_of(params, state))
        kt_mean, kt_sem, n_eff = kt_stats(
            torch.stack(kts).cpu().numpy().astype(np.float64))
        if n_eff >= MIN_N_EFF:
            break
    torch.cuda.synchronize()
    launches = read_launches()
    every = system.cells.rebuild_every
    diag = {k: torch.cat([equil[k], timed[k]] + [d[k] for d in traced])
            for k in timed}
    half_skin = 0.5 * system.cells.skin
    res = {"force_path": system.force_path, "rng_mode": system.rng_mode,
           "skin": system.cells.skin, "rebuild_every": every,
           "nlist_m": system.nlist_m, "capacity": system.cells.capacity,
           "ncell": list(system.cells.ncell), "n_particles": n,
           "timed_steps": NL_TIMED_CHUNKS * every, "wall_s": wall,
           "ms_per_step": 1e3 * wall / (NL_TIMED_CHUNKS * every),
           "particle_steps_per_s": n * NL_TIMED_CHUNKS * every / wall,
           "list_build_ms": build_ms, "setup_s": t1 - t0,
           "cell_overflow": int(diag["cell_overflow"].max()),
           "nlist_overflow": int(diag["nlist_overflow"].max()),
           "max_neigh": int(diag["max_neigh"].max()),
           "skin_violations_timed": int(timed["skin_violation"].sum()),
           "skin_violations": int(diag["skin_violation"].sum()),
           "chunks": int(diag["skin_violation"].numel()),
           "worst_skin_ratio_timed": float(
               timed["max_disp_sq"].max().sqrt()) / half_skin,
           "worst_skin_ratio": float(diag["max_disp_sq"].max().sqrt())
           / half_skin,
           "kT_mean": kt_mean, "kT_sem": kt_sem, "kT_3sig": 3 * kt_sem,
           "kT_n_eff": n_eff, "kT_trace_steps": len(kts) * every,
           "launches": {k: v for k, v in launches.items() if v},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    say("nlist-path", **res)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.x, state.v, state.f))
    checks = {"no kernel launched but the integrator, once a step":
              only_integrator(launches, res["chunks"] * every),
              "cell_overflow == 0": res["cell_overflow"] == 0,
              "nlist_overflow == 0": res["nlist_overflow"] == 0,
              "state finite": finite,
              "kT_n_eff >= 10": n_eff >= MIN_N_EFF,
              "|kT - 1| + 3 sigma <= 0.01":
                  abs(kt_mean - 1.0) + 3 * kt_sem <= 0.01}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"nlist-path failed: {failed}")
    return res


def sweep_path(model):
    """(system, params, state) of a 1M sweep path at set-up: the builder's
    system with force_path "bucket" on strict buckets (skin 0.4, a
    rebuild every SWEEP_EVERY steps, the fast tier), set up on the
    equilibrated end state of the model's 1M path: classic_fluid (the main
    path's a, gamma, dt and lambda), edpd_slab and tdpd_diffusion (their
    transport-full settings)."""
    from meso_tpu_torch.core.system import fit_capacity, setup
    from meso_tpu_torch.models.classic import classic_fluid
    from meso_tpu_torch.models.transport import edpd_slab, tdpd_diffusion
    kw = dict(force_path="bucket", skin=SKIN, device=DEVICE)
    if model == "dpd":
        system, params, _ = classic_fluid(l=L_MAIN, rng_mode="fast",
                                          rebuild="sort", **kw)
        system = system.replace(lam=LAM)
        start = FINAL_STATES["classic"]
    elif model == "edpd":
        system, params, _ = edpd_slab(l=L_MAIN, kappa=2.0, cv=30.0,
                                      t_hot=1.3, t_cold=0.7, **kw)
        start = FINAL_STATES["edpd"]
    else:
        system, params, _ = tdpd_diffusion(l=L_MAIN, kappa_c=2.0, **kw)
        start = FINAL_STATES["tdpd"]
    system = system.replace(cells=system.cells.replace(
        rebuild="sort", rebuild_every=SWEEP_EVERY))
    state = resume(start)
    system = fit_capacity(system, state)
    return system, params, setup(system, params, state)


def phase_bucket_paths():
    """The sweep (force_path "bucket") at 1,029,000 particles for classic
    DPD, eDPD and tDPD through ``run_bucket_fixed``, each from its 1M
    path's equilibrated end state: SWEEP_TIMED_CHUNKS chunks of
    SWEEP_EVERY steps timed, with transport-full's gates (launch counts:
    the fast tier's hash once per force evaluation and no pair kernel;
    overflow 0, skin ratio < 1, finite; eDPD T in (0.3, 3), tDPD sum C
    drift < 1e-4). Then ``run_adaptive`` for ADAPTIVE_STEPS steps on the
    neighbour lists (classic_fluid's defaults) from the classic start: its
    rebuild count and worst displacement, overflow 0, the overshoot within
    skin/2 + 0.1 (the JAX package's own test bound)."""
    import torch
    from meso_tpu_torch.core.system import run_adaptive, run_bucket_fixed
    from meso_tpu_torch.core.system import setup
    from meso_tpu_torch.models.classic import classic_fluid
    out = {}
    for model in ("dpd", "edpd", "tdpd"):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        system, params, state = sweep_path(model)
        n = int(state.n_valid())
        c0 = float(torch.sum(state.C[state.mask])) if model == "tdpd" \
            else None
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, diag = run_bucket_fixed(system, params, state,
                                       SWEEP_TIMED_CHUNKS, SWEEP_EVERY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = read_launches()
        steps = SWEEP_TIMED_CHUNKS * SWEEP_EVERY
        # the builder's set-up on its own start, set-up on the resumed
        # start, and the timed steps
        force_evals = 2 + steps
        fields = (state.x, state.v, state.f) + (
            (state.T,) if model == "edpd" else
            (state.C,) if model == "tdpd" else ())
        res = {"model": model, "rows": state.n, "n_particles": n,
               "capacity": system.cells.capacity, "spill": False,
               "steps_per_rebuild": SWEEP_EVERY, "timed_steps": steps,
               "wall_s": wall, "ms_per_step": 1e3 * wall / steps,
               "particle_steps_per_s": n * steps / wall,
               "setup_s": t1 - t0,
               "bucket_overflow": int(diag["bucket_overflow"]),
               "worst_skin_ratio": float(diag["worst_skin_ratio"]),
               "force_evals": force_evals,
               "launches": {k: v for k, v in launches.items() if v},
               "kT": float(kt_of(params, state)),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        checks = {"no pair kernel launched":
                  not any(pair_launches(launches).values()),
                  "hash launches == force evaluations":
                  launches["particle_hash"] == force_evals,
                  "bucket_overflow == 0": res["bucket_overflow"] == 0,
                  "worst_skin_ratio < 1": res["worst_skin_ratio"] < 1.0,
                  "state finite": all(bool(torch.isfinite(t).all())
                                      for t in fields)}
        if model == "edpd":
            t = state.T[state.mask]
            res["t_min"], res["t_max"] = float(t.min()), float(t.max())
            checks["0.3 < T < 3"] = res["t_min"] > 0.3 and res["t_max"] < 3
        elif model == "tdpd":
            c1 = float(torch.sum(state.C[state.mask]))
            res["c_rel_drift"] = abs(c1 - c0) / abs(c0)
            checks["sum C drift < 1e-4"] = res["c_rel_drift"] < 1e-4
        say(f"bucket-{model}", **res)
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"bucket-{model} failed: {failed}")
        out[model] = res
        del system, params, state
        torch.cuda.empty_cache()

    reset_launches()
    system, params, _ = classic_fluid(l=L_MAIN, device=DEVICE)
    state = setup(system, params, resume(FINAL_STATES["classic"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, diag = run_adaptive(system, params, state, ADAPTIVE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    res = {"steps": ADAPTIVE_STEPS, "n_rebuilds": diag["n_rebuilds"],
           "worst_disp_at_rebuild": float(diag["worst_disp_at_rebuild"]),
           "half_skin": 0.5 * system.cells.skin,
           "cell_overflow": int(diag["cell_overflow"]),
           "nlist_overflow": int(diag["nlist_overflow"]),
           "ms_per_step": 1e3 * wall / ADAPTIVE_STEPS,
           "launches": {k: v for k, v in launches.items() if v}}
    say("adaptive-nlist", **res)
    checks = {"no kernel launched but the integrator, once a step":
              only_integrator(launches, ADAPTIVE_STEPS),
              "overflow == 0": res["cell_overflow"] == 0
              and res["nlist_overflow"] == 0,
              "rebuilt at least once": res["n_rebuilds"] > 0,
              "overshoot < skin/2 + 0.1": res["worst_disp_at_rebuild"]
              < res["half_skin"] + 0.1,
              "state finite": all(bool(torch.isfinite(t).all())
                                  for t in (state.x, state.v, state.f))}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"adaptive-nlist failed: {failed}")
    out["adaptive"] = res
    return out


def phase_dd_bucket():
    """The classic sweep path (force_path "bucket", strict buckets, the
    fast tier) under the 1-D decomposition on two gloo ranks sharing the
    card, with dd-paths' harness: the start is the main path's
    equilibrated fluid, distributed into two slabs of 25 cell columns; the
    ranks run DD_SWEEP_WARMUP chunks, then DD_SWEEP_CHUNKS timed ones, of
    DD_EVERY steps. Gates (dd-paths'): overflow 0, bonded_missing 0, the
    worst skin ratio < 1, N conserved and tags unique, the state finite,
    one hash launch per force evaluation and no pair kernel (the sweep is
    plain torch), and kT within 1% of 1 at the end. The kT average of
    dd-paths (10 effective samples) would take thousands of these steps;
    the start is equilibrated, so the end's kT is held to 1% instead. Not
    a scaling figure."""
    import torch
    from meso_tpu_torch.kernels import _build
    from meso_tpu_torch.models.classic import classic_fluid
    from meso_tpu_torch.core.system import setup
    from meso_tpu_torch.parallel import (collect_state, distribute_state,
                                         launch)
    _build.build()
    system, params, _ = classic_fluid(
        l=L_MAIN, rng_mode="fast", rebuild="sort", force_path="bucket",
        skin=SKIN, rebuild_every=DD_EVERY, device=DEVICE)
    system = system.replace(lam=LAM)
    state = setup(system, params, resume(FINAL_STATES["classic"]))
    system, dcfg = dd_domain(system, state, DD_RANKS)
    slabs = distribute_state(state, dcfg, device=DEVICE)
    n0 = int(state.n_valid())
    job = dict(system=system, params=launch.params_on(params, "cpu"),
               states=[launch.on_device(s, "cpu") for s in slabs], dcfg=dcfg,
               nchunks=DD_SWEEP_CHUNKS, warmup=DD_SWEEP_WARMUP)
    del state, slabs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per = [r[0] for r in launch.spawn(
        launch.slab_runs, DD_RANKS, ROOT / "build" / "dd_ranks",
        args=([job],), device=DEVICE, timeout_s=DD_SPAWN_TIMEOUT_S,
        op_timeout_s=DD_OP_TIMEOUT_S)]
    spawn_s = time.perf_counter() - t0
    final = collect_state([p["state"] for p in per])
    launches = {k: sum(p["launches"][k] for p in per)
                for k in per[0]["launches"]}
    steps = DD_EVERY * (DD_SWEEP_WARMUP + DD_SWEEP_CHUNKS)
    evals = DD_RANKS * steps
    timed_steps = DD_EVERY * DD_SWEEP_CHUNKS
    timed_s = max(p["seconds"] for p in per)
    m = final.mask
    n = int(m.sum())
    kt = float(kt_of(launch.params_on(params, "cpu"), final))
    diags = {"equil": per[0]["warmup_diag"], "timed": per[0]["diag"]}
    res = {"path": "classic-bucket", "ranks": DD_RANKS, "n_particles": n,
           "rows_per_rank": job["states"][0].n,
           "ncx_local": dcfg.ncx_local, "capacity": dcfg.cells.capacity,
           "spill": dcfg.cells.spill, "steps_per_rebuild": DD_EVERY,
           "steps": steps, "timed_steps": timed_steps,
           "ms_per_step_two_ranks_sharing_one_card":
               1e3 * timed_s / timed_steps,
           "particle_steps_per_s": n * timed_steps / timed_s,
           "diags": diags, "launches": {k: v for k, v in launches.items()
                                        if v},
           "force_evaluations": evals, "kT_end": kt, "spawn_s": spawn_s}
    say("dd-bucket", **res)
    checks = {
        "no pair kernel launched": not any(pair_launches(launches).values()),
        "one hash launch per force evaluation":
            launches["particle_hash"] == evals,
        "overflow == 0": all(d["overflow"] == 0 for d in diags.values()),
        "bonded_missing == 0": all(d["bonded_missing"] == 0
                                   for d in diags.values()),
        "worst_skin_ratio < 1": max(d["worst_skin_ratio"]
                                    for d in diags.values()) < 1.0,
        "N conserved, tags unique": n == n0 and int(
            torch.unique(final.tag[m]).numel()) == n,
        "state finite": all(bool(torch.isfinite(t).all())
                            for t in (final.x, final.v, final.f)),
        "|kT - 1| < 0.01 at the end": abs(kt - 1.0) < 0.01}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dd-bucket failed: {failed}")
    return res


# ---------------------------------------------------------------------------
# cli: the golden decks, the 1M main path, a resume, --dd, --autotune,
# --profile and the observables through python -m meso_tpu_torch
# ---------------------------------------------------------------------------

CLI_DIR = ROOT / "build" / "cli"
GOLDEN_DECKS = ("classic_fluid", "couette", "edpd_slab",
                "membrane_suspension", "poiseuille", "polymer_melt",
                "polymer_special", "tdpd_diffusion")
# JAX's validate decks (tests/unit/test_golden_decks.py:50-53)
VALIDATE_DECKS = ("classic_fluid", "poiseuille", "edpd_slab",
                  "tdpd_diffusion", "polymer_special", "membrane_suspension")
VALIDATE_TOL = 1e-4
# the kernels that take a force evaluation of a pallas deck
CLI_PAIR_KERNELS = ("pair_dpd_v3", "pair_dpd_v3_general", "pair_edpd_v3",
                    "pair_tdpd_v3")
# the main path through a deck: config 1 at L=70, 900 steps, a thermo row
# every 150; from step 600 on every row's kT within 1% of 1 (the random
# start runs hot for its first ~400 steps)
CLI_L, CLI_STEPS, CLI_THERMO = 70.0, 900, 150
CLI_KT_FROM, CLI_KT_TOL = 600, 0.01
CLI_RESUME_STEPS = 30
# --dd 2 on the membrane deck: two of its thermo intervals
CLI_DD_STEPS = 200
CLI_AUTOTUNE_L = 20.0
AUTOTUNE_RELAX_STEPS = 600
RDF_SUBSET, RDF_R_MAX, RDF_BINS = 20_000, 3.0, 60
OBS_REL_TOL = 1e-5

MAIN_DECK = """# config 1 at L={l} through the deck loader (chip_smoke.py)
[box]
lengths = [{l}, {l}, {l}]
[atoms]
density = 3.0
kt = 1.0
create = "random"
init_seed = 0
[pair.dpd]
a = 25.0
gamma = 4.5
rc = 1.0
kt = 1.0
seed = 928459
[integrate]
dt = 0.01
lambda_ = 0.65
[neighbor]
skin = 0.4
rebuild_every = 3
[rng]
mode = "fast"
[engine]
force_path = "pallas"
spill = true
rebuild = "sort"
wrap_mode = "rebuild"
[run]
steps = {steps}
thermo_every = {thermo}
dump_every = {steps}
dump_path = "{out}/main.lammpstrj"
restart_every = {steps}
restart_path = "{out}/main_restart.npz"
"""

AUTOTUNE_DECK = """# config 1 at L={l} for --autotune (chip_smoke.py)
[box]
lengths = [{l}, {l}, {l}]
[atoms]
density = 3.0
kt = 1.0
{start}
[pair.dpd]
a = 25.0
gamma = 4.5
rc = 1.0
kt = 1.0
seed = 928459
[integrate]
dt = 0.01
lambda_ = 0.65
[neighbor]
skin = 0.4
rebuild_every = 3
[rng]
mode = "fast"
[engine]
force_path = "pallas"
rebuild = "sort"
[run]
{run}
"""


class CliRun:
    """``meso_tpu_torch.__main__.main(argv)`` in this process, its standard
    output kept (and written to build/cli/<label>.out), with the loop's
    arguments and end state captured and the launch counts set to 0 just
    before the loop (after the deck's build and set-up) and read just
    after it."""

    def __init__(self, label, argv):
        import contextlib
        import io

        import meso_tpu_torch.__main__ as cli
        self.label = label
        self.loop = None
        real = cli.run_loop

        def spy(system, params, state, plan, logger, timer, runner=None):
            reset_launches()
            code, end = real(system, params, state, plan, logger, timer,
                             runner)
            self.loop = {"system": system, "params": params, "state": end,
                         "launches": read_launches()}
            return code, end

        buf = io.StringIO()
        t0 = time.perf_counter()
        cli.run_loop = spy
        try:
            with contextlib.redirect_stdout(buf):
                self.code = cli.main([*map(str, argv), "--device", DEVICE])
        finally:
            cli.run_loop = real
        self.seconds = time.perf_counter() - t0
        self.out = buf.getvalue()
        (CLI_DIR / f"{label}.out").write_text(self.out)
        if self.code != 0:
            raise AssertionError(f"cli {label}: exit {self.code}:\n"
                                 f"{self.out[-2000:]}")

    def footer(self, phase):
        """Seconds of one phase of the timing footer."""
        for ln in self.out.splitlines():
            parts = ln.split()
            if len(parts) == 4 and parts[0] == phase:
                return float(parts[1])
        raise AssertionError(f"cli {self.label}: no {phase} in the footer")


def jsonl(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


def thermo_rows_ok(rows, steps, every, label):
    """A row at step 0 and every ``every`` steps to ``steps``, each finite."""
    import math
    want = list(range(0, steps + 1, every))
    if want[-1] != steps:
        want.append(steps)
    got = [r["step"] for r in rows]
    bad = [r for r in rows
           if not all(math.isfinite(r[k]) for k in ("temp", "px"))]
    if got != want or bad:
        raise AssertionError(f"cli {label}: thermo steps {got} (want "
                             f"{want}), non-finite rows {bad}")


def state_finite(state):
    import torch
    fields = [state.x, state.v, state.f] + [
        t for t in (state.T, state.C) if t is not None]
    return all(bool(torch.isfinite(t).all()) for t in fields)


def deck_steps(name):
    import tomllib
    with open(ROOT / "tests" / "golden_decks" / f"{name}.toml", "rb") as fh:
        run = tomllib.load(fh)["run"]
    return run["steps"], run["thermo_every"]


def pallas_copy(name):
    """The golden deck on the kernels, written into build/cli/: builder
    decks get force_path "pallas" in [model.args], the explicit deck in
    [engine]."""
    text = (ROOT / "tests" / "golden_decks" / f"{name}.toml").read_text()
    if "[model.args]" in text:
        lines = [ln for ln in text.splitlines()
                 if not ln.strip().startswith("force_path")]
        text = "\n".join(lines).replace(
            "[model.args]", '[model.args]\nforce_path = "pallas"') + "\n"
    else:
        text = text.replace("[run]", '[engine]\nforce_path = "pallas"\n\n'
                            "[run]")
    path = CLI_DIR / f"{name}_pallas.toml"
    path.write_text(text)
    return path


def validate_report(out):
    line = [ln for ln in out.splitlines() if ln.startswith("validate:")][0]
    rep = {}
    for kv in line.split()[1:]:
        k, v = kv.split("=")
        rep[k] = v == "True" if v in ("True", "False") else float(v)
    return rep


def cli_golden(name, pallas):
    """One golden deck through the CLI: exit 0 (no overflow), a finite
    thermo row every thermo_every steps, a finite end state; on the
    kernels, every force evaluation of the loop through K1, K1 general, K2
    or K3 by the launch counters, and --validate on JAX's validate decks
    within VALIDATE_TOL of the dense oracle."""
    steps, every = deck_steps(name)
    label = f"{name}{'_pallas' if pallas else ''}"
    deck = pallas_copy(name) if pallas else \
        ROOT / "tests" / "golden_decks" / f"{name}.toml"
    log = CLI_DIR / f"{label}.jsonl"
    log.unlink(missing_ok=True)
    argv = [deck, "--log", log]
    validate = pallas and name in VALIDATE_DECKS
    if validate:
        argv.append("--validate")
    run = CliRun(label, argv)
    thermo_rows_ok(jsonl(log), steps, every, label)
    if not state_finite(run.loop["state"]):
        raise AssertionError(f"cli {label}: end state not finite")
    res = {"seconds": run.seconds, "steps": steps,
           "run_s": run.footer("run"),
           "force_path": run.loop["system"].force_path,
           "launches": {k: v for k, v in run.loop["launches"].items() if v}}
    if pallas:
        pairs = pair_launches(run.loop["launches"])
        ours = sum(pairs.get(k, 0) for k in CLI_PAIR_KERNELS)
        others = {k: n for k, n in pairs.items()
                  if n and k not in CLI_PAIR_KERNELS}
        if ours != steps or others:
            raise AssertionError(f"cli {label}: {ours} launches of "
                                 f"{CLI_PAIR_KERNELS} for {steps} steps, "
                                 f"others {others}")
    if validate:
        rep = validate_report(run.out)
        res["validate"] = rep
        bad = [k for k in ("max_rel", "dTdt_max_rel", "dCdt_max_rel",
                           "bonded_momentum_rel")
               if k in rep and not rep[k] < VALIDATE_TOL]
        if rep.get("bonded_missing", 0) or not rep.get("bonded_finite",
                                                       True):
            bad.append("bonded")
        if bad:
            raise AssertionError(f"cli {label}: validate {bad}: {rep}")
    return res


def cli_main_path(main_ms):
    """The 1M main path through a deck of config 1: K1's launches equal
    the steps, every row's kT from CLI_KT_FROM on within CLI_KT_TOL of 1,
    a dump, a binary frame and a restart of the end state, ms/step from
    the footer's run phase beside phase 6's."""
    from meso_tpu_torch.io.dump import read_frames_bin, write_frame_bin
    deck = CLI_DIR / "main.toml"
    deck.write_text(MAIN_DECK.format(l=CLI_L, steps=CLI_STEPS,
                                     thermo=CLI_THERMO, out=CLI_DIR))
    log = CLI_DIR / "main.jsonl"
    log.unlink(missing_ok=True)
    (CLI_DIR / "main.lammpstrj").unlink(missing_ok=True)
    run = CliRun("main", [deck, "--log", log])
    rows = jsonl(log)
    thermo_rows_ok(rows, CLI_STEPS, CLI_THERMO, "main")
    state = run.loop["state"]
    n = int(state.n_valid())
    write_frame_bin(str(CLI_DIR / "main.bin"), state, append=False)
    (frame,) = read_frames_bin(str(CLI_DIR / "main.bin"))
    dump_atoms = int((CLI_DIR / "main.lammpstrj").read_text(
        ).split("ITEM: NUMBER OF ATOMS\n")[1].split("\n")[0])
    launches = run.loop["launches"]
    run_s = run.footer("run")
    kts = {r["step"]: r["temp"] for r in rows}
    late = {s: t for s, t in kts.items() if s >= CLI_KT_FROM}
    res = {"n_particles": n, "steps": CLI_STEPS, "seconds": run.seconds,
           "run_s": run_s, "ms_per_step": 1e3 * run_s / CLI_STEPS,
           "phase6_ms_per_step": main_ms, "kT_rows": kts,
           "skin_ratio_rows": [r.get("skin_ratio") for r in rows[1:]],
           "capacity": run.loop["system"].cells.capacity,
           "launches": {k: v for k, v in launches.items() if v},
           "dump_atoms": dump_atoms, "bin_atoms": int(frame["tag"].size)}
    say("cli-main", **res)
    checks = {
        "pair_dpd_v3 launches == steps, no other pair kernel":
            pair_launches(launches) == {
                **{k: 0 for k in pair_launches(launches)},
                "pair_dpd_v3": CLI_STEPS},
        "hash launches == steps": launches["particle_hash"] == CLI_STEPS,
        f"kT within {CLI_KT_TOL} of 1 from step {CLI_KT_FROM}":
            bool(late) and all(abs(t - 1.0) <= CLI_KT_TOL
                               for t in late.values()),
        "state finite": state_finite(state),
        "dump and frame hold every particle": dump_atoms == n == int(
            frame["tag"].size),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cli main failed: {failed}: {res}")
    return res, run.loop


def cli_resume(loop):
    """The 1M restart resumed through the library, as JAX's
    test_restart_resume_is_deterministic: CLI_RESUME_STEPS straight
    through against half, a save and a load, and the other half; the end
    states bitwise equal by tag."""
    import torch
    from meso_tpu_torch.core.system import run_bucket_chunked
    from meso_tpu_torch.io.restart import load_restart, save_restart
    system, params = loop["system"], loop["params"]
    every = system.cells.rebuild_every
    half = CLI_RESUME_STEPS // 2 // every

    def run(st, chunks):
        return run_bucket_chunked(system, params, st, chunks, every,
                                  thermo_trace=False)[0]

    start = load_restart(str(CLI_DIR / "main_restart.npz"), device=DEVICE)
    t0 = time.perf_counter()
    straight = run(start, 2 * half)
    mid = run(start, half)
    save_restart(str(CLI_DIR / "resume_mid.npz"), mid)
    resumed = run(load_restart(str(CLI_DIR / "resume_mid.npz"),
                               device=DEVICE), half)

    def by_tag(st):
        order = torch.argsort(st.tag[st.mask])
        return [t[st.mask][order] for t in (st.x, st.v, st.f, st.image)]

    same = all(torch.equal(a, b) for a, b in zip(by_tag(straight),
                                                 by_tag(resumed)))
    res = {"from_step": start.step, "steps": 2 * half * every,
           "end_step": resumed.step, "bitwise_by_tag": same,
           "seconds": time.perf_counter() - t0}
    say("cli-resume", **res)
    if not same or resumed.step != straight.step:
        raise AssertionError(f"cli resume not bitwise: {res}")
    return res, straight


def cli_dd():
    """--dd 2 on the membrane deck (its l = 10.4 gives 8 cell columns, 4 a
    rank): two gloo ranks sharing the card; exit 0, bonded_missing 0 in
    every row, N and the tags kept (the restart written from the gathered
    end state)."""
    import torch
    from meso_tpu_torch.io.restart import load_restart
    steps, every = CLI_DD_STEPS, deck_steps("membrane_suspension")[1]
    text = (ROOT / "tests" / "golden_decks" /
            "membrane_suspension.toml").read_text()
    deck = CLI_DIR / "membrane_dd.toml"
    deck.write_text(text + f'restart_every = {steps}\n'
                    f'restart_path = "{CLI_DIR}/membrane_dd.npz"\n')
    log = CLI_DIR / "membrane_dd.jsonl"
    log.unlink(missing_ok=True)
    run = CliRun("membrane_dd", [deck, "--dd", "2", "--log", log,
                                 "--steps", steps])
    rows = jsonl(log)
    thermo_rows_ok(rows, steps, every, "membrane_dd")
    end = load_restart(str(CLI_DIR / "membrane_dd.npz"), device="cpu")
    tags = end.tag[end.mask]
    n0 = int(round(3.0 * 10.4 ** 3))
    res = {"ranks": 2, "steps": steps, "seconds": run.seconds,
           "run_s": run.footer("run"),
           "bonded_missing": [r["bonded_missing"] for r in rows[1:]],
           "n_particles": int(tags.numel()), "n_start": n0,
           "tags_unique": int(torch.unique(tags).numel()) == tags.numel(),
           "end_step": end.step, "kT_rows": [r["temp"] for r in rows]}
    say("cli-dd", **res)
    if any(res["bonded_missing"]) or res["n_particles"] != n0 or \
            not res["tags_unique"] or end.step != steps:
        raise AssertionError(f"cli dd failed: {res}")
    return res


def cli_autotune_profile():
    """--autotune on a classic deck at CLI_AUTOTUNE_L on the kernels, from
    a relaxed start that the deck reads with ``create = "read_data"`` (a
    random start runs hot for its first hundreds of steps, and no
    candidate stays inside its skin there): the chosen candidate's skin
    ratio <= 1. --profile on the golden classic deck on the kernels (two
    thermo intervals, the second traced): a trace in build/cli/prof."""
    import numpy as np

    import meso_tpu_torch.utils.autotune as at
    from meso_tpu_torch.io.restart import load_restart
    l = CLI_AUTOTUNE_L
    relax = CLI_DIR / "autotune_relax.toml"
    relax.write_text(AUTOTUNE_DECK.format(
        l=l, start='create = "random"', run=(
            f"steps = {AUTOTUNE_RELAX_STEPS}\nthermo_every = "
            f"{AUTOTUNE_RELAX_STEPS}\nrestart_every = "
            f"{AUTOTUNE_RELAX_STEPS}\n"
            f'restart_path = "{CLI_DIR}/autotune_relaxed.npz"')))
    CliRun("autotune_relax", [relax])
    st = load_restart(str(CLI_DIR / "autotune_relaxed.npz"), device="cpu")
    np.savez(CLI_DIR / "autotune_start.npz",
             x=st.box.wrap(st.x)[0][st.mask].numpy(),
             v=st.v[st.mask].numpy(), box_hi=st.box.hi.numpy())
    text = AUTOTUNE_DECK.format(
        l=l, start=f'create = "read_data"\nfile = "{CLI_DIR}/'
        'autotune_start.npz"', run="steps = 30\nthermo_every = 30")
    deck = CLI_DIR / "autotune.toml"
    deck.write_text(text)
    chosen = []
    real = at.autotune_fluid

    def spy(*a, **kw):
        best, results = real(*a, **kw)
        chosen.append((best, results))
        return best, results

    at.autotune_fluid = spy
    try:
        tune = CliRun("autotune", [deck, "--autotune"])
    finally:
        at.autotune_fluid = real
    best, results = chosen[0]
    prof_dir = CLI_DIR / "prof"
    trace = prof_dir / "trace.json"
    trace.unlink(missing_ok=True)
    # two thermo intervals of the classic deck on the kernels: the second
    # is traced
    steps, every = deck_steps("classic_fluid")
    prof = CliRun("profile", [pallas_copy("classic_fluid"), "--profile",
                              prof_dir, "--steps", 2 * every])
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    res = {"autotune": {"seconds": tune.seconds,
                        "candidates_measured": len(results),
                        "best": {k: getattr(best, k) for k in (
                            "skin", "rebuild_every", "ms_per_step",
                            "skin_ratio", "spill", "pair_kernel",
                            "rebuild", "capacity", "wrap_mode")}},
           "profile": {"seconds": prof.seconds,
                       "trace_bytes": trace.stat().st_size,
                       "events": len(events), "kernel_events": kernels}}
    say("cli-autotune-profile", **res)
    if not best.skin_ratio <= 1.0 or not events or (
            DEVICE == "cuda" and not kernels):
        raise AssertionError(f"cli autotune/profile failed: {res}")
    return res


def cli_observables(inputs, system, params):
    """rdf of the RDF_SUBSET rows, msd of ``b`` against ``a`` and the
    pressure profile along x of the strict re-laid state (the inputs of
    ``cli_observables_inputs``), on the inputs' device."""
    from meso_tpu_torch.obs import msd, rdf, unwrapped
    from meso_tpu_torch.obs.stress import pressure_profile
    a, b, sub = inputs["a"], inputs["b"], inputs["sub"]
    return {"rdf": rdf(sub.x, sub.mask, sub.box, RDF_R_MAX, RDF_BINS),
            "msd": msd(b.x, b.image, unwrapped(a.x, a.image, a.box), b.mask,
                       b.box),
            "pressure": pressure_profile(system, params, inputs["relaid"],
                                         0, 10)}


def cli_observables_inputs(loop, later):
    """The observables' inputs from the 1M end state (``loop``) and the
    state ``later`` (both in tag order): the first RDF_SUBSET particles
    for rdf, both states for msd, and the end state re-laid on strict
    buckets (the sweep's layout) at the least capacity that places it,
    with the system on those cells."""
    import torch
    from meso_tpu_torch.core.state import PER_PARTICLE
    from meso_tpu_torch.neighbor.bucket_layout import (rebuild_buckets,
                                                       to_bucket_state)
    from meso_tpu_torch.neighbor.cells import CellConfig

    def by_tag(st):
        rows = torch.nonzero(st.mask).squeeze(1)
        rows = rows[torch.argsort(st.tag[rows])]
        return st.replace(**{f: getattr(st, f)[rows] for f in PER_PARTICLE
                             if getattr(st, f) is not None})

    a, b = by_tag(loop["state"]), by_tag(later)
    system = loop["system"]
    sub = a.replace(x=a.box.wrap(a.x)[0][:RDF_SUBSET],
                    mask=a.mask[:RDF_SUBSET])
    x, image = a.box.wrap(a.x, a.image)
    wrapped = a.replace(x=x, image=image)
    strict = CellConfig.for_box([float(v) for v in a.box.lengths], 1.0, 3.0,
                                skin=system.cells.skin)
    # the sweep's work goes as K^2: take the least K that holds this state
    k = next(k for k in range(4, strict.capacity + 1)
             if int(rebuild_buckets(wrapped, strict.replace(capacity=k))[1])
             == 0)
    strict = strict.replace(capacity=k)
    return ({"sub": sub, "a": a, "b": b,
             "relaid": to_bucket_state(wrapped, strict)},
            system.replace(cells=strict))


def cli_observables_cpu(in_path, out_path):
    """The CPU copy's observables, in a process of their own
    (``--cli-obs-cpu IN OUT``): inputs and results through torch.save."""
    import torch
    data = torch.load(in_path, weights_only=False)
    torch.set_num_threads(data["threads"])
    t0 = time.perf_counter()
    res = cli_observables(data["inputs"], data["system"], data["params"])
    res["seconds"] = time.perf_counter() - t0
    torch.save(res, out_path)


def cli_observables_compare(card, cpu):
    """The card's observables against the CPU copy's: within OBS_REL_TOL
    relative (rdf: counts within one pair a bin)."""
    import numpy as np
    res = {}
    g_c, g_p = card["rdf"][1].cpu().numpy(), cpu["rdf"][1].numpy()
    centers = cpu["rdf"][0].numpy()
    n = RDF_SUBSET
    ideal = n / (CLI_L ** 3) * 4.0 / 3.0 * np.pi * np.diff(
        (np.arange(RDF_BINS + 1) * RDF_R_MAX / RDF_BINS) ** 3) * n
    count_diff = np.abs(np.rint(g_c * ideal) - np.rint(g_p * ideal))
    res["rdf_max_count_diff"] = float(count_diff.max())
    res["rdf_max_rel"] = float(np.max(np.abs(g_c - g_p)) / np.max(
        np.abs(g_p)))
    res["rdf_peak"] = [float(centers[np.argmax(g_p)]), float(g_p.max())]
    m_c, m_p = float(card["msd"]), float(cpu["msd"])
    res["msd"], res["msd_rel"] = m_p, abs(m_c - m_p) / abs(m_p)
    p_c, p_p = card["pressure"][1].cpu().numpy(), \
        cpu["pressure"][1].numpy()
    res["pressure_max_rel"] = float(np.max(np.abs(p_c - p_p)) / np.max(
        np.abs(p_p)))
    res["pressure_profile"] = [float(v) for v in p_p]
    ok = (res["rdf_max_count_diff"] <= 1 and res["msd_rel"] <= OBS_REL_TOL
          and res["pressure_max_rel"] <= OBS_REL_TOL)
    return res, ok


def phase_cli(main_ms=None):
    """The CLI phase: the 1M main path through a deck, its restart resumed
    bitwise, rdf, msd and pressure_profile on its end state on the card
    (against a CPU copy computed in a process of its own while the card
    runs the rest), the golden decks as shipped and on the kernels (with
    --validate), the module entry point in a subprocess, --dd 2 on the
    membrane deck, --autotune and --profile. Writes into build/cli/."""
    import torch
    from meso_tpu_torch.parallel.launch import on_device, params_on
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    rec = {"shipped": {}, "pallas": {}}
    rec["main"], loop = cli_main_path(main_ms)
    rec["resume"], later = cli_resume(loop)
    inputs, strict_sys = cli_observables_inputs(loop, later)
    t1 = time.perf_counter()
    card = cli_observables(inputs, strict_sys, loop["params"])
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    # the CPU copy takes minutes at 1M: a process of its own on all but
    # two of this process's cores, beside the card's steps that follow
    cores = sorted(os.sched_getaffinity(0))
    obs_in, obs_out = CLI_DIR / "obs_inputs.pt", CLI_DIR / "obs_cpu.pt"
    obs_out.unlink(missing_ok=True)
    torch.save({"inputs": {k: on_device(v, "cpu") for k, v in
                           inputs.items()},
                "system": strict_sys, "params": params_on(loop["params"],
                                                          "cpu"),
                "threads": max(1, len(cores) - 2)}, obs_in)
    del loop, later, inputs
    worker = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--cli-obs-cpu", str(obs_in), str(obs_out)])
    try:
        if len(cores) > 2:
            os.sched_setaffinity(worker.pid, cores[2:])
        for name in GOLDEN_DECKS:
            rec["shipped"][name] = cli_golden(name, pallas=False)
            say("cli-deck", deck=name, **rec["shipped"][name])
        for name in GOLDEN_DECKS:
            rec["pallas"][name] = cli_golden(name, pallas=True)
            say("cli-deck-pallas", deck=name, **rec["pallas"][name])
        # the module entry point in its own process
        log = CLI_DIR / "subprocess.jsonl"
        log.unlink(missing_ok=True)
        ts = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "meso_tpu_torch",
             str(CLI_DIR / "classic_fluid_pallas.toml"), "--log", str(log),
             "--device", DEVICE],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise AssertionError(f"python -m meso_tpu_torch: exit "
                                 f"{proc.returncode}\n{proc.stderr[-2000:]}")
        steps, every = deck_steps("classic_fluid")
        thermo_rows_ok(jsonl(log), steps, every, "subprocess")
        rec["subprocess"] = {"seconds": time.perf_counter() - ts,
                             "rows": len(jsonl(log))}
        say("cli-subprocess", **rec["subprocess"])
        rec["dd"] = cli_dd()
        rec["autotune_profile"] = cli_autotune_profile()
        tw = time.perf_counter()
        code = worker.wait(timeout=900)
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    if code:
        raise AssertionError(f"cli observables: the CPU copy exited {code}")
    cpu = torch.load(obs_out, weights_only=False)
    obs, ok = cli_observables_compare(card, cpu)
    rec["observables"] = {**obs, "card_s": card_s, "cpu_s": cpu["seconds"],
                          "cpu_wait_s": time.perf_counter() - tw,
                          "strict_capacity": strict_sys.cells.capacity}
    say("cli-observables", **rec["observables"])
    if not ok:
        raise AssertionError(f"cli observables off: {rec['observables']}")
    del card, cpu
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    say("cli", seconds=rec["seconds"])
    return rec


# --ab: two trees' kernels and main path on one card, a process a run, in
# the order parent, change, change, parent per round
AB_ROUNDS = 2
AB_POLYMER_STEPS = 150
# outputs of --ab that the trees share within AB_BONDS_REL_TOL of their
# largest value, not bitwise: the plain chain's bonded sums are atomics in
# no fixed order
AB_TOLERANT = ("bonds ",)
AB_BONDS_REL_TOL = 1e-6


def ab_one(out_path):
    """One run of --ab in this process's meso_tpu_torch (the tree --ab-one
    put first on sys.path): the main path (set-up, EQUIL_CHUNKS, then
    TIMED_CHUNKS in TIMED_BLOCKS blocks, each timed), K1 through its
    wrapper at the main-path shape, K5's classic brick kernel alone and K6
    through its wrapper on their 1M paths' inputs, K1's general variant (walls, polymers), K2 and
    K3 through their wrappers on their paths' inputs, and the eDPD path
    (transport-full's equilibration, then its timed steps); and the kernel
    outputs the trees must share bitwise, saved to ``out_path``: K1 on
    kernels-l8's cases and at the main-path shape, the selectors' entry
    points on BRICK_TILE_CASES and on the v2 and banded classic paths'
    inputs, K1's
    general variant and K3 on their paths' inputs."""
    import torch
    import meso_tpu_torch
    from meso_tpu_torch.core.system import run_bucket_chunked
    from meso_tpu_torch.kernels.pair_dpd_v3 import bucket_forces_pallas_v3
    from meso_tpu_torch.ops.dpd import DPDParams
    res = {"package": str(Path(meso_tpu_torch.__file__).parent.parent)}
    outputs = {}
    system, params, state = classic_path()
    state, _ = run_bucket_chunked(system, params, state, EQUIL_CHUNKS, EVERY,
                                  thermo_trace=False)
    torch.cuda.synchronize()
    block_ms = []
    for chunks in timed_blocks():
        tb = time.perf_counter()
        state, _ = run_bucket_chunked(system, params, state, chunks, EVERY,
                                      thermo_trace=False)
        torch.cuda.synchronize()
        block_ms.append(1e3 * (time.perf_counter() - tb) / (chunks * EVERY))
    res["main_ms_per_step"] = sum(
        ms * c for ms, c in zip(block_ms, timed_blocks())) / TIMED_CHUNKS
    res["main_block_ms_per_step"] = block_ms
    outputs["main path end x"] = state.x
    del system, params, state
    dpd = DPDParams.build(a=25.0, gamma=4.5, rc=1.0, kt=1.0, seed=77,
                          device=DEVICE)
    for spill in (True, False):
        for min_image in (False, True):
            for rng_mode in ("fast", "tea"):
                bst, cfg = bucket_case(8.0, 1536, spill, min_image)
                outputs[f"K1 l8 spill={spill} min_image={min_image} "
                        f"{rng_mode}"] = bucket_forces_pallas_v3(
                    bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, 42,
                    dpd, 0.01, cfg, rng_mode=rng_mode)
    bst, cfg = bucket_case(L_MAIN, int(round(3.0 * L_MAIN ** 3)), True,
                           False)
    k1_args = (bst.x, bst.v, bst.typ, bst.tag, bst.mask, bst.box, 42, dpd,
               0.01, cfg)
    outputs["K1 L70"] = bucket_forces_pallas_v3(*k1_args)
    res["k1_ms"] = timed_ms(lambda: bucket_forces_pallas_v3(
        *k1_args, need_virial=False), 20)
    # the slot assignment at the main-path shape (the parent's may be its
    # plain torch version)
    from meso_tpu_torch.neighbor.bucket_layout import spill_assign
    assign_args = assign_inputs(bst, cfg)
    for wrap in (True, False):
        outputs[f"spill_assign L70 wrap={wrap}"] = spill_assign(
            *assign_args, wrap=wrap)
    outputs["spill_assign L70 brick"] = spill_assign(
        *assign_inputs(bst, cfg, brick=True), wrap=False)
    res["spill_assign_ms"] = timed_ms(lambda: spill_assign(*assign_args), 20)
    del bst, k1_args, assign_args
    phase_brick_tiles(keep=outputs)
    for sel in ("v2", "banded"):
        system, sparams, st = classic_path(sel)
        name = SELECTOR_KERNELS[sel]["dpd"]
        outputs[f"{name} path"] = run_entry(name, False, st, None, 1,
                                            sparams.pair, system.dt,
                                            system.cells)
        if name == K6_ROWS:
            # the brick kernel in trees from before K6 read the rows in
            # place: through the wrapper in both
            res[f"{name}_ms"] = timed_ms(lambda: run_entry(
                name, False, st, None, 1, sparams.pair, system.dt,
                system.cells), 20)
        else:
            brick = entry_brick(name, st, None, 1, sparams.pair,
                                system.cells)
            res[f"{name}_kernel_ms"] = kernel_alone_ms(
                name, brick, st.box, 1, sparams.pair, system.dt,
                system.cells)
            del brick
        del system, sparams, st
    # K1's general variant, K2 and K3 through their wrappers on their
    # paths' inputs at set-up (the parent's may be another design), their
    # outputs kept but K2's (a redesign may move it by ulps)
    for label, build in (("walls", walls_path), ("polymer", polymer_path),
                         ("tdpd", lambda: transport_path("tdpd")),
                         ("edpd", lambda: transport_path("edpd"))):
        system, sparams, st = build()
        if label in ("edpd", "tdpd"):
            fn = transport_fns(label)[0]
            args = (st.x, st.v, st.T if label == "edpd" else st.C, st.typ,
                    st.tag, st.mask, st.box, 1, sparams.pair, system.dt,
                    system.cells)
        else:
            fn = bucket_forces_pallas_v3
            args = (st.x, st.v, st.typ, st.tag, st.mask, st.box, 1,
                    sparams.pair, system.dt, system.cells)
        if label != "edpd":
            outputs[f"{label} path kernel"] = fn(*args)
        res[f"{label}_kernel_ms"] = timed_ms(lambda: fn(*args), 20)
        del args
        if label == "polymer":
            # the bonded force (the parent's may be the plain chain, whose
            # atomics are not bitwise) and the polymer path's steps
            from meso_tpu_torch.ops.bonded import bonded_forces
            bargs = (st.x, st.tag, st.mask, st.box, sparams.bonded,
                     system.bond_style, system.n_tags)
            outputs["bonds polymer path"] = bonded_forces(*bargs)
            res["bonds_ms"] = timed_ms(lambda: bonded_forces(*bargs), 20)
            st, _ = advance(system, sparams, st, 30 * EVERY)
            torch.cuda.synchronize()
            tb = time.perf_counter()
            st, _ = advance(system, sparams, st, AB_POLYMER_STEPS)
            torch.cuda.synchronize()
            res["polymer_ms_per_step"] = 1e3 * (
                time.perf_counter() - tb) / AB_POLYMER_STEPS
        if label == "edpd":
            # the eDPD path as transport-full times it
            st, _ = advance(system, sparams, st,
                            TRANSPORT_EQUIL_CHUNKS * TRANSPORT_EVERY,
                            TRANSPORT_EVERY)
            torch.cuda.synchronize()
            tb = time.perf_counter()
            st, _ = advance(system, sparams, st,
                            TRANSPORT_TIMED_CHUNKS * TRANSPORT_EVERY,
                            TRANSPORT_EVERY)
            torch.cuda.synchronize()
            res["edpd_ms_per_step"] = 1e3 * (time.perf_counter() - tb) / (
                TRANSPORT_TIMED_CHUNKS * TRANSPORT_EVERY)
        del system, sparams, st
    torch.save({k: [t.cpu() for t in (v if isinstance(v, tuple) else (v,))
                    if t is not None] for k, v in outputs.items()}, out_path)
    say("ab-run", **res)
    return res


def phase_ab(parent, rounds=AB_ROUNDS):
    """--ab PARENT: ab_one in the tree at PARENT (a checkout of the parent
    commit, unpacked inside the repository) and in this one, each run its
    own process, rounds of parent, change, change, parent; then every
    output of the change's runs against the parent's first, bitwise."""
    import torch
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"parent": str(Path(parent).resolve()), "change": str(ROOT)}
    runs = []
    for r in range(rounds):
        for i, which in enumerate(("parent", "change", "change", "parent")):
            out = out_dir / f"{r}-{i}-{which}.pt"
            proc = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--ab-one",
                 trees[which], str(out)], capture_output=True, text=True,
                timeout=900, cwd=ROOT)
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("[ab-run] ")]
            if proc.returncode or not line:
                raise AssertionError(f"--ab-one {which} failed "
                                     f"({proc.returncode}):\n"
                                     f"{proc.stdout[-3000:]}"
                                     f"{proc.stderr[-3000:]}")
            runs.append({"which": which, "out": out,
                         **json.loads(line[0][len("[ab-run] "):])})
            say("ab", round=r,
                **{k: v for k, v in runs[-1].items() if k != "out"})
    ref = torch.load(next(r["out"] for r in runs if r["which"] == "parent"))

    def same(key, a, b):
        if not key.startswith(AB_TOLERANT):
            return torch.equal(a, b)
        return bool((a - b).abs().max() <= AB_BONDS_REL_TOL
                    * b.abs().max())

    differ = {}
    for r in runs:
        got = torch.load(r["out"])
        bad = sorted(k for k in ref if k not in got or len(got[k]) !=
                     len(ref[k]) or not all(same(k, a, b) for a, b in
                                            zip(got[k], ref[k])))
        if bad:
            differ[f"{r['which']} {r['out'].name}"] = bad
    summary = {
        which: {k: [r[k] for r in runs if r["which"] == which]
                for k in ("main_ms_per_step", "k1_ms", "spill_assign_ms",
                          "pair_fused_dpd_kernel_ms",
                          "pair_banded_dpd_ms", "walls_kernel_ms",
                          "polymer_kernel_ms", "tdpd_kernel_ms",
                          "edpd_kernel_ms", "edpd_ms_per_step", "bonds_ms",
                          "polymer_ms_per_step")}
        for which in ("parent", "change")}
    say("ab-summary", outputs=len(ref), differ=differ, **summary)
    # the main path's end state may differ by the rebuild's own
    # nondeterminism; every kernel output must not
    kernel_differ = {k: [b for b in v if b != "main path end x"]
                     for k, v in differ.items()}
    if any(kernel_differ.values()):
        raise AssertionError(f"kernel outputs differ between the trees: "
                             f"{kernel_differ}")
    return {"runs": [{k: v for k, v in r.items() if k != "out"}
                     for r in runs], "differ": differ, **summary}


# how the profiler names a kernel of csrc/ (each file's kernels sit in an
# anonymous namespace)
PORT_KERNEL_PREFIX = "void (anonymous namespace)::"
# the profiled path and the kernel's name (up to its template arguments)
# of each row of the kernels line that a profiled path runs
IN_PATH = {"pair_dpd_v3": ("classic", "pair_dpd_v3_kernel<"),
           "particle_hash": ("classic", "particle_hash_kernel<"),
           "spill_assign": ("classic", "spill_assign_kernel<"),
           "pair_dpd_v3_general": ("walls", "pair_dpd_v3_general_kernel"),
           "pair_bonds": ("polymer", "pair_bonds_kernel<"),
           "pair_edpd_v3": ("edpd", "pair_edpd_v3_kernel"),
           "pair_tdpd_v3": ("tdpd", "pair_tdpd_v3_kernel"),
           **{SELECTOR_KERNELS[sel][model]: (f"{sel}-{label}",
                                             "pair_brick_kernel<")
              for sel in ("v2", "banded")
              for model, label in (("dpd", "classic"), ("edpd", "edpd"),
                                   ("tdpd", "tdpd"))},
           # K6 reads the bucket rows on one card: K1's general variant
           "pair_banded_dpd": ("banded-classic",
                               "pair_dpd_v3_general_kernel<0, true")}
PORT_KERNELS = tuple(sorted({PORT_KERNEL_PREFIX + kernel
                             for _, kernel in IN_PATH.values()}))


def in_path_ms(profiles, name):
    """A kernel's device time a call on the profiled path that runs it
    (IN_PATH), or None where no profiled path runs it."""
    if name not in IN_PATH:
        return None
    path, kernel = IN_PATH[name]
    hits = [e for e in profiles[path]["port"]
            if e["kernel"].startswith(PORT_KERNEL_PREFIX + kernel)]
    calls = sum(e["calls"] for e in hits)
    if not calls:
        raise AssertionError(f"the profile of {path} lists no {kernel}")
    return sum(e["ms_per_chunk"] for e in hits) * PROFILE_CHUNKS / calls


def tile_row_fields(rec):
    """What a bucket-row tile kernel's row (K1's general variant, K2, K3)
    adds to the contract's keys: its tile plan and slot tests a valid
    row."""
    return {k: rec[k] for k in ("width", "smem_bytes", "blocks_per_sm",
                                "tests_per_valid_row")}


def brick_row_fields(rec):
    """What a brick kernel's row adds to the contract's keys, as K1's row
    does: its tile plan, slot tests a valid row, and its time alone
    (kernel_ms; "ms" is through the wrapper, the brick's build
    included)."""
    return {k: rec[k] for k in ("width", "smem_bytes", "blocks_per_sm",
                                "tests_per_valid_row", "kernel_ms")}


def kernel_records(record):
    """The kernels' JSON record: every kernel of the ported paths, with its
    launches on the path that runs it (K1 and the hash: the classic main
    path; K2: the eDPD path; K3: the tDPD path)."""
    l70 = record["kernels"]["l70"]
    tl70 = record["transport_kernels"]["l70"]
    k1_launches = record["main_path"]["launches"]
    full = record["transport_full"]
    k1_src = "meso_tpu_torch/csrc/pair_dpd_v3.cu"
    tr_src = "meso_tpu_torch/csrc/pair_transport_v3.cu"
    rows = [
        {"name": "pair_dpd_v3", "route": "cuda", "source": k1_src,
         "replaces": "meso_tpu/kernels/pair_dpd_v3.py:75",
         "launches": k1_launches["pair_dpd_v3"],
         "max_abs_err": l70["max_abs_err"], "ms": l70["pair_ms"],
         "plain_ms": l70["pair_plain_ms"], "bound_ms": l70["pair_bound_ms"],
         "bound_by": l70["pair_bound_by"], "library_ms": None,
         "width": l70["plan"]["width"],
         "smem_bytes": l70["plan"]["smem_bytes"],
         "blocks_per_sm": l70["blocks_per_sm"],
         "tests_per_valid_row": l70["tests_per_valid_row"]},
        {"name": "particle_hash", "route": "cuda", "source": k1_src,
         "replaces": "meso_tpu/kernels/pair_dpd_v3.py:161",
         "launches": k1_launches["particle_hash"],
         "max_abs_err": l70["hash_max_abs_err"],
         # "ms" through particle_hash_v3, as on every row through its
         # wrapper; launch_ms through launch_hash, the paths' call (events
         # around back-to-back calls time the host's launches: longer than
         # the kernel, whose time on the main path is in_path_ms)
         "ms": l70["hash_ms"], "launch_ms": l70["hash_kernel_ms"],
         "odd_rows": l70["hash_odd_rows"],
         "odd_launch_ms": l70["hash_odd_kernel_ms"],
         "plain_ms": l70["hash_plain_ms"], "bound_ms": l70["hash_bound_ms"],
         "bound_by": l70["hash_bound_by"], "library_ms": None,
         # its bound's instructions a row, counted from the built library
         "ops_per_row": l70["hash_ops_per_row"]},
        # the spill rebuild's slot assignment (no TPU kernel: XLA code in
        # the JAX package), once a rebuild of the main path, inside the
        # rebuild's one host call (bucket_rebuild) but at set-up
        {"name": "spill_assign", "route": "cuda",
         "source": "meso_tpu_torch/csrc/bucket_assign.cu",
         "replaces": None, "launches": k1_launches["spill_assign"]
         + k1_launches["bucket_rebuild"],
         "max_abs_err": 0, "ms": l70["assign_ms"],
         "plain_ms": l70["assign_plain_ms"],
         "bound_ms": l70["assign_bound_ms"],
         "bound_by": l70["assign_bound_by"], "library_ms": None}]
    # K1's general variant: its launches on both paths that run it, its
    # numbers on walls-full's inputs (two types; polymer-full's are in
    # build/chip_smoke.json and PERF.md)
    gl70 = record["general_kernels"]["l70"]
    gen = gl70["walls"]
    rows.append(
        {"name": "pair_dpd_v3_general", "route": "cuda", "source": k1_src,
         "replaces": "meso_tpu/kernels/pair_dpd_v3.py:75",
         "launches": sum(record[p]["launches"]["pair_dpd_v3_general"]
                         for p in ("walls_full", "polymer_full")),
         "max_abs_err": max(gl70[p]["max_abs_err"]
                            for p in ("walls", "polymer")),
         "ms": gen["ms"], "plain_ms": gen["plain_ms"],
         "bound_ms": gen["bound_ms"], "bound_by": gen["bound_by"],
         "library_ms": None, **tile_row_fields(gen)})
    # the pair bonds (no TPU kernel: XLA code in the JAX package): the
    # numbers on the melt's inputs (harmonic), the launches of the polymer
    # path (FENE), a call a step
    bk = record["bond_kernels"]["harmonic"]
    rows.append(
        {"name": "pair_bonds", "route": "cuda",
         "source": "meso_tpu_torch/csrc/bonds.cu", "replaces": None,
         "launches": record["polymer_full"]["launches"]["pair_bonds"],
         "max_abs_err": max(r["max_rel_err_cpu_plain"]
                            for r in record["bond_kernels"].values()),
         "ms": bk["ms"], "kernel_ms": bk["kernel_ms"],
         "tag_rows_ms": bk["tag_rows_ms"], "plain_ms": bk["plain_ms"],
         "bound_ms": bk["bound_ms"], "bound_by": bk["bound_by"],
         "library_ms": None, "calls_a_step": bk["calls_a_step"],
         "melt_in_path_ms": bk["in_path_ms"] + bk["tag_rows_in_path_ms"]})
    # K2's and K3's numbers are those at the inputs their path gives them
    for model, line in (("edpd", 871), ("tdpd", 896)):
        name = f"pair_{model}_v3"
        rec = tl70[f"{model}_path"]
        rows.append(
            {"name": name, "route": "cuda", "source": tr_src,
             "replaces": f"meso_tpu/kernels/pair_dpd_v3.py:{line}",
             "launches": full[model]["launches"][name],
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": None,
             **tile_row_fields(rec), "ptxas": rec["ptxas"]})
    # K5, K6 and K7: the numbers at their own 1M path's inputs, the
    # launches of that path's run
    sk = record["selector_kernels_l70"]
    replaces = {"v2": "meso_tpu/kernels/pair_dpd_fused.py:63",
                "banded-dpd": "meso_tpu/kernels/pair_dpd.py:60",
                "banded": "meso_tpu/kernels/pair_multiphysics.py:40"}
    for sel in ("v2", "banded"):
        for model in ("dpd", "edpd", "tdpd"):
            name = SELECTOR_KERNELS[sel][model]
            rec = sk[f"{sel}-{model}"]
            # K6 reads the bucket rows on K1's general variant: its time
            # alone and its tile plan are that kernel's, and the brick
            # kernel's time on its inputs rides beside them
            fields = ({**tile_row_fields(rec), "kernel_ms": rec["kernel_ms"],
                       "brick_kernel_ms": rec["brick_kernel_ms"]}
                      if name == K6_ROWS else brick_row_fields(rec))
            rows.append(
                {"name": name, "route": "cuda",
                 "source": k1_src if name == K6_ROWS
                 else "meso_tpu_torch/csrc/pair_brick.cu",
                 "replaces": replaces.get(f"{sel}-{model}", replaces[sel]),
                 "launches": record["selector_full"][f"{sel}-{model}"][
                     "launches"][name],
                 "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                 "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                 "bound_by": rec["bound_by"], "library_ms": None,
                 **fields})
    # K4 and K6-halo, one row for each two-rank path: the numbers on its
    # rank-0 inputs, the launches of both ranks on that path (K4 runs the
    # classic path and, with exclusions, the polymer one: "pair_halo_dpd"
    # and "pair_halo_dpd/polymer")
    dk, dp = record["dd_kernels_l70"], record["dd_paths"]
    for label in ("classic", "polymer", "banded", "edpd", "tdpd"):
        name, rec = dd_kernel_of(label), dk[label]
        rows.append(
            {"name": name + ("/polymer" if label == "polymer" else ""),
             "path": label, "route": "cuda",
             "source": "meso_tpu_torch/csrc/pair_brick.cu",
             "replaces": HALO_REPLACES[name],
             "launches": dp[label]["launches"][name],
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": None,
             **brick_row_fields(rec)})
    # K4 on the brick paths (one call a step over the brick extended along
    # x and y, or x, y and z): the numbers on rank 0's extended planes, the
    # launches of all ranks on that path
    bk, bp = record["bricks_kernels"], record["bricks"]
    for label in ("classic-2d", "polymer-2d", "classic-3d"):
        rec = bk[label]
        rows.append(
            {"name": f"pair_halo_dpd/{label}", "path": label,
             "route": "cuda", "source": "meso_tpu_torch/csrc/pair_brick.cu",
             "replaces": HALO_REPLACES["pair_halo_dpd"],
             "launches": bp[label]["launches"]["pair_halo_dpd"],
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": None,
             **brick_row_fields(rec)})
    for row in rows:
        if row["name"] in ("pair_dpd_v3", "particle_hash"):
            row["ensemble_launches"] = bp["ensemble"]["launches"][row["name"]]
        if row["name"] == "pair_halo_dpd":
            row["dpsp_launches"] = bp["dpsp"]["launches"]["pair_halo_dpd"]
            row["dryrun_launches"] = bp["dryrun"]["slabs_k4"][
                "launches"]["pair_halo_dpd"]
    rows += record["probes"]["rows"]
    # the launches of the CLI phase's runs: the golden decks on the kernels
    # and the 1M deck
    cli_runs = [*record["cli"]["pallas"].values(), record["cli"]["main"]]
    for row in rows:
        if row["name"] in ("pair_dpd_v3", "pair_dpd_v3_general",
                           "pair_edpd_v3", "pair_tdpd_v3", "particle_hash"):
            row["cli_launches"] = sum(r["launches"].get(row["name"], 0)
                                      for r in cli_runs)
    # the measured floor of each byte-bound kernel: its bytes over the
    # streaming rate the null stage (T4) reached on this card
    rate = record["probes"]["t4"]["best_rate_bytes_per_s"]
    for row in rows:
        row["in_path_ms"] = in_path_ms(record["profile"], row["name"])
        if row["bound_by"] == "bytes":
            row["floor_ms"] = row["bound_ms"] * HBM_BYTES_PER_S / rate
    return {"kernels": rows}


def main(argv):
    import torch
    if "--cli-obs-cpu" in argv:
        i = argv.index("--cli-obs-cpu")
        cli_observables_cpu(argv[i + 1], argv[i + 2])
        return 0
    if "--ab-one" in argv:
        from meso_tpu_torch.kernels import _build
        _build.load_library()  # the other tree's, in its own build/
        ab_one(argv[argv.index("--ab-one") + 2])
        return 0
    info = phase_env()
    record = {"env": info, "build": phase_build()}
    if "--ab" in argv:
        record["ab"] = phase_ab(argv[argv.index("--ab") + 1])
        (ROOT / "build" / "chip_smoke_ab.json").write_text(
            json.dumps(record, indent=1, default=str))
        return 0
    if "--cli-only" in argv:
        record["cli"] = phase_cli()
    elif "--bricks-only" in argv:
        record["bricks"], record["bricks_kernels"] = phase_bricks()
    elif "--bonds-only" in argv:
        record["bond_kernels"] = phase_bond_kernels()
    elif "--decay-from" in argv:
        record["decay_from"] = phase_decay_from(
            argv[argv.index("--decay-from") + 1])
    elif "--sweep-only" in argv:
        record["kernels"] = phase_kernels(record["build"]["ptxas"])
        record["probes"] = phase_probes(record["kernels"]["l70"])
    elif "--dd-only" not in argv:
        record["kernels"] = phase_kernels(record["build"]["ptxas"])
        record["transport_kernels"] = phase_transport_kernels(
            record["build"]["ptxas"])
        record["general_kernels"] = phase_general_kernels(
            record["kernels"]["l70"]["pair_ms"], info["card"],
            record["build"]["ptxas"])
        record["selector_kernels"] = phase_selector_kernels()
        record["brick_tiles"] = phase_brick_tiles()
        record["selector_kernels_l70"] = phase_selector_kernels_l70()
        record["bond_kernels"] = phase_bond_kernels()
        record["probes"] = phase_probes(record["kernels"]["l70"])
    if not set(argv) & {"--decay-from", "--sweep-only", "--cli-only",
                        "--bricks-only", "--bonds-only"}:
        record["dd_kernels"] = phase_dd_kernels()
    if "--dd-only" in argv:
        record["dd_ring_of_one"] = phase_dd_ring_of_one()
        record["dd_paths"], record["dd_kernels_l70"] = phase_dd_paths()
    elif "--sweep-only" in argv:
        record["main_path"] = phase_main_path()
        record["transport_full"] = {m: phase_transport_full(m)
                                    for m in ("edpd", "tdpd")}
        record["nlist_path"] = phase_nlist_path()
        record["bucket_paths"] = phase_bucket_paths()
        record["dd_bucket"] = phase_dd_bucket()
    elif not set(argv) & {"--kernels-only", "--decay-from", "--cli-only",
                          "--bricks-only", "--bonds-only"}:
        record["main_path"] = phase_main_path()
        record["transport_physics"] = phase_transport_physics()
        record["transport_full"] = {m: phase_transport_full(m)
                                    for m in ("edpd", "tdpd")}
        record["cli"] = phase_cli(record["main_path"]["ms_per_step"])
        record["walls_physics"] = phase_walls_physics()
        record["bonded_physics"] = phase_bonded_physics()
        record["walls_full"] = phase_walls_full()
        record["polymer_full"] = phase_polymer_full()
        record["selector_full"] = {}
        for sel in ("v2", "banded"):
            record["selector_full"][f"{sel}-dpd"] = phase_main_path(sel)
            for model in ("edpd", "tdpd"):
                record["selector_full"][f"{sel}-{model}"] = \
                    phase_transport_full(model, sel)
        record["banded_physics"] = phase_banded_physics()
        record["dd_ring_of_one"] = phase_dd_ring_of_one()
        record["dd_paths"], record["dd_kernels_l70"] = phase_dd_paths()
        record["bricks"], record["bricks_kernels"] = phase_bricks()
        record["nlist_path"] = phase_nlist_path()
        record["bucket_paths"] = phase_bucket_paths()
        record["dd_bucket"] = phase_dd_bucket()
        record["profile"] = phase_profile(
            {p: record[f"{p}_full"]["steps_per_rebuild"]
             for p in ("walls", "polymer")})
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    if set(argv) & {"--kernels-only", "--decay-from", "--dd-only",
                    "--sweep-only", "--cli-only", "--bricks-only",
                    "--bonds-only"}:
        return 0
    print(json.dumps(kernel_records(record)), flush=True)
    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--ab-one" in sys.argv:
        # the tree whose meso_tpu_torch this run drives (--ab)
        sys.path.insert(0, sys.argv[sys.argv.index("--ab-one") + 1])
    sys.exit(main(sys.argv[1:]))
