"""Chip smoke test of the PyTorch/CUDA port (pylamp_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the twelve hand-written CUDA kernels from ``pylamp_tpu_torch/csrc``
(nvcc, sm_90a, one process per source) and checks each one against its
plain PyTorch version on the card:

- kernels 1-6 at the shapes of the Frank-Kamenetskii 1024^2 x K18
  benchmark step (the fused smoother on the solve's own levels 1024, 512
  and 256, the coarse sub-V-cycle from 128^2), and kernels 5 and 6 again
  on the sticky-air 1024x256 hierarchy (degree 6 + the emitted residual,
  depth 7, on 1024x256, 512x128 and 256x64; the coarse cycle from 128x32
  with capped viscosities and power-iteration bounds);
- kernel 7 (the MG momentum apply) at 1024x256 and 512x128 with the
  sticky-air viscosities, at 1024^2 with the FK viscosities and at one odd
  shape;
- the per-shard kernels 8-12 at the 4x2 per-shard shapes of FK 1024^2 x
  K18 (256x512 blocks): kernel 8 on the frames of levels 1024, 512 and 256
  (degree 4 + the residual, zero and non-zero start), on a 3x3 and a 4x4
  mesh (interior shards), on frames deeper than the sweep, and timed on
  each of its six mesh levels (blocks 256x512 to 8x16), kernel 9 in both
  forms at 256x512 and 128x256, kernels 10-12 on the blocks of the FK
  markers, each at one odd shape as well (kernel 9 at 21x38, partial
  tiles in both dimensions; kernels 10-12 at 20x20, narrower than one
  strip), and kernels 10-12 held bit for bit to their single-device
  siblings at both shapes: the halo transfer to kernel 2, kernel 11 on
  windows cut from kernel 3's padded lattices to kernel 3 (reach 1 and
  2), the halo rebucket to kernel 4;
- the periodic forms of kernels 1-5 and 7 (rows ``*_periodic``) at the
  shapes of the periodic falling block at 1024^2 x K18: kernel 1 on the
  solve's viscosities, kernels 2-4 on its markers, kernel 5 on levels
  1024, 512 and 256 in both forms, kernel 7 on those levels (timed at
  1024^2); the seam columns of kernels 1, 5 and 7 bit-identical;
- the periodic forms of kernels 10-12 (rows ``*_block_periodic``, port-
  only: the sharded layout's wrap-around marker exchange) on the ring-
  exchanged 256x512 x K18 blocks of that state and on a 40x48 periodic
  build on the 2x4 mesh, each against its plain version and against
  kernels 2p-4p: the halo transfer bit-identical to kernel 2p, the
  exchanged velocity windows equal to kernel 3p's wrapped planes and
  kernel 11p on them bit-identical to kernel 3p at reach 1 and 2 for
  every marker clear of the seam (those crossing it counted), the halo
  rebucket slot for slot kernel 4p's;
- kernels 2 and 10 with the rho0 * alpha stream (rows ``m2g_ra`` and
  ``m2g_block_ra``, adiabatic heating's corner field) on the FK markers
  and their 4x2 blocks, each at one odd shape (37x23; 40^2 on 2x2): a
  rerun and every other stream bit-identical, and the halo transfer with
  the stream bit-identical to kernel 2's.

Kernels 1-4 are checked in both forms at odd shapes as well (kernel 1
at 23x37 and 129x257, seam columns bit-identical; kernel 4 at 37x23 x
K33, 65x33 x K9 and, periodic, 3x3 x K18 and 65x33 x K9, bit-identical
with equal drop counts; kernels 2 and 3 on seeded markers at 37x23 x K33,
65x33 x K9 and, periodic, 3x3 x K18 and 6x3 x K9, under their bars, a
rerun bit-identical), and kernels 2 and 3 at the FK and periodic shapes
are rerun bit-identical too.  Kernel and plain version are timed with CUDA
events, and each kernel's bound (bytes over 3.35 TB/s or f32 operations
over 67 TFLOP/s, whichever is larger) is computed from the inputs it was
timed on.  Kernels 1-4 and 7-12, the periodic forms of 1-4 and 7 and
kernel 2 with the rho0 * alpha stream are also timed on the device alone
(one call captured in a CUDA graph and replayed), and kernel 1's and 7's
wrappers on the host (microseconds per call with the launch enqueued).  Kernel 5's pre-smooth
form is also timed on each of its six levels and kernel 6 on both
hierarchies, per call and on the device alone, both checked bit-identical
on a rerun; an "occupancy" line gives the registers, shared memory and
resident blocks of kernels 5, 6 and 8 (clusters for kernel 6) and of
kernels 1-4, 7 and 9-12 in every form from the card, and every kernel's
ptxas registers and spills (no kernel may spill; kernels 2-4 and 10-12
must keep their plans' shared memory, kernels 3, 4, 11 and 12 2 blocks
per SM, kernels 2 and 10 4 at FK).  Then two paths run through the
port's ``build`` + ``make_step``, each with every launch counter set to 0
just before it:

- FK 1024^2, ``fk_bench_config`` (the JAX bench preset): 2 warm-up + 3
  measured steps, kernels 1-6; then its A/B partner
  ``use_pallas_smoother=False`` from the same built state (Krylov counts
  within +-2 per step);
- sticky-air 1024x256, ``sticky_air_bench_config`` (the preset of
  ``bench.py --benchmark sticky_air`` with ``use_pallas=True``): 1 warm-up
  + 3 measured steps, all seven kernels, interleaved step by step with its
  A/B partner ``use_pallas=False`` from the same built state, which must
  not launch kernel 7 (outer Krylov counts within +-max(2, 10 %) per
  step).

- the periodic falling block at 1024^2, ``falling_block_periodic_config``
  (the preset's own solver, f32 state): 1 warm-up + 3 measured steps,
  kernels 1-5 in their periodic forms, interleaved step by step with its
  partner ``use_pallas=True, use_pallas_smoother=False`` (kernels 1-4 and
  7 periodic); every launch of a path must be a periodic form of its
  kernels and no other kernel may launch; every marker x in [0, lx), the
  vx seam columns within 1e-6 max|vx|, the largest vy within 3 columns of
  the seam, Krylov counts within +-2 of the partner.

- FK 1024^2 with ``explicit_halo=True`` on the in-process 4x2 mesh
  (``make_step(..., mesh=make_mesh(8))``): 1 warm-up + 3 measured steps,
  interleaved step by step with the single-device step from the same built
  state; kernels 8-12 must advance and kernels 1-7 stay idle on the mesh
  path, Krylov counts within +-2 of the partner, and after the first step
  velocities within 1e-5 max|vy|, marker y within 1e-5 max|y| and
  materials equal.

- the same FK 1024^2 step on the sharded layout (``dist_mesh_path``,
  ``parallel/mesh.py shard_state``): the in-process 4x2 mesh steps the
  sharded state first, within the mesh bars (Krylov +-2) of the
  in-process global-layout step; then on the DISTRIBUTED 4x2 mesh
  (``parallel/dist.py``) eight gloo ranks spawned by ``launch`` share the
  card (CUDA payloads staged through pinned host buffers), each loading
  the state the in-process mesh path started from on the host (a file)
  and moving only its blocks to the card, then stepping them; rank 0's
  gathered state must equal the in-process sharded state after that step
  bit for bit in every leaf, the replicated scalars and strips must agree
  on every rank, the Krylov counts must be equal, every rank must launch
  kernels 8-12 exactly as often as the in-process sharded step and
  kernels 1-7 never (each rank's counters set to 0 just before the step
  and read just after), hold no leaf larger than its block, stay within
  0.5 GiB of step peak memory and all-gather no block in the step; it
  prints the backend, the world size, s/step, step peak memory and
  collectives by kind per rank, and the in-process layouts' step peaks,
  beside the card's name and power limit.  In the same world each rank
  then steps the periodic falling block 1024^2 (its built state, a second
  file) on the sharded layout, the markers on their blocks through the
  wrap-around exchange: rank 0's leaves bit-identical to the in-process
  sharded 4x2 step, which must hold the in-process global-layout periodic
  step at the mesh bars (Krylov +-2), keep its vx seam columns
  bit-identical and x in [0, lx) and drop no marker; every rank launches
  kernels 9-12 as often as in-process, 10-12 only in their periodic
  forms, 1-8 never, within the same memory and all-gather bars.  Then a
  one-rank NCCL group runs the distributed mesh's gather, gather to rank
  0, psum, psum_many and pmax on the card against the in-process mesh.

- the heated FK 1024^2 (``models.profile.fk_heated_config``: the FK
  bench preset with shear and adiabatic heating, subgrid diffusion d = 1
  and reseeding below 2 per cell), from the FK build's state: 1 warm-up +
  3 measured steps interleaved with its partner
  ``energy_preconditioner="mg"`` (energy multigrid + flexible CG);
  kernels 1-6, kernel 2 always with the rho0 * alpha stream; each step's
  marker count held to the count it started from (reseeding adds after
  it), both energy solves converged (1e-10); Krylov counts within
  +-max(2, 10 %) of the partner's (sticky air's bar: the trajectories part
  by one f32 ulp of T after step 1, and the log gives the count a one-ulp
  nudge alone makes) and, after step 1, T within 1e-7 max|T| of it.  Then
  ``bucket_reseed`` at 9 per cell on the card against the CPU on the
  heated state (at least one spawned; valid and mat equal, x and y within
  one f32 spacing, T within 1e-6 max|T|), with the thermal tensor work
  timed;
- the heated FK on the 4x2 mesh: 1 warm-up + 2 measured steps interleaved
  with the single-device heated step, under the mesh path's checks and
  bars (Krylov: +-max(2, 10 %)), kernel 10 always with the rho0 * alpha
  stream;
- the heated FK on the sharded layout (``dist_heated_path``): the
  in-process 4x2 mesh steps the sharded state of the FK build once with
  the Jacobi-CG energy solve, within the mesh bars (Krylov
  +-max(2, 10 %)) of the heated mesh path's first (global-layout) step,
  and once with the energy multigrid and flexible CG (T within 1e-7
  max|T| of the Jacobi step, Krylov within the same bar); then eight
  gloo ranks on the card, in ONE world, each take the Jacobi step and
  then the MG-FCG step from that state on their own blocks.  Per variant
  rank 0's gathered state (the marker count after reseeding included)
  must equal the in-process sharded step's bit for bit in every leaf, the
  Stokes and energy counts must be equal on every rank, every rank must
  launch kernels 8-12 as often as the in-process sharded step, kernel 10
  on every launch with the rho0 * alpha stream, and kernels 1-7 never,
  converge its energy solve (1e-10), drop no marker, keep its replicated
  values in agreement, hold no leaf beyond its block, stay within 0.5 GiB
  of step peak and all-gather no block in the step; each rank's s/step,
  collectives and received bytes by kind are printed.

- the stretched grid (``stretched_paths``): FK 1024^2 y-stretched 8x
  (``fk_stretched_bench_config``, ``bench.py --stretch-y 8``): 1 warm-up +
  3 measured steps, every counter at 0 (no kernel: every gate fails on a
  non-uniform grid, as in the reference), each energy solve converged, the
  Krylov iterations per step beside the reference's 115
  (``validation/bench_stretched.json``; a step above twice that fails);
  its partner with the line smoothers (Stokes MG and energy MG + flexible
  CG) from the same state, 1 warm-up + 2 steps; and FK 256^2 on explicit
  uniform edges (the stretched code path) against the uniform path with
  every kernel switch off, both with power-iteration bounds, 2 steps from
  one state (Krylov within +-2, fields within 1e-5, sorted marker
  positions within 1e-6).

- the batched parameter sweep (``sweep_paths``): ``models/sweep.py``'s
  ``make_sweep_step`` on four FK 1024^2 members of the bench preset,
  (Ra_top, visc_contrast) in {100, 300} x {1e3, 1e4}, 3 sweep steps, each
  followed by every member's solo ``make_step`` from the same build: each
  member converged to 1e-8 with no marker dropped, bit-identical to its
  solo step in every ``state.*`` leaf with the same Krylov and energy
  iterations, the batch it stepped from untouched, and kernels 1-6 launching per sweep step exactly as often
  as the four solo steps together; s per sweep step against the sum of
  the solo steps' logged.

- the command line (``cli_paths``): ``python -m pylamp_tpu_torch run
  fk_stagnant_lid --nx 1024`` in-process (the preset's own solver, f32
  state) for 4 steps with a checkpoint and a field dump at step 4, for 2
  steps with ``--profile-phases`` and a checkpoint, resumed from that
  checkpoint to step 4, and for 4 steps with ``--scan 2``: kernels 1-6
  launch in each run and no other kernel or form, every ``state.*`` leaf
  of the resumed and the scanned run's checkpoints is bit-identical to
  the 4-step run's, the scanned run's metrics lines equal the 4-step
  run's but for the clocks and its dump and checkpoint land at the chunk
  cadence, the dump holds every live marker;
  ``run rt_van_keken --steps 2`` at its 512^2 (K = 32) launches kernels
  1-6; ``python3 -m pylamp_tpu_torch list`` prints the six presets.  It
  logs the median step wall time, the Krylov counts, the seconds of each
  checkpoint, field dump and checkpoint load, and its own seconds.

- the periodic falling block at 1024^2 with ``explicit_halo=True`` on
  the in-process 4x2 mesh (``periodic_mesh_path``): 1 warm-up + 2
  measured steps interleaved with the single-device preset from the same
  built state; the mesh path launches kernel 9 per shard and kernels 2-4
  in their periodic forms on the global markers, and no other kernel (5,
  6 and 8 stay off under periodic walls, 10-12 with the marker halo
  engine on the global layout, as in the reference); every step keeps
  the periodic seam
  checks, Krylov within +-2 of the single device, and after step 1 the
  mesh path's bars.

- the solver options that no preset uses (``solver_option_paths``): FK
  1024^2 from the FK build's state with ``schur="wbfbt"`` and with
  ``preconditioner="vanka"`` (``mg_semicoarsen=0``, which the step
  requires with it), 1 warm-up + 1 measured step each; the MG options,
  which do not hold 1e-8 on FK 1024^2 in the reference either (scaled
  transfers from step 1, the line search from step 2), take one FK 64^2
  step each, and the line search (with ``use_pallas``, so that its
  fine-level applies reach kernel 7) its first step at 1024^2 as well.
  Every step to 1e-8 with no marker dropped, its Krylov count and s/step
  logged beside the bench preset's from the same state; kernel 7
  launches under the line search at 1024^2, kernel 6 under neither MG
  option, no MG kernel (5-7) under Vanka.  Then the reference's slow
  Vanka test on the card (``vanka_sharp_check``): its 1e6 cell-sharp
  problem at 64^2 in f64 at restart 60, converged in fewer than 400
  iterations.

- the validation phase (``validation_paths``): the flat marker engine
  with the block-Jacobi preconditioner (the falling block at 64^2, f64, 3
  steps) on the card against the same steps on the CPU (within 1e-10) and
  rerun bit-identical; FK 256^2 with flat markers interleaved with the
  bucket engine from the same markers (Krylov within +-max(2, 10 %),
  velocities within 1e-5 after step 1; the flat path launches kernels 1,
  5 and 6, none of 2-4); 100 steps of ``models.validate_blankenbach`` at
  64^2 (kernels 1-4 and 6, every step converged, Nu, v_rms and the
  markers dropped printed).

Every step must converge to 1e-8, drop no marker, keep every field finite
and launch every kernel of its path.  A 64^2 FK step on the card (coarse
kernel from 32^2) and a 256^2 periodic falling-block step (kernels 1-5
periodic) are also held against the plain f64 step on the CPU (the path
the CPU tests hold against the JAX package).  The line before the
last lists every kernel with its numbers; the last line is the JSON device
record.  Any failure raises, so the exit code is non-zero; it exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from functools import partial

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FK_NX = 1024
STICKY_NX = 1024  # sticky-air nx x nx // 4
WARMUP_STEPS = 2
MEASURED_STEPS = 3
PLAIN_MG_MEASURED_STEPS = 2  # the use_pallas_smoother=False path
MESH_WARMUP_STEPS = 1
MESH_MEASURED_STEPS = 3
MESH_SHARDS = 8  # make_mesh(8): the reference's 4x2 mesh
STICKY_WARMUP_STEPS = 1
STICKY_MEASURED_STEPS = 3
PERIODIC_NX = 1024  # falling_block_periodic at nx^2
PERIODIC_WARMUP_STEPS = 1
PERIODIC_MEASURED_STEPS = 3
PERIODIC_SMALL_NX = 256  # kernel 5 takes nx >= 256; square: not semicoarsened
SEAM_TOL = 1e-6  # |vx[:, 0] - vx[:, -1]| / max|vx| after a periodic step
HEATED_WARMUP_STEPS = 1  # FK with the four thermal switches
HEATED_MEASURED_STEPS = 3
HEATED_MESH_MEASURED_STEPS = 2
HEATED_T_TOL = 1e-7  # max |dT| / max|T| after step 1, Jacobi-CG vs MG-FCG
# Krylov counts per step of the heated paths against their partners: within
# +-max(2, 10 %), sticky air's bar.  After step 1 the two trajectories part
# by one f32 ulp of T, and that alone moves step 2's count by 2-3 of ~54
# (the one-ulp twin that heated_paths logs measures it in the same call)
HEATED_KRYLOV_REL = 0.1
NOISE_FRACTION = 1e-3  # marker T slots the one-ulp twin nudges
RESEED_MIN = 9  # the preset's initial markers per cell
# the stretched phase: FK nx^2 with y edges geometric 8x (bench.py
# --stretch-y 8), its line-smoother partner, and the uniform-edges check
STRETCHED_NX = 1024
STRETCHED_WARMUP_STEPS = 1
STRETCHED_MEASURED_STEPS = 3
STRETCHED_LINE_MEASURED_STEPS = 2
# the reference's Krylov iterations per step on this configuration (TPU
# v5e, the same algorithm from the same seeded state); a step above twice
# that means a broken hierarchy or bound
STRETCHED_REFERENCE = "validation/bench_stretched.json"
STRETCHED_KRYLOV_FACTOR = 2.0
UNIFORM_EDGES_NX = 256
UNIFORM_EDGES_STEPS = 2
UNIFORM_EDGES_FIELD_TOL = 1e-5  # max |diff| / max|ref| of vx, vy, p, T
UNIFORM_EDGES_MARKER_TOL = 1e-6  # sorted marker x, y, over the box size
KRYLOV_AB_TOL = 2  # Krylov iterations per step, fused vs plain MG smoother
PERIODIC_MESH_WARMUP_STEPS = 1  # the periodic falling block on the 4x2 mesh
PERIODIC_MESH_MEASURED_STEPS = 2
# the solver options that no preset uses, on FK from one built state per
# size: name -> (FK nx, solver switches, steps).  The MG options do not
# hold the 1e-8 gate on FK 1024^2 in the reference either (its JAX step on
# the CPU: scaled transfers stop at 0.985 relative residual on step 1, the
# line search at 6.4e-5 on step 2): the line search takes its first step
# there, and each takes one at 64^2, where the reference holds both steps
# (scaled transfers need 300-400 Krylov a step there, ~30 s on the card)
SOLVER_OPTIONS = {
    "fk_1024_wbfbt": (FK_NX, dict(schur="wbfbt"), 2),
    # the step refuses semicoarsening with Vanka, as the reference's
    "fk_1024_vanka": (FK_NX, dict(preconditioner="vanka",
                                  mg_semicoarsen=0.0), 2),
    # use_pallas opens kernel 7's gate for the line search's fine-level
    # applies (the FK preset keeps it shut, as the reference's)
    "fk_1024_ls_damp": (FK_NX, dict(mg_ls_damp=True, use_pallas=True), 1),
    "fk_64_scaled_transfers": (64, dict(mg_scaled_transfers=True), 1),
    "fk_64_ls_damp": (64, dict(mg_ls_damp=True, use_pallas=True), 1),
}
# the kernels each option's step launches; every other counter stays 0
# (kernel 6's gate refuses either MG option; Vanka runs no MG kernel;
# kernels 5 and 7 take no level of 64^2)
OPTION_KERNELS = {
    "fk_1024_wbfbt": ("saddle", "m2g", "advect", "rebucket", "cheb",
                      "coarse_vcycle"),
    "fk_1024_vanka": ("saddle", "m2g", "advect", "rebucket"),
    "fk_1024_ls_damp": ("saddle", "m2g", "advect", "rebucket", "cheb",
                        "momentum"),
    "fk_64_scaled_transfers": ("saddle", "m2g", "advect", "rebucket"),
    "fk_64_ls_damp": ("saddle", "m2g", "advect", "rebucket"),
}
# the reference's slow Vanka test (tests/test_vanka.py _sharp_problem: a
# 1e6 cell-sharp jump, seed 5) at its 64^2, f64, restart 60, maxiter 1500,
# and its bar (the reference measured 282)
VANKA_SHARP_NX = 64
VANKA_SHARP_MAX_ITERS = 400
# the sweep phase: FK nx^2 (the bench preset), one member per (Ra_top,
# visc_contrast); (100, 1e4) is the preset's own material
SWEEP_NX = 1024
SWEEP_MEMBERS = ((100.0, 1e3), (100.0, 1e4), (300.0, 1e3), (300.0, 1e4))
SWEEP_STEPS = 3  # 1 warm-up + 2
# the CLI phase: `python -m pylamp_tpu_torch run fk_stagnant_lid --nx 1024`
# (the preset's own solver, f32 state) for CLI_STEPS steps, the same run
# cut in half by a checkpoint and resumed, and rt_van_keken at its 512^2
CLI_NX = 1024
CLI_STEPS = 4
CLI_RT_STEPS = 2
# (e): the 4 steps again with `--scan CLI_SCAN`, its checkpoint and field
# dump every CLI_SCAN_EVERY steps: the chunk boundaries 2 and 4 write at 4
# only (4 % 3 < 2), where the per-step loop would write at 3
CLI_SCAN = 2
CLI_SCAN_EVERY = 3
CLI_BENCHMARKS = ("blankenbach", "falling_block", "falling_block_periodic",
                  "fk_stagnant_lid", "rt_van_keken", "sticky_air")
SMALL_NX = 64
# the validation phase: (a) the flat falling block with block Jacobi, f64,
# card vs CPU and a bit-identical rerun; (b) FK flat vs bucket; (c) the
# Blankenbach 1a module's first steps
VALIDATION_FLAT_NX = 64
VALIDATION_FLAT_STEPS = 3
# (tol, restart, maxiter): block Jacobi needs ~8000 FGMRES iterations a
# step at 64^2 to reach 1e-10 with restart 200 (11-13 s on the card, 28-30
# s on its host's CPU), ~1,400 unrestarted (~20 s on a CPU)
VALIDATION_FLAT_TOL = (1e-10, 1500, 20000)
VALIDATION_FLAT_REL = 1e-10  # card vs CPU, every f64 leaf over its max
VALIDATION_FK_NX = 256
VALIDATION_FK_STEPS = 3
VALIDATION_FK_VTOL = 1e-5  # flat vs bucket after step 1, over max|vy|
# Krylov per step, flat vs bucket: +-max(2, 10 %), the heated paths' bar.
# The two engines sum each node's markers in different orders: from one
# FK 64^2 state on the CPU their eta, rho and T fields agree within 3-32
# ulp pointwise in f64 and in f32, the geometric eta taking the most
# (tests/test_torch_flat_markers.py::test_flat_matches_bucket_interp),
# and the mixed-precision count moves by ~3 under such rounding (step 1
# took 35 flat and 38 bucket iterations, the velocities 1.7e-7 apart)
VALIDATION_FK_KRYLOV_REL = HEATED_KRYLOV_REL
VALIDATION_BB_NX = 64
VALIDATION_BB_STEPS = 100
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# float32 operations per point of the staggered momentum stencil
# (ops/stokes.py's x and y rows: two normal stresses of 4, two shear
# stresses of 6, their differences and signs -> 26 per row), per
# Chebyshev update (residual, recurrence, iterate: 6) and per Jacobi
# diagonal (8); per marker of m2g (cell location, bilinear weights of four
# lattices, ~13 accumulated streams: ~80), of RK4 advection (four stages
# of two bilinear interpolations and the location: ~130) and of rebucket
# (cell of the new position and the slot arithmetic: ~10)
OPS = dict(stencil=26, pressure=2, continuity=5, cheb_update=6, diag=8,
           restrict=12, prolong=4, m2g=80, advect=130, rebucket=10)
# tolerances of the kernels against their plain versions on the card
TOL = {
    "saddle": 1e-5,  # max |err| / max |ref| per output array
    "m2g": 1e-5,  # the bar of the TPU kernel's own equivalence test
    # max |displacement error| / max |displacement|, the error counted
    # beyond one f32 spacing of the position (see displacement_error)
    "advect": 1e-4,
    "rebucket": 0.0,  # bit-identical
    # max |err| / max |ref| per output: the bars of the TPU kernels' tests
    # (tests/test_cheb_kernel.py, tests/test_coarse_vcycle.py)
    "cheb": 2e-5,
    "coarse_vcycle": 2e-5,
    # max |err| / max |ref| per output, the bar of the TPU kernel's own
    # test (tests/test_pallas_stokes.py)
    "momentum": 1e-5,
    # the per-shard kernels: the bars of their single-device siblings
    "cheb_block": 2e-5,
    "saddle_block": 1e-5,
    "m2g_block": 1e-5,
    # kernels 2 and 10 with the rho0 * alpha stream: the m2g bar
    "m2g_ra": 1e-5,
    "m2g_block_ra": 1e-5,
    "advect_block": 1e-4,  # as advect: one f32 spacing of the position
    "rebucket_block": 0.0,  # bit-identical
}


# rows timed on the device alone as well (one call captured in a CUDA
# graph and replayed: graph_ms), and rows whose wrapper's host time per
# call is measured (host_us)
DEVICE_TIMED = ("saddle", "m2g", "advect", "rebucket", "saddle_periodic",
                "m2g_periodic", "advect_periodic", "rebucket_periodic",
                "m2g_ra", "cheb_block", "momentum", "momentum_periodic",
                "saddle_block", "m2g_block", "m2g_block_ra", "advect_block",
                "rebucket_block", "m2g_block_periodic",
                "advect_block_periodic", "rebucket_block_periodic")
HOST_TIMED = ("saddle", "saddle_periodic", "momentum")

# what kernels 5, 6 and 8 report besides their rows: their times on every
# level or hierarchy they run, and the occupancy of each timed
# instantiation (from the card's function attributes)
LEVEL_TIMES = []
BLOCK_LEVEL_TIMES = []
OCCUPANCY = {}
# frames deeper than the sweep (kernel 8's check): the deepest fused sweep
MAX_FRAME_DEPTH = 7


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Median of per-launch CUDA-event times (after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps: int = 20):
    """Device time of one call of ``fn`` without its host work: the call
    captured once in a CUDA graph, the graph replayed ``reps`` times
    between two events.  A call that cannot be captured (a host sync in a
    wrapper) fails the run."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps: int = 200) -> float:
    """Host wall time of one call of ``fn`` with its launch enqueued: the
    mean over ``reps`` calls made back to back without a synchronize (the
    device runs behind the host and never makes it wait)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes, n_ops):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def stencil_ops(grid) -> int:
    """f32 operations of one momentum apply (both rows) on ``grid``."""
    return OPS["stencil"] * (grid.ny * (grid.nx + 1) + (grid.ny + 1) * grid.nx)


def errors(pairs):
    """(max |got - ref|, max over arrays of max |got - ref| / max |ref|)."""
    abs_err, rel = 0.0, 0.0
    for got, ref in pairs:
        scale = float(torch.max(torch.abs(ref)))
        err = float(torch.max(torch.abs(got.double() - ref.double())))
        abs_err = max(abs_err, err)
        rel = max(rel, err / scale if scale > 0 else err)
    return abs_err, rel


def displacement_error(got, ref, start, periods=(None, None)):
    """Advect: (max |got - ref| of the new positions, max over x and y of
    the displacement error over max |displacement|).  Both versions round
    start + displacement to f32 last, which alone may part them by one f32
    spacing of the position; the displacement error is what exceeds that.
    A whole-position bar would pass a kernel of the wrong order: at the
    FK step a marker moves ~5e-4 of the unit domain.  ``periods``: the
    period of each coordinate (periodic x wraps into [0, lx)), whose
    differences are taken into [-period/2, period/2)."""
    def gap(a, b, period):
        d = a.double() - b.double()
        return d if period is None else torch.remainder(
            d + 0.5 * period, period) - 0.5 * period

    abs_err, excess, scale = 0.0, 0.0, 0.0
    for g, r, s, period in zip(got, ref, start, periods):
        top = torch.maximum(torch.abs(g), torch.abs(r))
        spacing = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        diff = torch.abs(gap(g, r, period))
        abs_err = max(abs_err, float(torch.max(diff)))
        excess = max(excess, float(torch.max(
            torch.clamp(diff - spacing.double(), min=0.0))))
        scale = max(scale, float(torch.max(torch.abs(gap(r, s, period)))))
    return abs_err, excess / scale


def rerun_equal(name, got, again):
    """A kernel's rerun on the same inputs must be bit-identical."""
    bad = [k for k in got if not torch.equal(got[k], again[k])]
    if bad:
        raise AssertionError(f"{name}: a rerun differs in {bad}")


def check_kernels(grid, table, cfg, state, ph):
    """Each kernel against its plain version on the card, on inputs taken
    from the built state after one interp and one Stokes solve."""
    from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
    from pylamp_tpu_torch.ops.kernels import saddle
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    phys, vbc = cfg.physics, cfg.physics.velocity_bcs
    io = ph.interp(state)
    vx, vy, p, sdiag = ph.stokes(state, io)
    dt = ph.timestep(vx, vy, io.k_m, io.rhocp_m)
    torch.cuda.synchronize()
    log(f"setup solve: {sdiag['stokes_iterations']} Krylov iterations, "
        f"rel residual {sdiag['stokes_residual_rel']:.3e}")
    m = state.markers
    rows = []

    # saddle apply: the solve's viscosities and scales; the vector is a
    # seeded random field at the solution's scale per component (at the
    # solution itself the momentum rows cancel to the buoyancy and f32
    # rounding of the individual terms dominates any comparison)
    kcont, kbnd = stokes_scales(characteristic_viscosity(io.eta_n.double()),
                                grid)
    prep = saddle.prep_saddle(io.eta_s, io.eta_n, kcont.float(), kbnd.float())
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = [torch.randn(t.shape, generator=gen, device="cuda") * torch.max(torch.abs(t))
         for t in (vx, vy, p)]
    got = saddle.saddle_apply_cuda(*u, prep, grid, vbc)
    ref = saddle.saddle_apply_plain(*u, prep, grid, vbc)
    err = errors(zip(got, ref))
    ops = (stencil_ops(grid) + OPS["pressure"] * (vx.numel() + vy.numel())
           + OPS["continuity"] * p.numel())
    rows.append(("saddle", "pylamp_tpu_torch/csrc/saddle.cu",
                 "pylamp_tpu/ops/pallas/stokes_kernel.py:407", err,
                 lambda: saddle.saddle_apply_cuda(*u, prep, grid, vbc),
                 lambda: saddle.saddle_apply_plain(*u, prep, grid, vbc), 50,
                 bound_ms(nbytes(*u, prep.eta_s, prep.eta_n, prep.kk, *got),
                          ops)))

    # marker -> grid on the built state's markers
    got = m2g.m2g_fused_cuda(m, grid, table, phys, with_energy=True)
    ref = m2g.m2g_fused_plain(m, grid, table, phys, with_energy=True)
    if sorted(got) != sorted(ref):
        raise AssertionError(f"m2g streams differ: {sorted(got)} vs {sorted(ref)}")
    rerun_equal("m2g", got, m2g.m2g_fused_cuda(m, grid, table, phys,
                                               with_energy=True))
    err = errors((got[k], ref[k]) for k in ref)
    n_valid = int(m.total())
    marker_bytes = nbytes(m.x, m.y, m.T, m.mat, m.valid)
    rows.append(("m2g", "pylamp_tpu_torch/csrc/m2g.cu",
                 "pylamp_tpu/markers/pallas/m2g_kernel.py:407", err,
                 lambda: m2g.m2g_fused_cuda(m, grid, table, phys, with_energy=True),
                 lambda: m2g.m2g_fused_plain(m, grid, table, phys, with_energy=True),
                 5, bound_ms(marker_bytes + nbytes(*got.values()),
                             OPS["m2g"] * n_valid)))

    # RK4 advection with the solve's velocities and the step's dt
    reach = 1
    got = advect.advect_rk4_cuda(m, vx, vy, dt, grid, vbc, reach)
    ref = advect.advect_rk4_plain(m, vx, vy, dt, grid, vbc, reach)
    again = advect.advect_rk4_cuda(m, vx, vy, dt, grid, vbc, reach)
    rerun_equal("advect", {"x": got.x, "y": got.y},
                {"x": again.x, "y": again.y})
    err = displacement_error((got.x, got.y), (ref.x, ref.y), (m.x, m.y))
    log(f"advect: new positions max |err| / max |ref| "
        f"{errors([(got.x, ref.x), (got.y, ref.y)])[1]:.3e}")
    rows.append(("advect", "pylamp_tpu_torch/csrc/advect.cu",
                 "pylamp_tpu/markers/pallas/advect_kernel.py:282", err,
                 lambda: advect.advect_rk4_cuda(m, vx, vy, dt, grid, vbc, reach),
                 lambda: advect.advect_rk4_plain(m, vx, vy, dt, grid, vbc, reach),
                 5, bound_ms(nbytes(m.x, m.y, m.valid, vx, vy, got.x, got.y),
                             OPS["advect"] * n_valid)))

    # rebucket of the advected markers: bit-identical
    moved = got
    (gm, gd), (rm, rd) = (rebucket.rebucket_cuda(moved, grid),
                          rebucket.rebucket_plain(moved, grid))
    same = all(torch.equal(getattr(gm, f), getattr(rm, f))
               for f in ("x", "y", "mat", "T", "valid")) and int(gd) == int(rd)
    moved_cells = int(torch.sum(moved.valid & ~gm.valid))  # slots repacked
    log(f"rebucket: dropped {int(gd)} (plain {int(rd)}), "
        f"{moved_cells} slots emptied by the repack")
    rows.append(("rebucket", "pylamp_tpu_torch/csrc/rebucket.cu",
                 "pylamp_tpu/markers/pallas/rebucket_kernel.py:311",
                 (0.0, 0.0) if same else (math.inf, math.inf),
                 lambda: rebucket.rebucket_cuda(moved, grid),
                 lambda: rebucket.rebucket_plain(moved, grid), 3,
                 bound_ms(2 * marker_bytes, OPS["rebucket"] * n_valid)))

    rows += mg_kernel_rows(grid, cfg, io)
    return rows, dict(io=io, vx=vx, vy=vy, dt=dt)


def odd_shape_checks():
    """Kernels 1-4 in both forms at shapes that straddle their tiles,
    strips and row chunks (tests/test_torch_kernels_cuda.py covers more):
    kernel 1 at 23x37 and 129x257 on seeded vectors and viscosities
    spanning ~e^+-4, under no-slip top and left walls and under periodic
    side walls (seam columns bit-identical); kernel 4 at 37x23 x K33 and
    65x33 x K9 (walls), 3x3 x K18 and 65x33 x K9 (periodic) on seeded
    markers displaced by up to 0.95 of a cell, about half valid, a sixth of
    the x on exact cell edges, and every marker of the middle cell's 3x3
    neighbourhood moved into it (overflow drops): bit-identical with equal
    drop counts; kernels 2 and 3 at 37x23 x K33 and 65x33 x K9 (walls),
    3x3 x K18 and 6x3 x K9 (periodic) on such markers with one cell full
    and the first two cell rows empty: kernel 2 with every stream (vx,
    energy, H, rho0 * alpha; three materials) within its bar per stream,
    kernel 3 at stage reach 2 with seeded velocities (a drift across the
    seam, periodic) within its displacement bar, both bit-identical on a
    rerun.  Returns {row: [(max abs err, rel err)]}."""
    import dataclasses

    from pylamp_tpu_torch.core.bc import VelocityBCs
    from pylamp_tpu_torch.core.grid import StaggeredGrid
    from pylamp_tpu_torch.markers.bucket import BucketedMarkers, wrap_x
    from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
    from pylamp_tpu_torch.models.benchmarks import fk_stagnant_lid
    from pylamp_tpu_torch.ops.kernels import saddle
    from pylamp_tpu_torch.physics.materials import Material, MaterialTable

    gen = torch.Generator(device="cuda").manual_seed(17)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def unit(shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def markers(ny, nx, K, periodic):
        grid = StaggeredGrid(nx=nx, ny=ny, lx=1.0, ly=1.0)
        shape = (ny, nx, K)
        cj = torch.arange(ny, device="cuda").view(ny, 1, 1).float()
        ci = torch.arange(nx, device="cuda").view(1, nx, 1).float()
        x = (ci + unit(shape) + 1.9 * (unit(shape) - 0.5)) * grid.dx
        y = (cj + unit(shape) + 1.9 * (unit(shape) - 0.5)) * grid.dy
        edge = (ci + (unit(shape) < 0.5).float()) * grid.dx
        x = torch.where(unit(shape) < 1 / 6, edge, x)
        valid = unit(shape) < 0.55
        mj, mi = ny // 2, nx // 2
        hood = (slice(max(mj - 1, 0), mj + 2), slice(max(mi - 1, 0), mi + 2))
        x[hood] = (mi + unit(x[hood].shape)) * grid.dx
        y[hood] = (mj + unit(y[hood].shape)) * grid.dy
        valid[hood] = True
        x = wrap_x(x, grid.lx) if periodic else torch.clamp(x, 0.0, grid.lx)
        bm = BucketedMarkers(
            x=x.contiguous(), y=torch.clamp(y, 0.0, grid.ly).contiguous(),
            mat=torch.randint(0, 3, shape, generator=gen, device="cuda",
                              dtype=torch.int32),
            T=rand(shape), valid=valid.contiguous())
        return grid, bm

    out = {"saddle": [], "saddle_periodic": [], "rebucket": [],
           "rebucket_periodic": [], "m2g": [], "m2g_periodic": [],
           "advect": [], "advect_periodic": []}
    forms = (("saddle", VelocityBCs(top="no_slip", left="no_slip")),
             ("saddle_periodic", VelocityBCs(top="no_slip", left="periodic",
                                             right="periodic")))
    for ny, nx in ((23, 37), (129, 257)):
        grid = StaggeredGrid(nx=nx, ny=ny, lx=nx / ny, ly=1.0)
        u = [rand(s) for s in (grid.shape_vx, grid.shape_vy,
                               grid.shape_center)]
        prep = saddle.prep_saddle(torch.exp(2.0 * rand(grid.shape_corner)),
                                  torch.exp(2.0 * rand(grid.shape_center)),
                                  3.5, 70.0)
        for name, bcs in forms:
            got = saddle.saddle_apply_cuda(*u, prep, grid, bcs)
            if bcs.periodic_x:
                seam_equal(f"{name} {ny}x{nx} rx", got[0])
            out[name].append(errors(zip(
                got, saddle.saddle_apply_plain(*u, prep, grid, bcs))))
            log(f"{name} {ny}x{nx}: rel err {out[name][-1][1]:.3e}")
    for name, ny, nx, K in (("rebucket", 37, 23, 33), ("rebucket", 65, 33, 9),
                            ("rebucket_periodic", 3, 3, 18),
                            ("rebucket_periodic", 65, 33, 9)):
        periodic = name.endswith("_periodic")
        grid, bm = markers(ny, nx, K, periodic)
        (gm, gd), (rm, rd) = (rebucket.rebucket_cuda(bm, grid, periodic),
                              rebucket.rebucket_plain(bm, grid, periodic))
        same = all(torch.equal(getattr(gm, f), getattr(rm, f))
                   for f in ("x", "y", "mat", "T", "valid")) \
            and int(gd) == int(rd)
        out[name].append((0.0, 0.0) if same else (math.inf, math.inf))
        log(f"{name} {ny}x{nx} x K{K}: "
            f"{'bit-identical' if same else 'DIFFERS'}, dropped {int(gd)} "
            f"(plain {int(rd)})")
    table = MaterialTable([
        Material(rho0=100.0, alpha=1.0, eta0=1.0,
                 viscosity="frank_kamenetskii", fk_gamma=9.2, k=1.0,
                 cp=0.01),
        Material(rho0=90.0, alpha=0.5, eta0=10.0, k=2.0, cp=0.02, H=1.5),
        Material(rho0=80.0, alpha=0.2, T_ref=0.5, eta0=3.0,
                 viscosity="arrhenius", E_act=3.0, k=0.5, cp=0.03)])
    for periodic, ny, nx, K in ((False, 37, 23, 33), (False, 65, 33, 9),
                                (True, 3, 3, 18), (True, 6, 3, 9)):
        form = "_periodic" if periodic else ""
        grid, bm = markers(ny, nx, K, periodic)
        valid = bm.valid.clone()
        valid[ny // 2, nx // 2, :] = True  # a full cell
        valid[:2] = False  # an empty tile
        bm = bm.replace(valid=valid.contiguous())
        phys = dataclasses.replace(fk_stagnant_lid(nx=nx, ny=ny).physics,
                                   gx=0.4)
        kw = dict(with_energy=True, periodic_x=periodic, with_ra=True)
        got = m2g.m2g_fused_cuda(bm, grid, table, phys, **kw)
        ref = m2g.m2g_fused_plain(bm, grid, table, phys, **kw)
        if sorted(got) != sorted(ref) or "vx_w" not in got:
            raise AssertionError(f"m2g{form} {ny}x{nx}: streams {sorted(got)}")
        rerun_equal(f"m2g{form} {ny}x{nx}", got,
                    m2g.m2g_fused_cuda(bm, grid, table, phys, **kw))
        out[f"m2g{form}"].append(errors((got[k], ref[k]) for k in ref))
        bcs = (VelocityBCs(top="no_slip", left="periodic", right="periodic")
               if periodic else VelocityBCs(top="no_slip", left="no_slip"))
        vx = (0.7 if periodic else 0.0) + 0.3 * rand(grid.shape_vx)
        if periodic:
            vx[:, -1] = vx[:, 0]
        vy = 0.5 * rand(grid.shape_vy)
        dt = torch.tensor(0.9 * grid.dx, device="cuda")
        moved = advect.advect_rk4_cuda(bm, vx, vy, dt, grid, bcs, 2)
        again = advect.advect_rk4_cuda(bm, vx, vy, dt, grid, bcs, 2)
        rerun_equal(f"advect{form} {ny}x{nx}", {"x": moved.x, "y": moved.y},
                    {"x": again.x, "y": again.y})
        ref = advect.advect_rk4_plain(bm, vx, vy, dt, grid, bcs, 2)
        out[f"advect{form}"].append(displacement_error(
            (moved.x, moved.y), (ref.x, ref.y), (bm.x, bm.y),
            (grid.lx if periodic else None, None)))
        log(f"m2g{form} / advect{form} {ny}x{nx} x K{K}: rel err "
            f"{out[f'm2g{form}'][-1][1]:.3e} / displacement "
            f"{out[f'advect{form}'][-1][1]:.3e}; reruns bit-identical")
    return out


def time_rows(rows, extra_errors):
    """Each row's kernel against its plain version: the agreement (the
    row's own check and ``extra_errors[name]``, checks at further shapes)
    against TOL, then both timed in the order plain, kernel, kernel,
    plain.  The rows of DEVICE_TIMED are also timed on the device alone
    (``graph_ms``), those of HOST_TIMED on the host (``host_us``)."""
    results = {}
    for (name, source, replaces, err, kfn, pfn, preps,
         (b_ms, b_by)) in rows:
        abs_err, rel = err
        for a, r in extra_errors.get(name, ()):
            abs_err, rel = max(abs_err, a), max(rel, r)
        tol = TOL[name.removesuffix("_periodic")]  # a periodic form: its bar
        ok = rel <= tol
        p1 = cuda_time_ms(pfn, preps)
        k1 = cuda_time_ms(kfn, 20)
        k2 = cuda_time_ms(kfn, 20)
        p2 = cuda_time_ms(pfn, preps)
        results[name] = dict(source=source, replaces=replaces,
                             max_abs_err=abs_err, ms=min(k1, k2),
                             plain_ms=min(p1, p2), bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
        extra = ""
        if name in DEVICE_TIMED:
            dev_ms = results[name]["device_ms"] = graph_ms(kfn)
            extra += (f", device {dev_ms:.4f} ms ({100 * b_ms / dev_ms:.2f} "
                      "% of bound)")
        if name in HOST_TIMED:
            us = results[name]["host_us"] = host_us(kfn)
            extra += f", host {us:.2f} us per call"
        log(f"kernel {name}: max abs err {abs_err:.3e}, rel err {rel:.3e} "
            f"(tol {tol:g}) "
            f"{'OK' if ok else 'FAIL'}; kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f}/{p2:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"{100 * b_ms / min(k1, k2):.2f} % of bound{extra}")
        if not ok:
            raise AssertionError(f"kernel {name} disagrees with its plain "
                                 f"version: {rel:.3e} > {tol:g}")
    return results


def mg_kernel_rows(grid, cfg, io):
    """The fused smoother and the coarse sub-V-cycle against their plain
    versions on the solve's own MG levels: f32 viscosities, kbnd and the
    per-level Gershgorin lambdas as the step computes them, seeded random
    residuals and start iterates."""
    from pylamp_tpu_torch.ops.kernels import cheb
    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
    from pylamp_tpu_torch.solvers import mg
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    solver, vbc = cfg.solver, cfg.physics.velocity_bcs
    deg = max(solver.mg_pre_smooth, solver.mg_post_smooth)
    es, en = io.eta_s.float(), io.eta_n.float()
    _, kbnd = stokes_scales(characteristic_viscosity(io.eta_n.double()), grid)
    kbnd = kbnd.float()
    plan, grids, etas, kbnds = mg._hierarchy(es, en, grid, kbnd,
                                             solver.mg_levels,
                                             solver.mg_semicoarsen)
    lam = mg.estimate_mg_lambdas(es, en, grid, vbc, kbnd,
                                 levels=solver.mg_levels,
                                 semicoarsen=solver.mg_semicoarsen,
                                 mode="gershgorin")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # kernel 5 on every level it takes: the pre-smooth form (zero start,
    # emitted residual) and the post-smooth form (non-zero start)
    cheb_levels = [l for l, g in enumerate(grids)
                   if cheb.smoother_eligible(g, torch.float32, deg, True)]
    if [grids[l].nx for l in cheb_levels] != [1024, 512, 256]:
        raise AssertionError(f"fused smoother levels {cheb_levels}")
    cheb_abs, cheb_rel, timed = 0.0, 0.0, None
    for l in cheb_levels:
        g, (les, len_) = grids[l], etas[l]
        prep = cheb.prep_smoother(les, len_, g, vbc, kbnds[l], lam[l], deg + 1)
        rx, ry = rand(g.shape_vx), rand(g.shape_vy)
        zx, zy = torch.zeros_like(rx), torch.zeros_like(ry)
        ex, ey = rand(g.shape_vx), rand(g.shape_vy)
        forms = (((zx, zy), True, True), ((ex, ey), False, False))
        for (sx, sy), zero_init, emit in forms:
            got = cheb.chebyshev_smooth_cuda(sx, sy, rx, ry, prep, g, vbc,
                                             deg, zero_init, emit)
            ref = cheb.chebyshev_smooth_plain(sx, sy, rx, ry, les, len_, g,
                                              vbc, kbnds[l], lam[l], deg,
                                              zero_init, emit)
            a, r = errors(zip(got, ref))
            log(f"cheb level {g.ny}x{g.nx} zero_init={zero_init} "
                f"emit={emit}: max abs err {a:.3e}, rel {r:.3e}")
            cheb_abs, cheb_rel = max(cheb_abs, a), max(cheb_rel, r)
        level_time(cheb, "fk", g, prep, zx, zy, rx, ry, vbc, deg)
        if timed is None:  # time the finest level's pre-smooth form
            timed = (
                partial(cheb.chebyshev_smooth_cuda, zx, zy, rx, ry, prep, g,
                        vbc, deg, True, True),
                partial(cheb.chebyshev_smooth_plain, zx, zy, rx, ry, les,
                        len_, g, vbc, kbnds[l], lam[l], deg, True, True))
            cheb_bound = bound_ms(
                2 * nbytes(rx, ry) + nbytes(rx, ry, prep.eta_s, prep.eta_n,
                                            prep.coeffs, prep.kb),
                cheb_ops(g, deg, True, True))
    rows = [("cheb", "pylamp_tpu_torch/csrc/cheb.cu",
             "pylamp_tpu/ops/pallas/cheb_kernel.py:347",
             (cheb_abs, cheb_rel), *timed, 20, cheb_bound)]

    # kernel 6 on the solve's coarse hierarchy from the fusion start
    fs = cvk.coarse_fuse_start(grids, plan, vbc, torch.float32, "chebyshev",
                               False, False)
    if fs is None or grids[fs].nx != 128:
        raise AssertionError(f"coarse fusion start {fs}")
    prep = cvk.CoarseVcyclePrep(grids[fs:], etas[fs:], kbnds[fs:], lam[fs:],
                                vbc, solver.mg_pre_smooth,
                                solver.mg_post_smooth, 32)
    rx, ry = rand(grids[fs].shape_vx), rand(grids[fs].shape_vy)
    got = cvk.coarse_vcycle_cuda(rx, ry, prep)
    again = cvk.coarse_vcycle_cuda(rx, ry, prep)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("coarse_vcycle: a rerun is not bit-identical")
    ref = cvk.coarse_vcycle_plain(rx, ry, prep)
    info = cvk.kernel_info(prep)
    if info["static_smem"] != cvk.SMEM_STATIC:  # the planner's budget
        raise AssertionError(f"coarse_vcycle: static shared memory "
                             f"{info['static_smem']} B, the planner assumes "
                             f"{cvk.SMEM_STATIC} B")
    OCCUPANCY[f"coarse_vcycle fk from {grids[fs].ny}x{grids[fs].nx}"] = info
    LEVEL_TIMES.append(dict(hierarchy="fk", coarse_from=f"{grids[fs].ny}x"
                            f"{grids[fs].nx}", levels=prep.nlev,
                            device_ms=graph_ms(partial(
                                cvk.coarse_vcycle_cuda, rx, ry, prep))))
    log(f"coarse V-cycle from {grids[fs].ny}x{grids[fs].nx} "
        f"({prep.nlev} levels, cluster of {cvk.CLUSTER} CTAs, "
        f"{prep.smem} shared bytes each)")
    rows.append(("coarse_vcycle", "pylamp_tpu_torch/csrc/coarse_vcycle.cu",
                 "pylamp_tpu/ops/pallas/coarse_vcycle_kernel.py:136",
                 errors(zip(got, ref)),
                 partial(cvk.coarse_vcycle_cuda, rx, ry, prep),
                 partial(cvk.coarse_vcycle_plain, rx, ry, prep), 10,
                 coarse_bound(rx, ry, got, prep)))
    return rows


def level_time(cheb, hier, g, prep, zx, zy, rx, ry, vbc, deg):
    """Kernel 5's pre-smooth form (zero start, degree ``deg`` + the
    residual) on level ``g``: checked bit-identical on a rerun, timed with
    its bound, and its occupancy recorded."""
    run = partial(cheb.chebyshev_smooth_cuda, zx, zy, rx, ry, prep, g, vbc,
                  deg, True, True)
    first, again = run(), run()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"cheb {g.ny}x{g.nx}: a rerun is not "
                             "bit-identical")
    plan = cheb.tile_plan(g.ny, g.nx, deg + 1, cheb.device_sms(0))
    ms = cuda_time_ms(run, 20)
    dev_ms = graph_ms(run)
    b_ms, b_by = bound_ms(2 * nbytes(rx, ry) + nbytes(
        rx, ry, prep.eta_s, prep.eta_n, prep.coeffs, prep.kb),
        cheb_ops(g, deg, True, True))
    LEVEL_TIMES.append(dict(hierarchy=hier, level=f"{g.ny}x{g.nx}",
                            depth=deg + 1, ms=ms, device_ms=dev_ms,
                            bound_ms=b_ms,
                            bound_by=b_by, tile_rows=plan.ty,
                            blocks=plan.nty * plan.ntx))
    form = " periodic" if vbc.periodic_x else ""
    OCCUPANCY[f"cheb{form} {g.ny}x{g.nx} depth {deg + 1}"] = cheb.kernel_info(
        deg + 1, plan.ty, vbc.periodic_x)
    log(f"cheb {hier} level {g.ny}x{g.nx}, pre-smooth form (depth "
        f"{deg + 1}): kernel {ms:.4f} ms per call ({dev_ms} ms on the "
        f"device, graph-timed), bound {b_ms:.5f} ms ({b_by}), "
        f"{plan.nty * plan.ntx} tiles of {plan.ty}x32")


def cheb_ops(g, iters, zero_init, emit):
    """f32 operations of one fused sweep on level ``g``."""
    applies = iters - (1 if zero_init else 0) + (1 if emit else 0)
    points = g.ny * (g.nx + 1) + (g.ny + 1) * g.nx
    return (stencil_ops(g) * applies
            + (OPS["cheb_update"] * iters + OPS["diag"]) * points)


def coarse_bound(rx, ry, out, prep):
    """Bound of one fused coarse V-cycle: its rhs, every level's
    viscosities and tables read once, the correction written once; the
    operations of every sweep and transfer of the cycle."""
    ops = 0
    for l, g in enumerate(prep.grids):
        if l == prep.nlev - 1:
            ops += cheb_ops(g, prep.coarse_iters, True, False)
            continue
        ops += (cheb_ops(g, prep.pre, True, True)
                + cheb_ops(g, prep.post, False, False))
        c = prep.grids[l + 1]
        points = g.ny * (g.nx + 1) + (g.ny + 1) * g.nx
        ops += (OPS["restrict"] * (c.ny * (c.nx + 1) + (c.ny + 1) * c.nx)
                + OPS["prolong"] * points)
    n = nbytes(rx, ry, *out, prep.coeffs, prep.kb,
               *(t for pair in prep.eta32 for t in pair))
    return bound_ms(n, ops)


def sticky_mg_checks(grid, cfg, io):
    """Kernels 5 and 6 on the sticky-air hierarchy as its solve builds it:
    f32 viscosities capped below the fine level, power-iteration bounds,
    seeded random residuals.  Kernel 5 at degree 6 with the emitted
    residual (depth 7, the deepest) on every level it takes; kernel 6 from
    the fusion start (128x32) with coarse_iters 32.  Returns
    {kernel: [(max abs err, rel err)]} and the capped hierarchy."""
    from pylamp_tpu_torch.ops.kernels import cheb
    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk
    from pylamp_tpu_torch.solvers import mg
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    solver, vbc = cfg.solver, cfg.physics.velocity_bcs
    deg = max(solver.mg_pre_smooth, solver.mg_post_smooth)
    es, en = io.eta_s.float(), io.eta_n.float()
    _, kbnd = stokes_scales(characteristic_viscosity(en), grid)
    plan, grids, etas, kbnds = mg._hierarchy(es, en, grid, kbnd,
                                             solver.mg_levels,
                                             solver.mg_semicoarsen)
    etas = [etas[0]] + [(mg._cap_eta(a, solver.mg_eta_cap),
                         mg._cap_eta(b, solver.mg_eta_cap))
                        for a, b in etas[1:]]
    lam = mg.estimate_mg_lambdas(es, en, grid, vbc, kbnd,
                                 levels=solver.mg_levels,
                                 semicoarsen=solver.mg_semicoarsen)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = {"cheb": [], "coarse_vcycle": []}
    levels = [l for l, g in enumerate(grids)
              if cheb.smoother_eligible(g, torch.float32, deg, True)]
    if [(grids[l].ny, grids[l].nx) for l in levels] != [
            (256, 1024), (128, 512), (64, 256)]:
        raise AssertionError(f"sticky-air fused smoother levels {levels}")
    for l in levels:
        g, (les, len_) = grids[l], etas[l]
        prep = cheb.prep_smoother(les, len_, g, vbc, kbnds[l], lam[l], deg + 1)
        rx, ry = rand(g.shape_vx), rand(g.shape_vy)
        for zero_init in (True, False):
            ex = torch.zeros_like(rx) if zero_init else rand(g.shape_vx)
            ey = torch.zeros_like(ry) if zero_init else rand(g.shape_vy)
            got = cheb.chebyshev_smooth_cuda(ex, ey, rx, ry, prep, g, vbc,
                                             deg, zero_init, True)
            ref = cheb.chebyshev_smooth_plain(ex, ey, rx, ry, les, len_, g,
                                              vbc, kbnds[l], lam[l], deg,
                                              zero_init, True)
            out["cheb"].append(errors(zip(got, ref)))
            log(f"sticky-air cheb level {g.ny}x{g.nx}, degree {deg} + "
                f"residual (depth {deg + 1}), zero_init={zero_init}: max abs "
                f"err {out['cheb'][-1][0]:.3e}, rel {out['cheb'][-1][1]:.3e}")
            if zero_init:
                level_time(cheb, "sticky_air", g, prep, ex, ey, rx, ry, vbc,
                           deg)
    fs = cvk.coarse_fuse_start(grids, plan, vbc, torch.float32, "chebyshev",
                               False, False)
    if fs is None or (grids[fs].ny, grids[fs].nx) != (32, 128):
        raise AssertionError(f"sticky-air coarse fusion start {fs}")
    prep = cvk.CoarseVcyclePrep(grids[fs:], etas[fs:], kbnds[fs:], lam[fs:],
                                vbc, solver.mg_pre_smooth,
                                solver.mg_post_smooth, 32)
    rx, ry = rand(grids[fs].shape_vx), rand(grids[fs].shape_vy)
    got = cvk.coarse_vcycle_cuda(rx, ry, prep)
    again = cvk.coarse_vcycle_cuda(rx, ry, prep)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("sticky-air coarse_vcycle: a rerun is not "
                             "bit-identical")
    ref = cvk.coarse_vcycle_plain(rx, ry, prep)
    out["coarse_vcycle"].append(errors(zip(got, ref)))
    OCCUPANCY[f"coarse_vcycle sticky_air from {grids[fs].ny}x"
              f"{grids[fs].nx}"] = cvk.kernel_info(prep)
    k1 = cuda_time_ms(partial(cvk.coarse_vcycle_cuda, rx, ry, prep), 20)
    LEVEL_TIMES.append(dict(hierarchy="sticky_air", coarse_from=f"{grids[fs].ny}"
                            f"x{grids[fs].nx}", levels=prep.nlev, ms=k1,
                            device_ms=graph_ms(partial(
                                cvk.coarse_vcycle_cuda, rx, ry, prep))))
    log(f"sticky-air coarse V-cycle from {grids[fs].ny}x{grids[fs].nx} "
        f"({prep.nlev} levels, degree {deg}, capped eta): max abs err "
        f"{out['coarse_vcycle'][0][0]:.3e}, rel "
        f"{out['coarse_vcycle'][0][1]:.3e}; kernel {k1:.4f} ms")
    return out, (grids, etas, kbnds)


def momentum_row(fk_grid, fk_io, st_grid, st_hier):
    """Kernel 7 against its plain version at 1024x256 (the fine level of
    the sticky-air solve, where the inner FGMRES applies it) and 512x128
    (its capped first coarse level), at 1024^2 with the FK viscosities, and
    at an odd shape that no block size divides.  The row is timed at
    1024x256."""
    from pylamp_tpu_torch.core.bc import VelocityBCs
    from pylamp_tpu_torch.core.grid import StaggeredGrid
    from pylamp_tpu_torch.ops.kernels import momentum
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    vbc = VelocityBCs()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    grids, etas, kbnds = st_hier
    fk_es, fk_en = fk_io.eta_s.float(), fk_io.eta_n.float()
    _, fk_kb = stokes_scales(characteristic_viscosity(fk_en), fk_grid)
    odd = StaggeredGrid(nx=517, ny=333, lx=517 / 333, ly=1.0)
    es_o = torch.exp(2.0 * rand(odd.shape_corner))
    en_o = torch.exp(2.0 * rand(odd.shape_center))
    _, kb_o = stokes_scales(characteristic_viscosity(en_o), odd)
    cases = [(grids[0], etas[0], kbnds[0], "sticky-air fine"),
             (grids[1], etas[1], kbnds[1], "sticky-air level 1 (capped)"),
             (fk_grid, (fk_es, fk_en), fk_kb, "FK"),
             (odd, (es_o, en_o), kb_o, "odd, random eta")]
    errs, timed = [], None
    for g, (es, en), kb, label in cases:
        prep = momentum.prep_momentum(es, en, kb)
        vx, vy = rand(g.shape_vx), rand(g.shape_vy)
        got = momentum.momentum_apply_cuda(vx, vy, prep, g, vbc)
        ref = momentum.momentum_apply_plain(vx, vy, es, en, g, vbc, kb)
        errs.append(errors(zip(got, ref)))
        log(f"momentum {g.ny}x{g.nx} ({label}): max abs err "
            f"{errs[-1][0]:.3e}, rel {errs[-1][1]:.3e}")
        if timed is None:
            timed = (partial(momentum.momentum_apply_cuda, vx, vy, prep, g, vbc),
                     partial(momentum.momentum_apply_plain, vx, vy, es, en, g,
                             vbc, kb),
                     bound_ms(nbytes(vx, vy, prep.eta_s, prep.eta_n, prep.kb,
                                     *got), stencil_ops(g)))
    err = (max(a for a, _ in errs), max(r for _, r in errs))
    return ("momentum", "pylamp_tpu_torch/csrc/momentum.cu",
            "pylamp_tpu/ops/pallas/stokes_kernel.py:183", err, timed[0],
            timed[1], 50, timed[2])


def report_occupancy(cuda_build, smi):
    """The occupancy line: kernels 5, 6 and 8 per timed instantiation, and
    kernels 1-4, 7 and 9-12 in every form (2-4 at the FK plans, 10-12 at
    the 4x2 blocks' plans, K = 18; 10p-12p too), from the card's function
    attributes
    (registers, static and dynamic shared memory, local bytes, resident
    blocks per SM or clusters), and every kernel's registers, static
    shared memory and spills from the build's ``ptxas -v`` report.  No
    kernel may spill; kernels 2-4's and 10-12's dynamic shared memory must
    be their plans', with at least 2 blocks resident per SM (kernels 2 and
    10: 4, which their 9-slot units are sized for; 10p: 3, its launch
    bounds)."""
    from pylamp_tpu_torch.markers.kernels import (
        advect,
        advect_block,
        m2g,
        m2g_block,
        rebucket,
        rebucket_block,
    )
    from pylamp_tpu_torch.ops.kernels import momentum, saddle, saddle_block

    plan = rebucket.rebucket_plan(FK_NX, FK_NX, 18)
    by, bx = FK_NX // 4, FK_NX // 2  # the 4x2 mesh's blocks
    b_plan = rebucket.rebucket_plan(by, bx, 18)
    m_plan = m2g.m2g_plan(FK_NX, FK_NX, 18)
    a_plan = advect.advect_plan(FK_NX, FK_NX, 18)
    held = []  # (name, info, dynamic shared bytes, blocks per SM)
    for periodic in (False, True):
        form = " periodic" if periodic else ""
        OCCUPANCY[f"saddle{form}"] = saddle.kernel_info(periodic)
        OCCUPANCY[f"momentum{form}"] = momentum.kernel_info(periodic)
        info = rebucket.kernel_info(18, plan.tx, periodic)
        OCCUPANCY[f"rebucket{form} K18 strips of {plan.tx}"] = info
        held.append((f"rebucket{form}", info, plan.smem, 2))
        for ra in (False, True):
            flags = (m2g.FLAG_ENERGY | m2g.FLAG_RA * ra
                     | m2g.FLAG_PERIODIC * periodic)
            name = f"m2g{form}{' ra' if ra else ''}"
            info = m2g.kernel_info(m_plan, flags)
            OCCUPANCY[f"{name} K18 units of {m_plan.kc}"] = info
            held.append((name, info, m_plan.smem, 4))
        info = advect.kernel_info(a_plan, periodic)
        OCCUPANCY[f"advect{form} K18 tiles of {a_plan.ty}x{a_plan.tx}"] = info
        held.append((f"advect{form}", info, a_plan.smem, 2))
    for with_p in (True, False):
        OCCUPANCY[f"saddle_block{'' if with_p else ' momentum-only'}"] = \
            saddle_block.kernel_info(with_p)
    mb_plan = m2g_block.block_plan(MESH_SHARDS, by, bx, 18)
    ab_plan = advect.advect_plan(by, bx, 18)
    for periodic in (False, True):  # kernels 10-12, and 10p-12p
        form = " periodic" if periodic else ""
        info = rebucket_block.kernel_info(18, b_plan.tx, periodic)
        OCCUPANCY[f"rebucket_block{form} {by}x{bx}xK18 strips of "
                  f"{b_plan.tx}"] = info
        held.append((f"rebucket_block{form}", info, b_plan.smem, 2))
        for ra in (False, True):
            name = f"m2g_block{form}{' ra' if ra else ''}"
            info = m2g_block.kernel_info(
                mb_plan, m2g.FLAG_ENERGY | m2g.FLAG_RA * ra
                | m2g.FLAG_PERIODIC * periodic)
            OCCUPANCY[f"{name} {by}x{bx}xK18 units of {mb_plan.kc}"] = info
            held.append((name, info, mb_plan.smem,
                         m2g_block.BLOCKS_PER_SM_PERIODIC if periodic
                         else m2g_block.BLOCKS_PER_SM))
        info = advect_block.kernel_info(ab_plan, periodic)
        OCCUPANCY[f"advect_block{form} {by}x{bx}xK18 tiles of "
                  f"{ab_plan.ty}x{ab_plan.tx}"] = info
        held.append((f"advect_block{form}", info, ab_plan.smem, 2))
    for name, info, smem, blocks in held:
        if info["dynamic_smem"] != smem or info["blocks_per_sm"] < blocks:
            raise AssertionError(f"{name}: {info}, the plan assumes {smem} "
                                 f"B and {blocks} blocks per SM")
    ptx = cuda_build.ptxas_summary()
    log("kernels 5 and 6 per level " + json.dumps({"device": smi,
                                                   "levels": LEVEL_TIMES}))
    log("kernel 8 per level " + json.dumps({"device": smi,
                                            "levels": BLOCK_LEVEL_TIMES}))
    log("occupancy " + json.dumps({"device": smi,
                                   "kernels": OCCUPANCY,
                                   "ptxas": ptx}))
    spills = [r["function"] for r in ptx
              if r["spill_stores"] or r["spill_loads"]]
    spills += [k for k, v in OCCUPANCY.items() if v["local_bytes"]]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


def check_state(state, n_markers, diag, label):
    if not diag["stokes_converged"]:
        raise AssertionError(f"{label}: Stokes solve did not converge")
    if not diag["stokes_residual_rel"] <= 1e-8:
        raise AssertionError(f"{label}: rel residual "
                             f"{diag['stokes_residual_rel']:.3e} > 1e-8")
    if int(diag["markers_dropped"]) != 0:
        raise AssertionError(f"{label}: {int(diag['markers_dropped'])} "
                             "markers dropped")
    if int(diag["marker_count"]) != n_markers:
        raise AssertionError(f"{label}: marker count "
                             f"{int(diag['marker_count'])} != {n_markers}")
    fields = dict(vx=state.vx, vy=state.vy, p=state.p, T=state.T,
                  eta_s=state.eta_s, eta_n=state.eta_n, x=state.markers.x,
                  y=state.markers.y, mT=state.markers.T)
    for k, v in fields.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite values in {k}")


def mean(xs):
    return sum(xs) / len(xs)


def take_step(step, state, n_markers, modules, tag):
    """One step that must pass check_state and launch every kernel of
    ``modules``.  Returns (state, wall seconds, Krylov iterations, the
    step's diagnostics)."""
    before = {k: mod.launches for k, mod in modules.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, diag = step(state)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    check_state(state, n_markers, diag, tag)
    launched = {k: mod.launches - before[k] for k, mod in modules.items()}
    stalled = [k for k, n in launched.items() if n <= 0]
    if stalled:
        raise AssertionError(f"{tag}: kernels not launched: {stalled}")
    energy = (f", energy CG {diag['energy_iterations']}"
              if "energy_iterations" in diag else "")
    log(f"{tag}: {dt_s:.3f} s, Krylov {diag['stokes_iterations']}{energy}, "
        f"rel residual {diag['stokes_residual_rel']:.3e}, dt "
        f"{float(diag['dt']):.4e}, launches "
        + ", ".join(f"{k}+{n}" for k, n in launched.items()))
    return state, dt_s, int(diag["stokes_iterations"]), diag


def run_steps(step, state0, n_markers, modules, measured, label):
    """WARMUP_STEPS + ``measured`` steps from state0 (take_step).  Returns
    the wall seconds and Krylov iterations of every step (warm-up
    first)."""
    state = state0
    times, iters = [], []
    for i in range(WARMUP_STEPS + measured):
        kind = "warm-up" if i < WARMUP_STEPS else "measured"
        state, dt_s, it, _ = take_step(step, state, n_markers, modules,
                                       f"{label} step {i + 1} ({kind})")
        times.append(dt_s)
        iters.append(it)
    return times, iters


def small_reference_check():
    """One 64^2 step on the card (f32, kernels: the coarse V-cycle runs
    levels 32 to 4) against the plain f64 step on the CPU from the same
    seeded initial state: velocities within 1e-4 max|v| (f32 viscosity
    rounding), like the CPU tests' bar."""
    from pylamp_tpu_torch.models.benchmarks import fk_bench_config
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step

    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk

    cfg = fk_bench_config(SMALL_NX)
    out = {}
    n0 = cvk.launches
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        grid, table, st = build(cfg, dtype=dtype, device=dev)
        st, d = make_step(grid, cfg, table)(st)
        out[dev] = (st, d)
    if cvk.launches <= n0:
        raise AssertionError(f"{SMALL_NX}^2 step: the coarse V-cycle kernel "
                             "was not launched")
    g, r = out["cuda"][0], out["cpu"][0]
    vmax = float(torch.max(torch.abs(r.vx)))
    err = max(float(torch.max(torch.abs(g.vx.cpu().double() - r.vx))),
              float(torch.max(torch.abs(g.vy.cpu().double() - r.vy))))
    log(f"{SMALL_NX}^2 step, card f32 vs CPU f64: max |dv| / max|v| = "
        f"{err / vmax:.3e}; Krylov {out['cuda'][1]['stokes_iterations']} vs "
        f"{out['cpu'][1]['stokes_iterations']}")
    if not err <= 1e-4 * vmax:
        raise AssertionError(f"{SMALL_NX}^2 step disagrees with the CPU "
                             f"reference: {err / vmax:.3e} > 1e-4")


def sticky_air_paths(grid, cfg, table, state0, n_markers, modules, counted):
    """The sticky-air 1024x256 path (this slice's main path, all seven
    kernels) and its use_pallas=False partner, each from the same built
    state, their steps interleaved (kernel path first on odd steps, second
    on even ones) so that host noise falls on both alike.  Every launch
    counter of ``counted`` (every kernel) is set to 0 just before each step
    and read just after; the main path must launch every kernel of
    ``modules`` (kernels 1-7), the partner all but kernel 7, and neither
    any other.  Returns the main path's launch counts."""
    from dataclasses import replace

    from pylamp_tpu_torch.models.step import make_step

    smi = nvidia_smi_line()
    cfg0 = replace(cfg, solver=replace(cfg.solver, use_pallas=False))
    paths = {
        "use_pallas": (make_step(grid, cfg, table), modules),
        "plain_momentum": (make_step(grid, cfg0, table),
                           {k: m for k, m in modules.items()
                            if k != "momentum"}),
    }
    states = dict.fromkeys(paths, state0)
    rec = {p: dict(step_s=[], krylov=[], launches={k: 0 for k in counted},
                   momentum_launches=[]) for p in paths}
    n_steps = STICKY_WARMUP_STEPS + STICKY_MEASURED_STEPS
    for i in range(n_steps):
        kind = "warm-up" if i < STICKY_WARMUP_STEPS else "measured"
        order = list(paths) if i % 2 == 0 else list(paths)[::-1]
        for p in order:
            step, required = paths[p]
            for mod in counted.values():
                mod.launches = 0
            states[p], dt_s, it, _ = take_step(
                step, states[p], n_markers, required,
                f"sticky-air {p} step {i + 1} ({kind})")
            r = rec[p]
            r["step_s"].append(dt_s)
            r["krylov"].append(it)
            r["momentum_launches"].append(modules["momentum"].launches)
            for k, mod in counted.items():
                r["launches"][k] += mod.launches
    others = {p: {k: n for k, n in r["launches"].items()
                  if k not in modules and n} for p, r in rec.items()}
    if any(others.values()):
        raise AssertionError(f"the sticky-air paths launched other kernels: "
                             f"{others}")
    if rec["plain_momentum"]["launches"]["momentum"]:
        raise AssertionError("the use_pallas=False path launched the momentum "
                             f"kernel: {rec['plain_momentum']['launches']}")
    meas = slice(STICKY_WARMUP_STEPS, None)
    for p, r in rec.items():
        r["median_s_per_step"] = statistics.median(r["step_s"][meas])
        log(f"sticky-air {grid.nx}x{grid.ny} on {smi} ({p}): median "
            f"{r['median_s_per_step']:.3f} s/step over "
            f"{STICKY_MEASURED_STEPS} steps, {mean(r['krylov'][meas]):.1f} "
            f"outer Krylov iterations/step, "
            f"{mean(r['momentum_launches'][meas]):.1f} momentum-kernel "
            f"launches/step; launches {r['launches']}")
    log("sticky-air A/B " + json.dumps({"device": smi, **rec}))
    for i, (a, b) in enumerate(zip(rec["use_pallas"]["krylov"],
                                   rec["plain_momentum"]["krylov"])):
        if abs(a - b) > max(2, 0.1 * a):
            raise AssertionError(
                f"sticky-air step {i + 1}: {a} outer Krylov iterations with "
                f"the momentum kernel, {b} without (bar +-max(2, 10 %))")
    return rec["use_pallas"]["launches"]


def zero_counters(modules):
    """Every launch counter of every kernel module (the periodic-form and
    rho0 * alpha counters too) set to 0."""
    for mod in modules.values():
        for f in ("launches", "launches_periodic", "launches_ra"):
            if hasattr(mod, f):
                setattr(mod, f, 0)


def counted_launches(modules):
    return {f"{k}.{f}": getattr(mod, f) for k, mod in modules.items()
            for f in ("launches", "launches_periodic", "launches_ra")
            if getattr(mod, f, 0)}


def stretched_step(step, state, n_markers, modules, tag):
    """One step of a stretched path with every counter set to 0 just
    before it: check_state's bars, the energy solve converged, and no
    kernel launched (every gate fails on a non-uniform grid).  Returns
    (state, seconds, Krylov, energy iterations)."""
    zero_counters(modules)
    state, dt_s, it, diag = take_step(step, state, n_markers, {}, tag)
    launched = counted_launches(modules)
    if launched:
        raise AssertionError(f"{tag}: kernels launched on a stretched grid: "
                             f"{launched}")
    if not diag["energy_converged"]:
        raise AssertionError(f"{tag}: the energy solve did not converge")
    return state, dt_s, it, int(diag["energy_iterations"])


def stretched_paths(modules):
    """The stretched grid (no kernel: the reference turns every one off on
    a non-uniform grid, and so does the port):

    (a) FK 1024^2 y-stretched 8x (``fk_stretched_bench_config``, bench.py
        --stretch-y 8): 1 warm-up + 3 measured steps, each converged
        (Stokes 1e-8, energy 1e-10), nothing dropped, every kernel counter
        at 0; the Krylov iterations per step beside the reference's, and a
        step above twice the reference's count fails;
    (b) its line-smoother partner from the same built state
        (``mg_smoother="line"``, the energy MG with ``"line"`` and flexible
        CG): 1 warm-up + 2 steps under the same bars;
    (c) FK 256^2 on explicit uniform edges (the stretched code path)
        against the uniform path with every kernel switch off, from one
        built state, 2 steps: Krylov counts within +-KRYLOV_AB_TOL, vx, vy,
        p and T within UNIFORM_EDGES_FIELD_TOL, sorted marker positions
        within UNIFORM_EDGES_MARKER_TOL of the box.  Both take
        power-iteration Chebyshev bounds (``mg_lam_mode="power"``): the
        stretched path's non-uniform levels always do, and the bound rule
        alone moves the first step's count by more than the bar on the
        card, which is not what this check compares.
    Returns the record printed in the log."""
    from dataclasses import replace

    import numpy as np

    from pylamp_tpu_torch.core.grid import StaggeredGrid
    from pylamp_tpu_torch.models.benchmarks import (
        fk_bench_config,
        fk_stretched_bench_config,
    )
    from pylamp_tpu_torch.models.profile import fk_stretched_line_config
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step

    smi = nvidia_smi_line()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           STRETCHED_REFERENCE)) as f:
        ref_krylov = float(json.load(f)["detail"]["krylov_iters_per_step"])
    cfg = fk_stretched_bench_config(STRETCHED_NX)
    t0 = time.perf_counter()
    grid, table, state0 = build(cfg, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_markers = int(state0.markers.total())
    ratio = float(grid.dys[-1] / grid.dys[0])
    log(f"built FK {grid.nx}^2 y-stretched {ratio:g}x: dy "
        f"{grid.dy_min:.4e} .. {float(grid.dys.max()):.4e}, "
        f"{n_markers} markers, {time.perf_counter() - t0:.1f} s")
    cfg_line = fk_stretched_line_config(STRETCHED_NX)
    rec = {}
    for name, c, measured in (
            ("chebyshev", cfg, STRETCHED_MEASURED_STEPS),
            ("line", cfg_line, STRETCHED_LINE_MEASURED_STEPS)):
        step = make_step(grid, c, table)
        state = state0
        r = rec[name] = dict(step_s=[], krylov=[], energy=[])
        for i in range(STRETCHED_WARMUP_STEPS + measured):
            kind = ("warm-up" if i < STRETCHED_WARMUP_STEPS else "measured")
            state, dt_s, it, e_it = stretched_step(
                step, state, n_markers, modules,
                f"stretched FK {name} step {i + 1} ({kind})")
            r["step_s"].append(dt_s)
            r["krylov"].append(it)
            r["energy"].append(e_it)
            if it > STRETCHED_KRYLOV_FACTOR * ref_krylov:
                raise AssertionError(
                    f"stretched FK {name} step {i + 1}: {it} Krylov "
                    f"iterations > {STRETCHED_KRYLOV_FACTOR:g} x the "
                    f"reference's {ref_krylov:g}")
        meas = slice(STRETCHED_WARMUP_STEPS, None)
        r["median_s_per_step"] = statistics.median(r["step_s"][meas])
        log(f"stretched FK {grid.nx}^2 ({ratio:g}x) on {smi}, "
            f"{name} smoother: median {r['median_s_per_step']:.3f} s/step "
            f"over {measured} steps, {mean(r['krylov'][meas]):.1f} Krylov "
            f"iterations/step (the reference: {ref_krylov:g} with the "
            f"Chebyshev smoother), energy iterations {r['energy']}; no "
            "kernel launched")
        del state
    del state0

    # (c) the stretched code path on uniform edges vs the uniform path
    n = UNIFORM_EDGES_NX
    base = fk_bench_config(n)
    base = replace(base, solver=replace(
        base.solver, use_pallas=False, use_pallas_apply=False,
        use_pallas_m2g=False, use_pallas_advect=False,
        use_pallas_smoother=False, use_pallas_coarse=False,
        mg_lam_mode="power"))
    xe = tuple(np.linspace(0.0, base.lx, n + 1))
    ye = tuple(np.linspace(0.0, base.ly, n + 1))
    cfg_e = replace(base, x_edges=xe, y_edges=ye)
    grid_u, table_u, st0 = build(base, dtype=torch.float32, device="cuda")
    grid_e = StaggeredGrid(nx=n, ny=n, lx=base.lx, ly=base.ly, x_edges=xe,
                           y_edges=ye)
    n_u = int(st0.markers.total())
    out = {}
    for name, g, c in (("uniform", grid_u, base), ("edges", grid_e, cfg_e)):
        step = make_step(g, c, table_u)
        st, its = st0, []
        for i in range(UNIFORM_EDGES_STEPS):
            tag = f"FK {n}^2 {name} step {i + 1}"
            if name == "edges":
                st, _, it, _ = stretched_step(step, st, n_u, modules, tag)
            else:
                st, _, it, _ = take_step(step, st, n_u, {}, tag)
            its.append(it)
        out[name] = (st, its)
    (a, ia), (b, ib) = out["uniform"], out["edges"]
    errs = {f: float(torch.max(torch.abs(getattr(b, f) - getattr(a, f)))
                     / torch.max(torch.abs(getattr(a, f))))
            for f in ("vx", "vy", "p", "T")}
    for f in ("x", "y"):
        pa = torch.sort(getattr(a.markers, f)[a.markers.valid])[0]
        pb = torch.sort(getattr(b.markers, f)[b.markers.valid])[0]
        box = base.lx if f == "x" else base.ly
        errs[f"markers.{f}"] = float(torch.max(torch.abs(pb - pa))) / box
    log(f"FK {n}^2 uniform edges vs uniform (kernels off): Krylov {ib} vs "
        f"{ia}, relative differences {errs}")
    rec["uniform_edges"] = dict(krylov_edges=ib, krylov_uniform=ia,
                                errors=errs)
    if any(abs(x - y) > KRYLOV_AB_TOL for x, y in zip(ia, ib)):
        raise AssertionError(f"uniform edges: Krylov {ib} vs {ia} (bar "
                             f"+-{KRYLOV_AB_TOL})")
    bad = {k: v for k, v in errs.items() if not v <= (
        UNIFORM_EDGES_MARKER_TOL if k.startswith("markers")
        else UNIFORM_EDGES_FIELD_TOL)}
    if bad:
        raise AssertionError(f"uniform edges disagree with the uniform step: "
                             f"{bad}")
    log("stretched " + json.dumps({"device": smi,
                                   "reference_krylov": ref_krylov, **rec}))
    return rec


def block_ops(n_points, iters, zero_init, emit):
    """f32 operations of one per-shard sweep over ``n_points`` velocity
    points (both lattices) of all shards."""
    applies = iters - (1 if zero_init else 0) + (1 if emit else 0)
    return (OPS["stencil"] * applies + OPS["cheb_update"] * iters
            + OPS["diag"]) * n_points


def block_level_times(cheb, cheb_block, hs, grids, etas, kbnds, lam, mesh,
                      vbc, deg, rand):
    """Kernel 8's pre-smooth form (zero start, degree ``deg`` + the
    residual) on every level of the FK 1024^2 hierarchy that the 4x2 mesh
    smooths with it (blocks 256x512 down to 8x16): checked bit-identical
    on a rerun, timed per call and on the device alone with its bound, and
    its occupancy recorded."""
    levels = [l for l, g in enumerate(grids) if hs.halo_smoother_eligible(
        g, mesh, vbc, torch.float32, deg, True)]
    blocks = [(grids[l].ny // mesh.my, grids[l].nx // mesh.mx)
              for l in levels]
    if blocks != [(256, 512), (128, 256), (64, 128), (32, 64), (16, 32),
                  (8, 16)]:
        raise AssertionError(f"kernel 8's mesh levels: blocks {blocks}")
    for l in levels:
        g, (les, len_) = grids[l], etas[l]
        prep = hs.prep_halo_smoother(les, len_, g, mesh, deg + 1, kbnds[l],
                                     lam[l])
        rx, ry = rand(*g.shape_vx), rand(*g.shape_vy)
        frames = hs.smoother_frames(torch.zeros_like(rx), torch.zeros_like(ry),
                                    rx, ry, vbc, mesh, prep.h)
        run = partial(cheb_block.cheb_block_cuda, *frames, prep, g, vbc, deg,
                      True, True)
        first, again = run(), run()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"cheb_block {g.ny}x{g.nx}: a rerun is not "
                                 "bit-identical")
        S, by, bx = mesh.size, prep.by, prep.bx
        plan = cheb.block_tile_plan(by, bx, deg + 1, S, cheb.device_sms(0))
        ms = cuda_time_ms(run, 20)
        dev_ms = graph_ms(run)
        b_ms, b_by = bound_ms(
            nbytes(*frames[2:], prep.es_v, prep.en_v, prep.flags,
                   prep.coeffs, prep.kb, *first),
            block_ops(2 * S * by * bx, deg, True, True))
        BLOCK_LEVEL_TIMES.append(dict(
            level=f"{g.ny}x{g.nx}", block=f"{by}x{bx}", shards=S,
            depth=deg + 1, ms=ms, device_ms=dev_ms, bound_ms=b_ms,
            bound_by=b_by, tile_rows=plan.ty,
            blocks=plan.nty * plan.ntx * S))
        OCCUPANCY[f"cheb_block {by}x{bx} depth {deg + 1}"] = \
            cheb_block.kernel_info(deg + 1, plan.ty)
        log(f"cheb_block level {g.ny}x{g.nx} ({S} blocks of {by}x{bx}), "
            f"pre-smooth form (depth {deg + 1}): kernel {ms:.4f} ms per call "
            f"({dev_ms} ms on the device, graph-timed), bound {b_ms:.5f} ms "
            f"({b_by}), {plan.nty * plan.ntx * S} tiles of {plan.ty}x32")


def mesh_kernel_rows(grid, cfg, table, state, fk):
    """The per-shard kernels 8-12 against their plain versions at the 4x2
    per-shard shapes of the FK 1024^2 x K18 step, each at one odd shape as
    well; inputs from the built state and its first solve (``fk``: the
    solve's eta, velocities and dt), seeded random residuals.  Kernels
    10-12 are also held bit for bit to their single-device siblings: the
    halo transfer to kernel 2, kernel 11 on windows cut from kernel 3's
    padded lattices to kernel 3 (reach 1 and 2), the halo rebucket to
    kernel 4."""
    from pylamp_tpu_torch.core.grid import StaggeredGrid
    from pylamp_tpu_torch.markers.bucket import padded_velocities
    from pylamp_tpu_torch.markers.kernels import (
        advect,
        advect_block,
        m2g,
        m2g_block,
        rebucket,
        rebucket_block,
    )
    from pylamp_tpu_torch.markers.kernels.advect_block import cut_windows
    from pylamp_tpu_torch.models.benchmarks import fk_stagnant_lid
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.ops.kernels import cheb, cheb_block, saddle_block
    from pylamp_tpu_torch.parallel import halo_smoother as hs
    from pylamp_tpu_torch.parallel.halo_markers import (
        BLK3,
        m2g_fused_halo,
        rebucket_halo,
        velocity_windows,
    )
    from pylamp_tpu_torch.parallel.mesh import P, make_mesh
    from pylamp_tpu_torch.solvers import mg
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    solver, phys, vbc = cfg.solver, cfg.physics, cfg.physics.velocity_bcs
    io = fk["io"]
    mesh = make_mesh(MESH_SHARDS)
    f32 = torch.float32
    deg = max(solver.mg_pre_smooth, solver.mg_post_smooth)
    es, en = io.eta_s.float(), io.eta_n.float()
    kcont, kbnd = stokes_scales(characteristic_viscosity(io.eta_n.double()),
                                grid)
    kcont, kbnd = kcont.float(), kbnd.float()
    _, grids, etas, kbnds = mg._hierarchy(es, en, grid, kbnd,
                                          solver.mg_levels,
                                          solver.mg_semicoarsen)
    lam = mg.estimate_mg_lambdas(es, en, grid, vbc, kbnd,
                                 levels=solver.mg_levels,
                                 semicoarsen=solver.mg_semicoarsen,
                                 mode="gershgorin")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows = []

    # -- kernel 8 on the frames of levels 1024, 512, 256 on the 4x2 mesh
    # (corner and edge shards), on a 3x3 and a 4x4 mesh (interior shards,
    # where whole shards take the branch-free path), on an odd 2x2 level,
    # and on frames deeper than the sweep: kernel vs plain, and the whole
    # sweep vs the single-device one
    def visc_case(n, shards, label, h=deg + 1):
        g = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
        eo, no = torch.exp(2.0 * rand(*g.shape_corner)), \
            torch.exp(2.0 * rand(*g.shape_center))
        _, kb_o = stokes_scales(characteristic_viscosity(no), g)
        return (g, (eo, no), kb_o, mg.gershgorin_lambda(eo, no, g, vbc, kb_o),
                make_mesh(shards), h, label)

    def cheb_cases():
        for l in range(3):
            yield (grids[l], etas[l], kbnds[l], lam[l], mesh, deg + 1,
                   f"level {grids[l].nx}")
        yield visc_case(384, 9, "384^2 on 3x3 (interior shard)")
        yield visc_case(256, 16, "256^2 on 4x4 (interior shards)")
        yield visc_case(68, 4, "odd 68^2 on 2x2")
        yield (grids[1], etas[1], kbnds[1], lam[1], mesh, MAX_FRAME_DEPTH,
               f"level {grids[1].nx}, frames of depth {MAX_FRAME_DEPTH}")

    errs, whole, timed = [], [], None
    for g, (les, len_), kb, lm, msh, h, label in cheb_cases():
        if not hs.halo_smoother_eligible(g, msh, vbc, f32, deg, True):
            raise AssertionError(f"cheb_block: {label} not eligible")
        prep = hs.prep_halo_smoother(les, len_, g, msh, h, kb, lm)
        rx, ry = rand(*g.shape_vx), rand(*g.shape_vy)
        for zero_init in (True, False):
            ex = torch.zeros_like(rx) if zero_init else rand(*g.shape_vx)
            ey = torch.zeros_like(ry) if zero_init else rand(*g.shape_vy)
            frames = hs.smoother_frames(ex, ey, rx, ry, vbc, msh, prep.h)
            got = cheb_block.cheb_block_cuda(*frames, prep, g, vbc, deg,
                                             zero_init, True)
            ref = cheb_block.cheb_block_plain(*frames, prep, g, vbc, deg,
                                              zero_init, True)
            errs.append(errors(zip(got, ref)))
            full = hs.chebyshev_smooth_halo(ex, ey, rx, ry, g, vbc, kb, lm,
                                            deg, msh, prep, zero_init, True)
            single = cheb.chebyshev_smooth_plain(ex, ey, rx, ry, les, len_, g,
                                                 vbc, kb, lm, deg, zero_init,
                                                 True)
            whole.append(errors(zip(full, single)))
            log(f"cheb_block {label} zero_init={zero_init}: kernel vs plain "
                f"rel {errs[-1][1]:.3e}; whole halo sweep vs single-device "
                f"rel {whole[-1][1]:.3e}")
            if timed is None:
                S, by, bx = msh.size, prep.by, prep.bx
                timed = (partial(cheb_block.cheb_block_cuda, *frames, prep, g,
                                 vbc, deg, True, True),
                         partial(cheb_block.cheb_block_plain, *frames, prep, g,
                                 vbc, deg, True, True),
                         # zero start: the ex/ey frames are never read
                         bound_ms(nbytes(*frames[2:], prep.es_v, prep.en_v,
                                         prep.flags, prep.coeffs, prep.kb,
                                         *got),
                                  block_ops(2 * S * by * bx, deg, True, True)))
    err = tuple(max(e[i] for e in errs + whole) for i in (0, 1))
    rows.append(("cheb_block", "pylamp_tpu_torch/csrc/cheb_block.cu",
                 "pylamp_tpu/ops/pallas/cheb_block_kernel.py:277", err,
                 timed[0], timed[1], 10, timed[2]))
    block_level_times(cheb, cheb_block, hs, grids, etas, kbnds, lam, mesh,
                      vbc, deg, rand)

    # -- kernel 9, both forms, on extended blocks of the solve's viscosities
    # (levels 1024 and 512) and at an odd shape
    def ext_blocks(g, les, len_, msh, scale):
        by, bx = g.ny // msh.my, g.nx // msh.mx
        S = msh.size
        en_e = msh.flat(msh.ext1(msh.split(len_, P("y", "x"))))
        es_e = msh.flat(msh.ext1(msh.split(les[:-1, :-1], P("y", "x")))
                        [..., 1:, 1:])
        vx_e, vy_e, p_e = (rand(S, by + 2, bx + 2) * sc for sc in scale)
        return vx_e, vy_e, p_e, es_e, en_e

    scale = [float(torch.max(torch.abs(fk[k]))) for k in ("vx", "vy")] + [
        1.0]
    errs, timed = [], None
    cases = [(grids[0], etas[0], mesh), (grids[1], etas[1], mesh)]
    for g, (les, len_), msh in cases:
        vx_e, vy_e, p_e, es_e, en_e = ext_blocks(g, les, len_, msh, scale)
        for p_or_none in (p_e, None):
            args = (vx_e, vy_e, p_or_none, es_e, en_e, g.dx, g.dy, kcont)
            got = saddle_block.saddle_block_cuda(*args)
            ref = saddle_block.saddle_block_plain(*args)
            errs.append(errors(zip(got, ref)))
            log(f"saddle_block {g.ny // msh.my}x{g.nx // msh.mx} blocks "
                f"with_p={p_or_none is not None}: rel {errs[-1][1]:.3e}")
            if timed is None:
                n = vx_e.shape[0] * (vx_e.shape[1] - 2) * (vx_e.shape[2] - 2)
                timed = (partial(saddle_block.saddle_block_cuda, *args),
                         partial(saddle_block.saddle_block_plain, *args),
                         bound_ms(nbytes(vx_e, vy_e, p_e, es_e, en_e, *got),
                                  n * (2 * OPS["stencil"] + 2 * OPS["pressure"]
                                       + OPS["continuity"])))
    odd = (rand(3, 23, 40), rand(3, 23, 40), rand(3, 23, 40),
           torch.exp(rand(3, 22, 39)), torch.exp(rand(3, 23, 40)))
    for with_p in (True, False):
        args = (odd[0], odd[1], odd[2] if with_p else None, odd[3], odd[4],
                0.01, 0.02, 3.0)
        errs.append(errors(zip(saddle_block.saddle_block_cuda(*args),
                               saddle_block.saddle_block_plain(*args))))
    log(f"saddle_block odd 21x38 blocks: rel {max(e[1] for e in errs[-2:]):.3e}")
    err = tuple(max(e[i] for e in errs) for i in (0, 1))
    rows.append(("saddle_block", "pylamp_tpu_torch/csrc/saddle_block.cu",
                 "pylamp_tpu/ops/pallas/block_stencil_kernel.py:174", err,
                 timed[0], timed[1], 20, timed[2]))

    # -- kernels 10-12 on the FK markers' 256x512x18 blocks, and on a 40^2
    # FK build on a 2x2 mesh (20x20 blocks)
    _, _, small = build(fk_stagnant_lid(nx=40, ny=40), dtype=f32,
                        device="cuda")
    small_grid = StaggeredGrid(nx=40, ny=40, lx=1.0, ly=1.0)
    marker_cases = [(grid, state.markers, mesh, fk["vx"], fk["vy"], fk["dt"],
                     "FK 1024^2"),
                    (small_grid, small.markers, make_mesh(4),
                     0.05 * rand(*small_grid.shape_vx),
                     0.05 * rand(*small_grid.shape_vy),
                     torch.tensor(2.0 * small_grid.dx, device="cuda"),
                     "odd 40^2 on 2x2")]
    e10, e11, e12, rows_t = [], [], [], {}
    for g, m, msh, vx, vy, dt, label in marker_cases:
        by, bx = g.ny // msh.my, g.nx // msh.mx
        bases = msh.bases(by, bx, device="cuda")
        ext = [msh.flat(msh.ext1(msh.split(a, BLK3), nd=3))
               for a in (m.x, m.y, m.T, m.mat, m.valid)]
        got = m2g_block.m2g_fused_block_cuda(*ext, g, table, phys, bases,
                                             with_energy=True)
        ref = m2g_block.m2g_fused_block_plain(*ext, g, table, phys, bases,
                                              with_energy=True)
        e10.append(errors((got[k], ref[k]) for k in ref))
        halo = m2g_fused_halo(m, g, table, phys, msh, with_energy=True)
        glob = m2g.m2g_fused_cuda(m, g, table, phys, with_energy=True)
        same = sorted(halo) == sorted(glob) and all(
            torch.equal(halo[k], glob[k]) for k in glob)
        log(f"m2g_block {label}: kernel vs plain rel {e10[-1][1]:.3e}; halo "
            f"transfer vs kernel 2 {'bit-identical' if same else 'max rel '}"
            + ("" if same else
               f"{errors((halo[k], glob[k]) for k in glob)[1]:.3e}"))
        if not same:  # kernel 2's body in kernel 2's order
            raise AssertionError(f"m2g_block {label}: the halo transfer is "
                                 "not bit-identical to kernel 2")
        if "m2g_block" not in rows_t:
            n_ext = int(ext[4].sum())
            rows_t["m2g_block"] = (
                partial(m2g_block.m2g_fused_block_cuda, *ext, g, table, phys,
                        bases, with_energy=True),
                partial(m2g_block.m2g_fused_block_plain, *ext, g, table, phys,
                        bases, with_energy=True),
                bound_ms(nbytes(*ext, bases, *got.values()),
                         OPS["m2g"] * n_ext))

        wins = velocity_windows(vx.float(), vy.float(), g, vbc, msh, 1)
        own = [msh.flat(msh.split(a, BLK3)) for a in (m.x, m.y, m.valid)]
        adv = (*own, *wins, dt, g, bases, 1)
        got = advect_block.advect_block_cuda(*adv)
        ref = advect_block.advect_block_plain(*adv)
        e11.append(displacement_error(got, ref, own[:2]))
        # on windows cut from kernel 3's padded lattices, kernel 11 gives
        # kernel 3's positions bit for bit, at both stage reaches
        cut_same = []
        for R in (1, 2):
            k3 = advect.advect_rk4_cuda(m, vx.float(), vy.float(), dt, g, vbc,
                                        R)
            cuts = cut_windows(*padded_velocities(vx.float(), vy.float(),
                                                  vbc), bases, by, bx, R)
            cx, cy = advect_block.advect_block_cuda(*own, *cuts, dt, g, bases,
                                                    R)
            cut_same.append(
                torch.equal(msh.gather(msh.unflat(cx), BLK3), k3.x)
                and torch.equal(msh.gather(msh.unflat(cy), BLK3), k3.y))
        log(f"advect_block {label}: displacement rel err {e11[-1][1]:.3e}; "
            "on windows cut from kernel 3's lattices, reach 1 and 2: "
            + ", ".join("bit-identical to kernel 3" if s else "DIFFERS"
                        for s in cut_same))
        if not all(cut_same):
            raise AssertionError(f"advect_block {label}: kernel 11 on cut "
                                 "windows is not bit-identical to kernel 3")
        if "advect_block" not in rows_t:
            rows_t["advect_block"] = (
                partial(advect_block.advect_block_cuda, *adv),
                partial(advect_block.advect_block_plain, *adv),
                bound_ms(nbytes(*own, *wins, bases, *got),
                         OPS["advect"] * int(own[2].sum())))

        moved = m.replace(x=msh.gather(msh.unflat(got[0]), BLK3),
                          y=msh.gather(msh.unflat(got[1]), BLK3))
        ext = [msh.flat(msh.ext1(msh.split(a, BLK3), nd=3))
               for a in (moved.x, moved.y, moved.T, moved.mat, moved.valid)]
        (gm, ga), (rm, ra) = (rebucket_block.rebucket_block_cuda(*ext, g,
                                                                  bases),
                              rebucket_block.rebucket_block_plain(*ext, g,
                                                                  bases))
        same = all(torch.equal(getattr(gm, f), getattr(rm, f))
                   for f in ("x", "y", "mat", "T", "valid")) and torch.equal(
            ga, ra)
        (hm, hd), (km, kd) = (rebucket_halo(moved, g, msh),
                              rebucket.rebucket_cuda(moved, g))
        same4 = all(torch.equal(getattr(hm, f), getattr(km, f))
                    for f in ("x", "y", "mat", "T", "valid")) and int(hd) == int(kd)
        e12.append((0.0, 0.0) if same else (math.inf, math.inf))
        log(f"rebucket_block {label}: {'bit-identical' if same else 'DIFFERS'}"
            f" to its plain version; halo rebucket "
            f"{'bit-identical' if same4 else 'DIFFERS'} to kernel 4 "
            f"(dropped {int(hd)})")
        if not same4:
            e12.append((math.inf, math.inf))
        if "rebucket_block" not in rows_t:
            rows_t["rebucket_block"] = (
                partial(rebucket_block.rebucket_block_cuda, *ext, g, bases),
                partial(rebucket_block.rebucket_block_plain, *ext, g, bases),
                bound_ms(nbytes(*ext, bases, gm.x, gm.y, gm.T, gm.mat,
                                gm.valid, ga),
                         OPS["rebucket"] * int(ext[4].sum())))
    for name, es_, src, ref_line, reps in (
            ("m2g_block", e10, "m2g_block.cu", "m2g_kernel.py:283", 3),
            ("advect_block", e11, "advect_block.cu", "advect_kernel.py:208", 3),
            ("rebucket_block", e12, "rebucket_block.cu",
             "rebucket_kernel.py:187", 2)):
        err = tuple(max(e[i] for e in es_) for i in (0, 1))
        k, pfn, b = rows_t[name]
        rows.append((name, f"pylamp_tpu_torch/csrc/{src}",
                     f"pylamp_tpu/markers/pallas/{ref_line}", err, k, pfn,
                     reps, b))
    return rows


def mesh_path(grid, cfg, table, state0, n_markers, modules, label="FK mesh",
              measured=MESH_MEASURED_STEPS, ra=False, krylov_rel=0.0):
    """FK 1024^2 with explicit_halo=True on the in-process 4x2 mesh and its
    single-device partner from the same built state, steps interleaved
    (mesh first on odd steps, second on even ones).  Every counter is set
    to 0 before each step and read after it; the mesh path must launch
    kernels 8-12 and none of kernels 1-7.  After the first step the two
    states are compared.  ``n_markers`` None: each step's marker count is
    held to the count it started from (reseeding adds markers after the
    count).  ``ra``: kernels 2 and 10 must launch with the rho0 * alpha
    stream on every step, and never without it.  Krylov counts within
    +-max(KRYLOV_AB_TOL, ``krylov_rel`` of the mesh path's).  Returns each
    path's launch counts and the mesh path's first step: (state, Krylov
    iterations, launches by kernel, the step's peak memory above what the
    process held, GiB)."""
    from dataclasses import replace

    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    smi = nvidia_smi_line()
    mesh = make_mesh(MESH_SHARDS)
    cfg_h = replace(cfg, solver=replace(cfg.solver, explicit_halo=True))
    block = ("cheb_block", "saddle_block", "m2g_block", "advect_block",
             "rebucket_block")
    single = ("saddle", "m2g", "advect", "rebucket", "cheb", "coarse_vcycle")
    paths = {
        "mesh_4x2": (make_step(grid, cfg_h, table, mesh=mesh),
                     {k: modules[k] for k in block}),
        "single": (make_step(grid, cfg, table),
                   {k: modules[k] for k in single}),
    }
    states = dict.fromkeys(paths, state0)
    rec = {p: dict(step_s=[], krylov=[], launches={k: 0 for k in modules})
           for p in paths}
    ra_mods = {"mesh_4x2": modules["m2g_block"], "single": modules["m2g"]}
    n_steps = MESH_WARMUP_STEPS + measured
    for i in range(n_steps):
        kind = "warm-up" if i < MESH_WARMUP_STEPS else "measured"
        order = list(paths) if i % 2 == 0 else list(paths)[::-1]
        for p in order:
            step, required = paths[p]
            for mod in modules.values():
                mod.launches = 0
            for mod in ra_mods.values():
                mod.launches_ra = 0
            tag = f"{label} A/B {p} step {i + 1} ({kind})"
            n_start = (n_markers if n_markers is not None
                       else int(states[p].markers.total()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held0 = torch.cuda.memory_allocated()
            states[p], dt_s, it, _ = take_step(step, states[p], n_start,
                                               required, tag)
            peak = (torch.cuda.max_memory_allocated() - held0) / 2 ** 30
            mod = ra_mods[p]
            if ra and not 0 < mod.launches_ra == mod.launches:
                raise AssertionError(
                    f"{tag}: {mod.launches_ra} of {mod.launches} m2g "
                    "launches with the rho0 * alpha stream")
            r = rec[p]
            r["step_s"].append(dt_s)
            r["krylov"].append(it)
            for k, mod in modules.items():
                r["launches"][k] += mod.launches
            if i == 0 and p == "mesh_4x2":
                first = (states[p], it,
                         {k: mod.launches for k, mod in modules.items()},
                         peak)
        if i == 0:
            mesh_agrees(label, states["mesh_4x2"], states["single"])
    idle = {k: n for k, n in rec["mesh_4x2"]["launches"].items()
            if k not in block and n}
    if idle:
        raise AssertionError(f"the mesh path launched single-device kernels: "
                             f"{idle}")
    meas = slice(MESH_WARMUP_STEPS, None)
    for p, r in rec.items():
        r["median_s_per_step"] = statistics.median(r["step_s"][meas])
        log(f"{label} {grid.nx}^2 {p} on {smi}: median "
            f"{r['median_s_per_step']:.3f} s/step over {measured} "
            f"steps, {mean(r['krylov'][meas]):.1f} Krylov iterations/step; "
            f"launches {r['launches']}")
    log(f"{label} A/B " + json.dumps({"device": smi, **rec}))
    for i, (a, b) in enumerate(zip(rec["mesh_4x2"]["krylov"],
                                   rec["single"]["krylov"])):
        if abs(a - b) > max(KRYLOV_AB_TOL, krylov_rel * a):
            raise AssertionError(
                f"{label} step {i + 1}: {a} Krylov iterations, single-device "
                f"{b} (bar +-max({KRYLOV_AB_TOL}, {krylov_rel:.0%}))")
    return {p: r["launches"] for p, r in rec.items()}, first


def mesh_agrees(label, a, b):
    """The mesh path's state ``a`` against the single device's ``b`` after
    one step from the same state: velocities within 1e-5 max|vy|, marker y
    within 1e-5 max|y|, materials equal."""
    vmax = float(torch.max(torch.abs(b.vy)))
    ymax = float(torch.max(torch.abs(b.markers.y)))
    dv = max(float(torch.max(torch.abs(a.vx - b.vx))),
             float(torch.max(torch.abs(a.vy - b.vy))))
    dyy = float(torch.max(torch.abs(a.markers.y - b.markers.y)))
    same_mat = torch.equal(a.markers.mat, b.markers.mat)
    log(f"{label} vs single-device after step 1: max |dv| / max|vy| "
        f"{dv / vmax:.3e}, max |dy| / max|y| {dyy / ymax:.3e}, "
        f"materials {'equal' if same_mat else 'DIFFER'}")
    if not (dv <= 1e-5 * vmax and dyy <= 1e-5 * ymax and same_mat):
        raise AssertionError(f"{label}: the mesh step disagrees with the "
                             "single-device step")


DIST_RANKS = 8  # the 4x2 mesh, one shard a rank
DIST_TIMEOUT_S = 900.0  # the world's deadline (launch kills it after)
BLOCK_KERNELS = ("cheb_block", "saddle_block", "m2g_block", "advect_block",
                 "rebucket_block")


def _kernel_modules():
    """The twelve kernel wrappers' modules by row name (their launch
    counters)."""
    from pylamp_tpu_torch.markers.kernels import (
        advect,
        advect_block,
        m2g,
        m2g_block,
        rebucket,
        rebucket_block,
    )
    from pylamp_tpu_torch.ops.kernels import (
        cheb,
        cheb_block,
        momentum,
        saddle,
        saddle_block,
    )
    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk

    return {"saddle": saddle, "m2g": m2g, "advect": advect,
            "rebucket": rebucket, "cheb": cheb, "coarse_vcycle": cvk,
            "momentum": momentum, "cheb_block": cheb_block,
            "saddle_block": saddle_block, "m2g_block": m2g_block,
            "advect_block": advect_block, "rebucket_block": rebucket_block}


def _measured_rank_step(step, state0, modules, device):
    """``step(state0)`` on a rank of a distributed mesh, measured: the
    peak memory, every launch counter (the periodic-form ones and kernel
    10's rho0 * alpha one too) and the transport's counts set to 0 after
    a barrier just before the step and read just after it.  Returns
    (state, diagnostics, {step_s, launches, launches_periodic,
    launches_ra, rounds, peak_gib})."""
    import torch.distributed as dist

    from pylamp_tpu_torch.parallel import dist as pdist

    m2g_block = modules["m2g_block"]
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    zero_counters(modules)
    pdist.reset_rounds()
    t0 = time.perf_counter()
    state, diag = step(state0)
    torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    return state, diag, dict(
        step_s=step_s,
        launches={k: mod.launches for k, mod in modules.items()},
        launches_periodic={k: mod.launches_periodic
                           for k, mod in modules.items()
                           if hasattr(mod, "launches_periodic")},
        launches_ra=m2g_block.launches_ra, rounds=dict(pdist.rounds),
        peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)


def _rank_state(cfg, state_path, mesh, device):
    """A rank's sharded state of ``cfg`` loaded from ``state_path`` (the
    host loads it, the rank moves only its blocks to the card): (grid,
    table, state, the largest piece of a leaf the rank holds, the markers'
    block size, the pieces beyond their lattice's block or strip)."""
    import numpy as np

    from pylamp_tpu_torch.bridge import (
        oversized_leaves,
        sharded_from_numpy,
        state_leaves,
    )
    from pylamp_tpu_torch.models.setup import grid_and_table

    grid, table = grid_and_table(cfg)
    with np.load(state_path) as z:
        state0 = sharded_from_numpy(dict(z), mesh, device=device)
    held = max(p.numel() for v in state_leaves(state0).values()
               for p in (v.pieces().values() if hasattr(v, "pieces")
                         else (v,)))
    block = (grid.ny // mesh.my) * (grid.nx // mesh.mx) * \
        state0.markers.x.shape[-1]
    return grid, table, state0, held, block, oversized_leaves(state0, grid,
                                                             mesh)


def _dist_rank_step(cfg, state_path, mesh, modules, device, label):
    """One measured step of ``cfg`` on this rank's shard of ``mesh`` from
    the state at ``state_path`` (``_rank_state``), checked by
    ``check_state``: the record ``dist_fk_rank`` returns for it."""
    from pylamp_tpu_torch.bridge import oversized_leaves, state_leaves
    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel.dist import replicas_agree
    from pylamp_tpu_torch.parallel.mesh import unshard_state

    grid, table, state0, held, block, oversized = _rank_state(
        cfg, state_path, mesh, device)
    n_markers = int(state0.markers.total())
    state, diag, out = _measured_rank_step(
        make_step(grid, cfg, table, mesh=mesh), state0, modules, device)
    check_state(state, n_markers, diag, f"{label} rank {mesh.rank}")
    oversized.update(oversized_leaves(state, grid, mesh))
    out.update(rank=mesh.rank, device=str(device),
               krylov=int(diag["stokes_iterations"]), held=held, block=block,
               oversized=oversized, agree=replicas_agree(state, mesh))
    full = unshard_state(state, mesh, root=0)
    if full is not None:
        out["leaves"] = {k: v.cpu() for k, v in state_leaves(full).items()}
    return out


def dist_fk_rank(device, state_path, periodic_path=None):
    """One rank of ``dist_mesh_path``: FK 1024^2 (the bench preset with
    explicit_halo) on this rank's shard of the distributed 4x2 mesh, in
    the sharded layout, one step from the state at ``state_path``: the
    host loads it and the rank moves only its blocks to the card.  Every
    launch counter and the transport's counts are set to 0 and the peak
    memory reset just before the step and read just after it.  Returns
    the step's seconds, Krylov count, launches, collectives by kind,
    peak device memory, the largest piece of a leaf the rank holds and
    the pieces beyond their own lattice's block or strip
    (``bridge.oversized_leaves``), whether the replicated scalars and
    strips agree on every rank, and (rank 0) the gathered state's
    leaves.  With ``periodic_path``, the rank then steps the periodic
    falling block 1024^2 (explicit halos, the marker engine's wrap-around
    exchange) from that state in the same world: its record under
    "periodic"."""
    from dataclasses import replace

    from pylamp_tpu_torch.models.benchmarks import (
        falling_block_periodic_config,
        fk_bench_config,
    )
    from pylamp_tpu_torch.parallel.dist import DistMesh

    modules = _kernel_modules()
    mesh = DistMesh.from_group(4, 2)
    cfg = fk_bench_config(FK_NX)
    cfg = replace(cfg, solver=replace(cfg.solver, explicit_halo=True))
    out = _dist_rank_step(cfg, state_path, mesh, modules, device,
                          "FK dist 4x2")
    if periodic_path is not None:
        cfg = falling_block_periodic_config(PERIODIC_NX)
        cfg = replace(cfg, solver=replace(cfg.solver, explicit_halo=True))
        out["periodic"] = _dist_rank_step(cfg, periodic_path, mesh, modules,
                                          device, "periodic dist 4x2")
    return out


def nccl_rank(device):
    """The one-rank NCCL group's check: the distributed 1x1 mesh's psum,
    psum_many, pmax, gather and gather to rank 0 (NCCL all-to-alls) on
    seeded tensors on the card, bit for bit against the in-process 1x1
    mesh's."""
    import torch.distributed as dist

    from pylamp_tpu_torch.parallel.dist import DistMesh, replicas_agree
    from pylamp_tpu_torch.parallel.mesh import P, Mesh

    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}, not nccl")
    mesh, ref = DistMesh.from_group(1, 1), Mesh(1, 1)
    gen = torch.Generator(device=device).manual_seed(18)
    a = torch.randn((256, 512), generator=gen, device=device)
    b = torch.randint(0, 9, (256, 512, 18), generator=gen, device=device,
                      dtype=torch.int32)
    checked = 0
    for spec in (P("y", "x"), P("y", None), P(None, "x")):
        for x in (a, b):
            got = mesh.gather(mesh.split(x, spec), spec)
            if not torch.equal(got, ref.gather(ref.split(x, spec), spec)):
                raise AssertionError(f"nccl gather {spec} differs")
            checked += 1
    for axes in ("y", "x", ("y", "x")):
        got = mesh.psum(mesh.split(a, P("y", "x")), axes)
        if not torch.equal(got, ref.psum(ref.split(a, P("y", "x")), axes)):
            raise AssertionError(f"nccl psum over {axes} differs")
        checked += 1
    pairs = ((a, P("y", "x"), "x"), (b, P("y", "x", None), ("y", "x")))
    got = mesh.psum_many(*((mesh.split(x, s), ax) for x, s, ax in pairs))
    want = ref.psum_many(*((ref.split(x, s), ax) for x, s, ax in pairs))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("nccl psum_many differs")
    x = mesh.split(a, P("y", "x"))
    if not torch.equal(mesh.pmax(x, ("y", "x")),
                       ref.pmax(ref.split(a, P("y", "x")), ("y", "x"))):
        raise AssertionError("nccl pmax differs")
    got = mesh.gather_many((x, P("y", "x")), root=0)[0]
    if not torch.equal(got, a):
        raise AssertionError("nccl gather to rank 0 differs")
    if not replicas_agree({"a": a, "b": b}):
        raise AssertionError("nccl: replicas_agree failed on one rank")
    return dict(checked=checked + 4, backend=dist.get_backend())


DIST_PEAK_GIB = 0.5  # a rank's step peak on the sharded layout
HEATED_VARIANTS = ("jacobi", "mg")  # the energy solve: Jacobi-CG, MG-FCG


PERIODIC_BLOCK_KERNELS = ("saddle_block", "m2g_block", "advect_block",
                          "rebucket_block")  # kernel 8 stays off there


def periodic_sharded_inprocess(grid, cfg, table, state0, modules):
    """The periodic falling block (``cfg``, explicit halos) on the
    in-process 4x2 mesh, one step on the global layout (markers on the
    global tensors, kernels 2p-4p and 9) and one on the sharded layout
    (the marker engine's wrap-around exchange, kernels 9 and 10p-12p)
    from the same built state: the sharded step must hold the global one
    within the mesh bars (``mesh_agrees``, Krylov +-2), keep its vx seam
    columns bit-identical, its marker x in [0, lx), drop no marker, launch
    kernels 9-12 (10-12 only in their periodic forms) and no other.
    Returns (the sharded step's global state, Krylov, launches, periodic
    launches, seconds, peak GiB above what the process held)."""
    from dataclasses import replace

    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_state,
        unshard_state,
    )

    mesh = make_mesh(DIST_RANKS)
    cfg_h = replace(cfg, solver=replace(cfg.solver, explicit_halo=True))
    step = make_step(grid, cfg_h, table, mesh=mesh)
    n_markers = int(state0.markers.total())
    zero_counters(modules)
    ref, _, ref_krylov, _ = take_step(
        step, state0, n_markers, {k: modules[k] for k in (
            "saddle_block", "m2g", "advect", "rebucket")},
        "periodic global-layout 4x2 step 1")
    sharded0 = shard_state(state0, mesh)
    zero_counters(modules)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    sharded, dt_s, krylov, _ = take_step(
        step, sharded0, n_markers,
        {k: modules[k] for k in PERIODIC_BLOCK_KERNELS},
        "periodic sharded 4x2 step 1")
    peak = (torch.cuda.max_memory_allocated() - held0) / 2 ** 30
    launches = {k: mod.launches for k, mod in modules.items()}
    launches_p = {k: mod.launches_periodic for k, mod in modules.items()
                  if hasattr(mod, "launches_periodic")}
    del sharded0
    want = unshard_state(sharded, mesh)
    del sharded
    mesh_agrees("periodic sharded 4x2 vs global layout", want, ref)
    seam_equal("periodic sharded 4x2 vx", want.vx)
    periodic_state_checks("periodic sharded 4x2", want, grid)
    if abs(krylov - ref_krylov) > KRYLOV_AB_TOL:
        raise AssertionError(f"periodic sharded 4x2: Krylov {krylov}, the "
                             f"global layout's {ref_krylov}")
    wrong = {k: n for k, n in launches.items()
             if (k not in PERIODIC_BLOCK_KERNELS and n)
             or (k in launches_p and k.endswith("_block")
                 and launches_p[k] != n)}
    if wrong:
        raise AssertionError(f"periodic sharded 4x2: launches outside "
                             f"kernels 9-12 or their periodic forms: {wrong}")
    log(f"periodic sharded 4x2 (in-process) on {nvidia_smi_line()}: "
        f"{dt_s:.3f} s, Krylov {krylov} (the global layout's {ref_krylov}), "
        f"launches {launches}, periodic forms {launches_p}, step peak above "
        f"what the process held {peak:.2f} GiB")
    return want, krylov, launches, launches_p, dt_s, peak


def dist_mesh_path(grid, cfg, table, state0, first, modules, periodic=None):
    """FK 1024^2 on the DISTRIBUTED 4x2 mesh (``parallel/dist.py``) in the
    sharded layout: first the in-process 4x2 mesh takes the step on the
    sharded state (``shard_state`` of ``state0``), held within the mesh
    bars (``mesh_agrees``, Krylov +-2) of the in-process global-layout
    step ``first`` (``mesh_path``'s first step); then eight gloo ranks on
    this one card (spawned by ``launch``, CUDA payloads staged through the
    host) each take it on their own blocks from ``state0`` (handed over
    in a file the host loads).  Rank 0's gathered state must equal the
    in-process sharded state bit for bit in every leaf, the replicated
    scalars and strips must agree on every rank, every rank's Krylov
    count must equal it, kernels 8-12 must launch per rank as often as in
    the in-process sharded step and kernels 1-7 never, no rank may hold a
    piece of a leaf larger than its own lattice's block or strip, its
    step peak must stay within DIST_PEAK_GIB and no block may be
    all-gathered in the step.  ``periodic`` (grid, cfg, table, state):
    the periodic falling block 1024^2, held in-process
    (``periodic_sharded_inprocess``) and then stepped by every rank of
    the same world after the FK step, under the same checks (kernels
    9-12, 10-12 only in their periodic forms).  Then a
    one-rank NCCL group runs the distributed mesh's collectives on the
    card against the in-process mesh.  Returns rank 0's launches, the
    logged record and every rank's summary."""
    import tempfile
    from dataclasses import replace

    import numpy as np

    from pylamp_tpu_torch.bridge import state_leaves, state_to_numpy
    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel.dist import launch
    from pylamp_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_state,
        unshard_state,
    )

    smi = nvidia_smi_line()
    ref_state, ref_krylov, ref_launches, peak_global = first
    mesh = make_mesh(DIST_RANKS)
    cfg_h = replace(cfg, solver=replace(cfg.solver, explicit_halo=True))
    sharded0 = shard_state(state0, mesh)
    n_markers = int(state0.markers.total())
    for mod in modules.values():
        mod.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    sharded, dt_s, krylov, _ = take_step(
        make_step(grid, cfg_h, table, mesh=mesh), sharded0, n_markers,
        {k: modules[k] for k in BLOCK_KERNELS}, "FK sharded 4x2 step 1")
    peak_sharded = (torch.cuda.max_memory_allocated() - held0) / 2 ** 30
    launches = {k: mod.launches for k, mod in modules.items()}
    del sharded0
    want_state = unshard_state(sharded, mesh)
    del sharded
    log(f"FK sharded 4x2 (in-process) on {smi}: {dt_s:.3f} s, Krylov "
        f"{krylov} (the global layout's {ref_krylov}), launches {launches}, "
        f"step peak above what the process held {peak_sharded:.2f} GiB "
        f"(the global layout's {peak_global:.2f} GiB)")
    mesh_agrees("FK sharded 4x2", want_state, ref_state)
    if abs(krylov - ref_krylov) > KRYLOV_AB_TOL:
        raise AssertionError(f"FK sharded 4x2: Krylov {krylov}, the global "
                             f"layout's {ref_krylov} (bar +-{KRYLOV_AB_TOL})")
    if any(launches[k] for k in modules if k not in BLOCK_KERNELS):
        raise AssertionError(f"FK sharded 4x2 launched single-device "
                             f"kernels: {launches}")
    if periodic is not None:
        t_p = time.perf_counter()
        per = periodic_sharded_inprocess(*periodic, modules)
        t_p = time.perf_counter() - t_p
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dist_mesh_") as tmp:
        path = os.path.join(tmp, "state0.npz")
        np.savez(path, **state_to_numpy(state0))
        paths = [path]
        if periodic is not None:
            paths.append(os.path.join(tmp, "periodic0.npz"))
            np.savez(paths[1], **state_to_numpy(periodic[3]))
        ranks = launch(DIST_RANKS, dist_fk_rank, *paths, device="cuda",
                       backend="gloo", timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r in ranks:
        log(f"FK dist 4x2 sharded rank {r['rank']} ({r['device']}, gloo) on "
            f"{smi}: {r['step_s']:.3f} s/step, Krylov {r['krylov']}, step "
            f"peak {r['peak_gib']:.3f} GiB, largest leaf {r['held']} of "
            f"{r['block']} block elements, launches {r['launches']}, "
            f"collectives {r['rounds']}")
    log(f"FK dist 4x2 sharded: backend gloo, world {DIST_RANKS} on one "
        f"card, {wall:.1f} s for the world (spawn, load, shard, step, "
        "gather, checks)")
    differ = _leaves_differ(state_leaves(want_state), ranks[0]["leaves"])
    agree = all(r["agree"] for r in ranks)
    log(f"FK dist 4x2 sharded vs the in-process sharded 4x2 step: "
        f"{'every leaf bit-identical' if not differ else differ}, replicated "
        f"values {'agree' if agree else 'DIFFER'}, Krylov "
        f"{[r['krylov'] for r in ranks]} vs {krylov}")
    if differ or not agree:
        raise AssertionError(f"FK dist 4x2: rank states differ from the "
                             f"in-process mesh's ({differ}, agree={agree})")
    want_l = {k: (launches[k] if k in BLOCK_KERNELS else 0) for k in modules}
    for r in ranks:
        tag = f"FK dist 4x2 rank {r['rank']}"
        if r["krylov"] != krylov:
            raise AssertionError(f"{tag}: Krylov {r['krylov']} != {krylov}")
        if r["launches"] != want_l:
            raise AssertionError(
                f"{tag}: launches {r['launches']}, the in-process sharded "
                f"step's {want_l} (kernels 1-7: 0)")
        if r["oversized"]:
            raise AssertionError(f"{tag}: holds pieces beyond their "
                                 "lattice's block or strip (held, bound): "
                                 f"{r['oversized']}")
        if r["peak_gib"] > DIST_PEAK_GIB:
            raise AssertionError(f"{tag}: step peak {r['peak_gib']:.3f} GiB "
                                 f"> {DIST_PEAK_GIB}")
        if r["rounds"]["block"]:
            raise AssertionError(f"{tag}: {r['rounds']['block']} block "
                                 "all-gathers in the step")
    rec_p = None
    if periodic is not None:
        rec_p = dist_periodic_checks(per, [r["periodic"] for r in ranks],
                                     smi, t_p)
    nccl = launch(1, nccl_rank, device="cuda", backend="nccl",
                  timeout_s=DIST_TIMEOUT_S)[0]
    log(f"one-rank NCCL group on {smi}: {nccl['checked']} checks of the "
        f"distributed mesh's gather / psum / psum_many / pmax / gather to "
        f"rank 0 / replicas_agree bit-identical to the in-process mesh's")
    rec = {"device": smi, "backend": "gloo", "world": DIST_RANKS,
           "layout": "sharded",
           "step_s": [r["step_s"] for r in ranks],
           "peak_gib": [r["peak_gib"] for r in ranks],
           "peak_gib_inprocess_sharded": peak_sharded,
           "peak_gib_inprocess_global": peak_global,
           "rounds_per_rank": ranks[0]["rounds"],
           "krylov": krylov, "krylov_global_layout": ref_krylov,
           "launches_per_rank": ranks[0]["launches"],
           "launches_global_layout": ref_launches, "world_s": wall}
    log("FK dist 4x2 " + json.dumps(rec))
    return {"launches": ranks[0]["launches"], **rec, "periodic": rec_p,
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("leaves", "periodic")} for r in ranks]}


def _leaves_differ(want, got):
    """The leaves of ``got`` (rank 0's gathered state) that are not
    bit-identical to ``want``'s: {name: max |difference| or "dtype"}."""
    differ = {}
    for k, v in want.items():
        g = got[k].to(v.device)
        if g.dtype != v.dtype or not torch.equal(g, v):
            differ[k] = (float(torch.max(torch.abs(g.double() - v.double())))
                         if g.dtype == v.dtype else "dtype")
    return differ


def dist_periodic_checks(inproc, ranks, smi, inproc_s):
    """The periodic falling block's ranks (``dist_fk_rank``'s "periodic"
    records) against the in-process sharded step ``inproc``
    (``periodic_sharded_inprocess``): rank 0's gathered leaves bit for
    bit, the replicated values agreeing, every rank's Krylov count equal,
    kernels 9-12 launched per rank as often as in-process (10-12 in their
    periodic forms only) and no other, no piece beyond its block, a peak
    within DIST_PEAK_GIB and no block all-gather.  Logs each rank's
    s/step and collectives by kind; returns the record."""
    from pylamp_tpu_torch.bridge import state_leaves

    want_state, krylov, launches, launches_p, dt_s, peak = inproc
    for r in ranks:
        log(f"periodic dist 4x2 sharded rank {r['rank']} ({r['device']}, "
            f"gloo) on {smi}: {r['step_s']:.3f} s/step, Krylov "
            f"{r['krylov']}, step peak {r['peak_gib']:.3f} GiB, largest leaf "
            f"{r['held']} of {r['block']} block elements, launches "
            f"{r['launches']}, periodic forms {r['launches_periodic']}, "
            f"collectives {r['rounds']}")
    differ = _leaves_differ(state_leaves(want_state), ranks[0]["leaves"])
    agree = all(r["agree"] for r in ranks)
    log(f"periodic dist 4x2 sharded vs the in-process sharded 4x2 step: "
        f"{'every leaf bit-identical' if not differ else differ}, replicated "
        f"values {'agree' if agree else 'DIFFER'}, Krylov "
        f"{[r['krylov'] for r in ranks]} vs {krylov}")
    if differ or not agree:
        raise AssertionError(f"periodic dist 4x2: rank states differ from "
                             f"the in-process mesh's ({differ}, "
                             f"agree={agree})")
    want_l = {k: (launches[k] if k in PERIODIC_BLOCK_KERNELS else 0)
              for k in launches}
    for r in ranks:
        tag = f"periodic dist 4x2 rank {r['rank']}"
        if r["krylov"] != krylov:
            raise AssertionError(f"{tag}: Krylov {r['krylov']} != {krylov}")
        if r["launches"] != want_l or any(
                r["launches_periodic"][k] != want_l[k]
                for k in ("m2g_block", "advect_block", "rebucket_block")):
            raise AssertionError(
                f"{tag}: launches {r['launches']} (periodic forms "
                f"{r['launches_periodic']}), the in-process sharded step's "
                f"{want_l} (kernels 1-8: 0; 10-12 periodic only)")
        if r["oversized"]:
            raise AssertionError(f"{tag}: holds pieces beyond their "
                                 f"lattice's block or strip: {r['oversized']}")
        if r["peak_gib"] > DIST_PEAK_GIB:
            raise AssertionError(f"{tag}: step peak {r['peak_gib']:.3f} GiB "
                                 f"> {DIST_PEAK_GIB}")
        if r["rounds"]["block"]:
            raise AssertionError(f"{tag}: {r['rounds']['block']} block "
                                 "all-gathers in the step")
    rec = {"device": smi, "backend": "gloo", "world": DIST_RANKS,
           "layout": "sharded", "step_s": [r["step_s"] for r in ranks],
           "peak_gib": [r["peak_gib"] for r in ranks],
           "peak_gib_inprocess_sharded": peak, "step_s_inprocess_sharded":
           dt_s, "inprocess_s": inproc_s,
           "rounds_per_rank": [r["rounds"] for r in ranks],
           "krylov": krylov, "launches_per_rank": ranks[0]["launches"],
           "launches_periodic_per_rank": ranks[0]["launches_periodic"]}
    log("periodic dist 4x2 " + json.dumps(rec))
    return rec


def _heated_halo_config(nx, energy_preconditioner):
    """``models.profile.fk_heated_config`` with ``explicit_halo=True``."""
    from dataclasses import replace

    from pylamp_tpu_torch.models.profile import fk_heated_config

    cfg = fk_heated_config(nx, energy_preconditioner)
    return replace(cfg, solver=replace(cfg.solver, explicit_halo=True))


def dist_heated_rank(device, state_path):
    """One rank of ``dist_heated_path``: the heated FK 1024^2 on this
    rank's shard of the distributed 4x2 mesh, the Jacobi-CG step and then
    the MG-FCG step, each from the state at ``state_path`` (the host loads
    it, the rank moves only its blocks to the card).  Every launch counter
    and the transport's counts are set to 0 and the peak memory reset just
    before each step and read just after it.  Returns per variant the
    step's seconds, Stokes and energy counts, launches (kernel 10's with
    the rho0 * alpha stream apart), collectives and received bytes by
    kind, peak device memory, the pieces beyond their own lattice's block
    or strip (after sharding and after the step), whether the replicated
    values agree, the marker count after reseeding and (rank 0) the
    gathered state's leaves."""
    import numpy as np

    from pylamp_tpu_torch.bridge import (
        oversized_leaves,
        sharded_from_numpy,
        state_leaves,
    )
    from pylamp_tpu_torch.models.setup import grid_and_table
    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel.dist import DistMesh, replicas_agree
    from pylamp_tpu_torch.parallel.mesh import unshard_state

    modules = _kernel_modules()
    mesh = DistMesh.from_group(4, 2)
    with np.load(state_path) as z:
        d0 = dict(z)
    out = {"rank": mesh.rank, "device": str(device)}
    for pre in HEATED_VARIANTS:
        tag = f"heated FK dist 4x2 {pre} rank {mesh.rank}"
        cfg = _heated_halo_config(FK_NX, pre)
        grid, table = grid_and_table(cfg)
        state0 = sharded_from_numpy(d0, mesh, device=device)
        oversized = oversized_leaves(state0, grid, mesh)
        n_markers = int(state0.markers.total())
        state, diag, rec = _measured_rank_step(
            make_step(grid, cfg, table, mesh=mesh), state0, modules, device)
        check_state(state, n_markers, diag, tag)
        if not diag["energy_converged"]:
            raise AssertionError(f"{tag}: the energy solve did not converge")
        oversized.update(oversized_leaves(state, grid, mesh))
        rec.update(krylov=int(diag["stokes_iterations"]),
                   energy=int(diag["energy_iterations"]),
                   oversized=oversized, agree=replicas_agree(state, mesh),
                   markers=int(state.markers.total()))
        full = unshard_state(state, mesh, root=0)
        if full is not None:
            rec["leaves"] = {k: v.cpu() for k, v in state_leaves(full).items()}
        out[pre] = rec
        del state0, state, full
    return out


def dist_heated_path(grid, table, state0, first, modules):
    """The heated FK 1024^2 (``models.profile.fk_heated_config``, both
    energy solves) on the sharded layout: the in-process 4x2 mesh takes
    the Jacobi-CG step on ``shard_state`` of ``state0``, held within the
    mesh bars (Krylov +-max(KRYLOV_AB_TOL, HEATED_KRYLOV_REL)) of the
    heated mesh path's first, global-layout step ``first`` from the same
    state, then the MG-FCG step (T within HEATED_T_TOL max|T| of the
    Jacobi step, Krylov within the same bar); kernels 8-12 must launch,
    kernel 10 always with the rho0 * alpha stream, 1-7 never.  Then eight
    gloo ranks on this one card, in one world, each take both steps from
    ``state0`` on their own blocks (``dist_heated_rank``).  Per variant,
    rank 0's gathered state must equal the in-process sharded step's bit
    for bit in every leaf, with the same marker count after reseeding;
    every rank must have its Stokes and energy counts, launch kernels
    8-12 as often (kernel 10 always with the stream) and 1-7 never, agree
    on its replicated values, hold no oversized leaf, stay within
    DIST_PEAK_GIB and all-gather no block.  Returns the record logged,
    with rank 0's launches per variant."""
    import tempfile

    import numpy as np

    from pylamp_tpu_torch.bridge import state_leaves, state_to_numpy
    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel.dist import launch
    from pylamp_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_state,
        unshard_state,
    )

    smi = nvidia_smi_line()
    ref_state, ref_krylov, _, _ = first
    mesh = make_mesh(DIST_RANKS)
    m2g_block = modules["m2g_block"]
    sharded0 = shard_state(state0, mesh)
    n_markers = int(state0.markers.total())
    want, inproc = {}, {}
    for pre in HEATED_VARIANTS:
        tag = f"heated FK sharded 4x2 {pre} step 1"
        for mod in modules.values():
            mod.launches = 0
        m2g_block.launches_ra = 0
        st, dt_s, krylov, diag = take_step(
            make_step(grid, _heated_halo_config(grid.nx, pre), table,
                      mesh=mesh), sharded0, n_markers,
            {k: modules[k] for k in BLOCK_KERNELS}, tag)
        launches = {k: mod.launches for k, mod in modules.items()}
        if any(launches[k] for k in modules if k not in BLOCK_KERNELS):
            raise AssertionError(f"{tag} launched single-device kernels: "
                                 f"{launches}")
        if not 0 < m2g_block.launches_ra == m2g_block.launches:
            raise AssertionError(
                f"{tag}: {m2g_block.launches_ra} of {m2g_block.launches} "
                "m2g_block launches with the rho0 * alpha stream")
        if not diag["energy_converged"]:
            raise AssertionError(f"{tag}: the energy solve did not converge")
        full = unshard_state(st, mesh)
        del st
        want[pre] = full
        inproc[pre] = dict(step_s=dt_s, krylov=krylov,
                           energy=int(diag["energy_iterations"]),
                           launches=launches,
                           launches_ra=m2g_block.launches_ra,
                           markers=int(full.markers.total()))
    del sharded0
    bar = max(KRYLOV_AB_TOL, HEATED_KRYLOV_REL * ref_krylov)
    mesh_agrees("heated FK sharded 4x2 (Jacobi-CG)", want["jacobi"],
                ref_state)
    dT = float(torch.max(torch.abs(want["mg"].T - want["jacobi"].T)))
    tmax = float(torch.max(torch.abs(want["jacobi"].T)))
    log(f"heated FK sharded 4x2 (in-process) on {smi}: {inproc} (the "
        f"global layout's Krylov {ref_krylov}); MG-FCG vs Jacobi-CG max "
        f"|dT| / max|T| {dT / tmax:.3e} (bar {HEATED_T_TOL:g})")
    for pre, r in inproc.items():
        if abs(r["krylov"] - ref_krylov) > bar:
            raise AssertionError(
                f"heated FK sharded 4x2 {pre}: Krylov {r['krylov']}, the "
                f"global layout's Jacobi step {ref_krylov} (bar +-{bar:g})")
    if not dT <= HEATED_T_TOL * tmax:
        raise AssertionError("heated FK sharded 4x2: the MG-FCG step's T "
                             "disagrees with the Jacobi-CG step's")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dist_heated_") as tmp:
        path = os.path.join(tmp, "state0.npz")
        np.savez(path, **state_to_numpy(state0))
        ranks = launch(DIST_RANKS, dist_heated_rank, path, device="cuda",
                       backend="gloo", timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    rec = {"device": smi, "backend": "gloo", "world": DIST_RANKS,
           "layout": "sharded", "world_s": wall,
           "krylov_global_layout": ref_krylov}
    for pre in HEATED_VARIANTS:
        label = f"heated FK dist 4x2 {pre}"
        ref = inproc[pre]
        for r in ranks:
            v = r[pre]
            log(f"{label} rank {r['rank']} ({r['device']}, gloo) on {smi}: "
                f"{v['step_s']:.3f} s/step, Krylov {v['krylov']}, energy "
                f"{v['energy']}, step peak {v['peak_gib']:.3f} GiB, markers "
                f"{v['markers']}, launches {v['launches']} (m2g_block with "
                f"rho0 * alpha {v['launches_ra']}), collectives and bytes "
                f"received {v['rounds']}")
        wl = state_leaves(want[pre])
        got = ranks[0][pre]["leaves"]
        differ = {}
        for k, v in wl.items():
            g = got[k].to(v.device)
            if g.dtype != v.dtype or not torch.equal(g, v):
                differ[k] = (float(torch.max(torch.abs(
                    g.double() - v.double()))) if g.dtype == v.dtype
                    else "dtype")
        agree = all(r[pre]["agree"] for r in ranks)
        log(f"{label} vs the in-process sharded 4x2 step: "
            f"{'every leaf bit-identical' if not differ else differ}, "
            f"replicated values {'agree' if agree else 'DIFFER'}, markers "
            f"after reseeding {[r[pre]['markers'] for r in ranks]} vs "
            f"{ref['markers']}")
        if differ or not agree:
            raise AssertionError(f"{label}: rank states differ from the "
                                 f"in-process mesh's ({differ}, "
                                 f"agree={agree})")
        want_l = {k: (ref["launches"][k] if k in BLOCK_KERNELS else 0)
                  for k in modules}
        for r in ranks:
            v, tag = r[pre], f"{label} rank {r['rank']}"
            for key in ("krylov", "energy", "markers"):
                if v[key] != ref[key]:
                    raise AssertionError(f"{tag}: {key} {v[key]}, the "
                                         f"in-process step's {ref[key]}")
            if v["launches"] != want_l:
                raise AssertionError(
                    f"{tag}: launches {v['launches']}, the in-process "
                    f"sharded step's {want_l} (kernels 1-7: 0)")
            if not 0 < v["launches_ra"] == v["launches"]["m2g_block"]:
                raise AssertionError(
                    f"{tag}: {v['launches_ra']} of "
                    f"{v['launches']['m2g_block']} m2g_block launches with "
                    "the rho0 * alpha stream")
            if v["oversized"]:
                raise AssertionError(f"{tag}: holds pieces beyond their "
                                     "lattice's block or strip (held, "
                                     f"bound): {v['oversized']}")
            if v["peak_gib"] > DIST_PEAK_GIB:
                raise AssertionError(f"{tag}: step peak {v['peak_gib']:.3f} "
                                     f"GiB > {DIST_PEAK_GIB}")
            if v["rounds"]["block"]:
                raise AssertionError(f"{tag}: {v['rounds']['block']} block "
                                     "all-gathers in the step")
        rec[pre] = {"step_s": [r[pre]["step_s"] for r in ranks],
                    "peak_gib": [r[pre]["peak_gib"] for r in ranks],
                    "rounds_per_rank": [r[pre]["rounds"] for r in ranks],
                    "krylov": ref["krylov"], "energy": ref["energy"],
                    "markers": ref["markers"],
                    "inprocess_sharded_s": ref["step_s"],
                    "launches_per_rank": ranks[0][pre]["launches"],
                    "launches_ra_per_rank": ranks[0][pre]["launches_ra"]}
    log(f"heated FK dist 4x2: backend gloo, world {DIST_RANKS} on one card, "
        f"{wall:.1f} s for the world (spawn, load, shard, two steps, "
        "gathers, checks)")
    log("heated FK dist 4x2 " + json.dumps(rec))
    return rec


def seam_equal(name, a):
    """The two seam columns of an nx+1-wide array: one node, bit-identical."""
    if not torch.equal(a[:, 0], a[:, -1]):
        d = float(torch.max(torch.abs(a[:, 0] - a[:, -1])))
        raise AssertionError(f"{name}: the seam columns differ by {d:.3e}")


def periodic_kernel_rows(grid, cfg, table, state):
    """The periodic forms of kernels 1-5 and 7 against their plain versions
    on the card at the falling_block_periodic 1024^2 x K18 shapes, inputs
    from the built state after one interp and one Stokes solve of the
    preset: kernel 1 on the solve's viscosities, kernels 2-4 on the markers
    (advection with the solve's velocities and dt), kernels 5 and 7 on the
    levels 1024, 512 and 256 of the solve's hierarchy (Gershgorin bounds),
    with seeded random vectors whose vx seam columns are equal, as the
    periodic multigrid keeps them.  Kernel 5 runs its pre-smooth form (zero
    start + residual) and its post-smooth form; each level's pre-smooth
    form is timed (``level_time``).  The seam columns of kernels 1, 5 and 7
    must come out bit-identical."""
    from pylamp_tpu_torch.markers.kernels import advect, m2g, rebucket
    from pylamp_tpu_torch.models.step import make_step_phases
    from pylamp_tpu_torch.ops.kernels import cheb, momentum, saddle
    from pylamp_tpu_torch.solvers import mg
    from pylamp_tpu_torch.solvers.scaling import (
        characteristic_viscosity,
        stokes_scales,
    )

    phys, solver, vbc = cfg.physics, cfg.solver, cfg.physics.velocity_bcs
    ph = make_step_phases(grid, cfg, table)
    io = ph.interp(state)
    vx, vy, p, sdiag = ph.stokes(state, io)
    dt = ph.timestep(vx, vy, io.k_m, io.rhocp_m)
    torch.cuda.synchronize()
    log(f"periodic setup solve: {sdiag['stokes_iterations']} Krylov "
        f"iterations, rel residual {sdiag['stokes_residual_rel']:.3e}")
    m = state.markers
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(shape, scale=1.0, seam=False):
        a = torch.randn(shape, generator=gen, device="cuda") * scale
        if seam:
            a[:, -1] = a[:, 0]
        return a

    rows = []
    # 1p: the saddle apply
    kcont, kbnd = stokes_scales(characteristic_viscosity(io.eta_n.double()),
                                grid)
    prep = saddle.prep_saddle(io.eta_s, io.eta_n, kcont.float(), kbnd.float())
    u = [rand(t.shape, torch.max(torch.abs(t)), seam=(t is vx))
         for t in (vx, vy, p)]
    got = saddle.saddle_apply_cuda(*u, prep, grid, vbc)
    ref = saddle.saddle_apply_plain(*u, prep, grid, vbc)
    seam_equal("saddle_periodic rx", got[0])
    ops = (stencil_ops(grid) + OPS["pressure"] * (vx.numel() + vy.numel())
           + OPS["continuity"] * p.numel())
    rows.append(("saddle_periodic", "pylamp_tpu_torch/csrc/saddle.cu",
                 "pylamp_tpu/ops/pallas/stokes_kernel.py:407",
                 errors(zip(got, ref)),
                 partial(saddle.saddle_apply_cuda, *u, prep, grid, vbc),
                 partial(saddle.saddle_apply_plain, *u, prep, grid, vbc), 50,
                 bound_ms(nbytes(*u, prep.eta_s, prep.eta_n, prep.kk, *got),
                          ops)))

    # 2p: marker -> grid, the streams of the step (no energy) timed, the
    # energy streams checked as well
    errs = []
    for with_energy in (True, phys.solve_energy):
        got = m2g.m2g_fused_cuda(m, grid, table, phys, with_energy, True)
        ref = m2g.m2g_fused_plain(m, grid, table, phys, with_energy, True)
        if sorted(got) != sorted(ref):
            raise AssertionError(f"periodic m2g streams differ: {sorted(got)}"
                                 f" vs {sorted(ref)}")
        errs.append(errors((got[k], ref[k]) for k in ref))
        rerun_equal("m2g_periodic", got, m2g.m2g_fused_cuda(
            m, grid, table, phys, with_energy, True))
        for k, a in got.items():
            if a.shape[1] == grid.nx + 1:
                seam_equal(f"m2g_periodic {k}", a)
    n_valid = int(m.total())
    rows.append(("m2g_periodic", "pylamp_tpu_torch/csrc/m2g.cu",
                 "pylamp_tpu/markers/pallas/m2g_kernel.py:407",
                 tuple(max(e[i] for e in errs) for i in (0, 1)),
                 partial(m2g.m2g_fused_cuda, m, grid, table, phys,
                         phys.solve_energy, True),
                 partial(m2g.m2g_fused_plain, m, grid, table, phys,
                         phys.solve_energy, True), 5,
                 bound_ms(nbytes(m.x, m.y, m.T, m.mat, m.valid)
                          + nbytes(*got.values()), OPS["m2g"] * n_valid)))

    # 3p: RK4 advection with the solve's velocities, x wrapped into [0, lx)
    got = advect.advect_rk4_cuda(m, vx, vy, dt, grid, vbc, 1)
    ref = advect.advect_rk4_plain(m, vx, vy, dt, grid, vbc, 1)
    again = advect.advect_rk4_cuda(m, vx, vy, dt, grid, vbc, 1)
    rerun_equal("advect_periodic", {"x": got.x, "y": got.y},
                {"x": again.x, "y": again.y})
    x = got.x[m.valid]
    if not (float(x.min()) >= 0.0 and float(x.max()) <= grid.lx):
        raise AssertionError("periodic advect: x outside [0, lx]")
    rows.append(("advect_periodic", "pylamp_tpu_torch/csrc/advect.cu",
                 "pylamp_tpu/markers/pallas/advect_kernel.py:282",
                 displacement_error((got.x, got.y), (ref.x, ref.y),
                                    (m.x, m.y), (grid.lx, None)),
                 partial(advect.advect_rk4_cuda, m, vx, vy, dt, grid, vbc, 1),
                 partial(advect.advect_rk4_plain, m, vx, vy, dt, grid, vbc, 1),
                 5, bound_ms(nbytes(m.x, m.y, m.valid, vx, vy, got.x, got.y),
                             OPS["advect"] * n_valid)))

    # 4p: rebucket of the advected markers, bit-identical
    moved = got
    (gm, gd), (rm, rd) = (rebucket.rebucket_cuda(moved, grid, True),
                          rebucket.rebucket_plain(moved, grid, True))
    same = all(torch.equal(getattr(gm, f), getattr(rm, f))
               for f in ("x", "y", "mat", "T", "valid")) and int(gd) == int(rd)
    crossed = int(torch.sum(moved.valid & (torch.abs(moved.x - m.x)
                                           > 0.5 * grid.lx)))
    log(f"periodic rebucket: dropped {int(gd)} (plain {int(rd)}), {crossed} "
        "markers crossed the seam")
    rows.append(("rebucket_periodic", "pylamp_tpu_torch/csrc/rebucket.cu",
                 "pylamp_tpu/markers/pallas/rebucket_kernel.py:311",
                 (0.0, 0.0) if same else (math.inf, math.inf),
                 partial(rebucket.rebucket_cuda, moved, grid, True),
                 partial(rebucket.rebucket_plain, moved, grid, True), 3,
                 bound_ms(2 * nbytes(m.x, m.y, m.T, m.mat, m.valid),
                          OPS["rebucket"] * n_valid)))

    # 5p and 7p on the solve's levels 1024, 512, 256
    deg = max(solver.mg_pre_smooth, solver.mg_post_smooth)
    es, en = io.eta_s.float(), io.eta_n.float()
    _, kb = stokes_scales(characteristic_viscosity(io.eta_n.double()), grid)
    _, grids, etas, kbnds = mg._hierarchy(es, en, grid, kb.float(),
                                          solver.mg_levels,
                                          solver.mg_semicoarsen)
    lam = mg.estimate_mg_lambdas(es, en, grid, vbc, kb.float(),
                                 levels=solver.mg_levels,
                                 semicoarsen=solver.mg_semicoarsen,
                                 mode="gershgorin")
    levels = [l for l, g in enumerate(grids)
              if cheb.smoother_eligible(g, torch.float32, deg, True)]
    if [grids[l].nx for l in levels] != [1024, 512, 256] or any(
            not mg._pallas_eligible(grids[l], torch.float32) for l in levels):
        raise AssertionError(f"periodic fused smoother levels {levels}")
    cheb_errs, mom_errs, timed = [], [], {}
    for l in levels:
        g, (les, len_), kbl = grids[l], etas[l], kbnds[l]
        seam_equal(f"eta_s of level {g.nx}", les)
        prep = cheb.prep_smoother(les, len_, g, vbc, kbl, lam[l], deg + 1)
        rx, ry = rand(g.shape_vx, seam=True), rand(g.shape_vy)
        zx, zy = torch.zeros_like(rx), torch.zeros_like(ry)
        ex, ey = rand(g.shape_vx, seam=True), rand(g.shape_vy)
        for (sx, sy), zero_init, emit in (((zx, zy), True, True),
                                          ((ex, ey), False, False)):
            got = cheb.chebyshev_smooth_cuda(sx, sy, rx, ry, prep, g, vbc,
                                             deg, zero_init, emit)
            ref = cheb.chebyshev_smooth_plain(sx, sy, rx, ry, les, len_, g,
                                              vbc, kbl, lam[l], deg,
                                              zero_init, emit)
            for a in got[::2]:
                seam_equal(f"cheb_periodic {g.nx}", a)
            cheb_errs.append(errors(zip(got, ref)))
            log(f"periodic cheb level {g.ny}x{g.nx} zero_init={zero_init} "
                f"emit={emit}: max abs err {cheb_errs[-1][0]:.3e}, rel "
                f"{cheb_errs[-1][1]:.3e}")
        level_time(cheb, "periodic", g, prep, zx, zy, rx, ry, vbc, deg)
        mprep = momentum.prep_momentum(les, len_, kbl)
        got = momentum.momentum_apply_cuda(ex, ey, mprep, g, vbc)
        ref = momentum.momentum_apply_plain(ex, ey, les, len_, g, vbc, kbl)
        seam_equal(f"momentum_periodic {g.nx}", got[0])
        mom_errs.append(errors(zip(got, ref)))
        log(f"periodic momentum {g.ny}x{g.nx}: max abs err "
            f"{mom_errs[-1][0]:.3e}, rel {mom_errs[-1][1]:.3e}")
        if not timed:  # the finest level
            timed["cheb_periodic"] = (
                partial(cheb.chebyshev_smooth_cuda, zx, zy, rx, ry, prep, g,
                        vbc, deg, True, True),
                partial(cheb.chebyshev_smooth_plain, zx, zy, rx, ry, les,
                        len_, g, vbc, kbl, lam[l], deg, True, True), 20,
                bound_ms(2 * nbytes(rx, ry) + nbytes(
                    rx, ry, prep.eta_s, prep.eta_n, prep.coeffs, prep.kb),
                    cheb_ops(g, deg, True, True)))
            timed["momentum_periodic"] = (
                partial(momentum.momentum_apply_cuda, ex, ey, mprep, g, vbc),
                partial(momentum.momentum_apply_plain, ex, ey, les, len_, g,
                        vbc, kbl), 50,
                bound_ms(nbytes(ex, ey, mprep.eta_s, mprep.eta_n, mprep.kb,
                                *got), stencil_ops(g)))
    for name, errs, src, line in (
            ("cheb_periodic", cheb_errs, "cheb.cu",
             "ops/pallas/cheb_kernel.py:347"),
            ("momentum_periodic", mom_errs, "momentum.cu",
             "ops/pallas/stokes_kernel.py:183")):
        kfn, pfn, reps, b = timed[name]
        rows.append((name, f"pylamp_tpu_torch/csrc/{src}",
                     f"pylamp_tpu/{line}",
                     tuple(max(e[i] for e in errs) for i in (0, 1)), kfn, pfn,
                     reps, b))
    return rows + periodic_block_rows(grid, table, phys, vbc, m, vx, vy, dt)


def periodic_block_rows(grid, table, phys, vbc, m, vx, vy, dt):
    """The periodic forms of the per-shard marker kernels (10p-12p, port-
    only) on the ring-exchanged blocks: at the 4x2 mesh's 256x512 x K18
    blocks of the periodic falling block 1024^2 (its built markers, the
    setup solve's velocities and dt), and on a 40x48 periodic build on the
    2x4 mesh (20x12 blocks, a ring of four) with seeded velocities.  Each
    against its plain version; and on frames cut from the global state
    against kernels 2p-4p: the halo transfer bit-identical to kernel 2p,
    the exchanged velocity windows equal to windows cut from kernel 3p's
    wrapped planes and kernel 11p on them bit-identical to kernel 3p at
    reach 1 and 2 on every marker that does not cross the seam (those
    that do are counted and their differences logged), the halo rebucket
    slot for slot kernel 4p's with the same drops."""
    from pylamp_tpu_torch.markers.bucket import padded_velocities
    from pylamp_tpu_torch.markers.kernels import (
        advect,
        advect_block,
        m2g,
        m2g_block,
        rebucket,
        rebucket_block,
    )
    from pylamp_tpu_torch.markers.kernels.advect_block import cut_windows
    from pylamp_tpu_torch.models.benchmarks import falling_block_periodic
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.parallel.halo_markers import (
        BLK3,
        _ext_blocks,
        m2g_fused_halo,
        rebucket_halo,
        velocity_windows,
    )
    from pylamp_tpu_torch.parallel.mesh import Mesh, make_mesh

    gen = torch.Generator(device="cuda").manual_seed(21)
    g_s, t_s, small = build(falling_block_periodic(nx=48, ny=40),
                            dtype=torch.float32, device="cuda")

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    vx_s = 0.05 * rand(g_s.shape_vx)
    vx_s[:, -1] = vx_s[:, 0]
    cases = [(grid, table, m, make_mesh(MESH_SHARDS), vx, vy, dt,
              f"periodic {grid.nx}^2 on 4x2"),
             (g_s, t_s, small.markers, Mesh(2, 4), vx_s,
              0.05 * rand(g_s.shape_vy),
              torch.tensor(2.0 * g_s.dx, device="cuda"),
              f"periodic {g_s.ny}x{g_s.nx} on 2x4")]
    e10, e11, e12, rows_t = [], [], [], {}
    for g, tbl, mk, msh, ux, uy, dt_, label in cases:
        by, bx = g.ny // msh.my, g.nx // msh.mx
        bases = msh.bases(by, bx, device="cuda")
        ext = _ext_blocks(msh, mk.x, mk.y, mk.T, mk.mat, mk.valid,
                          periodic_x=True)
        kw = dict(with_energy=True, periodic_x=True)
        got = m2g_block.m2g_fused_block_cuda(*ext, g, tbl, phys, bases, **kw)
        ref = m2g_block.m2g_fused_block_plain(*ext, g, tbl, phys, bases, **kw)
        e10.append(errors((got[k], ref[k]) for k in ref))
        halo = m2g_fused_halo(mk, g, tbl, phys, msh, with_energy=True,
                              periodic_x=True)
        glob = m2g.m2g_fused_cuda(mk, g, tbl, phys, True, True)
        same = sorted(halo) == sorted(glob) and all(
            torch.equal(halo[k], glob[k]) for k in glob)
        log(f"m2g_block_periodic {label}: kernel vs plain rel "
            f"{e10[-1][1]:.3e}; halo transfer vs kernel 2p "
            + ("bit-identical" if same else "DIFFERS"))
        if not same:
            raise AssertionError(f"m2g_block_periodic {label}: the halo "
                                 "transfer is not bit-identical to kernel 2p")
        if "m2g_block_periodic" not in rows_t:
            rows_t["m2g_block_periodic"] = (
                partial(m2g_block.m2g_fused_block_cuda, *ext, g, tbl, phys,
                        bases, **kw),
                partial(m2g_block.m2g_fused_block_plain, *ext, g, tbl, phys,
                        bases, **kw),
                bound_ms(nbytes(*ext, bases, *got.values()),
                         OPS["m2g"] * int(ext[4].sum())))

        own = [msh.flat(msh.split(a, BLK3)) for a in (mk.x, mk.y, mk.valid)]
        wins = velocity_windows(ux, uy, g, vbc, msh, 1)
        adv = (*own, *wins, dt_, g, bases, 1, True)
        got = advect_block.advect_block_cuda(*adv)
        ref = advect_block.advect_block_plain(*adv)
        e11.append(displacement_error(got, ref, own[:2], (g.lx, None)))
        planes = advect.wrapped_planes(*padded_velocities(ux, uy, vbc), g.nx)
        notes = []
        for R in (1, 2):
            cuts = cut_windows(*planes, bases, by, bx, R, advect.PADW)
            if R == 1 and not all(torch.equal(w, c)
                                  for w, c in zip(wins, cuts)):
                raise AssertionError(f"advect_block_periodic {label}: the "
                                     "exchanged windows differ from kernel "
                                     "3p's wrapped planes")
            k3 = advect.advect_rk4_cuda(mk, ux, uy, dt_, g, vbc, R)
            cx, cy = advect_block.advect_block_cuda(*own, *cuts, dt_, g,
                                                    bases, R, True)
            cx = msh.gather(msh.unflat(cx), BLK3)
            cy = msh.gather(msh.unflat(cy), BLK3)
            crossed = torch.abs(k3.x - mk.x) > 0.5 * g.lx
            diff = (cx != k3.x) | (cy != k3.y)
            bad = int(torch.sum(diff & ~crossed))
            notes.append(f"reach {R}: {int(torch.sum(crossed & mk.valid))} "
                         f"cross the seam ({int(torch.sum(diff & crossed))} "
                         f"of those differ), {bad} others differ")
            if bad:
                raise AssertionError(f"advect_block_periodic {label} reach "
                                     f"{R}: {bad} markers that stay clear "
                                     "of the seam differ from kernel 3p")
        log(f"advect_block_periodic {label}: displacement rel err "
            f"{e11[-1][1]:.3e}; windows equal kernel 3p's wrapped planes; "
            f"on cut windows vs kernel 3p: {'; '.join(notes)}")
        if "advect_block_periodic" not in rows_t:
            rows_t["advect_block_periodic"] = (
                partial(advect_block.advect_block_cuda, *adv),
                partial(advect_block.advect_block_plain, *adv),
                bound_ms(nbytes(*own, *wins, bases, *got),
                         OPS["advect"] * int(own[2].sum())))

        moved = mk.replace(x=msh.gather(msh.unflat(got[0]), BLK3),
                           y=msh.gather(msh.unflat(got[1]), BLK3))
        ext = _ext_blocks(msh, moved.x, moved.y, moved.T, moved.mat,
                          moved.valid, periodic_x=True)
        (gm, ga), (rm, ra) = (
            rebucket_block.rebucket_block_cuda(*ext, g, bases, True),
            rebucket_block.rebucket_block_plain(*ext, g, bases))
        same = all(torch.equal(getattr(gm, f), getattr(rm, f))
                   for f in ("x", "y", "mat", "T", "valid")) and torch.equal(
            ga, ra)
        (hm, hd), (km, kd) = (rebucket_halo(moved, g, msh, periodic_x=True),
                              rebucket.rebucket_cuda(moved, g, True))
        same4 = all(torch.equal(getattr(hm, f), getattr(km, f))
                    for f in ("x", "y", "mat", "T", "valid")) and \
            int(hd) == int(kd)
        crossed = int(torch.sum(moved.valid & (torch.abs(moved.x - mk.x)
                                               > 0.5 * g.lx)))
        e12.append((0.0, 0.0) if same and same4 else (math.inf, math.inf))
        log(f"rebucket_block_periodic {label}: "
            f"{'bit-identical' if same else 'DIFFERS'} to its plain version; "
            f"halo rebucket {'slot for slot' if same4 else 'DIFFERS from'} "
            f"kernel 4p's (dropped {int(hd)}, {crossed} markers crossed the "
            "seam)")
        if "rebucket_block_periodic" not in rows_t:
            rows_t["rebucket_block_periodic"] = (
                partial(rebucket_block.rebucket_block_cuda, *ext, g, bases,
                        True),
                partial(rebucket_block.rebucket_block_plain, *ext, g, bases),
                bound_ms(nbytes(*ext, bases, gm.x, gm.y, gm.T, gm.mat,
                                gm.valid, ga),
                         OPS["rebucket"] * int(ext[4].sum())))
    rows = []
    for name, es_, src, ref_line, reps in (
            ("m2g_block_periodic", e10, "m2g_block.cu", "m2g_kernel.py:283",
             3),
            ("advect_block_periodic", e11, "advect_block.cu",
             "advect_kernel.py:208", 3),
            ("rebucket_block_periodic", e12, "rebucket_block.cu",
             "rebucket_kernel.py:187", 2)):
        err = tuple(max(e[i] for e in es_) for i in (0, 1))
        k, pfn, b = rows_t[name]
        rows.append((name, f"pylamp_tpu_torch/csrc/{src}",
                     f"pylamp_tpu/markers/pallas/{ref_line}", err, k, pfn,
                     reps, b))
    return rows


PERIODIC_PATHS = {
    # the preset: kernels 1-5 in their periodic forms
    "preset": ("saddle", "m2g", "advect", "rebucket", "cheb"),
    # use_pallas=True, use_pallas_smoother=False: kernels 1-4 and 7
    "partner": ("saddle", "m2g", "advect", "rebucket", "momentum"),
}


def periodic_state_checks(tag, st, grid):
    """A periodic falling-block state: every marker x in [0, lx), the vx
    seam columns within SEAM_TOL max|vx|, the largest vy within 3 columns
    of the seam.  Returns (seam difference over max|vx|, the peak's
    column)."""
    x = st.markers.x[st.markers.valid]
    if not (float(x.min()) >= 0.0 and float(x.max()) < grid.lx):
        raise AssertionError(f"{tag}: marker x outside [0, lx): "
                             f"{float(x.min())}, {float(x.max())}")
    vmax = float(torch.max(torch.abs(st.vx)))
    seam = float(torch.max(torch.abs(st.vx[:, 0] - st.vx[:, -1])))
    col = int(torch.argmax(st.vy)) % grid.nx
    if not seam <= SEAM_TOL * vmax:
        raise AssertionError(f"{tag}: vx seam columns differ by "
                             f"{seam / vmax:.3e} of max|vx|")
    if not (col <= 3 or col >= grid.nx - 4):
        raise AssertionError(f"{tag}: the largest vy sits in column {col}, "
                             "not at the seam")
    return seam / vmax, col


def periodic_paths(grid, cfg, table, state0, n_markers, modules):
    """The periodic falling block at 1024^2 and its partner
    ``use_pallas=True, use_pallas_smoother=False`` from the same built
    state, steps interleaved (preset first on odd steps, second on even
    ones).  Every launch counter (all and periodic) is set to 0 just before
    each step and read just after: each kernel of the path
    (``PERIODIC_PATHS``) must launch, every launch of it in its periodic
    form, and no other kernel may launch.  Every step must also keep every
    marker x in [0, lx), the vx seam columns within SEAM_TOL max|vx| and
    the largest vy within 3 columns of the seam; Krylov counts within
    KRYLOV_AB_TOL of the partner's.  Returns each path's record."""
    from pylamp_tpu_torch.models.benchmarks import (
        falling_block_periodic_config,
    )
    from pylamp_tpu_torch.models.step import make_step

    smi = nvidia_smi_line()
    cfg_b = falling_block_periodic_config(grid.nx, fused_smoother=False)
    steps = {"preset": make_step(grid, cfg, table),
             "partner": make_step(grid, cfg_b, table)}
    periodic = {k: mod for k, mod in modules.items()
                if hasattr(mod, "launches_periodic")}
    states = dict.fromkeys(steps, state0)
    rec = {p: dict(step_s=[], krylov=[], seam_rel=[], peak_vy_col=[],
                   launches={k: 0 for k in modules},
                   launches_periodic={k: 0 for k in periodic})
           for p in steps}
    n_steps = PERIODIC_WARMUP_STEPS + PERIODIC_MEASURED_STEPS
    for i in range(n_steps):
        kind = "warm-up" if i < PERIODIC_WARMUP_STEPS else "measured"
        order = list(steps) if i % 2 == 0 else list(steps)[::-1]
        for p in order:
            expected = PERIODIC_PATHS[p]
            for mod in modules.values():
                mod.launches = 0
            for mod in periodic.values():
                mod.launches_periodic = 0
            tag = f"periodic {p} step {i + 1} ({kind})"
            st, dt_s, it, _ = take_step(steps[p], states[p], n_markers,
                                        {k: modules[k] for k in expected},
                                        tag)
            states[p] = st
            wall = {k: mod.launches - getattr(mod, "launches_periodic", 0)
                    for k, mod in modules.items()}
            wrong = {k: n for k, n in wall.items() if n} | {
                k: mod.launches for k, mod in modules.items()
                if k not in expected and mod.launches}
            if wrong:
                raise AssertionError(f"{tag}: launches outside the path's "
                                     f"periodic forms: {wrong}")
            seam_rel, col = periodic_state_checks(tag, st, grid)
            r = rec[p]
            r["step_s"].append(dt_s)
            r["krylov"].append(it)
            r["seam_rel"].append(seam_rel)
            r["peak_vy_col"].append(col)
            for k, mod in modules.items():
                r["launches"][k] += mod.launches
            for k, mod in periodic.items():
                r["launches_periodic"][k] += mod.launches_periodic
    meas = slice(PERIODIC_WARMUP_STEPS, None)
    for p, r in rec.items():
        r["median_s_per_step"] = statistics.median(r["step_s"][meas])
        log(f"periodic falling block {grid.nx}^2 on {smi} ({p}): median "
            f"{r['median_s_per_step']:.3f} s/step over "
            f"{PERIODIC_MEASURED_STEPS} steps, {mean(r['krylov'][meas]):.1f} "
            f"Krylov iterations/step; periodic-form launches "
            f"{r['launches_periodic']}")
    log("periodic A/B " + json.dumps({"device": smi, **rec}))
    for i, (a, b) in enumerate(zip(rec["preset"]["krylov"],
                                   rec["partner"]["krylov"])):
        if abs(a - b) > KRYLOV_AB_TOL:
            raise AssertionError(
                f"periodic step {i + 1}: {a} Krylov iterations (preset), "
                f"{b} (partner) (bar +-{KRYLOV_AB_TOL})")
    return rec


def periodic_reference_check(modules):
    """One falling_block_periodic 256^2 step on the card (f32, kernels 1-5
    in their periodic forms) against the plain f64 step on the CPU from the
    same seeded build: velocities within 1e-4 max|v|, as
    small_reference_check."""
    from pylamp_tpu_torch.models.benchmarks import falling_block_periodic
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step

    cfg = falling_block_periodic(nx=PERIODIC_SMALL_NX, ny=PERIODIC_SMALL_NX)
    kernels = {k: modules[k] for k in PERIODIC_PATHS["preset"]}
    for mod in kernels.values():
        mod.launches_periodic = 0
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        grid, table, st = build(cfg, dtype=dtype, device=dev)
        st, d = make_step(grid, cfg, table)(st)
        out[dev] = (st, d)
    idle = [k for k, mod in kernels.items() if mod.launches_periodic <= 0]
    if idle:
        raise AssertionError(f"periodic {PERIODIC_SMALL_NX}^2 step: periodic "
                             f"forms not launched: {idle}")
    g, r = out["cuda"][0], out["cpu"][0]
    vmax = max(float(torch.max(torch.abs(r.vx))),
               float(torch.max(torch.abs(r.vy))))
    err = max(float(torch.max(torch.abs(g.vx.cpu().double() - r.vx))),
              float(torch.max(torch.abs(g.vy.cpu().double() - r.vy))))
    log(f"periodic {PERIODIC_SMALL_NX}^2 step, card f32 vs CPU f64: max |dv| "
        f"/ max|v| = {err / vmax:.3e}; Krylov "
        f"{out['cuda'][1]['stokes_iterations']} vs "
        f"{out['cpu'][1]['stokes_iterations']}")
    if not err <= 1e-4 * vmax:
        raise AssertionError(f"periodic {PERIODIC_SMALL_NX}^2 step disagrees "
                             f"with the CPU reference: {err / vmax:.3e} > 1e-4")


PERIODIC_MESH_PATHS = {
    # kernel 9 per shard; kernels 2-4 in their periodic forms on the global
    # markers (the marker halo engine has no wrap-around path)
    "mesh_4x2": ("saddle_block", "m2g", "advect", "rebucket"),
    "single": PERIODIC_PATHS["preset"],
}


def periodic_mesh_path(grid, cfg, table, state0, n_markers, modules):
    """The periodic falling block at 1024^2 with explicit_halo=True on the
    in-process 4x2 mesh and the single-device preset from the same built
    state, steps interleaved (mesh first on odd steps, second on even
    ones).  Every counter (all and periodic) is set to 0 just before each
    step and read just after: each path must launch its kernels
    (``PERIODIC_MESH_PATHS``), kernels 2-5 only in their periodic forms,
    and no other kernel.  Every step keeps periodic_state_checks; after
    step 1 the two states agree (mesh_agrees); Krylov counts within
    KRYLOV_AB_TOL.  Returns each path's record."""
    from dataclasses import replace

    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    smi = nvidia_smi_line()
    cfg_h = replace(cfg, solver=replace(cfg.solver, explicit_halo=True))
    steps = {"mesh_4x2": make_step(grid, cfg_h, table,
                                   mesh=make_mesh(MESH_SHARDS)),
             "single": make_step(grid, cfg, table)}
    periodic = {k: mod for k, mod in modules.items()
                if hasattr(mod, "launches_periodic")}
    states = dict.fromkeys(steps, state0)
    rec = {p: dict(step_s=[], krylov=[], seam_rel=[], peak_vy_col=[],
                   launches={k: 0 for k in modules},
                   launches_periodic={k: 0 for k in periodic})
           for p in steps}
    n_steps = PERIODIC_MESH_WARMUP_STEPS + PERIODIC_MESH_MEASURED_STEPS
    for i in range(n_steps):
        kind = "warm-up" if i < PERIODIC_MESH_WARMUP_STEPS else "measured"
        order = list(steps) if i % 2 == 0 else list(steps)[::-1]
        for p in order:
            expected = PERIODIC_MESH_PATHS[p]
            zero_counters(modules)
            tag = f"periodic mesh A/B {p} step {i + 1} ({kind})"
            st, dt_s, it, _ = take_step(steps[p], states[p], n_markers,
                                        {k: modules[k] for k in expected},
                                        tag)
            states[p] = st
            wrong = {k: mod.launches - mod.launches_periodic
                     for k, mod in periodic.items()
                     if mod.launches != mod.launches_periodic} | {
                k: mod.launches for k, mod in modules.items()
                if k not in expected and mod.launches}
            if wrong:
                raise AssertionError(f"{tag}: launches outside the path's "
                                     f"kernels and periodic forms: {wrong}")
            seam_rel, col = periodic_state_checks(tag, st, grid)
            r = rec[p]
            r["step_s"].append(dt_s)
            r["krylov"].append(it)
            r["seam_rel"].append(seam_rel)
            r["peak_vy_col"].append(col)
            for k, mod in modules.items():
                r["launches"][k] += mod.launches
            for k, mod in periodic.items():
                r["launches_periodic"][k] += mod.launches_periodic
        if i == 0:
            mesh_agrees("periodic mesh", states["mesh_4x2"], states["single"])
    meas = slice(PERIODIC_MESH_WARMUP_STEPS, None)
    for p, r in rec.items():
        r["median_s_per_step"] = statistics.median(r["step_s"][meas])
        log(f"periodic falling block {grid.nx}^2 {p} on {smi}: median "
            f"{r['median_s_per_step']:.3f} s/step over "
            f"{PERIODIC_MESH_MEASURED_STEPS} steps, "
            f"{mean(r['krylov'][meas]):.1f} Krylov iterations/step; "
            f"launches {r['launches']}")
    log("periodic mesh A/B " + json.dumps({"device": smi, **rec}))
    for i, (a, b) in enumerate(zip(rec["mesh_4x2"]["krylov"],
                                   rec["single"]["krylov"])):
        if abs(a - b) > KRYLOV_AB_TOL:
            raise AssertionError(
                f"periodic mesh step {i + 1}: {a} Krylov iterations, "
                f"single-device {b} (bar +-{KRYLOV_AB_TOL})")
    return rec


def solver_option_paths(fk_grid, fk_table, fk_state, n_markers, modules,
                        preset):
    """FK with each of ``SOLVER_OPTIONS`` from one built state per size
    (the FK 1024^2 build's, a fresh 64^2 build), every counter set to 0
    just before each step and read just after.  Each step must pass
    take_step's checks (1e-8, no marker dropped) and launch the option's
    kernels (``OPTION_KERNELS``) and no other.  ``preset``: the bench
    preset's (s/step, Krylov) of its first two steps from the 1024^2
    state, logged beside each option's (the 64^2 preset's run here).
    Returns each option's record."""
    from dataclasses import replace

    from pylamp_tpu_torch.models.benchmarks import fk_bench_config
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step

    smi = nvidia_smi_line()
    builds = {FK_NX: (fk_grid, fk_table, fk_state, n_markers)}
    presets = {FK_NX: preset}
    rec = {}
    for name, (nx, opts, n_steps) in SOLVER_OPTIONS.items():
        cfg = fk_bench_config(nx)
        if nx not in builds:
            grid, table, state0 = build(cfg, dtype=torch.float32,
                                        device="cuda")
            builds[nx] = (grid, table, state0, int(state0.markers.total()))
            st, times, iters = state0, [], []
            step = make_step(grid, cfg, table)
            for i in range(2):
                st, dt_s, it, _ = take_step(step, st, builds[nx][3], {},
                                            f"FK {nx}^2 preset step {i + 1}")
                times.append(dt_s)
                iters.append(it)
            presets[nx] = dict(step_s=times, krylov=iters)
        grid, table, state, n = builds[nx]
        step = make_step(grid, replace(cfg, solver=replace(cfg.solver,
                                                           **opts)), table)
        r = rec[name] = dict(step_s=[], krylov=[],
                             launches={k: 0 for k in modules})
        for i in range(n_steps):
            zero_counters(modules)
            tag = f"{name} step {i + 1}"
            state, dt_s, it, _ = take_step(
                step, state, n, {k: modules[k] for k in OPTION_KERNELS[name]},
                tag)
            other = {k: mod.launches for k, mod in modules.items()
                     if k not in OPTION_KERNELS[name] and mod.launches}
            if other:
                raise AssertionError(f"{tag}: other kernels launched: "
                                     f"{other}")
            r["step_s"].append(dt_s)
            r["krylov"].append(it)
            for k, mod in modules.items():
                r["launches"][k] += mod.launches
        del state
        p = presets[nx]
        log(f"{name} on {smi}: s/step {r['step_s']} (preset "
            f"{p['step_s'][:n_steps]}), Krylov {r['krylov']} (preset "
            f"{p['krylov'][:n_steps]}); launches {r['launches']}")
    log("solver options " + json.dumps({"device": smi, "presets": presets,
                                        **rec}))
    return rec


def vanka_sharp_check():
    """The reference's slow Vanka test (tests/test_vanka.py, not run by
    tier-1) on the card: its two-layer 1e6 cell-sharp viscosity at 64^2
    with random buoyancy (seed 5), f64, ``solve_stokes`` with the Vanka
    preconditioner (one cycle, 2 + 2 sweeps), restart 60, tol 1e-8: it
    must converge in fewer than VANKA_SHARP_MAX_ITERS iterations."""
    import numpy as np

    from pylamp_tpu_torch.core.bc import VelocityBCs
    from pylamp_tpu_torch.core.grid import StaggeredGrid
    from pylamp_tpu_torch.solvers.stokes_solver import solve_stokes
    from pylamp_tpu_torch.solvers.vanka import make_vanka_mg_preconditioner

    n = VANKA_SHARP_NX
    grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)

    def layers(y, shape):
        col = np.where(np.asarray(y) < 0.35, 1e6, 1.0)
        return torch.tensor(np.broadcast_to(col[:, None], shape).copy(),
                            dtype=torch.float64, device="cuda")

    eta_s = layers(grid.y_corner, grid.shape_corner)
    eta_n = layers(grid.y_center, grid.shape_center)
    rng = np.random.default_rng(5)
    rho_vy = torch.tensor(rng.normal(size=grid.shape_vy), device="cuda")
    rho_vx = torch.zeros(grid.shape_vx, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_stokes(eta_s, eta_n, rho_vx, rho_vy, 0.0, 1.0, grid,
                       VelocityBCs(), tol=1e-8, restart=60, maxiter=1500,
                       make_preconditioner=partial(
                           make_vanka_mg_preconditioner, cycles=1,
                           pre_smooth=2, post_smooth=2))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    info = sol.info
    log(f"Vanka on the sharp 1e6 problem {n}^2 (f64) on "
        f"{nvidia_smi_line()}: {info.iterations} iterations, relative "
        f"residual {info.residual / info.bnorm:.3e}, {secs:.2f} s (the "
        f"reference test's bar < {VANKA_SHARP_MAX_ITERS}; it measured 282)")
    if not (info.converged and info.iterations < VANKA_SHARP_MAX_ITERS):
        raise AssertionError(
            f"Vanka sharp problem: converged {info.converged} after "
            f"{info.iterations} iterations (bar < {VANKA_SHARP_MAX_ITERS})")
    return dict(iterations=info.iterations, seconds=secs,
                residual_rel=info.residual / info.bnorm)

def ra_kernel_rows(grid, cfg, table, state):
    """Kernels 2 and 10 with the rho0 * alpha stream (rows ``m2g_ra`` and
    ``m2g_block_ra``) against their plain versions on the heated FK
    markers (the FK build's: the thermal switches do not change it) and on
    their 4x2 blocks, and each at one odd shape: a 37x23 FK build, and a
    40^2 one on a 2x2 mesh.  A rerun must be bit-identical, and every other
    stream bit-identical to the launch without the stream; the halo
    transfer with the stream bit-identical to kernel 2's on every
    stream."""
    from pylamp_tpu_torch.markers.kernels import m2g, m2g_block
    from pylamp_tpu_torch.models.benchmarks import fk_stagnant_lid
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.parallel.halo_markers import BLK3, m2g_fused_halo
    from pylamp_tpu_torch.parallel.mesh import make_mesh

    phys = cfg.physics
    f32 = torch.float32
    rows, errs = [], {"m2g_ra": [], "m2g_block_ra": []}

    def held(name, label, run, plain, base_run):
        got, again, ref, base = run(), run(), plain(), base_run()
        if sorted(got) != sorted(ref) or "c_ra" not in got:
            raise AssertionError(f"{name} {label}: streams {sorted(got)} vs "
                                 f"{sorted(ref)}")
        bad = [k for k in got if not torch.equal(got[k], again[k])]
        bad += [k for k in base if not torch.equal(got[k], base[k])]
        if bad:
            raise AssertionError(f"{name} {label}: a rerun or the launch "
                                 f"without rho0 * alpha differs in {bad}")
        errs[name].append(errors((got[k], ref[k]) for k in ref))
        log(f"{name} {label}: kernel vs plain rel {errs[name][-1][1]:.3e} "
            f"(c_ra {errors([(got['c_ra'], ref['c_ra'])])[1]:.3e}); rerun "
            "and the other streams bit-identical")
        return got

    small_grid, _, small = build(fk_stagnant_lid(nx=37, ny=23), dtype=f32,
                                 device="cuda")
    for g, m, label in ((grid, state.markers, f"FK {grid.nx}^2"),
                        (small_grid, small.markers, "odd 37x23")):
        kw = dict(with_energy=True)
        got = held("m2g_ra", label,
                   partial(m2g.m2g_fused_cuda, m, g, table, phys, **kw,
                           with_ra=True),
                   partial(m2g.m2g_fused_plain, m, g, table, phys, **kw,
                           with_ra=True),
                   partial(m2g.m2g_fused_cuda, m, g, table, phys, **kw))
        if not rows:
            rows.append((
                "m2g_ra", "pylamp_tpu_torch/csrc/m2g.cu",
                "pylamp_tpu/markers/pallas/m2g_kernel.py:407", None,
                partial(m2g.m2g_fused_cuda, m, g, table, phys, **kw,
                        with_ra=True),
                partial(m2g.m2g_fused_plain, m, g, table, phys, **kw,
                        with_ra=True), 5,
                bound_ms(nbytes(m.x, m.y, m.T, m.mat, m.valid,
                                *got.values()),
                         OPS["m2g"] * int(m.total()))))

    small_grid, _, small = build(fk_stagnant_lid(nx=40, ny=40), dtype=f32,
                                 device="cuda")
    for g, m, msh, label in ((grid, state.markers, make_mesh(MESH_SHARDS),
                              f"FK {grid.nx}^2 on 4x2"),
                             (small_grid, small.markers, make_mesh(4),
                              "odd 40^2 on 2x2")):
        by, bx = g.ny // msh.my, g.nx // msh.mx
        bases = msh.bases(by, bx, device="cuda")
        ext = [msh.flat(msh.ext1(msh.split(a, BLK3), nd=3))
               for a in (m.x, m.y, m.T, m.mat, m.valid)]
        kw = dict(with_energy=True)
        got = held("m2g_block_ra", label,
                   partial(m2g_block.m2g_fused_block_cuda, *ext, g, table,
                           phys, bases, **kw, with_ra=True),
                   partial(m2g_block.m2g_fused_block_plain, *ext, g, table,
                           phys, bases, **kw, with_ra=True),
                   partial(m2g_block.m2g_fused_block_cuda, *ext, g, table,
                           phys, bases, **kw))
        halo = m2g_fused_halo(m, g, table, phys, msh, with_energy=True,
                              with_ra=True)
        glob = m2g.m2g_fused_cuda(m, g, table, phys, with_energy=True,
                                  with_ra=True)
        bad = [k for k in glob if k not in halo
               or not torch.equal(halo[k], glob[k])]
        log(f"m2g_block_ra {label}: the halo transfer vs kernel 2's "
            + (f"DIFFERS in {bad}" if bad
               else "bit-identical on every stream, c_ra included"))
        if bad or sorted(halo) != sorted(glob):
            raise AssertionError(f"m2g_block_ra {label}: the halo transfer "
                                 f"is not bit-identical to kernel 2 ({bad})")
        if len(rows) == 1:
            rows.append((
                "m2g_block_ra", "pylamp_tpu_torch/csrc/m2g_block.cu",
                "pylamp_tpu/markers/pallas/m2g_kernel.py:283", None,
                partial(m2g_block.m2g_fused_block_cuda, *ext, g, table, phys,
                        bases, **kw, with_ra=True),
                partial(m2g_block.m2g_fused_block_plain, *ext, g, table,
                        phys, bases, **kw, with_ra=True), 3,
                bound_ms(nbytes(*ext, bases, *got.values()),
                         OPS["m2g"] * int(ext[4].sum()))))
    return [(name, src, rep, tuple(max(e[i] for e in errs[name])
                                   for i in (0, 1)), *rest)
            for name, src, rep, _, *rest in rows]


def heated_paths(grid, table, state0, modules):
    """FK 1024^2 with the reference's four thermal switches
    (``models.profile.fk_heated_config``: shear and adiabatic heating,
    subgrid diffusion d = 1, reseeding below 2 per cell) and its partner
    with the energy multigrid and flexible CG, from the FK build's state,
    steps interleaved.  Every counter is set to 0 just before each step and
    read just after it: kernels 1-6 must launch, kernel 2 on every launch
    with the rho0 * alpha stream, no other kernel; each step must converge
    (Stokes to 1e-8, energy to its 1e-10), drop nothing, keep every field
    finite, and keep the count it started from until reseeding.  Krylov
    counts within +-max(KRYLOV_AB_TOL, HEATED_KRYLOV_REL) of the
    partner's, and after step 1 T within HEATED_T_TOL max|T| of it.  The
    noise floor of the Krylov comparison is logged: step 2 of a twin of the
    Jacobi path whose marker T is nudged up by one f32 ulp in a
    NOISE_FRACTION of the slots after step 1.  Returns (the heated path's
    record, its last state)."""
    from pylamp_tpu_torch.models.profile import fk_heated_config
    from pylamp_tpu_torch.models.step import make_step

    smi = nvidia_smi_line()
    six = ("saddle", "m2g", "advect", "rebucket", "cheb", "coarse_vcycle")
    steps = {"jacobi_cg": make_step(grid, fk_heated_config(grid.nx), table),
             "mg_fcg": make_step(grid, fk_heated_config(grid.nx, "mg"),
                                 table)}
    m2g = modules["m2g"]
    states = dict.fromkeys(steps, state0)
    rec = {p: dict(step_s=[], krylov=[], energy=[], markers=[],
                   launches={k: 0 for k in modules}, launches_ra=0)
           for p in steps}
    for i in range(HEATED_WARMUP_STEPS + HEATED_MEASURED_STEPS):
        kind = "warm-up" if i < HEATED_WARMUP_STEPS else "measured"
        order = list(steps) if i % 2 == 0 else list(steps)[::-1]
        for p in order:
            for mod in modules.values():
                mod.launches = 0
            m2g.launches_ra = 0
            tag = f"heated FK {p} step {i + 1} ({kind})"
            st, dt_s, it, diag = take_step(
                steps[p], states[p], int(states[p].markers.total()),
                {k: modules[k] for k in six}, tag)
            other = {k: mod.launches for k, mod in modules.items()
                     if k not in six and mod.launches}
            if other:
                raise AssertionError(f"{tag}: other kernels launched: "
                                     f"{other}")
            if not 0 < m2g.launches_ra == m2g.launches:
                raise AssertionError(
                    f"{tag}: {m2g.launches_ra} of {m2g.launches} m2g "
                    "launches with the rho0 * alpha stream")
            if not diag["energy_converged"]:
                raise AssertionError(f"{tag}: the energy solve did not "
                                     "converge")
            states[p] = st
            r = rec[p]
            r["step_s"].append(dt_s)
            r["krylov"].append(it)
            r["energy"].append(int(diag["energy_iterations"]))
            r["markers"].append(int(st.markers.total()))
            r["launches_ra"] += m2g.launches_ra
            for k, mod in modules.items():
                r["launches"][k] += mod.launches
        if i == 0:
            a, b = states["jacobi_cg"].T, states["mg_fcg"].T
            dT = float(torch.max(torch.abs(a - b)))
            tmax = float(torch.max(torch.abs(b)))
            log(f"heated FK after step 1: Jacobi-CG vs MG-FCG max |dT| / "
                f"max|T| {dT / tmax:.3e} (bar {HEATED_T_TOL:g})")
            if not dT <= HEATED_T_TOL * tmax:
                raise AssertionError("the energy-MG partner's T disagrees")
            twin = states["jacobi_cg"]
            mT = twin.markers.T
            gen = torch.Generator(device="cuda").manual_seed(0)
            nudge = torch.rand(mT.shape, generator=gen,
                               device="cuda") < NOISE_FRACTION
            up = torch.nextafter(mT, torch.full_like(mT, math.inf))
            twin = twin.replace(markers=twin.markers.replace(
                T=torch.where(nudge, up, mT)))
            _, tdiag = steps["jacobi_cg"](twin)
            noise = int(tdiag["stokes_iterations"])
    meas = slice(HEATED_WARMUP_STEPS, None)
    for p, r in rec.items():
        r["median_s_per_step"] = statistics.median(r["step_s"][meas])
        log(f"heated FK {grid.nx}^2 on {smi} ({p}): median "
            f"{r['median_s_per_step']:.3f} s/step over "
            f"{HEATED_MEASURED_STEPS} steps, {mean(r['krylov'][meas]):.1f} "
            f"Krylov iterations/step, energy iterations {r['energy']}, "
            f"markers after each step {r['markers']}; launches "
            f"{r['launches']}, with rho0 * alpha {r['launches_ra']}")
    log(f"heated FK Krylov noise floor: step 2 of the Jacobi path with "
        f"{NOISE_FRACTION:g} of its marker T one f32 ulp up after step 1: "
        f"{noise} Krylov iterations, unperturbed "
        f"{rec['jacobi_cg']['krylov'][1]}, MG-FCG partner "
        f"{rec['mg_fcg']['krylov'][1]}")
    log("heated A/B " + json.dumps({"device": smi, "noise_step2": noise,
                                    **rec}))
    for i, (a, b) in enumerate(zip(rec["jacobi_cg"]["krylov"],
                                   rec["mg_fcg"]["krylov"])):
        if abs(a - b) > max(KRYLOV_AB_TOL, HEATED_KRYLOV_REL * a):
            raise AssertionError(
                f"heated step {i + 1}: {a} Krylov iterations (Jacobi-CG), "
                f"{b} (MG-FCG) (bar +-max({KRYLOV_AB_TOL}, "
                f"{HEATED_KRYLOV_REL:.0%}))")
    return rec["jacobi_cg"], states["jacobi_cg"]


def reseed_check(grid, table, state):
    """``bucket_reseed`` at RESEED_MIN per cell on the card against the same
    call on the CPU, on a heated state: at least one marker spawned, valid
    and mat equal, x and y within one f32 spacing, T within 1e-6 max|T|.
    Also times the thermal path's extra tensor work on the card: the
    reseed, and subgrid diffusion's one-stream g2m and m2g on every slot."""
    from pylamp_tpu_torch.markers.bucket import (
        BucketedMarkers,
        bucket_grid_to_markers,
        bucket_markers_to_grid,
        bucket_reseed,
    )

    m, T = state.markers, state.T
    nmat = len(table)
    got = bucket_reseed(m, T, grid, RESEED_MIN, n_materials=nmat)
    cpu = BucketedMarkers(**{f: getattr(m, f).cpu()
                             for f in ("x", "y", "mat", "T", "valid")})
    ref = bucket_reseed(cpu, T.cpu(), grid, RESEED_MIN, n_materials=nmat)
    spawned = int(got.total()) - int(m.total())
    same = (torch.equal(got.valid.cpu(), ref.valid)
            and torch.equal(got.mat.cpu(), ref.mat))
    gap = 0.0
    for f in ("x", "y"):
        g, r = getattr(got, f).cpu(), getattr(ref, f)
        top = torch.maximum(torch.abs(g), torch.abs(r))
        spacing = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        gap = max(gap, float(torch.max(torch.abs(g - r) / spacing)))
    dT = float(torch.max(torch.abs(got.T.cpu() - ref.T)))
    tmax = float(torch.max(torch.abs(ref.T)))
    log(f"reseed at {RESEED_MIN}/cell, card vs CPU: {spawned} spawned, "
        f"valid and mat {'equal' if same else 'DIFFER'}, x/y within "
        f"{gap:.2f} f32 spacings, max |dT| / max|T| {dT / tmax:.3e}")
    if not (spawned >= 1 and same and gap <= 1.0 and dT <= 1e-6 * tmax):
        raise AssertionError("reseeding on the card disagrees with the CPU "
                             "or spawned nothing")
    ms = {
        "reseed_min2": cuda_time_ms(
            lambda: bucket_reseed(m, T, grid, 2, n_materials=nmat), 3),
        "g2m_corner": cuda_time_ms(
            lambda: bucket_grid_to_markers(T, m.x, m.y, m.valid, grid,
                                           "corner"), 3),
        "m2g_corner_one_stream": cuda_time_ms(
            lambda: bucket_markers_to_grid(m, m.T, grid, "corner"), 3),
    }
    log("thermal tensor work on the card (ms, "
        f"{tuple(m.x.shape)} slots): " + json.dumps(ms))


def sweep_paths(modules):
    """The batched parameter sweep (``models/sweep.py``) at full width:
    ``fk_bench_config(SWEEP_NX)`` with one member per (Ra_top,
    visc_contrast) of ``SWEEP_MEMBERS`` (each member's material
    ``fk_stagnant_lid``'s, nothing else changed; (100, 1e4) is the preset
    itself), every state built from the one seed.  SWEEP_STEPS sweep
    steps, each followed by every member's solo ``make_step`` from the same
    build, every launch counter set to 0 just before each:

    - every member converged to 1e-8 with no marker dropped, in the sweep
      and solo;
    - each member's state bit-identical to its solo step's in every
      ``state.*`` leaf, with the same Krylov and energy iterations, and
      the batch the sweep stepped from (each member a view of it) still
      bit-identical to the solo states it started from;
    - kernels 1-6 launch per sweep step exactly as often as the four solo
      steps together, and no other kernel or form.

    Logs the s per sweep step against the sum of the members' solo s per
    step.  Returns the record printed in the log (the sweep's launches
    over its steps under "launches")."""
    from dataclasses import replace

    from pylamp_tpu_torch.bridge import state_leaves
    from pylamp_tpu_torch.models.benchmarks import (
        fk_bench_config,
        fk_stagnant_lid,
    )
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step
    from pylamp_tpu_torch.models.sweep import (
        make_sweep_step,
        stack_states,
        unstack_state,
    )

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    six = ("saddle", "m2g", "advect", "rebucket", "cheb", "coarse_vcycle")
    cfg = fk_bench_config(SWEEP_NX)
    built = []
    for ra, vc in SWEEP_MEMBERS:
        mats = fk_stagnant_lid(nx=SWEEP_NX, Ra_top=ra,
                               visc_contrast=vc).physics.materials
        built.append(build(replace(cfg, physics=replace(
            cfg.physics, materials=mats)), dtype=torch.float32,
            device="cuda"))
    grid, tables = built[0][0], [b[1] for b in built]
    solo = [b[2] for b in built]
    n_markers = [int(st.markers.total()) for st in solo]
    del built
    steps = [make_step(grid, cfg, t) for t in tables]
    sweep, params = make_sweep_step(grid, cfg, tables)
    batched = stack_states(solo)
    torch.cuda.synchronize()
    log(f"sweep: built {len(SWEEP_MEMBERS)} FK {SWEEP_NX}^2 members "
        f"{SWEEP_MEMBERS}, {time.perf_counter() - t_phase:.1f} s")

    def counted(fn, *args):
        zero_counters(modules)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counted_launches(modules)

    rec = dict(device=smi, nx=SWEEP_NX, members=SWEEP_MEMBERS,
               sweep_s=[], solo_s=[], krylov=[], energy_iterations=[],
               launches_per_step=[], launches={k: 0 for k in modules})
    def differ(x, y):
        a, b = state_leaves(x), state_leaves(y)
        if sorted(a) != sorted(b):
            return sorted(set(a) ^ set(b))
        return [key for key in a if not torch.equal(a[key], b[key])]

    for k in range(SWEEP_STEPS):
        prev = batched
        (batched, bdiag), sweep_s, sweep_n = counted(sweep, prev, params)
        solo_s, solo_n, kry, en = [], {}, [], []
        for i, step in enumerate(steps):
            tag = f"sweep step {k + 1} member {SWEEP_MEMBERS[i]}"
            wrote = differ(unstack_state(prev, i), solo[i])
            if wrote:
                raise AssertionError(f"{tag}: the sweep changed its input "
                                     f"batch in {wrote}")
            (solo[i], diag), secs, n = counted(step, solo[i])
            solo_s.append(secs)
            for key, v in n.items():
                solo_n[key] = solo_n.get(key, 0) + v
            member = unstack_state(batched, i)
            row = {key: v[i] for key, v in bdiag.items()}
            for label, d in (("sweep", row), ("solo", diag)):
                if not (bool(d["stokes_converged"])
                        and float(d["stokes_residual_rel"]) <= 1e-8
                        and int(d["markers_dropped"]) == 0
                        and int(d["marker_count"]) == n_markers[i]):
                    raise AssertionError(
                        f"{tag} ({label}): converged {d['stokes_converged']}"
                        f", rel residual {float(d['stokes_residual_rel']):.3e}"
                        f", {int(d['markers_dropped'])} dropped, "
                        f"{int(d['marker_count'])} of {n_markers[i]} markers "
                        f"(Krylov {int(d['stokes_iterations'])})")
            diff = differ(member, solo[i])
            if diff:
                raise AssertionError(f"{tag}: the sweep's state differs from "
                                     f"the solo step's in {diff}")
            pair = [(int(row[key]), int(diag[key])) for key in
                    ("stokes_iterations", "energy_iterations")]
            if any(x != y for x, y in pair):
                raise AssertionError(f"{tag}: Krylov / energy iterations "
                                     f"{pair} (sweep, solo)")
            kry.append(pair[0][0])
            en.append(pair[1][0])
            del member
        del prev
        idle = [key for key in six if not sweep_n.get(f"{key}.launches")]
        if sweep_n != solo_n or idle or any(
                key.removesuffix(".launches") not in six for key in sweep_n):
            raise AssertionError(f"sweep step {k + 1}: launches {sweep_n} "
                                 f"against the solo steps' {solo_n}")
        for key in six:
            rec["launches"][key] += sweep_n[f"{key}.launches"]
        rec["sweep_s"].append(sweep_s)
        rec["solo_s"].append(solo_s)
        rec["krylov"].append(kry)
        rec["energy_iterations"].append(en)
        rec["launches_per_step"].append(sweep_n)
        log(f"sweep step {k + 1} on {smi}: {sweep_s:.3f} s against "
            f"{sum(solo_s):.3f} s for the four solo steps "
            f"({', '.join(f'{x:.3f}' for x in solo_s)}); Krylov {kry}, "
            f"energy {en}; every member bit-identical to its solo step; "
            "launches " + ", ".join(f"{key}+{v}"
                                    for key, v in sweep_n.items()))
    del batched, solo
    rec["phase_s"] = time.perf_counter() - t_phase
    log("sweep_paths " + json.dumps(rec))
    return rec


def _cli_lines(out_dir, label, energy):
    """The metrics lines of a CLI run, each converged to 1e-8 with no
    marker dropped (and, with ``energy``, the energy solve converged)."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    for r in lines:
        tag = f"{label} step {r['step']}"
        if not r["stokes_converged"] or not r["stokes_residual_rel"] <= 1e-8:
            raise AssertionError(f"{tag}: Stokes rel residual "
                                 f"{r['stokes_residual_rel']:.3e} (converged "
                                 f"{r['stokes_converged']})")
        if r["markers_dropped"] != 0:
            raise AssertionError(f"{tag}: {r['markers_dropped']} markers "
                                 "dropped")
        if energy and not r["energy_converged"]:
            raise AssertionError(f"{tag}: the energy solve did not converge")
    return lines


def cli_paths(modules):
    """The port's command line, in-process (``pylamp_tpu_torch.cli.main``)
    in a temporary directory, every launch counter set to 0 just before
    each run:

    (a) ``run fk_stagnant_lid --nx 1024 --steps 4 --checkpoint-every 4
        --output-every 4`` (the preset's own solver, f32 state): kernels
        1-6 launch, kernels 7-12 and every periodic and rho0 * alpha form
        stay idle;
    (b) the same for 2 steps with ``--checkpoint-every 2
        --profile-phases``: every line carries the four phase seconds;
    (c) 4 steps resumed from (b)'s checkpoint: every ``state.*`` leaf of
        its final checkpoint bit-identical to (a)'s (exact resume, and the
        phased runner equal to the plain step);
    (d) ``run rt_van_keken --steps 2`` at its 512^2 with K = 32: kernels
        1-6 launch;
    (e) (a) again with ``--scan 2`` and the checkpoint and field dump
        every 3 steps: kernels 1-6 launch, each metrics line equals (a)'s
        in every key but the clocks (``step_wall_s``, ``wall_s``), the
        one checkpoint and field dump land at step 4 (``step % 3 <
        chunk``, the reference's chunk cadence), every ``state.*`` leaf
        of the checkpoint and every array of the dump bit-identical to
        (a)'s;
    (f) ``python3 -m pylamp_tpu_torch list`` in a subprocess: exit 0 and
        the six names.

    Every metrics line of (a)-(e) converged to 1e-8 with no marker
    dropped; (a)'s field dump holds every live marker.  The driver's
    ``save_checkpoint``, ``save_fields`` and ``load_checkpoint`` are
    timed where the runs call them.  Returns the record printed in the
    log (with (a)'s launches)."""
    import shutil
    import tempfile

    import numpy as np

    from pylamp_tpu_torch import cli
    from pylamp_tpu_torch.models import driver

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    io_s = {}

    def timed_io(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            io_s.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return run

    io_fns = {n: getattr(driver, n) for n in
              ("save_checkpoint", "save_fields", "load_checkpoint")}
    six = ("saddle", "m2g", "advect", "rebucket", "cheb", "coarse_vcycle")
    tmp = tempfile.mkdtemp(prefix="cli_paths_")
    launches = {}
    try:
        for n, fn in io_fns.items():
            setattr(driver, n, timed_io(n, fn))

        def run(tag, *argv):
            zero_counters(modules)
            out = os.path.join(tmp, tag)
            t0 = time.perf_counter()
            if cli.main(["run", *argv, "--out", out]) != 0:
                raise AssertionError(f"cli run {tag}: non-zero exit")
            secs = time.perf_counter() - t0
            counts = counted_launches(modules)
            idle = [k for k in six if not counts.get(f"{k}.launches")]
            other = {k: v for k, v in counts.items()
                     if k.removesuffix(".launches") not in six}
            if idle or other:
                raise AssertionError(f"cli run {tag}: kernels idle {idle}, "
                                     f"other kernels launched {other}")
            launches[tag] = {k: modules[k].launches for k in modules}
            log(f"cli run {tag} ({' '.join(argv)}): {secs:.1f} s, launches "
                + ", ".join(f"{k}+{n}" for k, n in counts.items()))
            return out

        fk = ("fk_stagnant_lid", "--nx", str(CLI_NX))
        half = CLI_STEPS // 2
        a = run("A", *fk, "--steps", str(CLI_STEPS), "--checkpoint-every",
                str(CLI_STEPS), "--output-every", str(CLI_STEPS))
        b = run("B", *fk, "--steps", str(half), "--checkpoint-every",
                str(half), "--profile-phases")
        c = run("C", *fk, "--steps", str(CLI_STEPS), "--resume",
                os.path.join(b, "checkpoint.npz"), "--checkpoint-every",
                str(CLI_STEPS))
        d = run("D", "rt_van_keken", "--steps", str(CLI_RT_STEPS))
        e = run("E", *fk, "--steps", str(CLI_STEPS), "--scan", str(CLI_SCAN),
                "--checkpoint-every", str(CLI_SCAN_EVERY), "--output-every",
                str(CLI_SCAN_EVERY))
    finally:
        for n, fn in io_fns.items():
            setattr(driver, n, fn)
    try:
        la, lb, lc = (_cli_lines(o, f"cli {t}", True)
                      for o, t in ((a, "A"), (b, "B"), (c, "C")))
        ld = _cli_lines(d, "cli D", False)
        for tag, lines, steps in (("A", la, range(1, CLI_STEPS + 1)),
                                  ("B", lb, range(1, half + 1)),
                                  ("C", lc, range(half + 1, CLI_STEPS + 1)),
                                  ("D", ld, range(1, CLI_RT_STEPS + 1))):
            if [r["step"] for r in lines] != list(steps):
                raise AssertionError(f"cli {tag}: steps "
                                     f"{[r['step'] for r in lines]}")
        for r in lb:
            if sorted(r["phase_seconds"]) != ["advect", "energy", "interp",
                                              "stokes"]:
                raise AssertionError(f"cli B: phase_seconds {r}")
        le = _cli_lines(e, "cli E", True)
        clocks = ("step_wall_s", "wall_s")
        for ra, re_ in zip(la, le):
            if ({k: v for k, v in ra.items() if k not in clocks}
                    != {k: v for k, v in re_.items() if k not in clocks}):
                raise AssertionError(f"cli E (--scan {CLI_SCAN}): {re_} "
                                     f"against the per-step line {ra}")
        if len(le) != len(la):
            raise AssertionError(f"cli E: {len(le)} lines, A {len(la)}")
        written = sorted(f for f in os.listdir(e)
                         if f.startswith(("fields_", "checkpoint")))
        if written != ["checkpoint.npz", f"fields_{CLI_STEPS:06d}.npz"]:
            raise AssertionError(f"cli E: wrote {written}")

        def same_arrays(tag, pa, pb, prefix):
            with np.load(pa) as za, np.load(pb) as zb:
                keys = sorted(k for k in za.files if k.startswith(prefix))
                if keys != sorted(k for k in zb.files
                                  if k.startswith(prefix)):
                    raise AssertionError(f"cli {tag}: arrays differ")
                differ = [k for k in keys if za[k].dtype != zb[k].dtype
                          or za[k].tobytes() != zb[k].tobytes()]
                if differ:
                    raise AssertionError(f"cli {tag} differs from the 4-step "
                                         f"run's in {differ}")
                return keys

        keys = same_arrays("C checkpoint", os.path.join(a, "checkpoint.npz"),
                           os.path.join(c, "checkpoint.npz"), "state.")
        same_arrays("E checkpoint", os.path.join(a, "checkpoint.npz"),
                    os.path.join(e, "checkpoint.npz"), "state.")
        dump = f"fields_{CLI_STEPS:06d}.npz"
        same_arrays("E field dump", os.path.join(a, dump),
                    os.path.join(e, dump), "")
        with np.load(os.path.join(a, "checkpoint.npz")) as za:
            n_live = int(za["state.markers.valid"].sum())
        with np.load(os.path.join(a, f"fields_{CLI_STEPS:06d}.npz")) as zf:
            n_dump = int(zf["marker_x"].size)
            finite = all(bool(np.isfinite(zf[k]).all())
                         for k in ("vx", "vy", "p", "T", "marker_x",
                                   "marker_y", "marker_T"))
        if n_dump != n_live or not finite:
            raise AssertionError(f"cli A: field dump holds {n_dump} markers "
                                 f"of {n_live} live (finite: {finite})")
        names = subprocess.run(
            [sys.executable, "-m", "pylamp_tpu_torch", "list"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, check=True).stdout.split()
        if tuple(names) != CLI_BENCHMARKS:
            raise AssertionError(f"cli list: {names}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    walls = [r["step_wall_s"] for r in la[1:]]
    rec = {
        "device": smi,
        "fk_nx": CLI_NX,
        "median_step_wall_s_after_step_1": statistics.median(walls),
        "step_wall_s": [r["step_wall_s"] for r in la],
        "krylov_per_step": [r["stokes_iterations"] for r in la],
        "energy_iterations_per_step": [r["energy_iterations"] for r in la],
        "phase_seconds_B": [r["phase_seconds"] for r in lb],
        "rt_van_keken_krylov_per_step": [r["stokes_iterations"] for r in ld],
        "rt_van_keken_step_wall_s": [r["step_wall_s"] for r in ld],
        "io_seconds": io_s,
        "resume_bit_identical_leaves": len(keys),
        "scan2_step_wall_s": [r["step_wall_s"] for r in le],
        "scan2_krylov_per_step": [r["stokes_iterations"] for r in le],
        "live_markers": n_live,
        "phase_s": time.perf_counter() - t_phase,
        "launches": launches,
    }
    log("cli_paths " + json.dumps(rec))
    return rec


def _flat_step(step, state, tag):
    """One flat-engine step that must converge to 1e-8 and keep every
    field and marker finite.  Returns (state, wall seconds, Krylov)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, diag = step(state)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    if not (diag["stokes_converged"]
            and diag["stokes_residual_rel"] <= 1e-8):
        raise AssertionError(f"{tag}: Stokes solve did not converge "
                             f"({diag['stokes_residual_rel']:.3e})")
    leaves = (state.vx, state.vy, state.p, state.eta_s, state.eta_n,
              state.markers.x, state.markers.y)
    if not all(bool(torch.isfinite(v).all()) for v in leaves):
        raise AssertionError(f"{tag}: non-finite values")
    log(f"{tag}: {dt_s:.3f} s, Krylov {diag['stokes_iterations']}, rel "
        f"residual {diag['stokes_residual_rel']:.3e}")
    return state, dt_s, int(diag["stokes_iterations"])


def validation_paths(modules):
    """The flat marker engine, the block-Jacobi preconditioner and the
    validation runs on the card, every launch counter set to 0 just
    before each path and read just after:

    (a) the flat falling block 64^2, f64, ``preconditioner="jacobi"``: 3
        steps on the card against the same 3 steps on the CPU (every field
        and marker within 1e-10 of the largest value), then the 3 card
        steps again from the same state, every field and marker
        bit-identical (the flat engine's sorted segment sums); no kernel
        launches (an f64 state);
    (b) FK 256^2 (``fk_bench_config``, f32, mixed precision, MG) with flat
        markers, 3 steps interleaved with 3 bucket-engine steps from the
        same markers: Krylov within +-max(2, 10 %), velocities within
        1e-5 max|vy| after step 1, no marker dropped; the flat path
        launches kernels 1, 5 and 6 and none of kernels 2-4, the bucket
        path kernels 1-6;
    (c) 100 steps of ``models.validate_blankenbach`` at 64^2 through the
        module (f32, its own configuration) with ``allow_drops``: every
        step converged, Nu and v_rms printed with the markers dropped
        (the configuration's K = 18 buckets overflow from step ~60 in the
        reference too, on the CPU), kernels 1-4 and 6 launching (kernel
        5 takes no level below 256).

    Returns the record printed in the log (with each path's launches)."""
    from dataclasses import replace

    from pylamp_tpu_torch.bridge import state_leaves
    from pylamp_tpu_torch.markers.bucket import flatten
    from pylamp_tpu_torch.markers.state import MarkerState
    from pylamp_tpu_torch.models import validate_blankenbach
    from pylamp_tpu_torch.models.benchmarks import (
        falling_block,
        fk_bench_config,
    )
    from pylamp_tpu_torch.models.config import SolverConfig
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    rec = {"device": smi}

    # (a) flat + block Jacobi, f64: card vs CPU, then a bit-identical rerun
    tol, restart, maxiter = VALIDATION_FLAT_TOL
    cfg_a = replace(falling_block(VALIDATION_FLAT_NX, VALIDATION_FLAT_NX),
                    marker_engine="flat",
                    solver=SolverConfig(stokes_tol=tol, stokes_restart=restart,
                                        stokes_maxiter=maxiter,
                                        preconditioner="jacobi"))
    runs = {}
    zero_counters(modules)
    for tag, dev in (("card", "cuda"), ("cpu", "cpu"), ("card rerun", "cuda")):
        grid, table, st = build(cfg_a, dtype=torch.float64, device=dev)
        if not isinstance(st.markers, MarkerState):
            raise AssertionError("flat build: not a flat marker state")
        step = make_step(grid, cfg_a, table)
        secs, iters = [], []
        for i in range(VALIDATION_FLAT_STEPS):
            st, dt_s, it = _flat_step(step, st, f"flat jacobi "
                                      f"{VALIDATION_FLAT_NX}^2 {tag} step "
                                      f"{i + 1}")
            secs.append(dt_s)
            iters.append(it)
        runs[tag] = (state_leaves(st), secs, iters)
    launched = counted_launches(modules)
    if launched:
        raise AssertionError(f"flat f64 path launched kernels: {launched}")
    card, cpu, again = (runs[k][0] for k in ("card", "cpu", "card rerun"))
    errs = {}
    for k, v in card.items():
        ref = cpu[k]
        if v.is_floating_point():
            scale = max(float(torch.max(torch.abs(ref))), 1e-300)
            errs[k] = float(torch.max(torch.abs(v.cpu() - ref))) / scale
        elif not torch.equal(v.cpu(), ref):
            raise AssertionError(f"flat card vs CPU: {k} differs")
    differ = [k for k, v in card.items() if not torch.equal(v, again[k])]
    worst = max(errs, key=errs.get)
    log(f"flat jacobi {VALIDATION_FLAT_NX}^2 f64, card vs CPU after "
        f"{VALIDATION_FLAT_STEPS} steps: max rel err {errs[worst]:.3e} "
        f"({worst}); rerun bit-identical: {not differ}")
    if errs[worst] > VALIDATION_FLAT_REL:
        raise AssertionError(f"flat card vs CPU: {worst} off by "
                             f"{errs[worst]:.3e} > {VALIDATION_FLAT_REL}")
    if differ:
        raise AssertionError(f"flat card rerun differs in {differ}")
    rec["flat_jacobi"] = {
        "nx": VALIDATION_FLAT_NX, "rel_err_card_vs_cpu": errs,
        "krylov": {k: runs[k][2] for k in runs},
        "step_s": {k: runs[k][1] for k in runs}}

    # (b) FK 256^2, flat vs bucket from the same markers, interleaved
    cfg_b = fk_bench_config(VALIDATION_FK_NX)
    cfg_f = replace(cfg_b, marker_engine="flat")
    grid, table, st_b = build(cfg_b, dtype=torch.float32, device="cuda")
    fx, fy, fm, fT, fv = flatten(st_b.markers)
    st_f = st_b.replace(markers=MarkerState(x=fx[fv], y=fy[fv], mat=fm[fv],
                                            T=fT[fv]))
    n_markers = int(st_b.markers.total())
    paths = {"flat": (make_step(grid, cfg_f, table), st_f),
             "bucket": (make_step(grid, cfg_b, table), st_b)}
    want = {"flat": ("saddle", "cheb", "coarse_vcycle"),
            "bucket": ("saddle", "m2g", "advect", "rebucket", "cheb",
                       "coarse_vcycle")}
    states = {p: st for p, (_, st) in paths.items()}
    pr = {p: dict(step_s=[], krylov=[], launches={}) for p in paths}
    for i in range(VALIDATION_FK_STEPS):
        for p in (("flat", "bucket") if i % 2 == 0 else ("bucket", "flat")):
            step = paths[p][0]
            zero_counters(modules)
            tag = f"FK {VALIDATION_FK_NX}^2 {p} step {i + 1}"
            if p == "flat":
                states[p], dt_s, it = _flat_step(step, states[p], tag)
            else:
                states[p], dt_s, it, _ = take_step(
                    step, states[p], n_markers,
                    {k: modules[k] for k in want[p]}, tag)
            counts = counted_launches(modules)
            for k, n in counts.items():
                pr[p]["launches"][k] = pr[p]["launches"].get(k, 0) + n
            extra = {k for k in counts
                     if k.removesuffix(".launches") not in want[p]}
            idle = [k for k in want[p] if not counts.get(f"{k}.launches")]
            if extra or idle:
                raise AssertionError(f"{tag}: kernels idle {idle}, other "
                                     f"kernels launched {sorted(extra)}")
            pr[p]["step_s"].append(dt_s)
            pr[p]["krylov"].append(it)
        if i == 0:
            a, b = states["flat"], states["bucket"]
            vmax = float(torch.max(torch.abs(b.vy)))
            dv = max(float(torch.max(torch.abs(a.vx - b.vx))),
                     float(torch.max(torch.abs(a.vy - b.vy))))
            log(f"FK {VALIDATION_FK_NX}^2 flat vs bucket after step 1: max "
                f"|dv| / max|vy| {dv / vmax:.3e}")
            if not dv <= VALIDATION_FK_VTOL * vmax:
                raise AssertionError("the flat FK step disagrees with the "
                                     f"bucket step: {dv / vmax:.3e}")
    if states["flat"].markers.n != n_markers:
        raise AssertionError("the flat path lost markers")
    for i, (a, b) in enumerate(zip(pr["flat"]["krylov"],
                                   pr["bucket"]["krylov"])):
        if abs(a - b) > max(KRYLOV_AB_TOL, VALIDATION_FK_KRYLOV_REL * b):
            raise AssertionError(
                f"FK {VALIDATION_FK_NX}^2 step {i + 1}: Krylov {a} flat, {b} "
                f"bucket (bar +-max({KRYLOV_AB_TOL}, "
                f"{VALIDATION_FK_KRYLOV_REL:.0%}))")
    rec["fk_flat_vs_bucket"] = pr

    # (c) 100 steps of the Blankenbach 1a validation module at 64^2
    zero_counters(modules)
    t0 = time.perf_counter()
    summary = validate_blankenbach.run(
        VALIDATION_BB_NX, max_steps=VALIDATION_BB_STEPS, device="cuda",
        allow_drops=True)
    launched = counted_launches(modules)
    idle = [k for k in ("saddle", "m2g", "advect", "rebucket",
                        "coarse_vcycle") if not launched.get(f"{k}.launches")]
    if idle or summary["failure"] or not summary["all_converged"] \
            or summary["steps"] != VALIDATION_BB_STEPS \
            or not math.isfinite(summary["nu_top"]) \
            or not math.isfinite(summary["vrms"]):
        raise AssertionError(f"validate_blankenbach {VALIDATION_BB_NX}^2: "
                             f"kernels idle {idle}, summary {summary}")
    log(f"validate_blankenbach {VALIDATION_BB_NX}^2, {summary['steps']} "
        f"steps: Nu {summary['nu_top']:.6f}, v_rms {summary['vrms']:.6f}, "
        f"t {summary['time_nondim']:.6f}, {summary['seconds_per_step']:.4f} "
        f"s/step, Krylov {summary['krylov_per_step']:.2f}/step, markers "
        f"dropped {summary['markers_dropped']} (first at step "
        f"{summary['first_drop_step']}), {time.perf_counter() - t0:.1f} s")
    rec["blankenbach_64_100_steps"] = {**summary, "launches": launched}
    rec["phase_s"] = time.perf_counter() - t_phase
    log("validation_paths " + json.dumps(rec))
    return rec


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    from pylamp_tpu_torch import cuda_build
    from pylamp_tpu_torch.markers.kernels import (
        advect,
        advect_block,
        m2g,
        m2g_block,
        rebucket,
        rebucket_block,
    )
    from pylamp_tpu_torch.models.benchmarks import (
        falling_block_periodic_config,
        fk_bench_config,
        sticky_air_bench_config,
    )
    from pylamp_tpu_torch.models.profile import fk_heated_config
    from pylamp_tpu_torch.models.setup import build
    from pylamp_tpu_torch.models.step import make_step, make_step_phases
    from pylamp_tpu_torch.ops.kernels import (
        cheb,
        cheb_block,
        momentum,
        saddle,
        saddle_block,
    )
    from pylamp_tpu_torch.ops.kernels import coarse_vcycle as cvk

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    lib, secs = cuda_build.build()
    cuda_build.library()
    log(f"kernels built in {secs:.1f} s -> {lib}")

    cfg = fk_bench_config(FK_NX)
    t0 = time.perf_counter()
    grid, table, state0 = build(cfg, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    n_markers = int(state0.markers.total())
    log(f"built FK {FK_NX}^2: {tuple(state0.markers.x.shape)} marker slots, "
        f"{n_markers} markers, {time.perf_counter() - t0:.1f} s")

    rows, fk = check_kernels(grid, table, cfg, state0,
                             make_step_phases(grid, cfg, table))
    fk_io = fk["io"]
    rows += mesh_kernel_rows(grid, cfg, table, state0, fk)
    del fk
    cfg_h = fk_heated_config(FK_NX)
    rows += ra_kernel_rows(grid, cfg_h, table, state0)

    cfg_s = sticky_air_bench_config(STICKY_NX)
    t0 = time.perf_counter()
    grid_s, table_s, state_s = build(cfg_s, dtype=torch.float32,
                                     device="cuda")
    torch.cuda.synchronize()
    n_markers_s = int(state_s.markers.total())
    log(f"built sticky-air {grid_s.nx}x{grid_s.ny}: "
        f"{tuple(state_s.markers.x.shape)} marker slots, {n_markers_s} "
        f"markers, {time.perf_counter() - t0:.1f} s")
    io_s = make_step_phases(grid_s, cfg_s, table_s).interp(state_s)
    extra, hier = sticky_mg_checks(grid_s, cfg_s, io_s)
    rows.append(momentum_row(grid, fk_io, grid_s, hier))

    cfg_p = falling_block_periodic_config(PERIODIC_NX)
    t0 = time.perf_counter()
    grid_p, table_p, state_p = build(cfg_p, dtype=torch.float32,
                                     device="cuda")
    torch.cuda.synchronize()
    n_markers_p = int(state_p.markers.total())
    log(f"built periodic falling block {grid_p.nx}^2: "
        f"{tuple(state_p.markers.x.shape)} marker slots, {n_markers_p} "
        f"markers, {time.perf_counter() - t0:.1f} s")
    rows += periodic_kernel_rows(grid_p, cfg_p, table_p, state_p)
    extra.update(odd_shape_checks())
    results = time_rows(rows, extra)
    report_occupancy(cuda_build, smi)
    del fk_io, io_s, hier

    modules = {"saddle": saddle, "m2g": m2g, "advect": advect,
               "rebucket": rebucket, "cheb": cheb, "coarse_vcycle": cvk,
               "momentum": momentum, "cheb_block": cheb_block,
               "saddle_block": saddle_block, "m2g_block": m2g_block,
               "advect_block": advect_block, "rebucket_block": rebucket_block}
    six = {k: modules[k] for k in ("saddle", "m2g", "advect", "rebucket",
                                   "cheb", "coarse_vcycle")}
    # the FK path: the JAX bench preset (use_pallas=False), kernels 1-6;
    # kernel 7 is counted too and must stay idle
    for mod in modules.values():
        mod.launches = 0
    times, iters = run_steps(make_step(grid, cfg, table), state0, n_markers,
                             six, MEASURED_STEPS, "fused")
    launches = {k: mod.launches for k, mod in modules.items()}
    if any(launches[k] for k in modules if k not in six):
        raise AssertionError("the FK bench preset (use_pallas=False, no "
                             f"mesh) launched another kernel: {launches}")
    log(f"FK {FK_NX}^2 on {smi}, fused MG smoother (bench preset): median "
        f"{statistics.median(times[WARMUP_STEPS:]):.3f} s/step over "
        f"{MEASURED_STEPS} steps, {mean(iters[WARMUP_STEPS:]):.1f} Krylov "
        f"iterations/step; launches {launches}")

    # the plain-smoother path (use_pallas_smoother=False) from the same
    # built state: four kernels, the MG smoother as tensor code
    cfg1 = fk_bench_config(FK_NX, fused_smoother=False)
    four = {k: modules[k] for k in ("saddle", "m2g", "advect", "rebucket")}
    for mod in modules.values():
        mod.launches = 0
    times1, iters1 = run_steps(make_step(grid, cfg1, table), state0,
                               n_markers, four, PLAIN_MG_MEASURED_STEPS,
                               "plain MG")
    launches1 = {k: mod.launches for k, mod in modules.items()}
    if launches1["cheb"] or launches1["coarse_vcycle"]:
        raise AssertionError("the use_pallas_smoother=False path launched a "
                             f"fused MG kernel: {launches1}")
    log(f"FK {FK_NX}^2 on {smi}, plain MG smoother "
        f"(use_pallas_smoother=False): median "
        f"{statistics.median(times1[WARMUP_STEPS:]):.3f} s/step over "
        f"{PLAIN_MG_MEASURED_STEPS} steps, "
        f"{mean(iters1[WARMUP_STEPS:]):.1f} Krylov iterations/step; "
        f"launches {launches1}")
    log("A/B " + json.dumps({
        "device": smi,
        "fused": {"median_s_per_step": statistics.median(times[WARMUP_STEPS:]),
                  "step_s": times, "krylov": iters},
        "plain_mg": {
            "median_s_per_step": statistics.median(times1[WARMUP_STEPS:]),
            "step_s": times1, "krylov": iters1}}))
    for i, (a, b) in enumerate(zip(iters, iters1)):
        if abs(a - b) > KRYLOV_AB_TOL:
            raise AssertionError(
                f"step {i + 1}: {a} Krylov iterations with the fused MG "
                f"kernels, {b} without (bar +-{KRYLOV_AB_TOL})")

    launches_m, first_m = mesh_path(grid, cfg, table, state0, n_markers,
                                    modules)
    rec_dist = dist_mesh_path(grid, cfg, table, state0, first_m, modules,
                              periodic=(grid_p, cfg_p, table_p, state_p))
    rec_dp = dict(launches=rec_dist["periodic"]["launches_per_rank"],
                  launches_periodic=rec_dist["periodic"]
                  ["launches_periodic_per_rank"])
    del first_m
    rec_h, state_h = heated_paths(grid, table, state0, modules)
    reseed_check(grid, table, state_h)
    del state_h
    launches_hm, first_hm = mesh_path(grid, cfg_h, table, state0, None,
                                      modules, label="heated FK mesh",
                                      measured=HEATED_MESH_MEASURED_STEPS,
                                      ra=True, krylov_rel=HEATED_KRYLOV_REL)
    rec_dh = dist_heated_path(grid, table, state0, first_hm, modules)
    del first_hm
    rec_opt = solver_option_paths(grid, table, state0, n_markers, modules,
                                  dict(step_s=times[:2], krylov=iters[:2]))
    del state0
    launches_s = sticky_air_paths(grid_s, cfg_s, table_s, state_s,
                                  n_markers_s,
                                  {k: modules[k] for k in (*six, "momentum")},
                                  modules)
    del state_s
    rec_p = periodic_paths(grid_p, cfg_p, table_p, state_p, n_markers_p,
                           modules)
    rec_pm = periodic_mesh_path(grid_p, cfg_p, table_p, state_p, n_markers_p,
                                modules)
    del state_p

    stretched_paths(modules)
    small_reference_check()
    periodic_reference_check(modules)
    vanka_sharp_check()
    rec_sweep = sweep_paths(modules)
    rec_cli = cli_paths(modules)
    rec_val = validation_paths(modules)

    def periodic_count(k, r):
        """Launches of row ``k``'s form on a periodic path's record ``r``:
        a periodic row's periodic-form launches, a wall-form row's
        wall-form ones (the rho0 * alpha rows: none, no periodic path runs
        them)."""
        if k.endswith("_ra"):
            return 0
        base = k.removesuffix("_periodic")
        n_periodic = r["launches_periodic"].get(base, 0)
        return n_periodic if k != base else r["launches"][base] - n_periodic

    def heated_count(k, launches_by_kernel, ra_kernel, n_ra):
        """Launches of row ``k``'s form on a heated path whose kernel
        ``ra_kernel`` launched ``n_ra`` times with the rho0 * alpha stream
        (every time: the path checks it)."""
        if k.endswith("_periodic"):
            return 0
        if k.endswith("_ra"):
            return n_ra if k == f"{ra_kernel}_ra" else 0
        return launches_by_kernel[k] - (n_ra if k == ra_kernel else 0)

    def main_count(k):
        """Launches on the path of the row's slice: kernels 1-7 the
        sticky-air path (all seven), 8-12 the mesh path, the periodic forms
        the periodic preset (1-5) or its partner (7), 10p-12p a rank of the
        distributed periodic path, the rho0 * alpha forms of 2 and 10 the
        heated FK path and its mesh form."""
        if k == "m2g_ra":
            return rec_h["launches_ra"]
        if k == "m2g_block_ra":
            return launches_hm["mesh_4x2"]["m2g_block"]
        if k.endswith("_block_periodic"):
            return periodic_count(k, rec_dp)
        if k.endswith("_block"):
            return launches_m["mesh_4x2"][k]
        if k.endswith("_periodic"):
            return periodic_count(k, rec_p["partner" if k.startswith(
                "momentum") else "preset"])
        return launches_s[k]

    def val_count(k, path):
        """Launches of row ``k``'s form on a validation_paths path (the
        flat FK path, or the Blankenbach module with ``path`` None): the
        wall form of kernels 1-6 only."""
        if k.endswith(("_periodic", "_ra")):
            return 0
        counts = (rec_val["fk_flat_vs_bucket"][path]["launches"]
                  if path else rec_val["blankenbach_64_100_steps"]
                  ["launches"])
        return counts.get(f"{k}.launches", 0)

    kernels = []
    for k, r in results.items():
        base = k.removesuffix("_periodic").removesuffix("_ra")
        wall_form = k == base
        kernels.append(dict(
            name=k, route="cuda", source=r["source"], replaces=r["replaces"],
            launches=main_count(k),
            launches_by_path={
                "fk_1024": launches[base] if wall_form else 0,
                "sticky_air_1024x256": launches_s[base] if wall_form else 0,
                "fk_1024_mesh_4x2": (launches_m["mesh_4x2"][base]
                                     if wall_form else 0),
                # dist_mesh_path: one step, per rank of the 8-rank world
                "fk_1024_dist_4x2": (rec_dist["launches"][base]
                                     if wall_form else 0),
                "falling_block_periodic_1024": periodic_count(
                    k, rec_p["preset"]),
                "falling_block_periodic_1024_partner": periodic_count(
                    k, rec_p["partner"]),
                # explicit_halo on the 4x2 mesh (periodic_mesh_path)
                "falling_block_periodic_1024_mesh_4x2": periodic_count(
                    k, rec_pm["mesh_4x2"]),
                # dist_mesh_path: one step per rank of the 8-rank world on
                # the sharded layout (the wrap-around marker exchange)
                "falling_block_periodic_1024_dist_4x2": periodic_count(
                    k, rec_dp),
                "fk_1024_heated": heated_count(
                    k, rec_h["launches"], "m2g", rec_h["launches_ra"]),
                "fk_1024_heated_mesh_4x2": heated_count(
                    k, launches_hm["mesh_4x2"], "m2g_block",
                    launches_hm["mesh_4x2"]["m2g_block"]),
                # dist_heated_path: one step of each energy solve, per
                # rank of the 8-rank world on the sharded layout
                **{f"fk_1024_heated_{pre}_dist_4x2": heated_count(
                    k, rec_dh[pre]["launches_per_rank"], "m2g_block",
                    rec_dh[pre]["launches_ra_per_rank"])
                   for pre in HEATED_VARIANTS},
                # stretched_paths fails on any launch there
                "fk_1024_stretched_8x": 0,
                "fk_1024_stretched_8x_line": 0,
                # `python -m pylamp_tpu_torch run fk_stagnant_lid --nx
                # 1024 --steps 4` (cli_paths (a))
                "cli_fk_1024": (rec_cli["launches"]["A"][base]
                                if wall_form else 0),
                # the same with `--scan 2` (cli_paths (e))
                "cli_fk_1024_scan2": (rec_cli["launches"]["E"][base]
                                      if wall_form else 0),
                # sweep_paths: the four FK 1024^2 members, all sweep steps
                "fk_1024_sweep_4": (rec_sweep["launches"][base]
                                    if wall_form else 0),
                # validation_paths (b): FK 256^2 with flat markers, and
                # (c): validate_blankenbach 64^2, 100 steps
                "fk_256_flat": val_count(k, "flat"),
                "blankenbach_64_validation": val_count(k, None),
                # solver_option_paths: FK with each option
                **{name: (r_opt["launches"][base] if wall_form else 0)
                   for name, r_opt in rec_opt.items()}},
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            **{k: r[k] for k in ("device_ms", "host_us") if k in r}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
