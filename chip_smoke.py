"""On-card smoke run of the PyTorch/CUDA port (peps_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each (failures exit non-zero before the last line):
  1. device and build: the card's name and power limit, then K1 and K2
     (CUDA C++, one nvcc per source, started together) built from the
     checkout's sources;
  2. every kernel against its plain PyTorch version at every main-path
     shape, float32 (tolerance 1e-5) and float64 (1e-12), errors as
     max |kernel - plain| / max |plain|, with both times; for K1 also the
     time of one torch.einsum call computing the same transfer, the bound
     (flops over the card's f32 or f64 peak derived from the SM count and
     nvidia-smi's clocks.max.sm, or bytes over 3.35 TB/s), the share of the
     bound reached, the launch plan taken, and the host microseconds per
     call with the meta cache warm. K2 also at the stretch run's shape
     (12x12, D=10, 256 samples; f32 and f64) and past 2^31 elements
     (16x16, D=12, 256 samples; f32, checked on its first and last site),
     with |psi| in [0.5, 1.5) and one psi = 0 row (k2_operands), each with
     its bound (bytes over 3.35 TB/s), the launch plan, and the
     time of a device-to-device copy_ that moves as many bytes (the
     attainable memory rate; no PyTorch call computes K2, so library_ms
     stays null). A kernel slower than its plain version is reported, not
     failed: only a wrong result fails;
  3. the main path through the user entry points: product_peps (Neel) ->
     simple_update -> to_tps -> vmc_optimize (SR by CG) on 8x8 Heisenberg,
     D=8, chi=32, sketch, 32 chains, f32, 3 iterations; energies finite
     with E/site in (-0.70, -0.40), every kernel launched; peak device
     memory counted from the phase's start;
  4. the sketch-vs-svd accuracy gate: local energies of 16 sampled
     configurations under both compression schemes, max relative
     difference < 1e-2;
  5. measure() on the main path's optimized state and final
     configurations, through the entry point: exchange, 32 chains, 2
     warm-up sweeps, 8 samples in chunks of 4, the S+S- walkers on; one
     line with sampling_wall_s, samples per second, the energy per site
     and its error, acceptance, autocorrelation time, sum of <Sz>, the
     mean nearest-neighbour <S+S-> in both frames, the bond-sum energy, K1
     launches inside measure(), peak device memory from the phase's start
     (and what earlier phases still hold at its start) and the phase's
     wall seconds; then a breakdown of one sample step
     (sweep, energy pass, walker pass; CUDA-synchronized host clock) and
     dump_stats into a temporary directory. Checks: finite statistics,
     E/site in (-0.70, -0.40), |sum <Sz>| < 1e-5, negative nearest-
     neighbour <S+S-> in both frames, the bond sum within max(5 stderr,
     3% |E|) of the E_loc energy, K1 launched, a CSV per statistic;
  6. the optimizers: vmc_optimize four times from the main path's state
     and final configurations (8x8, D=8, chi=32, 32 chains, f32, exchange,
     1 sample step per evaluation, no warm-up): (a) dense MinSR, cutoff
     1e-8, 2 iterations; (b) Krylov MinSR, 16 Lanczos steps, 2
     iterations; (c) Adam with CosineAnnealing, clip_norm, spike
     detection with rollback, the step selector (3 energy-only probes at
     step 0), a checkpoint per iteration, the trajectory CSV and the JSONL
     log, 3 iterations; (d) L-BFGS with the strong-Wolfe search (at most 4
     evaluations), 2 iterations. One line per run: energies per site,
     eval/update/iteration seconds, evaluations per iteration (counted
     through the sweep and probe uniform sources), spike events, K1 and K2
     launches and peak device memory from the run's start. Then dense
     against Krylov MinSR (m = Ns = 32) on one evaluation's buffers: in
     float64 within 1e-8, in float32 printed. Checks: finite energies in
     (-0.70, -0.40) per site, finite states, K1 launched in every run and
     K2 in (a) and (b), run (c)'s 3 checkpoints equal to the states the
     callback saw, its CSV with one header and 3 rows, its 3 JSONL records.
  7. the long-range terms (j1j2), from the main path's state and final
     configurations, each step with the launch counters at 0 and its own
     seconds, launches and peak memory: the route check (the 32
     configurations' local energies of j1j2_xxz(1, 1, 0, 0), whose vertical
     bonds go through the two-row pair pass, against heisenberg(), whose
     go through the transposed frame: mean within 1e-2 relative, the
     largest single-configuration difference printed); two SR iterations
     of vmc_optimize on j1j2_xxz(1, 1, 0.5, 0.5); measure() of that state
     (8 samples in chunks of 4, no warm-up, no walkers), E/site in
     (-0.60, -0.35); one energy-only evaluation each of
     triangle_j1j2_heisenberg(1, 0.5) and of J1 plus 0.25 J1 on the
     third neighbours in both directions. Checks: finite energies, K1, K2
     and K3 launched.
  8. the rest of the bosonic OBC surface (bosonic_rest), at the main
     path's width, each step with the launch counters at 0: the J1-J2
     state from simple_update_nnn (j1j2_xxz(1, 1, 0.5, 0.5) from the Neel
     state, tau 0.1, 40 steps; seconds, e0 per site and truncation error
     per step), then to_tps and 2 SR iterations from it (E/site in (-0.60,
     -0.35), beside phase 7's from the Heisenberg state); the triangular
     state from simple_update_triangle (triangle_j1j2_heisenberg(1, 0.5),
     20 steps) and one energy-only evaluation of it, below the product
     state's energy; on the J1-J2 state the ratio-table energy against
     local_energy_and_holes (< 1e-4 relative) and the Jastrow-dressed
     energy (v = 0 equal to the undressed in value, a small seeded v
     finite); two mc_sweep_3site sweeps of the 32 chains (seconds,
     acceptance, every chain's Sz kept); psi_consistency_check and the
     entanglement entropy of a boundary MPS's middle cut; on the main
     path's state and 16 configurations the local energies under var2,
     var1 and fast against svd (< 1e-2 relative), then one energy-only
     evaluation per scheme, of 16 chains for sketch and fast and 2 for
     var1 and var2 (their batched SVDs are slow on cuSOLVER: one batch of
     16 matrices of 256 x 256 f32 is timed beside them). Checks: those
     limits, K1, K2 and K3 launched.
  9. the close of the bosonic OBC surface (bosonic_close), at the main
     path's width, each step with the launch counters at 0: (a) the
     complex64 main path: product_peps (Neel) -> simple_update with the
     energy-stall stop (energy_abs_tol 1e-2, patience 3) and a step
     observer (executed_steps, converged) -> to_tps -> 2 SR iterations of
     vmc_optimize -> measure() (8 samples, the S+S- walkers), E/site in
     (-0.70, -0.40), complex K1 and K2 launched, then the SR run and
     measure() again with CUDA events around each K1 launch (K1's device
     ms and launches in each); (b) an energy-only
     J1-J2 (J2 = J1/2) evaluation of that complex64 state with
     eval_chunk 8 (complex K3), its peak memory and K3's device ms in it
     (CUDA events around each K3 call) against its wall seconds; (c)
     complex128 on the card
     against the port on the CPU: one SR evaluation of J1-J2 on a seeded
     4x4, D=4 state, chi=16, 8 chains, the same uniforms and sketch
     blocks, energy, gradient and SR buffers within 1e-10 relative and the
     same configurations, all three kernels launched; (d) TFIM (J = h =
     1): the site term folded into the bonds, SU from the z-polarised
     state, 2 SR iterations with Suwa-Todo from uniform configurations,
     SU and VMC E/site within max(5 stderr, 3%) and both below the
     z-polarised state's -1.75; (e) the real J1-J2 SR evaluation with
     eval_chunk None and 8 on the same uniforms, energies within 1e-5
     relative, both peaks printed.
Phase 2 also holds the complex bodies of K1, K2 and K3 (complex64 to 1e-5,
complex128 to 1e-12) at the main path's shapes: K1 at all ten cases of
k1_cases, K2 on the 8x8 D=8 SR buffer with a psi = 0 row, K3
at every case of k3_cases (the BTen2 env step in both forms, the diagonal
block's lblk and rblk, the anti-diagonal block's lblk; at the blocks the
complex128 plain chain and einsum run on 4 chains' items: the full
block's intermediates do not fit the card), each with its time, bound (a
complex multiply-add is 4
real FMAs; complex64 on the FP32 peak, complex128 on the f64 one), the
plain version's and the yardstick's times, the plan and, for K1 and K3,
the compiled kernel's registers a thread and spill bytes (kernels_complex
lines); a slow complex kernel is reported, not failed. Phase 9 also times
K1's launches inside the complex64 SR evaluation and measure() (CUDA
events around each launch, in a second run of each: the events cost host
time) and prints their device ms and count.
Each phase ends with a phase_end line holding its wall seconds.
 10. fermions: (a) the Jordan-Wigner path on
     examples/hubbard_vmc.py's configuration (2x4 Hubbard U=8, D=4,
     chi=16, the fast scheme, 64 chains, Suwa-Todo with the N_up/N_dn
     conservation mask, quarter filling), 2 SR iterations: finite
     energies, every chain's N_up and N_dn kept; (b) the graded path at
     examples/flagship_tj_6x6.py's width: 6x6 t-J (t=3, J=1) with holes at
     (2,2) and (3,2) on the Neel background, the graded SU at D=4 with
     U(1) charges and the QR-reduced projection (40 steps at tau 0.2, 40
     at 0.05; seconds per step), to_tps_fermion, expand_bond_dim_graded to
     D=8 (4|4) with noise 1e-3, then vmc_optimize on the
     GradedFermionModel with SR (CG 40, shift 1e-3), 3 iterations, 1
     sample step, 2 warm-up sweeps, chi=32, sketch, 32 chains, eval_chunk
     8, float32 (seconds per evaluation, K1, K1's backward, K2, K3 and
     K4 launches, peak memory), the split of one SR iteration
     (graded_breakdown: sweep, holes, tables, the rest of the local
     energy, SR solve, with every ColTransferFunction backward call
     counted: one backward launch and no K1 launch each); checks: the SU estimate per site
     finite and below the Neel state's -0.736 (53 bonds at -J/2 over 36
     sites, from the channel tables), every SR iteration's E/site in
     (-1.35, -0.736), N_up = N_dn = 17 in every chain, acceptance above 0,
     every kernel launched; (c) graded t-J at 4x4, D=4, chi=6, 8 chains,
     complex128 and float64, one SR evaluation on the card and on the CPU
     with the same uniforms: energy, O buffer and SR direction within
     1e-10 relative, the same configurations.
 11. fermion_measure: (a) measure() of phase 10 (b)'s optimized graded
     6x6 t-J state and final configurations at the flagship's width (D=8,
     chi=32, sketch, 32 chains, float32, 2 warm-up sweeps, 4 samples in
     chunks of 2, eval_chunk 8, env_chunk 8, measure_pair_corr): one line
     with sampling_wall_s, samples per second, E/site, the sums of the
     density maps, the launches inside the call and the peak memory, one
     line with the split of a sample step timed inside the real call (the
     sweep, the energy pass without the env build, the GradedEnvShared
     build, the row walker, the column walker; synchronized wrappers
     where measure() looks the functions up); checks: finite statistics,
     E/site in (-1.35, -0.736), N_up = N_dn = 17 and 2 holes after every
     sweep (and the density maps summing to them), both pair tables zero
     wherever |i-k| <= 1, K1, K3, K4 and K5 launched; (b) the conditioned
     estimator at 6x6: P(A) counted over 4 unconditioned sweeps of the 32
     chains, then 8 chains moved into A (holes Chebyshev-adjacent) and
     swept under the hard hole-attraction dress (kappa 50), 2 warm-up
     sweeps and 2 samples with both pair tables; A must hold in every
     chain, the tables finite; (c) the card against the CPU in float64
     and complex128 within 1e-10: both graded walkers on one
     GradedEnvShared of 8 configurations of a seeded 4x4, D=4 state at
     chi=6, and exact_sum_pair_corr_graded on a seeded 2x4 ladder; (d) a
     Jordan-Wigner t-J measure() with the pair correlators (2x4, D=4) and
     one of phase 10 (a)'s Hubbard state: finite, N_up and N_dn kept.
 12. pbc (the torus, pbc lines): (a) examples/heisenberg_pbc_vmc.py's
     width: the 4x4 Heisenberg torus SU from the Neel state at D=3, tau
     0.2 then 0.05, 40 + 40 steps (the example runs 120 + 120), seconds
     per step, its estimate per site below the Neel state's -0.5 (32
     bonds at -1/4 on 16 sites); to_tps_pbc in float32; (b) the torus
     local energy and holes (one autograd pass for the holes, the bond
     recomputes of every chain, bond and candidate pair in one batched
     contraction) of 8 and 32 Sz = 0 configurations from
     init_configs_occupancy at chi=12 under the fast scheme (one power
     iteration) and the svd scheme: seconds per evaluation, the mean
     E_loc (a number only: the configurations are not drawn from
     |psi|^2), finite E_loc and holes; (c) float64 card against the CPU on
     that state and 8 configurations: log|psi|, the mantissa's sign, E_loc
     and O within 1e-8; (d) examples/tfim_pbc_trg.py at its width (2x2
     TFIM, D=2, chi=16, float64, CG 200), 20 SR iterations (the example
     runs 60) through exact_sum_evaluation(bc=PERIODIC) and
     iterative_optimize, the final state's exact-sum energy within 1e-6
     of ED of the same state; (e) contract_pbc of a random 4x4 D=2 torus
     in float64, both schemes at chi=16, against exact_contract_pbc within
     1e-10. No hand kernel lies on the torus path (its products and
     factorizations are torch's); the phase prints the launch counters.
 13. pbc_sampler (the torus sampler, pbc_sampler lines): (a)
     vmc_optimize(bc=PERIODIC) from phase 12's state at
     examples/heisenberg_pbc_vmc.py's width (8 chains, SR by CG 60, lr
     0.1; 2 warm-up sweeps, 4 samples, 3 iterations): seconds an
     iteration, E/site in (-0.75, -0.60), acceptance in (0, 1), Sz kept,
     K2 launched (it writes the torus SR buffer); (b) measure(bc=PERIODIC)
     of the result (8 chains, 2 warm-up sweeps, 8 samples): samples/s,
     |sum <Sz>| < 1e-5, nearest-neighbour <SzSz> < 0; (c) one sweep of 8
     and of 32 chains under the full recompute, the frozen and the exact
     trial sweeps (chain-sweeps/s), and the frozen sweep equal to the full
     one at 4x4 D=2 chi=16 in float64; (d) float64 card against CPU of one
     mc_energy_grad of 2 chains under both samplers.
Phase 2 also holds K5 (bmps_overlap, kernels_fermion lines) at the column
walker's per-k shape (8 configurations x 5 start bonds x 6 columns x 4
closures, Lx=6, chi=32, D=8, b broadcast over the start bonds) in all four
dtypes against its plain version (float32 and complex64 to 1e-5, float64
and complex128 to 1e-12), with both times, the bound (FP32 or DMMA peak,
or bytes), the share of it reached and the launch plan (lanes a CTA).
Phase 2 also holds the fermion slice's kernels (kernels_fermion lines): K4
(fermion_dress) in its three outputs at 6x6, D=8, d=3, 32 chains (the
projection, the prefix-flipped projection, one row's candidates, a
per-chain gradient undressed through a stride-0 physical axis) in all
four dtypes, exactly equal to its plain version, with its device time
alone (a CUDA graph of 20 launches), its host microseconds a call, its
time in back-to-back calls, the plain version's, a copy_ of the output's
bytes and the bytes bound; and K1's
backward (csrc/col_transfer_backward.cu: one launch a backward call for
every requested gradient) at the graded holes' shapes (the sketch V and W
scans, the pair traces; a chunk of 8 chains) in all four dtypes, every
input's gradient within 1e-5 / 1e-12 of autograd through the plain
transfer, one launch and no K1 launch in the backward, timed against the
plain chain's backward with its bound (the shared chain's products) and
the launch plan.
Phase 2 also holds K1 at the walker's shape (2048 items, top, bot and site
broadcast over the start column) and at the 3-site window's (32 chains x 6
candidates, top and bot broadcast over the candidates, the left env too in
the window's first transfer), and K3 (pair_transfer) at the J1-J2
path's shapes and forms: the BTen2 scan step (224 items) in the left and
the right form, and the 3136-item blocks of the pair pass with a candidate
axis: the diagonal's lblk (left form, candidates on row1) and rblk (right
form, candidates on row2) and the anti-diagonal's lblk (left form,
candidates on row2). Each K3 case is held to its plain version and timed
beside it, one torch.einsum of the whole contraction and its FP32 or FP64
bound, with the launch plan and what the compiled kernel reaches there
(registers a thread, spill bytes, CTAs an SM). The line before the last is
the kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

LY = LX = 8
D = 8
CHI = 32
NCHAINS = 32
PHYS = 2
SU_STEPS = 40
WARMUP_SWEEPS = 2
SR_ITERS = 3
MEASURE_SAMPLES = 8
MEASURE_CHUNK = 4
MINSR_LR = 0.02            # phase 6 learning rates (the main path's SR: 0.05)
ADAM_LR = 1e-4             # Adam moves every parameter by about lr at first
ADAM_CLIP = 1.0
LBFGS_LR = 1e-3            # the strong-Wolfe search's first trial step
NNN_SU_STEPS = 40          # phase 8: the J1-J2 state's cluster update
TRI_SU_STEPS = 20          # phase 8: the triangular state's
GATE_CONFIGS = 16          # configurations of the scheme gates
# phase 8's energy-only evaluation per scheme takes 16 of the 32 chains,
# and 2 for var1 and var2: an absorb of those runs 14-42 batched SVDs of
# 256 x 256 a chain on cuSOLVER (timed in the phase's svd_batched line), and
# the scheme gate before it already holds them against svd
SCHEME_EVAL_CHAINS = {"sketch": 16, "fast": 16, "var1": 2, "var2": 2}
SWEEPS_3SITE = 2
TOL = {"float32": 1e-5, "float64": 1e-12, "complex64": 1e-5,
       "complex128": 1e-12}
COMPLEX_DTYPES = ("complex64", "complex128")
# phase 2's complex cases: K1 at every main-path shape, K3 at its largest
K1_COMPLEX_CASES = ("sketch_v_step", "sketch_w_step", "right_btens",
                    "bond_step", "row_envs", "right_blocks", "nn_traces",
                    "walker", "window3_first", "window3_next")
K3_COMPLEX_CASES = ("env_step", "env_step_right", "diag_block",
                    "diag_block_right", "antidiag_block")
K3_SUBSET_CHAINS = 4       # complex128 blocks: the plain chain on 4 chains
# phase 9 (bosonic_close)
CLOSE_SU_STEPS = 40
CLOSE_SU_TOL = 1e-2        # energy_abs_tol of the complex main path's SU
CLOSE_SR_ITERS = 2
CLOSE_EVAL_CHUNK = 8
TFIM_WARMUP_SWEEPS = 10
SMALL = {"ly": 4, "lx": 4, "D": 4, "chi": 16, "nchains": 8}
# phase 10 (fermions): examples/flagship_tj_6x6.py's width, depth cut
FLAG = {"L": 6, "D_su": 4, "D": 8, "chi": 32, "nchains": 32, "chunk": 8,
        "t": 3.0, "J": 1.0, "sr_iters": 3, "warmup": 2,
        "su": ((40, 0.2), (40, 0.05))}
# phase 10 (c): SMALL's lattice, D and chains at chi = 6, which truncates
# every boundary past the first row; at chi = 16 the edge rows' sketch
# Grams are rank 4 in 16, held only by the 1e-12 jitter, and the holes
# (autograd through them) move with the summation order beyond 1e-10
FERMION_CARD_CPU_CHI = 6
# phase 10 (b)'s float32 evaluation against float64 at float32's sketch
# jitter on the card at the flagship's shape: relative Frobenius
# differences, 4-11x the first card readings (8.8e-6, 1.1e-3, 5.4e-3;
# PERF.md section 6) and below the 5.5e-2 and 3.8e-2 that the jitter
# itself moves O and the SR direction by
GRADED_F32_TOL = {"energy": 1e-4, "o_samples": 1e-2, "sr_direction": 2e-2}
HUBBARD = {"ly": 2, "lx": 4, "D": 4, "chi": 16, "nchains": 64,
           "samples": 10, "warmup": 20, "sr_iters": 2}
# phase 2's K4 cases (6x6, D=8, t-J's d=3, 32 chains): the projection, the
# prefix-flipped projection and one row's candidates
K4_CASES = (("project", {"select_config": True, "f0": 0, "nf": 1}),
            ("project_flipped", {"select_config": True, "f0": 1, "nf": 1}),
            ("candidates_row", {"y0": 2, "ny": 1}),
            ("undress_grad", {"select_config": True, "f0": 0, "nf": 1}))
K4_GRAPH_LAUNCHES = 20     # launches captured in the graph one replay times
# phase 11 (fermion_measure): measure() of phase 10 (b)'s state, the
# conditioned estimator's count and conditioned chains
FMEAS = {"warmup": 2, "samples": 4, "chunk": 2, "env_chunk": 8,
         "count_sweeps": 4, "cond_chains": 8, "cond_warmup": 2,
         "cond_samples": 2}
# phase 12 (pbc): examples/heisenberg_pbc_vmc.py's width (4x4 torus, D=3,
# chi=12, fast with one power iteration, float32), 40 + 40 SU steps
# instead of 120 + 120; examples/tfim_pbc_trg.py's (2x2, D=2, chi=16,
# float64, CG 200), 20 SR iterations instead of 60
PBC = {"L": 4, "D": 3, "chi": 12, "su": ((40, 0.2), (40, 0.05)),
       "nconf": (8, 32), "svd_nconf": (8, 32), "card_cpu_nconf": 8}
TFIM_PBC = {"L": 2, "D": 2, "chi": 16, "iters": 20, "cg": 200, "lr": 0.1}
# phase 13 (pbc_sampler): examples/heisenberg_pbc_vmc.py's torus VMC and
# measure() from phase 12's state at the example's width (8 chains, half
# filling, exchange rule, SR by CG 60, lr 0.1): 2 warm-up sweeps, 4 samples
# and 3 iterations where the example runs 20, 16 and 40; measure() with 2
# warm-up sweeps and 8 samples where it runs 20 and 48. Sweep rates at 8
# and 32 chains; the samplers' equality at 4x4 D=2 chi=16 (no truncation)
# in float64; card against CPU with 4 chains in float64.
PBC_SAMPLER = {"nchains": 8, "warmup": 2, "samples": 4, "iters": 3,
               "cg": 60, "lr": 0.1, "measure_warmup": 2,
               "measure_samples": 8, "sweep_chains": (8, 32),
               "equal": {"D": 2, "chi": 16}, "card_cpu_chains": 4}
HBM_BPS = 3.35e12          # H100 SXM device memory rate (data sheet)
EINSUM_1CALL = "...alc,...auA,...uldr,...cdC->...ArC"
EINSUM_K3 = "...amnc,...auA,...umdr,...dnef,...ceC->...ArfC"
# K2 cases: (name, Ns, sites, K, dtypes, check on the first and last site
# only). The stretch run is examples/stretch_heisenberg.py's 12x12 D=10 with
# 32 chains x 8 samples; 16x16 D=12 at 256 samples is past 2^31 elements.
# The torus case is phase 13 (a)'s SR buffer: 8 chains x 4 samples of the
# 4x4 D=3 torus.
K2_CASES = (
    ("main_path_8x8_D8", NCHAINS, LY * LX, D ** 4, ("float32", "float64"),
     False),
    ("torus_4x4_D3", 32, 16, 3 ** 4, ("float32", "float64"), False),
    ("stretch_12x12_D10", 256, 144, 10 ** 4, ("float32", "float64"), False),
    ("big_16x16_D12", 256, 256, 12 ** 4, ("float32",), True),
)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def time_ms(fn, reps):
    """Mean device time of fn() in ms over reps launches (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(out, ref):
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-300)


def _in_turns(fns, reps):
    """Mean ms of each named fn over the turns a, b, ..., ..., b, a."""
    order = list(fns) + list(fns)[::-1]
    t = {k: [] for k in fns}
    for k in order:
        t[k].append(time_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in t.items()}


def peak_rates(device):
    """The card's f32 and f64 peaks (flop/s) from its SM count and maximum
    SM clock (nvidia-smi clocks.max.sm), two flops per fused multiply-add.
    f32: 128 FP32 CUDA-core lanes per Hopper SM (TF32 is a lower precision,
    not f32's rate). f64: 128 FMA per clock per SM on the DMMA tensor cores,
    full IEEE f64; the 64 FP64 CUDA-core lanes (DFMA, what K1 runs on) give
    half that, printed as fp64_simt_flops."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i",
                          str(device.index or 0)], capture_output=True,
                         text=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {"sms": sms, "clock_max_sm_MHz": mhz,
            "fp32_flops": sms * 128 * 2 * mhz * 1e6,
            "fp64_flops": sms * 128 * 2 * mhz * 1e6,
            "fp64_simt_flops": sms * 64 * 2 * mhz * 1e6, "hbm_Bps": HBM_BPS}


def k1_work(env, top, site, bot, out):
    """(flops, bytes) of one K1 call on left-form operands: the three
    contractions per item, each input read once, the output written once.
    A complex multiply-add counts 4 real FMAs (8 flops)."""
    na, nl, nc = env.shape[-3:]
    nu, nA = top.shape[-2:]
    nd, nr = site.shape[-2:]
    nC = bot.shape[-1]
    items = math.prod(out.shape[:-3])
    flops = 2 * items * (na * nl * nc * nu * nA + nA * nc * nl * nu * nd * nr
                         + nA * nr * nc * nd * nC)
    flops *= 4 if env.is_complex() else 1
    nbytes = sum(t.numel() for t in (env, top, site, bot, out)) \
        * env.element_size()
    return flops, nbytes


def k1_cases(dtype, device, gen):
    """K1 operands at the shapes and broadcast patterns the main path gives
    it (8x8, D=8, chi=32, 32 chains, d=2): (name, form, env, top, site, bot)."""
    import torch
    nc, lx, ly, d, losk = NCHAINS, LX, LY, PHYS, CHI + 8

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=device, dtype=dtype)

    env = (CHI, D, CHI)
    z = r(D * CHI, CHI).reshape(D, CHI, CHI).permute(2, 0, 1)
    y = r(D, losk, losk).permute(1, 0, 2)
    # the walker's column step: walkers [nc, Ly, Lx(x1)], column x of the
    # stacks and of the candidates broadcast over x1 (algorithm/measure.py)
    w_tops, w_bots = r(nc, ly + 1, lx, *env), r(nc, ly + 1, lx, *env)
    w_sites, wx = r(nc, ly, lx, D, D, D, D), lx // 2
    # the 3-site window's transfers: the chains' top row [nc, Lx] and bottom
    # stack [nc, Ly+1, Lx] at column x broadcast over the 6 candidates, the
    # candidates' sites gathered per chain; the first transfer's left env
    # broadcast too, the later ones' per candidate (montecarlo/sweep.py)
    t3, s6 = r(nc, lx, *env), r(nc, 6, D, D, D, D)
    return [
        ("sketch_v_step", "right", r(nc, *env), r(nc, *env), r(nc, D, D, D, D), z),
        ("sketch_w_step", "left", r(nc, CHI, D, losk), r(nc, *env),
         r(nc, D, D, D, D), y),
        ("right_btens", "right", r(nc, *env), r(nc, *env), r(nc, D, D, D, D),
         r(nc, *env)),
        ("bond_step", "left", r(nc, 1, *env), r(nc, 1, *env), r(d, D, D, D, D),
         r(nc, 1, *env)),
        ("row_envs", "left", r(nc, ly, *env), r(nc, ly, *env),
         r(nc, ly, D, D, D, D), r(nc, ly, *env)),
        ("right_blocks", "right", r(nc, lx - 1, 1, *env), r(nc, lx - 1, 1, *env),
         r(lx - 1, d, D, D, D, D), r(nc, lx - 1, 1, *env)),
        ("nn_traces", "left", r(nc, ly, lx - 1, 1, *env),
         r(nc, ly, lx - 1, 1, *env), r(ly, lx - 1, d, D, D, D, D),
         r(nc, ly, lx - 1, 1, *env)),
        ("walker", "left", r(nc, ly, lx, *env), w_tops[:, :ly, wx, None],
         w_sites[:, :, wx, None], w_bots[:, 1:, wx, None]),
        ("window3_first", "left", r(nc, *env)[:, None], t3[:, wx, None], s6,
         w_bots[:, ly // 2, wx, None]),
        ("window3_next", "left", r(nc, 6, *env), t3[:, wx, None], s6,
         w_bots[:, ly // 2, wx, None]),
    ]


def k1_views(form, ops):
    """The left-form operands a K1 call of this form computes on."""
    if form == "left":
        return tuple(ops)
    env, *rest = ops
    return (env, *(o.transpose(-3, -1) for o in rest))


def k1_device_ms(fn, by_items=None):
    """fn() with every K1 launch between two CUDA events (the kernel
    library's K1 entries wrapped, whichever module calls K1). Returns (fn's
    result, device ms summed over those launches, the launches, fn's
    synchronized wall seconds, which include the events' host cost). A dict
    by_items receives {batch items: [launches, device ms]}."""
    import torch
    from peps_tpu_torch.kernels import _build
    real = _build.cuda_library
    built = real()
    events = []

    class Timed:
        def __getattr__(self, name):
            entry = getattr(built.lib, name)
            if name not in ("col_transfer_f32", "col_transfer_f64",
                            "col_transfer_c64", "col_transfer_c128"):
                return entry

            def call(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                code = entry(*args)
                end.record()
                meta = args[5]      # the launch meta: batch sizes first
                events.append((start, end, math.prod(meta[:4])))
                return code
            return call

    _build.cuda_library = lambda: built._replace(lib=Timed())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        _build.cuda_library = real
    wall = time.perf_counter() - t0
    total = 0.0
    for start, end, items in events:
        ms = start.elapsed_time(end)
        total += ms
        if by_items is not None:
            rec = by_items.setdefault(items, [0, 0.0])
            rec[0] += 1
            rec[1] += ms
    return out, total, len(events), wall


def k3_work(env, top, row1, row2, bot, out):
    """(flops, bytes) of one K3 call on left-form operands: the four
    products per item, each input read once (a broadcast operand once), the
    output written once. A complex multiply-add counts 4 real FMAs."""
    na, nm, nn, nc = env.shape[-4:]
    nu, nA = top.shape[-2:]
    nd, nr = row1.shape[-2:]
    ne, nf = row2.shape[-2:]
    nC = bot.shape[-1]
    items = math.prod(out.shape[:-4])
    flops = 2 * items * (na * nm * nn * nc * nu * nA
                         + nm * nn * nc * nA * nu * nd * nr
                         + nn * nc * nA * nr * nd * ne * nf
                         + nA * nr * nf * nc * ne * nC)
    flops *= 4 if env.is_complex() else 1
    nbytes = sum(t.numel() for t in (env, top, row1, row2, bot, out)) \
        * env.element_size()
    return flops, nbytes


def k3_cases(dtype, device, gen):
    """K3 operands at the J1-J2 path's shapes (8x8, D=8, chi=32, 32 chains,
    7 row pairs, d=2), as (name, form, env, top, row1, row2, bot): the
    BTen2 scan step of _pair_row_envs (224 items) in both forms, and the
    blocks of _pair_pass (3136 items: env, top, bot and the unchanged row
    broadcast over the candidate axis, the candidate sites over the chains):
    the diagonal's lblk (left form, candidates on row1) and rblk (right
    form, candidates on row2), and the anti-diagonal's lblk (left form,
    candidates on row2); energy.py's lblk/rblk calls."""
    import torch
    nc, pairs, nb, d = NCHAINS, LY - 1, LX - 1, PHYS

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=device, dtype=dtype)

    two, env = (CHI, D, D, CHI), (CHI, D, CHI)
    site = (D, D, D, D)

    def step():
        return (r(nc, pairs, *two), r(nc, pairs, *env), r(nc, pairs, *site),
                r(nc, pairs, *site), r(nc, pairs, *env))

    def block(cands_on):
        rows = [r(nc, pairs, nb, 1, *site), r(pairs, nb, d, *site)]
        row1, row2 = rows if cands_on == 2 else rows[::-1]
        return (r(nc, pairs, nb, 1, *two), r(nc, pairs, nb, 1, *env), row1,
                row2, r(nc, pairs, nb, 1, *env))

    return [("env_step", "left", *step()),
            ("env_step_right", "right", *step()),
            ("diag_block", "left", *block(1)),
            ("diag_block_right", "right", *block(2)),
            ("antidiag_block", "left", *block(2))]


def k3_views(form, ops):
    """The left-form operands a K3 call of this form computes on."""
    if form == "left":
        return tuple(ops)
    env, *rest = ops
    return (env, *(o.transpose(-3, -1) for o in rest))


def k3_subset(views):
    """The first K3_SUBSET_CHAINS chains' items of a block's operands (those
    with the chain axis have 4 batch dims before their own)."""
    return tuple(o[:K3_SUBSET_CHAINS] if o.dim() - k == 4 else o
                 for o, k in zip(views, (4, 3, 4, 4, 3)))


def k3_device_ms(fn):
    """fn() with energy.py's K3 calls (pair_transfer, pair_transfer_right)
    each between two CUDA events. Returns (fn's result, device ms summed
    over those calls, the calls, fn's synchronized wall seconds)."""
    import torch
    from peps_tpu_torch.algorithm import energy
    events = []

    def timed(f):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = f(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out
        return call

    orig = energy.pair_transfer, energy.pair_transfer_right
    energy.pair_transfer, energy.pair_transfer_right = map(timed, orig)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        energy.pair_transfer, energy.pair_transfer_right = orig
    wall = time.perf_counter() - t0
    return out, sum(a.elapsed_time(b) for a, b in events), len(events), wall


def k3_phase(device, peak, gen):
    """K3 against its plain version and one torch.einsum of the whole
    five-operand contraction, f32 and f64, at every case of k3_cases, with
    the plan each launch takes and what the compiled kernel reaches there
    (registers a thread, spill bytes, CTAs an SM). Returns the f32 record
    at the diagonal block."""
    import torch
    from peps_tpu_torch.kernels import pair_transfer as k3
    rec = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[str(dtype).split(".")[1]]
        flop_rate = peak["fp32_flops" if dtype == torch.float32
                         else "fp64_flops"]
        for name, form, *ops in k3_cases(dtype, device, gen):
            views = k3_views(form, ops)
            kern = lambda: k3.pair_transfer(*views)
            plain = lambda: k3.pair_transfer_plain(*views)
            one_call = lambda: torch.einsum(EINSUM_K3, *views)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            abs_err, rel = max_err(out, ref)
            del ref
            t = _in_turns({"plain": plain, "kern": kern, "one": one_call}, 3)
            ms, plain_ms, one_ms = t["kern"], t["plain"], t["one"]
            flops, nbytes = k3_work(*views, out)
            bound_ms = max(flops / flop_rate, nbytes / HBM_BPS) * 1e3
            bound_by = "operations" if flops / flop_rate >= nbytes / HBM_BPS \
                else "bytes"
            batch = tuple(out.shape[:-4])
            diag = k3.pair_transfer_diagnostic(*views)
            log("kernels", kernel="pair_transfer", case=name, form=form,
                dtype=str(dtype), batch=batch, items=math.prod(batch),
                rel_err=rel, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                einsum_1call_ms=one_ms, flops=flops, bytes=nbytes,
                bound_ms=bound_ms, bound_by=bound_by,
                pct_of_bound=100 * bound_ms / ms,
                regs_per_thread=diag["regs_per_thread"],
                spill_bytes=diag["spill_bytes"],
                ctas_per_sm=diag["ctas_per_sm"], plan=diag)
            del out
            torch.cuda.empty_cache()
            if not (rel <= tol):
                fail(f"pair_transfer {name} {dtype}: rel err {rel} > {tol}")
            if dtype == torch.float32:
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
                if name == "diag_block":
                    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=one_ms,
                               regs_per_thread=diag["regs_per_thread"],
                               spill_bytes=diag["spill_bytes"],
                               ctas_per_sm=diag["ctas_per_sm"])
    return rec


def k1_host_us(k1, case, reps=400):
    """Host microseconds per K1 call (wrapper + launch, meta cache warm),
    host clock over reps calls with no synchronisation in between."""
    _, form, env, top, site, bot = case
    call = k1.col_transfer_right if form == "right" else k1.col_transfer
    return host_us(lambda: call(env, top, site, bot), reps)


def phase_kernels(device):
    """Phase 2: K1, K2 and K3 vs their plain versions (K1 and K3 also vs
    one einsum call, K2 vs a copy of as many bytes), with their bounds.
    Returns
    per-kernel records (f32 numbers at the largest main-path shape)."""
    import torch
    from peps_tpu_torch.kernels import centered_o as k2
    from peps_tpu_torch.kernels import col_transfer as k1

    peak = peak_rates(device)
    log("peak", **peak)
    gen = torch.Generator(device=device).manual_seed(1234)
    rec = {"col_transfer": {"max_abs_err": 0.0}, "centered_o": {"max_abs_err": 0.0}}
    for dtype in (torch.float32, torch.float64):
        tol = TOL[str(dtype).split(".")[1]]
        flop_rate = peak["fp32_flops" if dtype == torch.float32
                         else "fp64_flops"]
        for case in k1_cases(dtype, device, gen):
            name, form, env, top, site, bot = case
            views = k1_views(form, (env, top, site, bot))
            if form == "right":
                kern = lambda: k1.col_transfer_right(env, top, site, bot)
                plain = lambda: k1.col_transfer_right(
                    env, top, site, bot, transfer=k1.col_transfer_plain)
            else:
                kern = lambda: k1.col_transfer(env, top, site, bot)
                plain = lambda: k1.col_transfer_plain(env, top, site, bot)
            one_call = lambda: torch.einsum(EINSUM_1CALL, *views)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            abs_err, rel = max_err(out, ref)
            t = _in_turns({"plain": plain, "kern": kern, "one": one_call},
                          10)
            ms, plain_ms, one_ms = t["kern"], t["plain"], t["one"]
            flops, nbytes = k1_work(*views, out)
            bound_ms = max(flops / flop_rate, nbytes / HBM_BPS) * 1e3
            bound_by = "operations" if flops / flop_rate >= nbytes / HBM_BPS \
                else "bytes"
            batch = tuple(out.shape[:-3])
            diag = k1.col_transfer_diagnostic(*views)
            log("kernels", kernel="col_transfer", case=name, form=form,
                dtype=str(dtype), batch=batch, items=math.prod(batch),
                rel_err=rel, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                einsum_1call_ms=one_ms, flops=flops, bytes=nbytes,
                bound_ms=bound_ms, bound_by=bound_by,
                pct_of_bound=100 * bound_ms / ms,
                regs_per_thread=diag["regs_per_thread"],
                spill_bytes=diag["spill_bytes"], plan=diag)
            if not (rel <= tol):
                fail(f"col_transfer {name} {dtype}: rel err {rel} > {tol}")
            if dtype == torch.float32:
                r = rec["col_transfer"]
                r["max_abs_err"] = max(r["max_abs_err"], abs_err)
                if name == "nn_traces":
                    r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=one_ms)
            if dtype == torch.float32 and name in ("bond_step", "nn_traces"):
                log("k1_host", case=name, dtype=str(dtype),
                    host_us_per_call=k1_host_us(k1, case))
    for case in K2_CASES:
        for dt in case[4]:
            dtype = getattr(torch, dt)
            r = k2_case(k2, case, dtype, device, gen)
            log("kernels", kernel="centered_o", **r)
            if not (r["rel_err"] <= TOL[dt]):
                fail(f"centered_o {case[0]} {dt}: rel err {r['rel_err']} "
                     f"> {TOL[dt]}")
            if case[0] == "main_path_8x8_D8" and dtype == torch.float32:
                rec["centered_o"].update(
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by="bytes", library_ms=None)
    rec["pair_transfer"] = k3_phase(device, peak, gen)
    for kernel, by_dtype in phase_kernels_complex(device, peak, gen).items():
        rec[kernel]["complex"] = {
            dt: {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "rel_err", "case")}
            for dt, r in by_dtype.items()}
    rec["fermion"] = phase_kernels_fermion(device)
    return rec


def k2_operands(ns, sites, k, dtype, device, gen):
    """K2's holes [ns, sites, k], psi and cfg (d = PHYS) drawn from gen.
    |psi| lies in [0.5, 1.5), so max |plain| stays within about 20x of a
    typical output, and the tolerance, a share of max |plain|, holds every
    value closely, the centering term of the unselected p included (a psi
    near 0 would inflate max |plain| by orders of magnitude). Row 0 has
    psi = 0 on purpose (safe(psi) = 1); NaN and subnormal psi are card-test
    cases."""
    import torch
    holes = torch.randn(ns, sites, k, generator=gen, device=device,
                        dtype=dtype)
    mag = 0.5 + torch.rand(ns, sites, generator=gen, device=device,
                           dtype=dtype)
    sign = torch.randint(0, 2, (ns, sites), generator=gen, device=device)
    psi = torch.where(sign == 1, mag, -mag)
    psi[0] = 0
    cfg = torch.randint(0, PHYS, (ns, sites), generator=gen, device=device)
    return holes, psi, cfg


def k2_case(k2, case, dtype, device, gen):
    """One K2 case: the kernel of module k2 against its plain version (on
    the first and last site only where the case says so), then the times of
    the kernel and of a copy_ moving K2's bytes, in turns (kernel, copy,
    copy, kernel), and of the plain version (after the copy's buffers are
    freed: at 16x16 D=12 they would not fit beside the plain version's
    temporaries). Returns the record; its plan is None for a module
    without centered_o_plan (the Triton K2 of earlier commits)."""
    import torch
    name, ns, sites, k, _, subset = case
    holes, psi, cfg = k2_operands(ns, sites, k, dtype, device, gen)
    out = k2.centered_o(holes, psi, cfg, PHYS)
    torch.cuda.synchronize()
    if subset:
        errs = []
        for site in (0, sites - 1):
            one = slice(site, site + 1)
            ref = k2.centered_o_plain(holes[:, one], psi[:, one], cfg[:, one],
                                      PHYS)
            errs.append(max_err(out[:, site * PHYS * k:(site + 1) * PHYS * k],
                                ref))
        abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    else:
        abs_err, rel = max_err(out, k2.centered_o_plain(holes, psi, cfg, PHYS))
    # bound: each input read once, the buffer written once
    nbytes = sum(x.numel() * x.element_size() for x in (holes, psi, cfg, out))
    shape = tuple(out.shape)
    del out
    reps = max(3, min(20, int(4e9 // nbytes)))
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    fns = {"kern": lambda: k2.centered_o(holes, psi, cfg, PHYS),
           "copy": lambda: dst.copy_(src)}
    t = {"kern": [], "copy": []}
    for key in ("kern", "copy", "copy", "kern"):
        t[key].append(time_ms(fns[key], reps))
    del src, dst
    torch.cuda.empty_cache()
    plain_ms = time_ms(lambda: k2.centered_o_plain(holes, psi, cfg, PHYS),
                       reps)
    ms, copy_ms = sum(t["kern"]) / 2, sum(t["copy"]) / 2
    bound_ms = nbytes / HBM_BPS * 1e3
    plan = None
    if hasattr(k2, "centered_o_plan"):
        plan = k2.centered_o_plan(ns, sites, k, PHYS, dtype)
    rec = {"case": name, "dtype": str(dtype), "shape": shape,
           "elements": shape[0] * shape[1],
           "site_subset_check": subset, "rel_err": rel,
           "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
           "copy_same_bytes_ms": copy_ms, "bytes": nbytes,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "pct_of_bound": 100 * bound_ms / ms,
           "copy_pct_of_bound": 100 * bound_ms / copy_ms,
           "plan": plan}
    del holes, psi, cfg
    torch.cuda.empty_cache()
    return rec


def _rate(peak, dtype):
    """The peak for a dtype: complex64 on the FP32 rate, complex128 on the
    f64 one (the same peaks peak_rates gives the real dtypes)."""
    import torch
    return peak["fp32_flops" if dtype in (torch.float32, torch.complex64)
                else "fp64_flops"]


def _complex_record(kernel, name, dtype, out, ref, ms, plain_ms, lib_ms,
                    flops, nbytes, peak, plan, **extra):
    abs_err, rel = max_err(out, ref)
    flop_s = flops / _rate(peak, dtype) if flops else 0.0
    byte_s = nbytes / HBM_BPS
    bound_ms = max(flop_s, byte_s) * 1e3
    rec = {"kernel": kernel, "case": name, "dtype": str(dtype),
           "rel_err": rel, "max_abs_err": abs_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "flops": flops,
           "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": "operations" if flop_s >= byte_s else "bytes",
           "pct_of_bound": 100 * bound_ms / ms, "plan": plan, **extra}
    log("kernels_complex", **rec)
    tol = TOL[str(dtype).split(".")[1]]
    if not (rel <= tol):
        fail(f"{kernel} {name} {dtype}: rel err {rel} > {tol}")
    return rec


def phase_kernels_complex(device, peak, gen):
    """Phase 2, complex part: K1, K2 and K3's complex bodies (complex64 and
    complex128) against their plain versions at the main path's shapes
    (K1: every case of k1_cases; K2: the 8x8 D=8 SR buffer with a psi = 0
    row; K3: the BTen2 env step and the blocks),
    timed in turns with the plain version and the yardstick (one einsum
    for K1 and K3, a copy_ of as many bytes for K2). At the diagonal block
    the complex128 plain chain and einsum do not fit the card (past 80 GB
    of intermediates), so they run on the first K3_SUBSET_CHAINS chains'
    items, and the kernel is held to them there (plain_items says so).
    Returns {kernel: {dtype: record at the largest shape}}."""
    import torch
    from peps_tpu_torch.kernels import centered_o as k2
    from peps_tpu_torch.kernels import col_transfer as k1
    from peps_tpu_torch.kernels import pair_transfer as k3
    out = {"col_transfer": {}, "centered_o": {}, "pair_transfer": {}}
    for dt in COMPLEX_DTYPES:
        dtype = getattr(torch, dt)
        for name, form, env, top, site, bot in k1_cases(dtype, device, gen):
            if name not in K1_COMPLEX_CASES:
                continue
            views = k1_views(form, (env, top, site, bot))
            res, ref = k1.col_transfer(*views), k1.col_transfer_plain(*views)
            torch.cuda.synchronize()
            t = _in_turns({"plain": lambda: k1.col_transfer_plain(*views),
                           "kern": lambda: k1.col_transfer(*views),
                           "one": lambda: torch.einsum(EINSUM_1CALL, *views)},
                          5)
            flops, nbytes = k1_work(*views, res)
            diag = k1.col_transfer_diagnostic(*views)
            rec = _complex_record("col_transfer", name, dtype, res, ref,
                                  t["kern"], t["plain"], t["one"], flops,
                                  nbytes, peak, diag, form=form,
                                  items=math.prod(res.shape[:-3]),
                                  regs_per_thread=diag["regs_per_thread"],
                                  spill_bytes=diag["spill_bytes"])
            if name == "nn_traces":
                out["col_transfer"][dt] = rec
            del res, ref
        rec = k2_case(k2, K2_CASES[0], dtype, device, gen)
        log("kernels_complex", kernel="centered_o", **rec)
        if not (rec["rel_err"] <= TOL[dt]):
            fail(f"centered_o {dt}: rel err {rec['rel_err']} > {TOL[dt]}")
        out["centered_o"][dt] = {**rec, "library_ms": None}
        for name, form, *ops in k3_cases(dtype, device, gen):
            if name not in K3_COMPLEX_CASES:
                continue
            views = k3_views(form, ops)
            sub = views
            if "block" in name and dtype == torch.complex128:
                sub = k3_subset(views)
            res = k3.pair_transfer(*views)
            ref = k3.pair_transfer_plain(*sub)
            torch.cuda.synchronize()
            head = res[:K3_SUBSET_CHAINS] if sub is not views else res
            kern_ms = _in_turns({"kern": lambda: k3.pair_transfer(*views)},
                                2)["kern"]
            t = _in_turns({"plain": lambda: k3.pair_transfer_plain(*sub),
                           "one": lambda: torch.einsum(EINSUM_K3, *sub)}, 2)
            flops, nbytes = k3_work(*views, res)
            diag = k3.pair_transfer_diagnostic(*views)
            rec = _complex_record(
                "pair_transfer", name, dtype, head, ref, kern_ms, t["plain"],
                t["one"], flops, nbytes, peak, diag,
                items=math.prod(res.shape[:-4]),
                plain_items=math.prod(ref.shape[:-4]),
                regs_per_thread=diag["regs_per_thread"],
                spill_bytes=diag["spill_bytes"],
                ctas_per_sm=diag["ctas_per_sm"])
            if name == "diag_block":
                out["pair_transfer"][dt] = rec
            del res, ref, head
            torch.cuda.empty_cache()
    return out


def phase_main_path(device):
    """Phase 3: SU -> to_tps -> vmc_optimize(SR), through the entry points.
    Returns (result, launches, SU seconds per step)."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.kernels.centered_o import centered_o
    from peps_tpu_torch.kernels.col_transfer import col_transfer
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
    from peps_tpu_torch.peps import (SimpleUpdateParams, product_peps,
                                     simple_update, to_tps)

    model = spin.heisenberg()
    n = LY * LX
    stamps = []

    def on_iter(rec, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log("main_path", iteration=rec.step, energy=rec.energy,
            energy_per_site=rec.energy / n, energy_error=rec.energy_error,
            accept_rate=rec.accept_rate, sr_iters=rec.sr_iters,
            eval_s=rec.eval_seconds, update_s=rec.update_seconds)

    col_transfer.launches = 0
    centered_o.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    occ = np.indices((LY, LX)).sum(0) % 2
    peps0 = product_peps(LY, LX, D, occ, PHYS, dtype=torch.float32,
                         device=device)
    su = simple_update(peps0, model.h_h, model.h_v,
                       SimpleUpdateParams(SU_STEPS, 0.1,
                                          TruncParams(D, 1, 1e-8)))
    tps = to_tps(su.peps)
    tps = tps / tps.abs().max()
    torch.cuda.synchronize()
    t_su = time.perf_counter()
    params = VMCParams(
        CHI, TruncParams(CHI, 1, 1e-6, scheme="sketch"),
        MCParams(num_samples=1, num_warmup_sweeps=WARMUP_SWEEPS,
                 nchains=NCHAINS),
        OptimizerParams(SR_ITERS, SRParams(CGParams(30, 1e-5), diag_shift=1e-3),
                        lr=0.05),
        occupancy=((0, n // 2), (1, n - n // 2)))
    gen = torch.Generator(device=device).manual_seed(2)
    res = vmc_optimize(tps, model, params, gen, callback=on_iter)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {"col_transfer": col_transfer.launches,
                "centered_o": centered_o.launches}
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    log("main_path", su_steps=SU_STEPS, su_s=t_su - t0,
        su_energy_per_site=su.estimated_e0 / n, vmc_s=t_end - t_su,
        seconds_per_train_step_after_first=step_s,
        mean_seconds_per_train_step=sum(step_s) / max(len(step_s), 1),
        launches=launches, peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9)
    e_site = [e / n for e in res.energies]
    if not all(math.isfinite(e) for e in e_site):
        fail(f"non-finite energies {res.energies}")
    if not all(-0.70 < e < -0.40 for e in e_site):
        fail(f"energy per site {e_site} outside (-0.70, -0.40)")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")
    return res, launches, (t_su - t0) / SU_STEPS


def phase_gate(res):
    """Phase 4: sketch vs svd local energies on 16 sampled configurations.
    Returns the svd ones."""
    import torch
    from peps_tpu_torch.algorithm.energy import (ModelTensors,
                                                 local_energy_and_holes)
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin

    tps = res.state
    cfgs = res.final_configs[:GATE_CONFIGS]
    mt = ModelTensors.from_model(spin.heisenberg(), tps.dtype, tps.device)
    t0 = time.perf_counter()
    e = {}
    for scheme in ("sketch", "svd"):
        e[scheme] = local_energy_and_holes(
            tps, cfgs, mt, CHI, TruncParams(CHI, 1, 1e-6, scheme=scheme),
            with_holes=False).e_loc
    torch.cuda.synchronize()
    finite = torch.isfinite(e["sketch"]) & torch.isfinite(e["svd"])
    rel = ((e["sketch"] - e["svd"]).abs()
           / e["svd"].abs().clamp(min=1e-12))[finite]
    gate = rel.max().item() if rel.numel() else float("nan")
    log("gate", configs=int(cfgs.shape[0]), nonfinite=int((~finite).sum()),
        accuracy_rel_diff_sketch_vs_svd=gate, seconds=time.perf_counter() - t0)
    if not (gate < 1e-2) or not bool(finite.all()):
        fail(f"sketch-vs-svd gate {gate} (non-finite {int((~finite).sum())})")
    return e["svd"]


def nn_mean(corr):
    """Mean nearest-neighbour entry [.., x, x+1] of an in-line correlator
    [lines, L, L]."""
    n = corr.shape[-1]
    return float(sum(corr[:, x, x + 1].mean() for x in range(n - 1))
                 / (n - 1))


def bond_sum_energy(stats):
    """sum over nearest-neighbour bonds of <Sz_i Sz_j> + <S+_i S-_j>: the
    Heisenberg energy (J = 1) from the registry's observables. For a real
    state <S+_i S-_j> = <S-_i S+_j>, so the bond's transverse term
    (S+S- + S-S+) / 2 has the expectation of <S+_i S-_j> alone."""
    szsz = stats["szsz"][0]
    row, col = stats["spsm_row"][0], stats["spsm_col"][0]
    e = 0.0
    for y in range(LY):
        for x in range(LX):
            i = y * LX + x
            if x + 1 < LX:
                e += szsz[i, i + 1] + row[y, x, x + 1]
            if y + 1 < LY:
                e += szsz[i, i + LX] + col[x, y, y + 1]
    return float(e)


def sync_s(fn):
    """Host seconds of fn() between two synchronizations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def step_breakdown(state, configs, trunc):
    """Seconds of one sample step's parts on the same configurations: a
    sweep of every chain, the energy pass (env stacks of both frames, local
    energies, diagonal observables) and the walker pass (the S+S- walkers
    in both frames: the full step less the step without walkers), each
    the mean of two synchronized runs after one warm-up."""
    import dataclasses
    import torch
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.measure import (MeasurementParams,
                                                  _sample_outputs)
    from peps_tpu_torch.algorithm.registry import spin_registry
    from peps_tpu_torch.lattice import transpose_tps
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import draw_uniforms, mc_sweep

    tps_t = transpose_tps(state)
    mt = ModelTensors.from_model(spin.heisenberg(), state.dtype, state.device)
    gen = torch.Generator(device=state.device).manual_seed(9)
    params = MeasurementParams(nchains=NCHAINS)
    cheap = dataclasses.replace(params, measure_offdiag_corr=False)
    runs = {
        "sweep": lambda: mc_sweep(state, tps_t, configs, CHI, trunc,
                                  uniforms=draw_uniforms(
                                      gen, NCHAINS, LY, LX, state.dtype,
                                      state.device)),
        "energy_pass": lambda: _sample_outputs(
            state, tps_t, configs, mt, CHI, trunc, spin_registry(cheap),
            cheap),
        "full_evaluation": lambda: _sample_outputs(
            state, tps_t, configs, mt, CHI, trunc, spin_registry(params),
            params),
    }
    out = {}
    for name, fn in runs.items():
        sync_s(fn)
        out[name] = (sync_s(fn) + sync_s(fn)) / 2
    out["walker_pass"] = out.pop("full_evaluation") - out["energy_pass"]
    total = sum(out.values())
    return {**{f"{k}_s": v for k, v in out.items()},
            **{f"{k}_share": v / total for k, v in out.items()}}


def phase_measure(res, device):
    """Phase 5: measure() on the optimized state through the entry point.
    Returns K1's launches inside measure()."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm.measure import (MeasurementParams,
                                                  dump_stats, measure)
    from peps_tpu_torch.kernels.centered_o import centered_o
    from peps_tpu_torch.kernels.col_transfer import col_transfer
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import UpdateRule

    n = LY * LX
    trunc = TruncParams(CHI, 1, 1e-6, scheme="sketch")
    params = MeasurementParams(num_samples=MEASURE_SAMPLES,
                               num_warmup_sweeps=WARMUP_SWEEPS,
                               nchains=NCHAINS, chunk_size=MEASURE_CHUNK,
                               measure_offdiag_corr=True)
    col_transfer.launches = 0
    centered_o.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device) / 1e9
    t0 = time.perf_counter()
    out = measure(res.state, spin.heisenberg(), params, CHI, trunc,
                  UpdateRule("exchange"), res.final_configs,
                  generator=torch.Generator(device=device).manual_seed(3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = col_transfer.launches
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    e, e_err = (float(v) for v in out.stats["energy"])
    sum_sz = float(np.sum(out.stats["sz"][0]))
    nn_row = nn_mean(out.stats["spsm_row"][0])
    nn_col = nn_mean(out.stats["spsm_col"][0])
    e_bonds = bond_sum_energy(out.stats)
    samples = NCHAINS * MEASURE_SAMPLES
    log("measure", samples=samples, warmup_sweeps=WARMUP_SWEEPS,
        chunk_size=MEASURE_CHUNK, sampling_wall_s=out.sampling_wall_s,
        samples_per_s=samples / out.sampling_wall_s,
        energy_per_site=e / n, energy_stderr_per_site=e_err / n,
        bond_sum_energy_per_site=e_bonds / n, accept_rate=out.accept_rate,
        energy_autocorr_time=out.energy_autocorr_time, sum_sz=sum_sz,
        nn_spsm_row=nn_row, nn_spsm_col=nn_col,
        col_transfer_launches=launches,
        centered_o_launches=centered_o.launches, peak_mem_GB=peak,
        mem_held_at_start_GB=held, phase_wall_s=wall)
    log("measure_breakdown", **step_breakdown(res.state, res.final_configs,
                                              trunc))
    with tempfile.TemporaryDirectory() as tmp:
        dump_stats(out, tmp)
        missing = [k for k in out.stats
                   if not os.path.exists(os.path.join(tmp, "stats",
                                                      f"{k}.csv"))]
    finite = all(np.all(np.isfinite(v)) for pair in out.stats.values()
                 for v in pair)
    if not finite or not math.isfinite(out.energy_autocorr_time):
        fail("measure: non-finite statistics")
    if not -0.70 < e / n < -0.40:
        fail(f"measure: energy per site {e / n} outside (-0.70, -0.40)")
    if not abs(sum_sz) < 1e-5:
        fail(f"measure: sum of <Sz> {sum_sz}, exchange conserves Sz = 0")
    if not (nn_row < 0 and nn_col < 0):
        fail(f"measure: nearest-neighbour <S+S-> {nn_row}, {nn_col} not "
             "negative")
    tol = max(5 * e_err, 0.03 * abs(e))
    if not abs(e_bonds - e) <= tol:
        fail(f"measure: bond-sum energy {e_bonds} vs E_loc energy {e} "
             f"(tolerance {tol})")
    if launches == 0:
        fail("measure: kernel col_transfer was not launched")
    if missing:
        fail(f"measure: dump_stats wrote no CSV for {missing}")
    return launches


def _optimizer_runs(tmp):
    """Phase 6's runs: (name, OptimizerParams) at the main path's width."""
    from peps_tpu_torch.optimizer.optimizer import (AdamParams, LBFGSParams,
                                                    MinSRParams,
                                                    OptimizerParams,
                                                    SpikeParams,
                                                    StepSelectorParams)
    from peps_tpu_torch.optimizer.schedulers import CosineAnnealing
    return [
        ("a_minsr_dense", OptimizerParams(
            2, MinSRParams(pseudo_inverse_cutoff=1e-8), lr=MINSR_LR)),
        ("b_minsr_krylov", OptimizerParams(
            2, MinSRParams(pseudo_inverse_cutoff=1e-8, krylov_iters=16),
            lr=MINSR_LR)),
        ("c_adam", OptimizerParams(
            3, AdamParams(), lr=CosineAnnealing(ADAM_LR, 3),
            clip_norm=ADAM_CLIP,
            spike=SpikeParams(enabled=True, enable_rollback=True),
            step_selector=StepSelectorParams(), checkpoint_every=1,
            checkpoint_path=os.path.join(tmp, "ckpt"),
            trajectory_csv=os.path.join(tmp, "traj.csv"),
            log_path=os.path.join(tmp, "log.jsonl"))),
        ("d_lbfgs", OptimizerParams(
            2, LBFGSParams(line_search="strong_wolfe", max_eval=4),
            lr=LBFGS_LR)),
    ]


def optimizer_run(res, device, name, opt):
    """One vmc_optimize call of phase 6 from the main path's state and
    final configurations. Returns (record, states the callback saw)."""
    import torch
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.kernels.centered_o import centered_o
    from peps_tpu_torch.kernels.col_transfer import col_transfer
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import draw_uniforms

    n = LY * LX
    gen = torch.Generator(device=device).manual_seed(6)
    sweeps = {"eval": 0, "probe": 0}

    def source(kind):
        def draw():
            sweeps[kind] += 1
            return draw_uniforms(gen, NCHAINS, LY, LX, torch.float32, device)
        return draw

    rows, states, seen = [], [], [0]

    def on_iter(rec, state):
        torch.cuda.synchronize()
        now = time.perf_counter()
        total = sweeps["eval"] + sweeps["probe"]
        rows.append({"rec": rec, "iter_s": now - stamp[0],
                     "evals": total - seen[0], "probes": sweeps["probe"],
                     "finite": bool(torch.isfinite(state).all())})
        states.append(state.detach().cpu().numpy())
        stamp[0], seen[0] = now, total

    params = VMCParams(
        CHI, TruncParams(CHI, 1, 1e-6, scheme="sketch"),
        MCParams(num_samples=1, num_warmup_sweeps=0, nchains=NCHAINS), opt)
    col_transfer.launches = 0
    centered_o.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    stamp = [time.perf_counter()]
    t0 = stamp[0]
    out = vmc_optimize(res.state, spin.heisenberg(), params, gen,
                       configs=res.final_configs,
                       sweep_uniforms=source("eval"),
                       probe_uniforms=source("probe"), callback=on_iter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"col_transfer": col_transfer.launches,
                "centered_o": centered_o.launches}
    recs = [r["rec"] for r in rows]
    record = {
        "run": name, "algorithm": type(opt.algorithm).__name__,
        "iterations": len(recs),
        "energy_per_site": [r.energy / n for r in recs],
        "energy_error_per_site": [r.energy_error / n for r in recs],
        "grad_norm": [r.grad_norm for r in recs],
        "natural_grad_norm": [r.natural_grad_norm for r in recs],
        "lr": [r.lr for r in recs],
        "accept_rate": [r.accept_rate for r in recs],
        "eval_s": [r.eval_seconds for r in recs],
        "update_s": [r.update_seconds for r in recs],
        "iter_s": [r["iter_s"] for r in rows],
        "evaluations_per_iteration": [r["evals"] for r in rows],
        "probe_evaluations": sweeps["probe"],
        "spike_events": [list(e) for e in out.spike_events],
        "launches": launches,
        "peak_mem_GB": torch.cuda.max_memory_allocated(device) / 1e9,
        "wall_s": wall}
    log("optimizers", **record)
    e_site = record["energy_per_site"]
    if len(recs) != opt.max_iters:
        fail(f"optimizers {name}: {len(recs)} of {opt.max_iters} iterations")
    if not all(math.isfinite(e) and -0.70 < e < -0.40 for e in e_site):
        fail(f"optimizers {name}: energy per site {e_site} not finite in "
             "(-0.70, -0.40)")
    if not all(r["finite"] for r in rows) or \
            not bool(torch.isfinite(out.state).all()):
        fail(f"optimizers {name}: a state holds NaN or inf")
    if launches["col_transfer"] == 0:
        fail(f"optimizers {name}: K1 col_transfer was not launched")
    if name.startswith(("a_", "b_")) and launches["centered_o"] == 0:
        fail(f"optimizers {name}: K2 centered_o was not launched")
    return record, states


def check_files(tmp, states):
    """Run (c)'s checkpoints, trajectory CSV and JSONL log."""
    import numpy as np
    ckpt = os.path.join(tmp, "ckpt")
    names = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    want = [f"state_step{k}.npy" for k in (1, 2, 3)]
    if names != want:
        fail(f"optimizers c_adam: checkpoints {names}, expected {want}")
    for k, state in enumerate(states, start=1):
        if not np.array_equal(np.load(os.path.join(ckpt, want[k - 1])),
                              state):
            fail(f"optimizers c_adam: {want[k - 1]} differs from the state "
                 "the callback saw")
    with open(os.path.join(tmp, "traj.csv")) as f:
        lines = f.read().splitlines()
    headers = sum(ln.startswith("step,") for ln in lines)
    if headers != 1 or len(lines) != 4:
        fail(f"optimizers c_adam: trajectory CSV has {headers} headers and "
             f"{len(lines)} lines, expected 1 and 4")
    with open(os.path.join(tmp, "log.jsonl")) as f:
        records = [json.loads(ln) for ln in f.read().splitlines()]
    if len(records) != 3:
        fail(f"optimizers c_adam: {len(records)} JSONL records, expected 3")
    return {"checkpoints": names, "csv_lines": len(lines),
            "jsonl_records": len(records)}


def minsr_paths(res, device):
    """Dense against Krylov MinSR (m = Ns) on one evaluation's buffers at
    the main path's width: float64 within 1e-8, float32 printed."""
    import torch
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams, mc_energy_grad
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import draw_uniforms
    from peps_tpu_torch.optimizer.krylov import minsr_krylov_natural_gradient
    from peps_tpu_torch.optimizer.optimizer import (Evaluation, MinSRParams,
                                                    minsr_natural_gradient)

    gen = torch.Generator(device=device).manual_seed(7)
    mt = ModelTensors.from_model(spin.heisenberg(), res.state.dtype, device)
    ev, _, _ = mc_energy_grad(
        res.state, res.final_configs, mt, CHI,
        TruncParams(CHI, 1, 1e-6, scheme="sketch"),
        MCParams(num_samples=1, num_warmup_sweeps=0, nchains=NCHAINS),
        lambda: draw_uniforms(gen, NCHAINS, LY, LX, torch.float32, device),
        with_sr_buffers=True)
    ns, p = ev.o_samples.shape
    out = {"ns": ns, "p": p}
    for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
        a, eps = ev.o_samples.to(dt), ev.e_samples.to(dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = minsr_natural_gradient(
            Evaluation(ev.energy, ev.gradient, o_samples=a, e_samples=eps),
            MinSRParams(pseudo_inverse_cutoff=1e-8), (p,))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kry = minsr_krylov_natural_gradient(a, eps, 1e-8, ns, (p,))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        diff = ((kry - dense).norm() / dense.norm()).item()
        out.update({f"{tag}_rel_diff": diff, f"{tag}_dense_s": t1 - t0,
                    f"{tag}_krylov_s": t2 - t1,
                    f"{tag}_finite": bool(torch.isfinite(dense).all()
                                          and torch.isfinite(kry).all())})
        del a, eps, dense, kry
    gram = ev.o_samples @ ev.o_samples.mH
    lam = torch.linalg.eigvalsh(gram.double())
    out.update(gram_lam_min=lam.min().item(), gram_lam_max=lam.max().item())
    log("minsr_paths", **out)
    if not (out["f64_rel_diff"] < 1e-8) or not out["f64_finite"]:
        fail(f"minsr_paths: Krylov (m = Ns) against dense in float64 "
             f"{out['f64_rel_diff']} (finite {out['f64_finite']})")
    if not out["f32_finite"]:
        fail("minsr_paths: a float32 MinSR path is not finite")


def phase_optimizers(res, device):
    """Phase 6: the optimizers through vmc_optimize, then the two MinSR
    paths against each other. Returns K1's and K2's launches over the four
    runs."""
    total = {"col_transfer": 0, "centered_o": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for name, opt in _optimizer_runs(tmp):
            record, states = optimizer_run(res, device, name, opt)
            for k, v in record["launches"].items():
                total[k] += v
            if name == "c_adam":
                log("optimizer_files", **check_files(tmp, states))
    minsr_paths(res, device)
    return total


def kernel_counts():
    """The three wrappers' launch counters (K1, K2, K3)."""
    from peps_tpu_torch.kernels.centered_o import centered_o
    from peps_tpu_torch.kernels.col_transfer import col_transfer
    from peps_tpu_torch.kernels.pair_transfer import pair_transfer
    return {"col_transfer": col_transfer, "centered_o": centered_o,
            "pair_transfer": pair_transfer}


def counted_step(device, phase, name, fn):
    """Run one step of a phase with every launch counter at 0 and the peak
    memory counter reset; log its seconds, launches and peak memory.
    Returns (fn's result, launches)."""
    import torch
    kernels = kernel_counts()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    log(phase, step=name, seconds=time.perf_counter() - t0,
        launches=launches,
        peak_mem_GB=torch.cuda.max_memory_allocated(device) / 1e9)
    return out, launches


def phase_j1j2(res, device):
    """Phase 7: the long-range energy terms from the main path's state and
    final configurations. Returns the launches summed over its steps."""
    import torch
    from peps_tpu_torch.algorithm.energy import (ModelTensors,
                                                 local_energy_and_holes)
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams, mc_energy_only
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import UpdateRule, draw_uniforms
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams

    n = LY * LX
    trunc = TruncParams(CHI, 1, 1e-6, scheme="sketch")
    state, cfgs = res.state, res.final_configs
    total = {k: 0 for k in kernel_counts()}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    def e_loc(model):
        mt = ModelTensors.from_model(model, state.dtype, device)
        return local_energy_and_holes(state, cfgs, mt, CHI, trunc,
                                      with_holes=False).e_loc

    # 1. the vertical bonds through the two-row sandwiches (pair pass)
    # against the transposed frame, on the same configurations
    e_pair, launches = counted_step(device, "j1j2", "route_pair",
                                    lambda: e_loc(spin.j1j2_xxz(1, 1, 0, 0)))
    add(launches)
    e_t, launches = counted_step(device, "j1j2", "route_transposed",
                                 lambda: e_loc(spin.heisenberg()))
    add(launches)
    mean_rel = abs((e_pair.mean() - e_t.mean()) / e_t.mean()).item()
    per_cfg = ((e_pair - e_t).abs() / e_t.abs().clamp(min=1e-12)).max().item()
    log("j1j2", step="route_check", mean_rel_diff=mean_rel,
        max_rel_diff_one_config=per_cfg, energy_per_site_pair=
        e_pair.mean().item() / n, energy_per_site_transposed=
        e_t.mean().item() / n)
    if not (mean_rel < 1e-2) or not bool(torch.isfinite(e_pair).all()):
        fail(f"j1j2 route check: mean E_loc differs by {mean_rel}")

    # 2. two SR iterations at the maximally frustrated point
    model = spin.j1j2_xxz(1, 1, 0.5, 0.5)
    recs = []
    params = VMCParams(
        CHI, trunc, MCParams(num_samples=1, num_warmup_sweeps=0,
                             nchains=NCHAINS),
        OptimizerParams(2, SRParams(CGParams(30, 1e-5), diag_shift=1e-3),
                        lr=0.05))
    out, launches = counted_step(
        device, "j1j2", "vmc_sr", lambda: vmc_optimize(
            state, model, params, torch.Generator(device=device).manual_seed(8),
            configs=cfgs, callback=lambda rec, st: recs.append(rec)))
    add(launches)
    e_site = [r.energy / n for r in recs]
    log("j1j2", step="vmc_sr_records", energy_per_site=e_site,
        eval_s=[r.eval_seconds for r in recs],
        update_s=[r.update_seconds for r in recs],
        sr_iters=[r.sr_iters for r in recs])
    if len(recs) != 2 or not all(math.isfinite(e) for e in e_site) or \
            not bool(torch.isfinite(out.state).all()):
        fail(f"j1j2 vmc_optimize: energies {e_site}")

    # 3. measure() on the optimized state
    mp = MeasurementParams(num_samples=MEASURE_SAMPLES,
                           num_warmup_sweeps=0, nchains=NCHAINS,
                           chunk_size=MEASURE_CHUNK,
                           measure_offdiag_corr=False)
    meas, launches = counted_step(
        device, "j1j2", "measure", lambda: measure(
            out.state, model, mp, CHI, trunc, UpdateRule("exchange"),
            out.final_configs,
            generator=torch.Generator(device=device).manual_seed(9)))
    add(launches)
    e, e_err = (float(v) for v in meas.stats["energy"])
    log("j1j2", step="measure_result", energy_per_site=e / n,
        energy_stderr_per_site=e_err / n,
        sampling_wall_s=meas.sampling_wall_s,
        samples_per_s=NCHAINS * MEASURE_SAMPLES / meas.sampling_wall_s,
        accept_rate=meas.accept_rate)
    if not (math.isfinite(e) and -0.60 < e / n < -0.35):
        fail(f"j1j2 measure: energy per site {e / n} outside (-0.60, -0.35)")

    # 4-5. energy-only evaluations of the triangular J1-J2 model and of a
    # model with third-neighbour couplings in both directions
    hb = spin.heisenberg_bond()
    tnn = spin.SquareLatticeModel(2, hb, hb, h_tnn_h=0.25 * hb,
                                  h_tnn_v=0.25 * hb, name="j1_tnn")
    gen = torch.Generator(device=device).manual_seed(10)
    for name, m in (("triangle_j1j2", spin.triangle_j1j2_heisenberg(1, 0.5)),
                    ("j1_tnn", tnn)):
        mt = ModelTensors.from_model(m, state.dtype, device)
        (energy, err), launches = counted_step(
            device, "j1j2", f"energy_only_{name}", lambda: mc_energy_only(
                state, cfgs, mt, CHI, trunc, UpdateRule("exchange"), 1,
                lambda: draw_uniforms(gen, NCHAINS, LY, LX, state.dtype,
                                      device)))
        add(launches)
        log("j1j2", step=f"energy_only_{name}_result",
            energy_per_site=float(energy) / n,
            energy_stderr_per_site=float(err) / n)
        if not math.isfinite(float(energy)):
            fail(f"j1j2 energy-only {name}: energy {float(energy)}")
    log("j1j2", step="total", launches=total)
    if total["pair_transfer"] == 0:
        fail("j1j2: kernel pair_transfer was not launched")
    if total["col_transfer"] == 0 or total["centered_o"] == 0:
        fail(f"j1j2: a kernel was not launched: {total}")
    return total, {"vmc_energy_per_site": e_site,
                   "measure_energy_per_site": e / n}


def product_energy(model, occ):
    """Energy of the product state |occ>: the diagonal element of every
    coupling on every bond (exact, the state has no other amplitude)."""
    ly, lx = occ.shape
    e = 0.0
    for name, (y1, x1), (y2, x2) in (
            ("h_h", (0, 0), (0, 1)), ("h_v", (0, 0), (1, 0)),
            ("h_d", (0, 0), (1, 1)), ("h_ad", (1, 0), (0, 1)),
            ("h_s5a", (1, 0), (0, 2)), ("h_s5b", (2, 0), (0, 1)),
            ("h_tnn_h", (0, 0), (0, 2)), ("h_tnn_v", (0, 0), (2, 0))):
        h = getattr(model, name)
        if h is None:
            continue
        for y in range(ly - max(y1, y2)):
            for x in range(lx - max(x1, x2)):
                c1, c2 = occ[y + y1, x + x1], occ[y + y2, x + x2]
                e += float(h[c1, c2, c1, c2])
    if model.h_site is not None:
        e += sum(float(model.h_site[c, c]) for c in occ.reshape(-1))
    return e


def cluster_su(step, device, name, fn, model, steps):
    """One cluster simple update from the Neel product state, run through
    step(name, fn) (phase 8's counted step), its steps timed through the
    step observer (synchronized). Returns the result."""
    import numpy as np
    import torch
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.peps import SimpleUpdateParams, product_peps

    n = LY * LX
    rec = {"s": [], "e0": [], "trunc_err": []}
    clock = [0.0]

    def observe(step, e0, en, trunc_err):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["s"].append(now - clock[0])
        rec["e0"].append(e0 / n)
        rec["trunc_err"].append(trunc_err)
        clock[0] = now

    def run():
        peps0 = product_peps(LY, LX, D, np.indices((LY, LX)).sum(0) % 2,
                             PHYS, dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        clock[0] = time.perf_counter()
        return fn(peps0, model, SimpleUpdateParams(steps, 0.1,
                                                   TruncParams(D, 1, 1e-8)),
                  step_observer=observe)

    su = step(name, run)
    log("bosonic_rest", step=f"{name}_steps", steps=steps,
        seconds_per_step=rec["s"], e0_nn_bonds_per_site=rec["e0"],
        trunc_err=rec["trunc_err"],
        mean_seconds_per_step_after_first=sum(rec["s"][1:])
        / max(len(rec["s"]) - 1, 1))
    if not bool(torch.isfinite(su.peps.gammas).all()):
        fail(f"{name}: non-finite state")
    return su


def phase_bosonic_rest(res, device, j1j2, nn_su_s_per_step, e_svd):
    """Phase 8: the rest of the bosonic OBC surface at the main path's
    width; e_svd: phase 4's svd local energies of the same 16
    configurations. Returns the launches summed over its steps."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm.energy import (
        ModelTensors, local_energy_and_holes, local_energy_and_holes_dressed,
        psi_consistency_check)
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams, mc_energy_only
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.contraction.bmps import (all_top_envs,
                                                 entanglement_entropy)
    from peps_tpu_torch.lattice import transpose_tps
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.jastrow import JastrowDress
    from peps_tpu_torch.montecarlo.sweep import (UpdateRule, draw_uniforms,
                                                 mc_sweep_3site)
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
    from peps_tpu_torch.peps import to_tps
    from peps_tpu_torch.peps_cluster import (simple_update_nnn,
                                             simple_update_triangle)
    from peps_tpu_torch.tps import project

    n = LY * LX
    trunc = TruncParams(CHI, 1, 1e-6, scheme="sketch")
    state0, cfgs = res.state, res.final_configs
    total = {k: 0 for k in kernel_counts()}

    def step(name, fn):
        out, launches = counted_step(device, "bosonic_rest", name, fn)
        for k, v in launches.items():
            total[k] += v
        return out

    def uniforms(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return lambda: draw_uniforms(gen, NCHAINS, LY, LX, torch.float32,
                                     device)

    def unit(su):
        tps = to_tps(su.peps)
        return tps / tps.abs().max()

    # 1. the J1-J2 state: NNN cluster simple update, then 2 SR iterations
    model = spin.j1j2_xxz(1, 1, 0.5, 0.5)
    su = cluster_su(step, device, "su_nnn", simple_update_nnn, model,
                    NNN_SU_STEPS)
    state = unit(su)
    recs = []
    params = VMCParams(
        CHI, trunc, MCParams(num_samples=1, num_warmup_sweeps=WARMUP_SWEEPS,
                             nchains=NCHAINS),
        OptimizerParams(2, SRParams(CGParams(30, 1e-5), diag_shift=1e-3),
                        lr=0.05))
    out = step("vmc_sr_j1j2_from_nnn", lambda: vmc_optimize(
        state, model, params, torch.Generator(device=device).manual_seed(81),
        configs=cfgs, callback=lambda rec, st: recs.append(rec)))
    e_site = [r.energy / n for r in recs]
    log("bosonic_rest", step="j1j2_from_nnn_state", energy_per_site=e_site,
        energy_stderr_per_site=[r.energy_error / n for r in recs],
        phase7_from_heisenberg_state=j1j2,
        su_nnn_nn_bond_energy_per_site=su.estimated_e0 / n,
        su_seconds_per_step_nn=nn_su_s_per_step,
        eval_s=[r.eval_seconds for r in recs],
        update_s=[r.update_seconds for r in recs],
        accept_rate=[r.accept_rate for r in recs])
    if len(recs) != 2 or not all(-0.60 < e < -0.35 for e in e_site) or \
            not bool(torch.isfinite(out.state).all()):
        fail(f"j1j2 from the NNN state: energy per site {e_site} outside "
             "(-0.60, -0.35)")

    # 2. the triangular state: triangle cluster update, energy-only
    tri = spin.triangle_j1j2_heisenberg(1, 0.5)
    su_tri = cluster_su(step, device, "su_triangle", simple_update_triangle,
                        tri, TRI_SU_STEPS)
    mt_tri = ModelTensors.from_model(tri, torch.float32, device)
    e_tri, err_tri = step("energy_only_triangle", lambda: mc_energy_only(
        unit(su_tri), cfgs, mt_tri, CHI, trunc, UpdateRule("exchange"), 2,
        uniforms(82), sweeps_between=2))
    e_prod = product_energy(tri, np.indices((LY, LX)).sum(0) % 2)
    log("bosonic_rest", step="triangle_result",
        energy_per_site=float(e_tri) / n,
        energy_stderr_per_site=float(err_tri) / n,
        product_state_energy_per_site=e_prod / n,
        lambda_sum_history=su_tri.energy_history[-3:])
    if not (math.isfinite(float(e_tri)) and float(e_tri) < e_prod):
        fail(f"triangle: energy {float(e_tri)} not below the product "
             f"state's {e_prod}")

    # 3. ratio tables against the evaluator; the dress
    mt_j = ModelTensors.from_model(model, torch.float32, device)
    e_ev = step("e_loc_j1j2_evaluator", lambda: local_energy_and_holes(
        state, cfgs, mt_j, CHI, trunc, with_holes=False).e_loc)
    e_tab = step("e_loc_j1j2_ratio_tables",
                 lambda: local_energy_and_holes_dressed(
                     state, cfgs, mt_j, None, CHI, trunc,
                     with_holes=False).e_loc)
    rel_tab = ((e_tab - e_ev).abs() / e_ev.abs().clamp(min=1e-12)).max()
    gen = torch.Generator(device=device).manual_seed(84)
    v = torch.randn(n, n, generator=gen, device=device) * 0.01
    v = (v + v.T).fill_diagonal_(0.0)
    nvals = torch.tensor([0.5, -0.5], device=device)
    e_zero = step("e_loc_dressed_v0", lambda: local_energy_and_holes_dressed(
        state, cfgs, mt_j, JastrowDress(torch.zeros_like(v), nvals), CHI,
        trunc, with_holes=False).e_loc)
    dressed = step("e_loc_dressed", lambda: local_energy_and_holes_dressed(
        state, cfgs, mt_j, JastrowDress(v, nvals), CHI, trunc))
    log("bosonic_rest", step="ratio_tables", max_rel_diff_vs_evaluator=
        rel_tab.item(), dressed_v0_equal=bool(torch.equal(e_zero, e_tab)),
        dressed_energy_per_site=dressed.e_loc.mean().item() / n,
        undressed_energy_per_site=e_tab.mean().item() / n)
    if not rel_tab.item() < 1e-4:
        fail(f"ratio-table energy against the evaluator: {rel_tab.item()}")
    if not torch.equal(e_zero, e_tab):
        fail("dressed energy with v = 0 differs from the undressed one")
    if not (bool(torch.isfinite(dressed.e_loc).all())
            and bool(torch.isfinite(dressed.o_tensor).all())):
        fail("dressed energy or holes not finite")

    # 4. the 3-site permutation sweep over the 32 chains
    gen = torch.Generator(device=device).manual_seed(85)
    cur = cfgs
    for i in range(SWEEPS_3SITE):
        t0 = time.perf_counter()
        new, st = step(f"sweep_3site_{i}", lambda: mc_sweep_3site(
            state0, transpose_tps(state0), cur, CHI, trunc, generator=gen))
        sz_kept = bool(torch.equal((new == 0).sum((1, 2)),
                                   (cur == 0).sum((1, 2))))
        log("bosonic_rest", step=f"sweep_3site_{i}_result",
            seconds=time.perf_counter() - t0,
            accept_rate=int(st.accepted) / max(int(st.trials), 1),
            trials=int(st.trials), sz_conserved=sz_kept)
        if not sz_kept:
            fail("the 3-site sweep changed a chain's Sz")
        cur = new

    # 5. monitors
    rel_psi, _ = step("psi_consistency", lambda: psi_consistency_check(
        state0, cfgs, CHI, trunc))
    tops, _ = all_top_envs(project(state0, cfgs[:1]), CHI, trunc)
    s_mid = step("entanglement_entropy", lambda: entanglement_entropy(
        tops[0, LY // 2], LX // 2))
    log("bosonic_rest", step="monitors",
        psi_consistency_max=rel_psi.max().item(),
        psi_consistency_median=rel_psi.median().item(),
        entanglement_entropy_mid_cut=float(s_mid))
    if not (math.isfinite(rel_psi.max().item())
            and math.isfinite(float(s_mid)) and float(s_mid) >= 0):
        fail(f"monitors: psi {rel_psi.max().item()}, S {float(s_mid)}")
    # 6. the compress schemes against svd on 16 configurations, then one
    # energy-only evaluation each
    cfg16 = cfgs[:GATE_CONFIGS]
    mt = ModelTensors.from_model(spin.heisenberg(), state0.dtype, device)

    def e_scheme(scheme, configs):
        return local_energy_and_holes(
            state0, configs, mt, CHI, TruncParams(CHI, 1, 1e-6,
                                                  scheme=scheme),
            with_holes=False).e_loc

    for scheme in ("var2", "var1", "fast"):
        e = step(f"e_loc_{scheme}", lambda: e_scheme(scheme, cfg16))
        rel = ((e - e_svd).abs() / e_svd.abs().clamp(min=1e-12)).max().item()
        log("bosonic_rest", step=f"scheme_{scheme}", configs=GATE_CONFIGS,
            max_rel_diff_vs_svd=rel)
        if not rel < 1e-2:
            fail(f"scheme {scheme} against svd: {rel}")
    # what bounds the svd-based schemes: one batched SVD as their absorbs
    # call it (linalg.truncated_svd), 16 random 256 x 256 f32 matrices
    gen = torch.Generator(device=device).manual_seed(86)
    mats = torch.randn(GATE_CONFIGS, 256, 256, device=device, generator=gen)
    svd_ms = time_ms(lambda: torch.linalg.svd(mats, full_matrices=False), 3)
    log("bosonic_rest", step="svd_batched", shape=list(mats.shape),
        ms=svd_ms, ms_per_matrix=svd_ms / GATE_CONFIGS)
    for scheme, nce in SCHEME_EVAL_CHAINS.items():
        tr = TruncParams(CHI, 1, 1e-6, scheme=scheme)
        gen = torch.Generator(device=device).manual_seed(83)
        t0 = time.perf_counter()
        energy, err = step(f"energy_only_{scheme}", lambda: mc_energy_only(
            state0, cfgs[:nce], mt, CHI, tr, UpdateRule("exchange"), 1,
            lambda: draw_uniforms(gen, nce, LY, LX, torch.float32, device)))
        log("bosonic_rest", step=f"energy_only_{scheme}_result", chains=nce,
            seconds=time.perf_counter() - t0,
            energy_per_site=float(energy) / n,
            energy_stderr_per_site=float(err) / n)
        if not math.isfinite(float(energy)):
            fail(f"energy-only with {scheme}: {float(energy)}")

    log("bosonic_rest", step="total", launches=total)
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        fail(f"bosonic_rest: kernels not launched: {missing}")
    return total


def _rel_diff(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-300)).item()


def phase_bosonic_close(res, device):
    """Phase 9: the rest of the bosonic OBC surface, at the main path's
    width, each step with the launch counters at 0: (a) the complex64 main
    path (SU with the energy-stall stop and a step observer, to_tps, SR,
    measure() with the walkers, then both again with K1's launches timed);
    (b) a complex J1-J2 energy-only evaluation
    with eval_chunk, K3's device ms in it; (c) complex128 on the card
    against the port on the CPU (4x4, D=4, chi=16, 8 chains, one SR
    evaluation of J1-J2 on the same uniforms); (d) TFIM: the site term
    folded into the bonds, SU, then SR with Suwa-Todo from uniform
    configurations; (e) eval_chunk on the real J1-J2 SR evaluation against
    the unchunked one. Returns (launches summed over its steps, {kernel:
    {complex run: launches}} of (a), (b) and (c))."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.mc_evaluator import (MCParams,
                                                       mc_energy_grad,
                                                       mc_energy_only)
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.lattice import boundary_mask
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import UpdateRule, draw_uniforms
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
    from peps_tpu_torch.peps import (SimpleUpdateParams,
                                     fold_site_into_bonds, product_peps,
                                     simple_update, to_tps)

    n = LY * LX
    trunc = TruncParams(CHI, 1, 1e-6, scheme="sketch")
    total = {k: 0 for k in kernel_counts()}
    main_c64 = {k: 0 for k in kernel_counts()}

    def step(name, fn, into=None):
        out, launches = counted_step(device, "bosonic_close", name, fn)
        for k, v in launches.items():
            total[k] += v
            if into is not None:
                into[k] += v
        return out, launches

    def sr(iters):
        return OptimizerParams(iters, SRParams(CGParams(30, 1e-5),
                                               diag_shift=1e-3), lr=0.05)

    def unit(su):
        tps = to_tps(su.peps)
        return tps / tps.abs().max()

    def su_params():
        return SimpleUpdateParams(CLOSE_SU_STEPS, 0.1, TruncParams(D, 1, 1e-8),
                                  energy_abs_tol=CLOSE_SU_TOL, patience=3,
                                  min_steps=10)

    # (a) the complex64 main path
    model = spin.heisenberg()
    seen = []
    su, _ = step("su_complex64", lambda: simple_update(
        product_peps(LY, LX, D, np.indices((LY, LX)).sum(0) % 2, PHYS,
                     dtype=torch.complex64, device=device),
        model.h_h, model.h_v, su_params(),
        step_observer=lambda **kw: seen.append(kw)), main_c64)
    log("bosonic_close", step="su_complex64_result",
        executed_steps=su.executed_steps, converged=su.converged,
        observer_calls=len(seen),
        e0_per_site=[kw["e0"] / n for kw in seen],
        trunc_err_last=seen[-1]["trunc_err"] if seen else None)
    if len(seen) != su.executed_steps or not math.isfinite(su.estimated_e0):
        fail(f"complex SU: {len(seen)} observer calls for "
             f"{su.executed_steps} steps, e0 {su.estimated_e0}")
    state = unit(su)
    recs = []
    params = VMCParams(
        CHI, trunc, MCParams(num_samples=1, num_warmup_sweeps=WARMUP_SWEEPS,
                             nchains=NCHAINS), sr(CLOSE_SR_ITERS),
        occupancy=((0, n // 2), (1, n - n // 2)))
    vmc, l_vmc = step("vmc_sr_complex64", lambda: vmc_optimize(
        state, model, params, torch.Generator(device=device).manual_seed(91),
        callback=lambda rec, st: recs.append(rec)), main_c64)
    mp = MeasurementParams(num_samples=MEASURE_SAMPLES, num_warmup_sweeps=0,
                           nchains=NCHAINS, chunk_size=MEASURE_CHUNK,
                           measure_offdiag_corr=True)
    meas, l_meas = step("measure_complex64", lambda: measure(
        vmc.state, model, mp, CHI, trunc, UpdateRule("exchange"),
        vmc.final_configs,
        generator=torch.Generator(device=device).manual_seed(92)), main_c64)
    e_site = [r.energy / n for r in recs]
    e_m, err_m = (float(v) for v in meas.stats["energy"])
    log("bosonic_close", step="complex64_main_path_result",
        dtype=str(vmc.state.dtype), energy_per_site=e_site,
        energy_stderr_per_site=[r.energy_error / n for r in recs],
        eval_s=[r.eval_seconds for r in recs],
        update_s=[r.update_seconds for r in recs],
        sr_iters=[r.sr_iters for r in recs],
        measure_energy_per_site=e_m / n,
        measure_stderr_per_site=err_m / n,
        sampling_wall_s=meas.sampling_wall_s,
        samples_per_s=NCHAINS * MEASURE_SAMPLES / meas.sampling_wall_s,
        launches=main_c64)
    if vmc.state.dtype != torch.complex64 or len(recs) != CLOSE_SR_ITERS:
        fail(f"complex main path: {vmc.state.dtype}, {len(recs)} records")
    if not all(math.isfinite(e) and -0.70 < e < -0.40
               for e in e_site + [e_m / n]):
        fail(f"complex main path: energy per site {e_site}, measure "
             f"{e_m / n} not in (-0.70, -0.40)")
    if l_vmc["col_transfer"] == 0 or l_vmc["centered_o"] == 0 or \
            l_meas["col_transfer"] == 0:
        fail(f"complex main path: K1/K2 not launched: {l_vmc}, {l_meas}")
    # K1's device time in the same SR run and measure() (CUDA events around
    # each K1 launch; a second run of each, so that the events' host cost
    # stays out of the wall times above)
    for name, run in (
            ("vmc_sr_complex64", lambda: vmc_optimize(
                state, model, params,
                torch.Generator(device=device).manual_seed(91))),
            ("measure_complex64", lambda: measure(
                vmc.state, model, mp, CHI, trunc, UpdateRule("exchange"),
                vmc.final_configs,
                generator=torch.Generator(device=device).manual_seed(92)))):
        by_items = {}
        (_, k1_ms, k1_calls, wall), _ = step(
            f"{name}_k1_events", lambda: k1_device_ms(run, by_items))
        log("bosonic_close", step=f"{name}_k1_device", k1_calls=k1_calls,
            k1_device_ms=k1_ms, seconds_with_events=wall,
            k1_share=k1_ms / (1e3 * wall),
            k1_by_items={str(k): v for k, v in sorted(by_items.items())})

    # (b) a complex J1-J2 energy-only evaluation, eval_chunk on
    j1j2 = spin.j1j2_xxz(1, 1, 0.5, 0.5)
    mt = ModelTensors.from_model(j1j2, vmc.state.dtype, device)
    gen = torch.Generator(device=device).manual_seed(93)
    ((e_j, err_j), k3_ms, k3_calls, wall_j), l_j = step(
        "energy_only_j1j2_complex64", lambda: k3_device_ms(
            lambda: mc_energy_only(
                vmc.state, vmc.final_configs, mt, CHI, trunc,
                UpdateRule("exchange"), 1,
                lambda: draw_uniforms(gen, NCHAINS, LY, LX, torch.float32,
                                      device), eval_chunk=CLOSE_EVAL_CHUNK)))
    log("bosonic_close", step="energy_only_j1j2_complex64_result",
        eval_chunk=CLOSE_EVAL_CHUNK, energy_per_site=float(e_j) / n,
        energy_stderr_per_site=float(err_j) / n,
        peak_mem_GB=torch.cuda.max_memory_allocated(device) / 1e9,
        seconds=wall_j, k3_calls=k3_calls, k3_device_ms=k3_ms,
        k3_share=k3_ms / (1e3 * wall_j))
    if not math.isfinite(float(e_j)) or l_j["pair_transfer"] == 0:
        fail(f"complex J1-J2: energy {float(e_j)}, launches {l_j}")

    # (c) complex128: the card against the port on the CPU
    ly, lx, dd, chi, nc = (SMALL[k] for k in ("ly", "lx", "D", "chi",
                                              "nchains"))
    rng = np.random.default_rng(94)
    shape = (ly, lx, PHYS) + (dd,) * 4
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        * boundary_mask(ly, lx, PHYS, dd)
    base = np.array([0, 1] * (ly * lx // 2) + [0] * (ly * lx % 2))
    cfg0 = np.stack([rng.permutation(base).reshape(ly, lx)
                     for _ in range(nc)])
    uni = draw_uniforms(torch.Generator().manual_seed(95), nc, ly, lx,
                        torch.float64, "cpu")
    small_trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")
    evals = {}
    for where in ("cpu", device):
        mt = ModelTensors.from_model(j1j2, torch.complex128, where)
        u = tuple(x.to(where) for x in uni)

        def run():
            return mc_energy_grad(
                torch.as_tensor(a, device=where),
                torch.as_tensor(cfg0, device=where), mt, chi, small_trunc,
                MCParams(num_samples=1, num_warmup_sweeps=0, nchains=nc),
                lambda: u, with_sr_buffers=True)
        if where == "cpu":
            t0 = time.perf_counter()
            evals["cpu"] = run()
            cpu_s = time.perf_counter() - t0
        else:
            evals["card"], l_c = step("c128_card_vs_cpu", run)
    (ev_c, cfg_c, _), (ev_g, cfg_g, _) = evals["cpu"], evals["card"]
    diffs = {
        "energy": abs(float(ev_g.energy) - float(ev_c.energy))
        / abs(float(ev_c.energy)),
        "gradient": _rel_diff(ev_g.gradient.cpu(), ev_c.gradient),
        "o_samples": _rel_diff(ev_g.o_samples.cpu(), ev_c.o_samples),
        "e_samples": _rel_diff(ev_g.e_samples.cpu(), ev_c.e_samples)}
    same_cfgs = bool(torch.equal(cfg_g.cpu(), cfg_c))
    log("bosonic_close", step="c128_card_vs_cpu_result", lattice=[ly, lx],
        D=dd, chi=chi, chains=nc, model="j1j2_xxz(1,1,.5,.5)",
        rel_diff=diffs, same_configurations=same_cfgs,
        energy_per_site=float(ev_g.energy) / (ly * lx), cpu_s=cpu_s,
        launches=l_c)
    if not (all(v <= 1e-10 for v in diffs.values()) and same_cfgs):
        fail(f"complex128 card against CPU: {diffs}, configurations equal "
             f"{same_cfgs}")
    if min(l_c.values()) == 0:
        fail(f"complex128 card evaluation: a kernel was not launched {l_c}")

    # (d) TFIM, J = h = 1: the site term folded into the bonds
    tfim = spin.transverse_field_ising(1.0, 1.0)
    hh, hv = fold_site_into_bonds(tfim.h_h, tfim.h_v, tfim.h_site, LY, LX)
    su_t, _ = step("su_tfim", lambda: simple_update(
        product_peps(LY, LX, D, np.zeros((LY, LX), int), PHYS,
                     dtype=torch.float32, device=device), hh, hv,
        su_params()))
    recs_t = []
    params = VMCParams(
        CHI, trunc, MCParams(num_samples=2,
                             num_warmup_sweeps=TFIM_WARMUP_SWEEPS,
                             nchains=NCHAINS), sr(2),
        rule=UpdateRule("suwa_todo"))
    vt, _ = step("vmc_sr_tfim", lambda: vmc_optimize(
        unit(su_t), tfim, params,
        torch.Generator(device=device).manual_seed(96),
        callback=lambda rec, st: recs_t.append(rec)))
    e_su = su_t.estimated_e0 / n
    e_vmc = [r.energy / n for r in recs_t]
    err_vmc = [r.energy_error / n for r in recs_t]
    e_prod = product_energy(tfim, np.zeros((LY, LX), int)) / n
    tol = max(5 * err_vmc[0], 0.03 * abs(e_su)) if recs_t else 0.0
    log("bosonic_close", step="tfim_result", su_executed_steps=
        su_t.executed_steps, su_converged=su_t.converged,
        su_energy_per_site=e_su, vmc_energy_per_site=e_vmc,
        vmc_stderr_per_site=err_vmc,
        accept_rate=[r.accept_rate for r in recs_t],
        z_polarised_energy_per_site=e_prod, su_vs_vmc_tolerance=tol)
    if not (len(e_vmc) == 2 and all(math.isfinite(e) for e in e_vmc + [e_su])
            and bool(torch.isfinite(vt.state).all())):
        fail(f"tfim: energies SU {e_su}, VMC {e_vmc}")
    if not abs(e_vmc[0] - e_su) <= tol:
        fail(f"tfim: SU {e_su} and VMC {e_vmc[0]} per site differ by more "
             f"than {tol}")
    if not all(e < e_prod for e in e_vmc + [e_su]):
        fail(f"tfim: SU {e_su} or VMC {e_vmc} not below the z-polarised "
             f"state's {e_prod}")

    # (e) eval_chunk on the real J1-J2 SR evaluation
    mt = ModelTensors.from_model(j1j2, res.state.dtype, device)
    energies, peaks = {}, {}
    for chunk in (None, CLOSE_EVAL_CHUNK):
        gen = torch.Generator(device=device).manual_seed(97)
        (ev, _, _), _ = step(f"sr_eval_j1j2_eval_chunk_{chunk}",
                             lambda: mc_energy_grad(
                                 res.state, res.final_configs, mt, CHI, trunc,
                                 MCParams(num_samples=1, num_warmup_sweeps=0,
                                          nchains=NCHAINS, eval_chunk=chunk),
                                 lambda: draw_uniforms(gen, NCHAINS, LY, LX,
                                                       torch.float32, device),
                                 with_sr_buffers=True))
        peaks[str(chunk)] = torch.cuda.max_memory_allocated(device) / 1e9
        energies[str(chunk)] = float(ev.energy)
        del ev
    rel = abs(energies[str(CLOSE_EVAL_CHUNK)] - energies["None"]) \
        / abs(energies["None"])
    log("bosonic_close", step="eval_chunk_result", chains=NCHAINS,
        energy_per_site={k: v / n for k, v in energies.items()},
        rel_diff=rel, peak_mem_GB=peaks)
    if not rel <= 1e-5:
        fail(f"eval_chunk {CLOSE_EVAL_CHUNK} against unchunked: {rel}")

    log("bosonic_close", step="total", launches=total)
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        fail(f"bosonic_close: kernels not launched: {missing}")
    complex_launches = {"complex64_main_path": main_c64,
                        "complex64_j1j2_eval_chunk": l_j,
                        "complex128_card_vs_cpu": l_c}
    return total, {k: {run: v[k] for run, v in complex_launches.items()}
                   for k in total}


# ---------------------------------------------------------------------------
# fermions: phase 2's K4 and K1-backward cases, and phase 10
# ---------------------------------------------------------------------------

def graph_ms(fn, launches=K4_GRAPH_LAUNCHES, replays=5):
    """Device ms a call of fn, free of the host's issue rate: `launches`
    calls captured in one CUDA graph, CUDA events around each of `replays`
    replays (after one warm-up replay), the mean over the replays and
    launches. fn must allocate nothing it has not allocated before (the
    graph's pool takes its outputs)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def host_us(fn, reps=400):
    """Host microseconds a call of fn (wrapper and launch), host clock over
    reps calls with no synchronisation in between, after one warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e6


def k4_bytes(tps, cfg, out, select_config=False, y0=0, ny=None, **_):
    """The bytes one K4 call must move: the tps slabs it reads (the rows
    [y0, y0+ny) at every value a; with select_config the distinct
    (chain, y, x, a) slabs the configurations select there, per chain
    where tps is per chain and a stride-0 axis a counting once), the
    configurations read once and the output written once."""
    import torch
    per_chain = tps.dim() == 8
    ly, lx, d = tps.shape[-7:-4]
    ny = ly - y0 if ny is None else ny
    slab = tps.shape[-4:].numel()
    if select_config:
        rows = cfg[:, y0:y0 + ny].long()
        if per_chain and tps.stride(3) == 0:
            rows = torch.zeros_like(rows)
        site = torch.arange(ny * lx, device=cfg.device).reshape(ny, lx)
        key = site * d + rows
        if per_chain:
            key = key + torch.arange(cfg.shape[0], device=cfg.device)[
                :, None, None] * (ny * lx * d)
        slabs = int(torch.unique(key).numel())
    else:
        slabs = ny * lx * d * (tps.shape[0] if per_chain else 1)
    return (slabs * slab + out.numel()) * tps.element_size() \
        + cfg.numel() * cfg.element_size()


def k4_operands(name, dt, device, gen):
    """(tps, cfg) of a K4 case at 6x6, D=8, d=3, 32 chains: a shared tps,
    or for undress_grad a per-chain gradient [nc, 6, 6, D^4] expanded over
    the physical axis (stride 0), as fermion/vmc.py passes it."""
    import torch
    L, D, nc, d = FLAG["L"], FLAG["D"], FLAG["nchains"], 3
    dtype = getattr(torch, dt)
    cfg = torch.randint(0, d, (nc, L, L), generator=gen, device=device)
    if name == "undress_grad":
        g = torch.randn(nc, L, L, D, D, D, D, generator=gen, device=device,
                        dtype=torch.float64).to(dtype)
        return g.unsqueeze(3).expand(-1, -1, -1, d, -1, -1, -1, -1), cfg
    return torch.randn(L, L, d, D, D, D, D, generator=gen, device=device,
                       dtype=torch.float64).to(dtype), cfg


def k4_phase(device, gen):
    """Phase 2, K4 (fermion_dress): its three outputs at 6x6, D=8, d=3,
    32 chains (the projection with either flag, one row's candidates, the
    undressing of a per-chain gradient through a stride-0 physical axis)
    in all four dtypes against the plain version (exactly equal: a
    multiply by +-1). Times: the kernel's device time alone (`ms`,
    :func:`graph_ms`: a CUDA graph of 20 launches, the host's issue rate
    out of it), the host microseconds a call (`host_us`), back-to-back
    calls between CUDA events (`stream_ms`, what a caller that issues one
    call at a time sees), the plain version and a copy_ of the output's
    bytes (graph-timed, `copy_ms`). The bound is the bytes (the tps slabs
    the call reads, the configurations and the output: :func:`k4_bytes`)
    over 3.35 TB/s. Returns the record of the float32 candidates of one
    row (the sampler's per-row call) with every case's line."""
    import torch
    from peps_tpu_torch.fermion.convert import dress_tables
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.kernels import fermion_dress as k4
    L, D = FLAG["L"], FLAG["D"]
    tab = dress_tables(FermionSpace((0, 1, 1), D // 2, D // 2), L, L)
    rec, cases = None, []
    for dt in ("float32", "float64", "complex64", "complex128"):
        for name, kw in K4_CASES:
            tps, cfg = k4_operands(name, dt, device, gen)
            out = k4.fermion_dress(tps, cfg, tab, **kw)
            ref = k4.fermion_dress_plain(tps, cfg, tab, **kw)
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, ref))
            err = (out - ref).abs().max().item()
            src = torch.empty_like(out)
            dst = torch.empty_like(out)

            def kern():
                return k4.fermion_dress(tps, cfg, tab, **kw)
            t = _in_turns({"kern": kern,
                           "plain": lambda: k4.fermion_dress_plain(
                               tps, cfg, tab, **kw)}, 10)
            dev_ms = graph_ms(kern)
            copy_ms = graph_ms(lambda: dst.copy_(src))
            nbytes = k4_bytes(tps, cfg, out, **kw)
            bound_ms = nbytes / HBM_BPS * 1e3
            r = {"kernel": "fermion_dress", "case": name, "dtype": dt,
                 "out_shape": list(out.shape), "exact": exact,
                 "max_abs_err": err, "ms": dev_ms, "host_us": host_us(kern),
                 "stream_ms": t["kern"], "plain_ms": t["plain"],
                 "copy_ms": copy_ms, "bytes": nbytes, "bound_ms": bound_ms,
                 "bound_by": "bytes", "pct_of_bound": 100 * bound_ms / dev_ms,
                 "library_ms": None}
            log("kernels_fermion", **r)
            if not exact:
                fail(f"fermion_dress {name} {dt}: max |kernel - plain| "
                     f"{err}, not 0")
            cases.append({k: r[k] for k in ("case", "dtype", "ms", "host_us",
                                            "stream_ms", "plain_ms",
                                            "copy_ms", "bound_ms")})
            if dt == "float32" and name == "candidates_row":
                rec = r
            del out, ref, src, dst
    rec["cases"] = cases
    return rec


def k1_backward_cases(dtype, device, gen):
    """K1 operands at the graded holes' shapes (6x6, D=8, chi=32, a chunk
    of 8 chains): the sketch V scan (right form, the mixing block in the
    bot slot, no gradient there), the W scan (left form) and the pair
    traces (all four gradients): (name, form, ops, needs_grad)."""
    import torch
    c, D, chi, losk = FLAG["chunk"], FLAG["D"], FLAG["chi"], FLAG["chi"] + 8
    L = FLAG["L"]

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float64).to(dtype)

    site = (D, D, D, D)
    return (("sketch_v", "right", (r(c, chi, D, chi), r(c, chi, D, chi),
                                   r(c, *site), r(chi, D, chi)),
             (True, True, True, False)),
            ("sketch_w", "left", (r(c, chi, D, losk), r(c, chi, D, chi),
                                  r(c, *site), r(losk, D, losk)),
             (True, True, True, False)),
            ("pair_traces", "left",
             (r(c, L, L - 1, 1, chi, D, chi), r(c, L, L - 1, 1, chi, D, chi),
              r(c, L, L - 1, 3, *site), r(c, L, L - 1, 1, chi, D, chi)),
             (True, True, True, True)))


def k1_backward_work(views, needs, g):
    """(flops, bytes) of one backward of K1 on left-form views: the
    products of the shared chain the requested gradients need (csrc/
    col_transfer_backward.cu: X = bot.G and P = env.top, R = site.X and
    F = site.P, then the site gradient P.X, the env and top gradients
    top.R and env.R, the bot gradient F.G), each at every item of the
    broadcast batch, P and the env and top gradients' at every distinct
    env.top where env and top share their broadcast (a 4-real-FMA complex
    multiply-add); the inputs and g read once, the gradients written
    once."""
    import torch
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    env, top, site, bot = views
    na, nl, nc = env.shape[-3:]
    nu, nA = top.shape[-2:]
    nd, nr = site.shape[-2:]
    nC = bot.shape[-1]
    ne, nt, ns, nb = needs
    items = math.prod(g.shape[:-3])
    # where env and top share their broadcast (the plan's "share"), P and
    # the env and top gradients' products run once per distinct env.top
    et_items = math.prod(torch.broadcast_shapes(env.shape[:-3],
                                                top.shape[:-3])) \
        if kb.launch_meta(g, *views, needs)[0]["share"] else items
    macs = (items * (nc * nd * nA * nr * nC * (ne or nt or ns)
                     + nu * nl * nc * nA * nd * nr * ((ne or nt) + nb + ns)
                     + nc * nd * nC * nA * nr * nb)
            + et_items * (nl * nc * nu * nA * na * (ns or nb)
                          + na * nl * nc * nu * nA * (ne + nt)))
    flops = 2 * macs * (4 if env.is_complex() else 1)
    ins = sum(t.numel() for t in (*views, g))
    outs = sum(t.numel() for t, n in zip(views, needs) if n)
    return flops, (ins + outs) * env.element_size()


def k1_backward_phase(device, peak, gen):
    """Phase 2, K1's backward (ColTransferFunction: one launch of
    csrc/col_transfer_backward.cu for every requested gradient) at the
    graded holes' shapes in all four dtypes, each input's gradient held to
    autograd of col_transfer_plain (1e-5 / 1e-12 of max |plain|), exactly
    one backward launch and no K1 launch inside the backward, the backward
    timed in turns with the plain chain's backward, with its bound, the
    launch plan and the compiled kernel's registers. Returns the float32
    pair traces' record, with every case's (name, dtype, ms, plain_ms,
    bound_ms) under "cases"."""
    import torch
    from peps_tpu_torch.kernels import col_transfer as k1
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    rec, cases = None, []
    for dt in ("float32", "float64", "complex64", "complex128"):
        dtype = getattr(torch, dt)
        diag = kb.backward_diagnostic(dtype)
        for name, form, ops, needs in k1_backward_cases(dtype, device, gen):
            grads, graphs = {}, {}
            with torch.no_grad():
                shape = (k1.col_transfer_right(
                    *ops, transfer=k1.col_transfer_plain) if form == "right"
                    else k1.col_transfer_plain(*ops)).shape
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float64).to(dtype)
            for path in ("kern", "plain"):
                xs = [o.detach().clone().requires_grad_(n)
                      for o, n in zip(ops, needs)]
                if form == "right":
                    out = k1.col_transfer_right(*xs) if path == "kern" else \
                        k1.col_transfer_right(
                            *xs, transfer=k1.col_transfer_plain)
                else:
                    out = k1.col_transfer(*xs) if path == "kern" else \
                        k1.col_transfer_plain(*xs)
                req = [x for x in xs if x.requires_grad]
                before = (kb.col_transfer_backward.launches,
                          k1.col_transfer.launches)
                grads[path] = torch.autograd.grad(out, req, w,
                                                  retain_graph=True)
                after = (kb.col_transfer_backward.launches,
                         k1.col_transfer.launches)
                if path == "kern" and after != (before[0] + 1, before[1]):
                    fail(f"K1 backward {name} {dt}: {after[0] - before[0]} "
                         f"backward and {after[1] - before[1]} K1 launches")
                graphs[path] = (out, req, w)
            torch.cuda.synchronize()
            rels = [((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(grads["kern"], grads["plain"])]

            def bw(path):
                out, req, w = graphs[path]
                return lambda: torch.autograd.grad(out, req, w,
                                                   retain_graph=True)

            t = _in_turns({"kern": bw("kern"), "plain": bw("plain")}, 5)
            views = k1_views(form, ops)
            flops, nbytes = k1_backward_work(views, needs, graphs["plain"][0])
            flop_s = flops / _rate(peak, dtype)
            byte_s = nbytes / HBM_BPS
            bound_ms = max(flop_s, byte_s) * 1e3
            plan, _ = kb.launch_meta(graphs["plain"][0].detach(), *views,
                                     needs, k1.sm_count(device))
            r = {"kernel": "col_transfer_backward", "case": name,
                 "form": form, "dtype": dt, "rel_err": max(rels),
                 "rel_err_per_input": rels,
                 "max_abs_err": max((a - b).abs().max().item() for a, b in
                                    zip(grads["kern"], grads["plain"])),
                 "ms": t["kern"], "plain_ms": t["plain"], "flops": flops,
                 "bytes": nbytes, "bound_ms": bound_ms,
                 "bound_by": "operations" if flop_s >= byte_s else "bytes",
                 "pct_of_bound": 100 * bound_ms / t["kern"],
                 "library_ms": None,
                 "plan": {k: plan[k] for k in ("cluster", "clusters", "ctas",
                                               "group_items", "groups",
                                               "smem_bytes")},
                 **diag}
            log("kernels_fermion", **r)
            cases.append({k: r[k] for k in ("case", "dtype", "ms", "plain_ms",
                                            "bound_ms")})
            if not max(rels) <= TOL[dt]:
                fail(f"K1 backward {name} {dt}: rel err {rels} > {TOL[dt]}")
            if dt == "float32" and name == "pair_traces":
                rec = r
            del grads, graphs
    return {**rec, "cases": cases}


def fermion_counts():
    """K1, K1's backward, K2, K3, K4 and K5's launch counters as they stand
    (not reset)."""
    from peps_tpu_torch.kernels.bmps_overlap import bmps_overlap
    from peps_tpu_torch.kernels.centered_o import centered_o
    from peps_tpu_torch.kernels.col_transfer import col_transfer
    from peps_tpu_torch.kernels.col_transfer_backward import \
        col_transfer_backward
    from peps_tpu_torch.kernels.fermion_dress import fermion_dress
    from peps_tpu_torch.kernels.pair_transfer import pair_transfer
    return {"col_transfer_forward": col_transfer.launches,
            "col_transfer_backward": col_transfer_backward.launches,
            "centered_o": centered_o.launches,
            "pair_transfer": pair_transfer.launches,
            "fermion_dress": fermion_dress.launches,
            "bmps_overlap": bmps_overlap.launches}


def fermion_counters():
    """K1, K1's backward, K2, K3, K4 and K5's launch counters, set to 0;
    returns a reader of {name: launches since}."""
    from peps_tpu_torch.kernels.bmps_overlap import bmps_overlap
    from peps_tpu_torch.kernels.centered_o import centered_o
    from peps_tpu_torch.kernels.col_transfer import col_transfer
    from peps_tpu_torch.kernels.col_transfer_backward import \
        col_transfer_backward
    from peps_tpu_torch.kernels.fermion_dress import fermion_dress
    from peps_tpu_torch.kernels.pair_transfer import pair_transfer
    for k in (col_transfer, col_transfer_backward, centered_o, pair_transfer,
              fermion_dress, bmps_overlap):
        k.launches = 0
    return fermion_counts


def fermion_product_energy(model, occ):
    """Energy of the product state |occ> of a fermionic model: the diagonal
    element of every channel on every NN bond plus the site term (phase
    8's product_energy on the channel tables)."""
    ly, lx = occ.shape
    e = 0.0
    for chans, (dy, dx) in ((model.channels_h, (0, 1)),
                            (model.channels_v, (1, 0))):
        for ch in chans:
            for y in range(ly - dy):
                for x in range(lx - dx):
                    c1, c2 = occ[y, x], occ[y + dy, x + dx]
                    e += float(ch.h[c1, c2, c1, c2])
    if model.h_site is not None:
        e += sum(float(model.h_site[c, c]) for c in occ.reshape(-1))
    return e


def phase_fermions(device):
    """Phase 10: fermions. (a) JW: examples/hubbard_vmc.py's configuration
    (2x4, D=4, chi=16, fast, 64 chains, Suwa-Todo with the conservation
    mask, quarter filling), 2 SR iterations: finite energies, every chain's
    N_up and N_dn kept. (b) Graded at the flagship's width
    (examples/flagship_tj_6x6.py): 6x6 t-J, holes at (2,2) and (3,2) on
    the Neel background; the graded SU at D=4 with U(1) charges and the
    QR-reduced projection, 40 steps at tau 0.2 and 40 at 0.05; to_tps,
    expand to D=8 (4|4) with noise 1e-3; SR (CG 40, shift 1e-3), 3
    iterations, 1 sample step, chi=32, sketch, 32 chains, eval_chunk 8,
    float32. The SU estimate per site below the Neel state's, every SR
    iteration's E/site in (-1.35, that), N_up = N_dn = 17 in every chain,
    acceptance above 0, every kernel launched (K1 forward and backward,
    K2, K3, K4); then where an iteration's time goes (graded_breakdown)
    and float32's evaluation against float64's at the same jitter
    (graded_precision). (c) The card against the CPU: graded t-J at 4x4, D=4,
    chi=6 (FERMION_CARD_CPU_CHI), 8 chains, complex128 and float64, one
    SR evaluation on the same uniforms: energy, O buffer and SR direction
    within 1e-10. Returns the launches of (a), the SU and (b)."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams, mc_energy_grad
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.fermion.graded import GT, parity_mask
    from peps_tpu_torch.fermion.peps import (FermionSpace,
                                             expand_bond_dim_graded,
                                             fermion_simple_update,
                                             product_fermion_peps,
                                             space_for_model, to_tps_fermion,
                                             u1_charges_for)
    from peps_tpu_torch.fermion.vmc import GradedFermionModel
    from peps_tpu_torch.lattice import boundary_mask
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import fermion
    from peps_tpu_torch.montecarlo.sweep import UpdateRule, draw_uniforms
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import (OptimizerParams,
                                                    SRParams,
                                                    sr_natural_gradient)
    from peps_tpu_torch.peps import SimpleUpdateParams
    from peps_tpu_torch.tps import random_tps

    def sr(iters, cg_iters, tol=1e-5):
        return OptimizerParams(iters, SRParams(CGParams(cg_iters, tol),
                                               diag_shift=1e-3), lr=0.05)

    # (a) JW Hubbard
    hp = HUBBARD
    ly, lx = hp["ly"], hp["lx"]
    n = ly * lx
    hub = fermion.hubbard(t=1.0, u=8.0)
    gen = torch.Generator(device=device).manual_seed(0)
    tps = random_tps(gen, ly, lx, 4, hp["D"], torch.float32, scale=0.5,
                     device=device)
    params = VMCParams(
        hp["chi"], TruncParams(hp["chi"], 1, 1e-8, scheme="fast"),
        MCParams(num_samples=hp["samples"], num_warmup_sweeps=hp["warmup"],
                 nchains=hp["nchains"]), sr(hp["sr_iters"], 80),
        rule=UpdateRule("suwa_todo", fermion.hubbard_conserve_mask()),
        occupancy=((0, n // 2), (1, n // 4), (2, n // 4)))
    read = fermion_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hub_res = vmc_optimize(tps, hub, params, gen)
    torch.cuda.synchronize()
    cfg = res.final_configs.cpu().numpy()
    n_up = np.asarray(hub.n_up)[cfg].sum((1, 2))
    n_dn = np.asarray(hub.n_dn)[cfg].sum((1, 2))
    l_jw = read()
    log("fermions", step="jw_hubbard", lattice=[ly, lx], D=hp["D"],
        chi=hp["chi"], chains=hp["nchains"], samples=hp["samples"],
        energy_per_site=[e / n for e in res.energies],
        accept=[r.accept_rate for r in res.records],
        seconds=time.perf_counter() - t0, launches=l_jw,
        n_up_kept=bool(np.all(n_up == n // 4)),
        n_dn_kept=bool(np.all(n_dn == n // 4)))
    if not all(math.isfinite(e) for e in res.energies):
        fail(f"JW Hubbard: energies {res.energies}")
    if not (np.all(n_up == n // 4) and np.all(n_dn == n // 4)):
        fail("JW Hubbard: a chain changed its N_up or N_dn")

    # (b) the graded flagship
    L = FLAG["L"]
    model = fermion.tj_model(FLAG["t"], FLAG["J"])
    occ0 = (np.indices((L, L)).sum(0) % 2 + 1).astype(int)
    occ0[2, 2] = 0
    occ0[3, 2] = 0
    n = L * L
    n_up0, n_dn0 = int((occ0 == 1).sum()), int((occ0 == 2).sum())
    e_neel = fermion_product_energy(model, occ0) / n
    space4 = space_for_model(model, FLAG["D_su"])
    space8 = FermionSpace(space4.phys_parity, FLAG["D"] // 2,
                          FLAG["D"] // 2)
    read = fermion_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    charges = u1_charges_for(model, space4, occ0)
    peps = product_fermion_peps(L, L, space4, occ0, device=device)
    stamps = []

    def observe(step, e0, en, trunc_err):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    su_log = []
    for steps, tau in FLAG["su"]:
        out = fermion_simple_update(
            peps, model, space4,
            SimpleUpdateParams(steps, tau, TruncParams(FLAG["D_su"], 1,
                                                       1e-12)),
            step_observer=observe, charges=charges)
        peps = out.peps
        su_log.append({"tau": tau, "steps": out.executed_steps,
                       "estimated_e0_per_site": out.estimated_e0 / n})
    torch.cuda.synchronize()
    t_su = time.perf_counter() - t0
    su_step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    l_su = read()
    e_su = out.estimated_e0 / n
    log("fermions", step="graded_su", lattice=[L, L], D=FLAG["D_su"],
        stages=su_log, seconds=t_su,
        seconds_per_su_step=sum(su_step_s) / max(len(su_step_s), 1),
        neel_energy_per_site=e_neel, launches=l_su)
    if not (math.isfinite(e_su) and e_su < e_neel):
        fail(f"graded SU: estimated e0 per site {e_su}, Neel {e_neel}")

    tps4 = to_tps_fermion(peps).to(torch.float32)
    tps4 = tps4 / tps4.abs().max()
    tps = expand_bond_dim_graded(tps4, space4, space8, 1e-3,
                                 torch.Generator(device=device)
                                 .manual_seed(11))
    gm = GradedFermionModel.from_model(model, space8, tps.dtype, device)
    recs = []

    def on_iter(rec, state):
        recs.append(rec)
        log("fermions", step="graded_sr_iteration", iteration=rec.step,
            energy_per_site=rec.energy / n,
            energy_error_per_site=rec.energy_error / n,
            accept_rate=rec.accept_rate, sr_iters=rec.sr_iters,
            eval_s=rec.eval_seconds, update_s=rec.update_seconds)

    vp = VMCParams(
        FLAG["chi"], TruncParams(FLAG["chi"], 1, 1e-6, scheme="sketch"),
        MCParams(num_samples=1, num_warmup_sweeps=FLAG["warmup"],
                 nchains=FLAG["nchains"], eval_chunk=FLAG["chunk"]),
        sr(FLAG["sr_iters"], 40),
        occupancy=((0, n - n_up0 - n_dn0), (1, n_up0), (2, n_dn0)))
    read = fermion_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = vmc_optimize(tps, gm, vp, torch.Generator(device=device)
                       .manual_seed(5), callback=on_iter)
    torch.cuda.synchronize()
    t_vmc = time.perf_counter() - t0
    l_vmc = read()
    cfg = res.final_configs.cpu().numpy()
    keeps = bool(np.all((cfg == 1).sum((1, 2)) == n_up0)
                 and np.all((cfg == 2).sum((1, 2)) == n_dn0))
    e_site = [e / n for e in res.energies]
    log("fermions", step="graded_vmc", lattice=[L, L], D=FLAG["D"],
        chi=FLAG["chi"], chains=FLAG["nchains"], eval_chunk=FLAG["chunk"],
        energy_per_site=e_site, seconds=t_vmc,
        seconds_per_evaluation=[r.eval_seconds for r in recs],
        accept=[r.accept_rate for r in recs], n_up=n_up0, n_dn=n_dn0,
        numbers_kept=keeps, launches=l_vmc,
        peak_mem_GB=torch.cuda.max_memory_allocated(device) / 1e9)
    if not all(math.isfinite(e) and -1.35 < e < e_neel for e in e_site):
        fail(f"graded VMC: E/site {e_site} outside (-1.35, {e_neel})")
    if not keeps:
        fail("graded VMC: a chain changed its N_up or N_dn")
    if not all(r.accept_rate > 0 for r in recs):
        fail(f"graded VMC: acceptance {[r.accept_rate for r in recs]}")
    # K5 lies on the measurement path only (phase 11)
    missing = [k for k, v in l_vmc.items() if v == 0 and k != "bmps_overlap"]
    if missing:
        fail(f"graded VMC: kernels not launched: {missing}")
    graded_breakdown(res, gm, vp, device)
    graded_precision(res, model, space8, vp, device)
    flag_res = res

    # (c) the card against the CPU
    ly, lx, dd, nc = (SMALL[k] for k in ("ly", "lx", "D", "nchains"))
    chi = FERMION_CARD_CPU_CHI
    sp = FermionSpace((0, 1, 1), dd // 2, dd // 2)
    pm = parity_mask(GT(torch.zeros((3,) + (dd,) * 4),
                        (sp.phys_parity,) + (sp.bond_parity,) * 4,
                        (False, True, True, False, False)))
    rng = np.random.default_rng(96)
    shape = (ly, lx, 3) + (dd,) * 4
    base = np.array([0] * 2 + [1] * 7 + [2] * 7)
    cfg0 = np.stack([rng.permutation(base).reshape(ly, lx)
                     for _ in range(nc)])
    uni = draw_uniforms(torch.Generator().manual_seed(97), nc, ly, lx,
                        torch.float64, "cpu")
    trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")
    cmp = {}
    for dt in ("complex128", "float64"):
        a = rng.standard_normal(shape)
        if dt == "complex128":
            a = a + 1j * rng.standard_normal(shape)
        a = a * pm * boundary_mask(ly, lx, 3, dd)
        evs = {}
        for where in ("cpu", device):
            gm_s = GradedFermionModel.from_model(fermion.tj_model(), sp,
                                                 getattr(torch, dt), where)
            u = tuple(x.to(where) for x in uni)
            t1 = time.perf_counter()
            ev, cfg_o, _ = mc_energy_grad(
                torch.as_tensor(a, device=where),
                torch.as_tensor(cfg0, device=where), gm_s, chi, trunc,
                MCParams(num_samples=1, num_warmup_sweeps=0, nchains=nc),
                lambda: u, with_sr_buffers=True)
            nat, cg = sr_natural_gradient(
                ev, SRParams(CGParams(100, 1e-12), diag_shift=1e-3),
                a.shape)
            evs[str(where) if where == "cpu" else "card"] = (
                ev, cfg_o.cpu(), nat.cpu(), int(cg.iterations),
                time.perf_counter() - t1)
        (ev_c, cfg_c, nat_c, it_c, s_c), (ev_g, cfg_g, nat_g, it_g, s_g) = \
            evs["cpu"], evs["card"]
        diffs = {"energy": abs(float(ev_g.energy) - float(ev_c.energy))
                 / abs(float(ev_c.energy)),
                 "o_samples": _rel_diff(ev_g.o_samples.cpu(), ev_c.o_samples),
                 "sr_direction": _rel_diff(nat_g, nat_c)}
        same = bool(torch.equal(cfg_g, cfg_c))
        cmp[dt] = diffs
        log("fermions", step="graded_card_vs_cpu", dtype=dt,
            lattice=[ly, lx], D=dd, chi=chi, chains=nc, rel_diff=diffs,
            same_configurations=same, cg_iterations=[it_c, it_g],
            cpu_s=s_c, card_s=s_g)
        if not (all(v <= 1e-10 for v in diffs.values()) and same):
            fail(f"graded {dt} card against CPU: {diffs}, configurations "
                 f"equal {same}")
    return {"jw_hubbard": l_jw, "graded_su": l_su, "graded_vmc": l_vmc,
            "hubbard": (hub_res, hub, params),
            "flagship": (flag_res, gm, vp, e_neel, n_up0, n_dn0)}


def graded_breakdown(res, gm, vp, device):
    """Where a graded SR iteration's time goes: one real mc_energy_grad
    (the phase's MCParams without the warm-up, SR buffers) and
    sr_natural_gradient on the optimized state and final configurations,
    with the functions the evaluator calls wrapped where it looks them up:
    the sweep (fermion.sweep.mc_sweep_fermion_shared), the local energy
    and holes (fermion.vmc.graded_energy_and_holes) and inside it the holes
    (fermion.vmc._holes: autograd through the top stack, undressed by K4)
    and the tables (fermion.tables.fermion_ratio_tables), and K2
    (mc_evaluator._center_scale). Each wrapper synchronizes the card and
    reads the host clock and the launch counters around its call. Parts
    are exclusive: "local_rest" is the local energy less its holes and
    tables (the dressed nets, the flipped top stack, the channel sums),
    "evaluator_rest" the evaluation less its sweep, local energies and K2.
    Returns the record."""
    import torch
    from peps_tpu_torch.algorithm import mc_evaluator
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.fermion import sweep as fsweep
    from peps_tpu_torch.fermion import tables as ftables
    from peps_tpu_torch.fermion import vmc as fvmc
    from peps_tpu_torch.kernels import col_transfer as k1
    from peps_tpu_torch.montecarlo.sweep import draw_uniforms
    from peps_tpu_torch.optimizer.optimizer import sr_natural_gradient
    tps, cfg = res.state, res.final_configs
    ly, lx = tps.shape[0], tps.shape[1]
    incl, counts = {}, {}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            c0 = fermion_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # a named range for scripts/profile_graded_holes.py's trace
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            incl[name] = incl.get(name, 0.0) + time.perf_counter() - t0
            c1 = fermion_counts()
            counts[name] = {k: counts.get(name, {}).get(k, 0) + c1[k] - c0[k]
                            for k in c1}
            return out
        return timed

    targets = ((fsweep, "mc_sweep_fermion_shared", "sweep"),
               (fvmc, "graded_energy_and_holes", "local"),
               (fvmc, "_holes", "holes"),
               (ftables, "fermion_ratio_tables", "tables"),
               (mc_evaluator, "_center_scale", "k2"))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    # every ColTransferFunction backward call, with the launches inside it
    bwd = {"calls": 0, "backward_launches": 0, "k1_launches": 0}
    real_backward = k1.ColTransferFunction.backward

    def counted_backward(ctx, g):
        c0 = fermion_counts()
        out = real_backward(ctx, g)
        c1 = fermion_counts()
        bwd["calls"] += 1
        bwd["backward_launches"] += c1["col_transfer_backward"] \
            - c0["col_transfer_backward"]
        bwd["k1_launches"] += c1["col_transfer_forward"] \
            - c0["col_transfer_forward"]
        return out
    gen = torch.Generator(device=device).manual_seed(8)
    mc = MCParams(num_samples=1, num_warmup_sweeps=0,
                  nchains=vp.mc.nchains, eval_chunk=vp.mc.eval_chunk)
    try:
        for mod, attr, name in targets:
            setattr(mod, attr, wrap(name, getattr(mod, attr)))
        k1.ColTransferFunction.backward = staticmethod(counted_backward)
        evaluate = wrap("evaluation", mc_evaluator.mc_energy_grad)
        ev, _, _ = evaluate(
            tps, cfg, gm, vp.chi, vp.trunc, mc,
            lambda: draw_uniforms(gen, cfg.shape[0], ly, lx, torch.float32,
                                  device), with_sr_buffers=True)
        wrap("sr_solve", sr_natural_gradient)(ev, vp.optimizer.algorithm,
                                               tps.shape)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        k1.ColTransferFunction.backward = staticmethod(real_backward)

    def less(name, *parts):
        return {"seconds": incl[name] - sum(incl[p] for p in parts),
                "launches": {k: counts[name][k]
                             - sum(counts[p][k] for p in parts)
                             for k in counts[name]}}

    parts = {n: {"seconds": incl[n], "launches": counts[n]}
             for n in ("sweep", "holes", "tables", "k2", "sr_solve")}
    parts["local_rest"] = less("local", "holes", "tables")
    parts["evaluator_rest"] = less("evaluation", "sweep", "local", "k2")
    total = incl["evaluation"] + incl["sr_solve"]
    rec = {"seconds_total": total,
           "evaluation_s": incl["evaluation"],
           "seconds": {k: v["seconds"] for k, v in parts.items()},
           "share": {k: v["seconds"] / total for k, v in parts.items()},
           "launches": {k: v["launches"] for k, v in parts.items()},
           "backward": bwd}
    log("fermions", step="graded_breakdown", **rec)
    if not (bwd["calls"] > 0 and bwd["backward_launches"] == bwd["calls"]
            and bwd["k1_launches"] == 0):
        fail(f"graded holes: {bwd['backward_launches']} backward launches "
             f"and {bwd['k1_launches']} K1 launches in {bwd['calls']} "
             "backward calls (one and none each expected)")
    return rec


def graded_precision(res, model, space, vp, device):
    """Phase 10 (b)'s holes in the regime it runs in (6x6, D=8, chi=32,
    sketch, where the edge rows' sketch Grams are rank deficient and held
    by the jitter) on the optimized state and final configurations: one
    mc_energy_grad with no sweep before its sample
    (sweeps_between_samples 0: E_loc and O of the same 32
    configurations, eval_chunk 8) and sr_natural_gradient (the phase's CG
    40, shift 1e-3), on the card in float32, in float64, and in float64
    with float32's sketch jitter (1e-5 relative in place of 1e-12;
    ``bmps._sketch_pinv_apply`` wrapped). The float32 energy, O buffer and
    SR direction are held against float64 at the same jitter (the
    derivative of the same map: float32 round-off only) within
    GRADED_F32_TOL; against float64 at its own jitter they are read, not
    gated (the jitter is the reference's own choice for each dtype). Also
    read: one graded sweep in each dtype on the same uniforms (drawn in
    float64, float32 takes them rounded), and how many chains end in other
    configurations."""
    import torch
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams, mc_energy_grad
    from peps_tpu_torch.contraction import bmps
    from peps_tpu_torch.fermion.sweep import mc_sweep_fermion_shared
    from peps_tpu_torch.fermion.vmc import GradedFermionModel
    from peps_tpu_torch.montecarlo.sweep import draw_uniforms
    from peps_tpu_torch.optimizer.optimizer import sr_natural_gradient
    tps, cfg = res.state, res.final_configs
    ly, lx = tps.shape[0], tps.shape[1]
    mc = MCParams(num_samples=1, num_warmup_sweeps=0,
                  sweeps_between_samples=0, nchains=vp.mc.nchains,
                  eval_chunk=vp.mc.eval_chunk)
    pinv = bmps._sketch_pinv_apply

    def evaluate(dt):
        gm = GradedFermionModel.from_model(model, space, dt, device)
        t0 = time.perf_counter()
        ev, _, _ = mc_energy_grad(tps.to(dt), cfg, gm, vp.chi, vp.trunc, mc,
                                  None, with_sr_buffers=True)
        nat, cg = sr_natural_gradient(ev, vp.optimizer.algorithm, tps.shape)
        torch.cuda.synchronize()
        return {"energy": ev.energy.double(), "e_samples": ev.e_samples,
                "o_samples": ev.o_samples, "sr_direction": nat,
                "cg": int(cg.iterations), "s": time.perf_counter() - t0}

    runs = {"float32": evaluate(torch.float32),
            "float64": evaluate(torch.float64)}
    try:
        bmps._sketch_pinv_apply = lambda a, w, eps_rel: pinv(a, w, 1e-5)
        runs["float64_jitter_1e-5"] = evaluate(torch.float64)
    finally:
        bmps._sketch_pinv_apply = pinv

    def diffs(x, y):
        x, y = runs[x], runs[y]
        d = {k: _rel_diff(x[k].to(y[k].dtype), y[k])
             for k in ("energy", "e_samples", "o_samples", "sr_direction")}
        d["o_samples_max_abs_rel"] = (
            (x["o_samples"].double() - y["o_samples"]).abs().max()
            / y["o_samples"].abs().max()).item()
        return d

    gated = diffs("float32", "float64_jitter_1e-5")
    uni = draw_uniforms(torch.Generator(device=device).manual_seed(9),
                        cfg.shape[0], ly, lx, torch.float64, device)
    swept = [mc_sweep_fermion_shared(tps.to(dt), space, cfg, vp.chi,
                                     vp.trunc, tuple(x.to(dt) for x in uni))[0]
             for dt in (torch.float32, torch.float64)]
    rec = {"lattice": [ly, lx], "D": tps.shape[3], "chi": vp.chi,
           "chains": cfg.shape[0],
           "rel_diff_same_jitter": gated, "tolerance": GRADED_F32_TOL,
           "rel_diff_own_jitter": diffs("float32", "float64"),
           "jitter_effect_float64": diffs("float64_jitter_1e-5", "float64"),
           "energy_per_site": {k: float(v["energy"]) / (ly * lx)
                               for k, v in runs.items()},
           "sweep_chains_differing": int((swept[0] != swept[1])
                                         .flatten(1).any(1).sum()),
           "cg_iterations": {k: v["cg"] for k, v in runs.items()},
           "seconds": {k: v["s"] for k, v in runs.items()}}
    log("fermions", step="graded_float32_vs_float64", **rec)
    bad = {k: v for k, v in gated.items()
           if k in GRADED_F32_TOL and not v <= GRADED_F32_TOL[k]}
    if bad:
        fail(f"graded float32 against float64 at float32's jitter at the "
             f"flagship's shape: {bad}")
    return rec


def phase_kernels_fermion(device):
    """Phase 2, the fermion slices' kernels: K4, K1's backward and K5."""
    import torch
    peak = peak_rates(device)
    gen = torch.Generator(device=device).manual_seed(4321)
    return {"fermion_dress": k4_phase(device, gen),
            "col_transfer_backward": k1_backward_phase(device, peak, gen),
            "bmps_overlap": k5_phase(device, peak, gen)}


def k5_phase(device, peak, gen):
    """Phase 2, K5 (bmps_overlap): the column walker's closures at the
    flagship's per-k shape (8 configurations x 5 start bonds x 6 columns
    x 4 closures, Lx = 6, chi = 32, D = 8; b broadcast over the start
    bonds) in all four dtypes against the plain version (the reference's
    scan of one einsum, a norm and a divide per column), timed in turns
    with it. The bound is the larger of 2 Lx chi^3 D multiply-adds an item
    (4 real FMAs a complex one) over the FP32 or DMMA peak and the
    distinct bytes read (a broadcast operand once) and written over
    3.35 TB/s; no single PyTorch call computes the scan (library_ms null).
    Returns the record of float32."""
    import torch
    from peps_tpu_torch.kernels import bmps_overlap as k5
    nc, nb, lx, chi, D = 8, 5, FLAG["L"], FLAG["chi"], FLAG["D"]
    rec = None
    for dt in ("float32", "float64", "complex64", "complex128"):
        dtype = getattr(torch, dt)
        real = torch.float32 if dt in ("float32", "complex64") \
            else torch.float64
        a = torch.randn(nc, nb, lx, 4, lx, chi, D, chi, generator=gen,
                        device=device, dtype=real)
        b = torch.randn(nc, 1, lx, 4, lx, chi, D, chi, generator=gen,
                        device=device, dtype=real)
        if dtype.is_complex:
            a = torch.complex(a, torch.randn_like(a))
            b = torch.complex(b, torch.randn_like(b))
        mant, logw = k5.bmps_overlap(a, b)
        rm, rl = k5.bmps_overlap_plain(a, b)
        torch.cuda.synchronize()
        shift = rl.max()
        psi, ref = mant * torch.exp(logw - shift), rm * torch.exp(rl - shift)
        abs_err, rel = max_err(psi, ref)
        log_err = (logw - rl).abs().max().item()
        t = _in_turns({"kern": lambda: k5.bmps_overlap(a, b),
                       "plain": lambda: k5.bmps_overlap_plain(a, b)}, 5)
        items = mant.numel()
        flops = 2 * 2 * lx * chi ** 3 * D * items * (4 if dtype.is_complex
                                                     else 1)
        rate = peak["fp32_flops" if real == torch.float32 else "fp64_flops"]
        nbytes = (a.numel() + b.numel() + mant.numel()) * a.element_size() \
            + logw.numel() * logw.element_size()
        bound_ms = max(flops / rate, nbytes / HBM_BPS) * 1e3
        bound_by = "operations" if flops / rate >= nbytes / HBM_BPS \
            else "bytes"
        meta = k5.launch_meta(a, b)[3]
        r = {"kernel": "bmps_overlap", "case": "colshared_step",
             "dtype": dt, "batch": list(mant.shape), "items": items,
             "plan": dict(zip(("body", "lanes", "nbuf", "vec", "chi_p",
                               "smem_bytes"), meta[-6:])),
             "rel_err": rel, "max_abs_err": abs_err, "log_weight_err": log_err,
             "ms": t["kern"], "plain_ms": t["plain"], "flops": flops,
             "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
             "pct_of_bound": 100 * bound_ms / t["kern"], "library_ms": None}
        log("kernels_fermion", **r)
        if not (rel <= TOL[dt] and log_err <= 10 * TOL[dt] * lx):
            fail(f"bmps_overlap {dt}: rel err {rel}, log-weight err "
                 f"{log_err} > {TOL[dt]}")
        if dt == "float32":
            rec = r
        del a, b, mant, logw, rm, rl
    return rec


def timed_parts(targets):
    """Wrap each (module, attribute, name) of targets where its callers
    look it up: every call synchronizes the card and adds its host seconds
    and its launches (fermion_counts) to the name's entry. Returns
    (seconds {name: [per call]}, launches {name: {kernel: n}}, restore)."""
    import torch
    secs, counts = {}, {}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def wrap(name, fn):
        def timed(*args, **kwargs):
            c0 = fermion_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs.setdefault(name, []).append(time.perf_counter() - t0)
            c1 = fermion_counts()
            counts[name] = {k: counts.get(name, {}).get(k, 0) + c1[k] - c0[k]
                            for k in c1}
            return out
        return timed

    for mod, attr, name in targets:
        setattr(mod, attr, wrap(name, getattr(mod, attr)))

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return secs, counts, restore


def make_adjacent(cfg):
    """Move the second hole of one configuration next to the first (swap
    contents), as examples/flagship_pc_cond.py starts its conditioned
    chains."""
    import numpy as np
    cfg = np.array(cfg)
    holes = np.argwhere(cfg == 0)
    if len(holes) != 2:
        return cfg
    (y0, x0), (y1, x1) = holes
    if max(abs(y0 - y1), abs(x0 - x1)) <= 1:
        return cfg
    ty, tx = (y0, x0 + 1) if x0 + 1 < cfg.shape[1] else (y0, x0 - 1)
    cfg[y1, x1], cfg[ty, tx] = cfg[ty, tx], cfg[y1, x1]
    return cfg


def fermion_measure_flagship(f, device):
    """Phase 11 (a): measure() of phase 10 (b)'s optimized graded 6x6
    state and final configurations with the pair walkers, the split of its
    sample steps timed inside the call. Returns the launches inside it."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm import measure as meas
    from peps_tpu_torch.algorithm import measure_fermion as mf
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.fermion import sweep as fsweep
    from peps_tpu_torch.montecarlo.sweep import UpdateRule

    res, gm, vp, e_neel, n_up0, n_dn0 = f["flagship"]
    L = FLAG["L"]
    n = L * L
    p = FMEAS
    params = MeasurementParams(
        num_samples=p["samples"], num_warmup_sweeps=p["warmup"],
        nchains=FLAG["nchains"], chunk_size=p["chunk"],
        eval_chunk=FLAG["chunk"], env_chunk=p["env_chunk"],
        measure_pair_corr=True)
    seen = []
    sweep_fn = fsweep.mc_sweep_fermion_shared

    def sweep_and_record(*args, **kwargs):
        out = sweep_fn(*args, **kwargs)
        c = out[0]
        seen.append(torch.stack([(c == s).sum((1, 2)) for s in range(3)])
                    .cpu())
        return out

    fsweep.mc_sweep_fermion_shared = sweep_and_record
    secs, counts, restore = timed_parts((
        (fsweep, "mc_sweep_fermion_shared", "sweep"),
        (meas, "_energy_pass", "energy_pass"),
        (mf, "graded_env_shared", "env_build"),
        (mf, "tj_singlet_pair_corr_graded_rowshared", "row_walker"),
        (mf, "tj_singlet_pair_corr_graded_colshared", "col_walker")))
    try:
        read = fermion_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = measure(res.state, gm, params, vp.chi, vp.trunc, UpdateRule(),
                      res.final_configs,
                      generator=torch.Generator(device=device).manual_seed(17))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    finally:
        restore()
        fsweep.mc_sweep_fermion_shared = sweep_fn
    s = p["samples"]
    per_step = {
        "sweep": sum(secs["sweep"][p["warmup"]:]) / s,
        "energy_pass": (sum(secs["energy_pass"]) - sum(secs["env_build"]))
        / s,
        "env_build": sum(secs["env_build"]) / s,
        "row_walker": sum(secs["row_walker"]) / s,
        "col_walker": sum(secs["col_walker"]) / s}
    step_s = out.sampling_wall_s / s
    per_step["rest"] = step_s - sum(per_step.values())
    samples = FLAG["nchains"] * s
    st = out.stats
    e = float(st["energy"][0]) / n
    counts_ok = all(bool(torch.all(c == torch.tensor([[n - n_up0 - n_dn0],
                                                      [n_up0], [n_dn0]])))
                    for c in seen)
    sums = {k: float(np.sum(st[k][0])) for k in ("n_up", "n_dn",
                                                 "hole_density")}
    nb = L - 1
    near = np.abs(np.subtract.outer(np.arange(nb), np.arange(nb))) <= 1
    tables = {k: st[k][0] for k in ("pair_corr_row", "pair_corr_col")}
    log("fermion_measure", step="flagship", lattice=[L, L], D=FLAG["D"],
        chi=FLAG["chi"], chains=FLAG["nchains"], samples=s,
        warmup_sweeps=p["warmup"], chunk_size=p["chunk"],
        eval_chunk=FLAG["chunk"], env_chunk=p["env_chunk"],
        sampling_wall_s=out.sampling_wall_s,
        samples_per_s=samples / out.sampling_wall_s,
        energy_per_site=e,
        energy_stderr_per_site=float(st["energy"][1]) / n,
        accept_rate=out.accept_rate, sums=sums,
        every_sweep_keeps_numbers=counts_ok,
        pair_corr_row_max_abs=float(np.abs(tables["pair_corr_row"]).max()),
        pair_corr_col_max_abs=float(np.abs(tables["pair_corr_col"]).max()),
        launches=launches, peak_mem_GB=peak_gb, phase_wall_s=wall)
    # a sample step's launches: one sweep (the sweeps' mean) plus the
    # energy pass (the env build inside it) and both walkers of a step
    per_step_launches = {
        k: counts["sweep"][k] / len(secs["sweep"])
        + sum(counts[part][k] for part in ("energy_pass", "row_walker",
                                           "col_walker")) / s
        for k in counts["sweep"]}
    log("fermion_measure", step="flagship_step_split",
        step_s=step_s, seconds=per_step,
        share={k: v / step_s for k, v in per_step.items()},
        calls={k: len(v) for k, v in secs.items()}, launches=counts,
        launches_per_step=per_step_launches,
        launches_per_step_total=sum(per_step_launches.values()))
    finite = all(np.all(np.isfinite(v)) for pair in st.values() for v in pair)
    if not finite:
        fail("fermion measure: non-finite statistics")
    if not -1.35 < e < e_neel:
        fail(f"fermion measure: E/site {e} outside (-1.35, {e_neel})")
    if not (counts_ok and sums == {"n_up": float(n_up0),
                                   "n_dn": float(n_dn0),
                                   "hole_density": float(n - n_up0 - n_dn0)}):
        fail(f"fermion measure: numbers not kept: {sums}, every sweep "
             f"{counts_ok}")
    for k, tab in tables.items():
        if not (tab.shape == (L, nb, nb) and np.all(tab[:, near] == 0)):
            fail(f"fermion measure: {k} {tab.shape} nonzero at |i-k| <= 1")
    missing = [k for k in ("col_transfer_forward", "pair_transfer",
                           "fermion_dress", "bmps_overlap")
               if launches[k] == 0]
    if missing:
        fail(f"fermion measure: kernels not launched: {missing}")
    return launches


def fermion_measure_conditioned(f, device):
    """Phase 11 (b): the support-conditioned estimator at 6x6: the count
    of A (holes Chebyshev-adjacent) over unconditioned sweeps of the 32
    chains, then 8 chains moved into A and swept under the hard hole-
    attraction dress with both pair tables per sample; A must hold in
    every chain after every sweep. Returns the launches of the
    conditioned run."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm import measure_fermion as mf

    res, gm, vp, *_ = f["flagship"]
    p = FMEAS
    gen = torch.Generator(device=device).manual_seed(31)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, inds = mf.count_adjacent(res.state, gm.space, res.final_configs,
                                vp.chi, vp.trunc, p["count_sweeps"], gen)
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t0
    starts = np.stack([make_adjacent(c) for c in
                       res.final_configs[:p["cond_chains"]].cpu().numpy()])
    read = fermion_counters()
    t0 = time.perf_counter()
    cfgs, tabs, ind = mf.conditioned_pair_tables(
        res.state, gm.space, torch.as_tensor(starts, device=device), vp.chi,
        vp.trunc, p["cond_warmup"], p["cond_samples"], gen,
        env_chunk=p["env_chunk"])
    torch.cuda.synchronize()
    t_cond = time.perf_counter() - t0
    launches = read()
    finite = all(bool(torch.isfinite(v).all()) for v in tabs.values())
    held = bool((ind > 0.5).all())
    pa = float(inds.mean())
    log("fermion_measure", step="conditioned", count_chains=inds.shape[1],
        count_sweeps=inds.shape[0], p_adjacent=pa, count_s=t_count,
        chains=len(starts), warmup_sweeps=p["cond_warmup"],
        samples=p["cond_samples"], adjacency_held=held, finite=finite,
        estimate_row_max_abs=pa * float(tabs["row"].mean((0, 1)).abs().max()),
        estimate_col_max_abs=pa * float(tabs["col"].mean((0, 1)).abs().max()),
        seconds=t_cond, launches=launches)
    if not (held and finite):
        fail(f"conditioned chains: adjacency held {held}, finite {finite}")
    return launches


def fermion_measure_card_vs_cpu(device):
    """Phase 11 (c): the graded walkers and the exact sector sum on the
    card against the CPU in float64 and complex128 within 1e-10: both
    walkers on one GradedEnvShared of 8 configurations of a seeded 4x4,
    D = 4 graded t-J state (4 holes, configurations with support drawn
    from a seeded pool) at chi = 6 (FERMION_CARD_CPU_CHI), and
    exact_sum_pair_corr_graded on a seeded 2x4 ladder (3 up, 3 down, 2
    holes)."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm import measure_fermion as mf
    from peps_tpu_torch.algorithm.exact_measure import (
        _pair_corr_support, exact_sum_pair_corr_graded)
    from peps_tpu_torch.algorithm.exact_sum import sector_configs
    from peps_tpu_torch.fermion.graded import GT, parity_mask
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.lattice import boundary_mask
    from peps_tpu_torch.linalg import TruncParams

    chi, dd = FERMION_CARD_CPU_CHI, SMALL["D"]
    sp = FermionSpace((0, 1, 1), dd // 2, dd // 2)
    pm = parity_mask(GT(torch.zeros((3,) + (dd,) * 4),
                        (sp.phys_parity,) + (sp.bond_parity,) * 4,
                        (False, True, True, False, False)))
    rng = np.random.default_rng(111)
    trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")

    def state(ly, lx, dt):
        shape = (ly, lx, 3) + (dd,) * 4
        a = rng.standard_normal(shape)
        if dt == "complex128":
            a = a + 1j * rng.standard_normal(shape)
        return a * pm * boundary_mask(ly, lx, 3, dd)

    ly, lx, nc = SMALL["ly"], SMALL["lx"], SMALL["nchains"]
    base = np.array([0] * 4 + [1] * 6 + [2] * 6)
    pool = np.stack([rng.permutation(base).reshape(ly, lx)
                     for _ in range(400)])
    ok = _pair_corr_support(pool) & _pair_corr_support(pool.swapaxes(1, 2))
    cfg = pool[np.nonzero(ok)[0][:nc]]
    ladder = sector_configs(2, 4, {0: 2, 1: 3, 2: 3})
    launches = {}
    for dt in ("float64", "complex128"):
        a, lad = state(ly, lx, dt), state(2, 4, dt)
        runs = {}
        for where in ("cpu", device):
            read = fermion_counters()
            t0 = time.perf_counter()
            tt = torch.as_tensor(a, device=where)
            c = torch.as_tensor(cfg, device=where)
            shared = mf.graded_env_shared(tt, c, sp, chi, trunc)
            row = mf.tj_singlet_pair_corr_graded_rowshared(tt, c, sp, chi,
                                                           trunc, shared)
            col = mf.tj_singlet_pair_corr_graded_colshared(tt, c, sp, chi,
                                                           trunc, shared)
            ex, z = exact_sum_pair_corr_graded(
                torch.as_tensor(lad, device=where), ladder, sp, chi, trunc)
            runs[str(where) if where == "cpu" else "card"] = (
                row.cpu(), col.cpu(), ex, z, time.perf_counter() - t0)
            if where != "cpu":
                launches[dt] = read()
        (rc, cc, exc, zc, sc), (rg, cg, exg, zg, sg) = runs["cpu"], \
            runs["card"]
        diffs = {"pair_corr_row": _rel_diff(rg, rc),
                 "pair_corr_col": _rel_diff(cg, cc),
                 "exact_row": _rel_diff(torch.as_tensor(exg["row"]),
                                        torch.as_tensor(exc["row"])),
                 "exact_col": _rel_diff(torch.as_tensor(exg["col"]),
                                        torch.as_tensor(exc["col"])),
                 "weight_sum": abs(zg / zc - 1)}
        log("fermion_measure", step="card_vs_cpu", dtype=dt,
            lattice=[ly, lx], D=dd, chi=chi, configurations=len(cfg),
            ladder_sector=len(ladder), rel_diff=diffs,
            max_abs={"row": float(rc.abs().max()),
                     "col": float(cc.abs().max()),
                     "exact_row": float(np.abs(exc["row"]).max()),
                     "exact_col": float(np.abs(exc["col"]).max())},
            cpu_s=sc, card_s=sg, launches=launches[dt])
        if not all(v <= 1e-10 for v in diffs.values()):
            fail(f"fermion measurement {dt} card against CPU: {diffs}")
    return launches


def fermion_measure_jw(f, device):
    """Phase 11 (d): Jordan-Wigner measure(): a t-J state (seeded 2x4,
    D = 4, chi = 16, 16 chains, exchange) with the pair correlators of
    both frames, and phase 10 (a)'s Hubbard state and final
    configurations (Suwa-Todo with the conservation mask); 4 samples
    each. Checks: finite statistics, N_up and N_dn kept (the sums of the
    density maps). Returns the launches of both."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import fermion
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.tps import random_tps

    hub_res, hub, hub_params = f["hubbard"]
    gen = torch.Generator(device=device).manual_seed(41)
    ly, lx = 2, 4
    tj = fermion.tj_model(3.0, 1.0)
    tps = random_tps(gen, ly, lx, 3, 4, torch.float32, scale=0.5,
                     device=device)
    base = torch.tensor([0, 0, 1, 1, 1, 2, 2, 2], device=device)
    cfg = torch.stack([base[torch.randperm(ly * lx, generator=gen,
                                           device=device)]
                       for _ in range(16)]).reshape(16, ly, lx)
    runs = (("jw_tj", tps, tj, cfg, UpdateRule("exchange"),
             TruncParams(16, 1, 1e-8, scheme="sketch"), (3, 3)),
            ("jw_hubbard", hub_res.state, hub, hub_res.final_configs,
             hub_params.rule, hub_params.trunc,
             (HUBBARD["ly"] * HUBBARD["lx"] // 4,) * 2))
    launches = {}
    for name, state, model, configs, rule, trunc, (nu, nd) in runs:
        read = fermion_counters()
        t0 = time.perf_counter()
        out = measure(state, model, MeasurementParams(
            num_samples=4, num_warmup_sweeps=2, nchains=configs.shape[0],
            chunk_size=2, measure_pair_corr=True), trunc.d_max, trunc, rule,
            configs, generator=torch.Generator(device=device).manual_seed(5))
        torch.cuda.synchronize()
        launches[name] = read()
        st = out.stats
        sums = {k: float(np.sum(st[k][0])) for k in ("n_up", "n_dn")}
        finite = all(np.all(np.isfinite(v)) for p in st.values() for v in p)
        log("fermion_measure", step=name, lattice=list(state.shape[:2]),
            chains=configs.shape[0], keys=sorted(st),
            energy_per_site=float(st["energy"][0]) / (state.shape[0]
                                                      * state.shape[1]),
            sums=sums, finite=finite, accept_rate=out.accept_rate,
            sampling_wall_s=out.sampling_wall_s,
            seconds=time.perf_counter() - t0, launches=launches[name])
        if not (finite and abs(sums["n_up"] - nu) < 1e-4
                and abs(sums["n_dn"] - nd) < 1e-4):
            fail(f"{name} measure: finite {finite}, sums {sums}, expected "
                 f"{nu}, {nd}")
        if name == "jw_tj" and not {"pair_corr_row",
                                    "pair_corr_col"} <= set(st):
            fail(f"jw_tj measure: no pair correlators in {sorted(st)}")
    return launches


def phase_fermion_measure(f, device):
    """Phase 11: fermion measurement. (a) measure() of phase 10 (b)'s
    state, (b) the conditioned estimator, (c) the card against the CPU,
    (d) Jordan-Wigner measure(). Returns the launches of (a)."""
    launches = fermion_measure_flagship(f, device)
    fermion_measure_conditioned(f, device)
    fermion_measure_card_vs_cpu(device)
    fermion_measure_jw(f, device)
    return launches


# ---------------------------------------------------------------------------
# the torus: phase 12
# ---------------------------------------------------------------------------

def dense_hamiltonian_pbc(mt, ly, lx):
    """Dense H [d^N, d^N] of a bosonic model (numpy ModelTensors entries)
    on the torus, over the bonds the PBC local energy sums
    (energy_pbc.pbc_bonds) and the one-site term: <c|H|c'> as E_loc reads
    it."""
    import numpy as np
    import itertools
    from peps_tpu_torch.algorithm.energy_pbc import pbc_bonds
    d = (mt.h_h if mt.h_h is not None else mt.h_site).shape[0]
    n = ly * lx
    cfgs = list(itertools.product(range(d), repeat=n))
    index = {c: i for i, c in enumerate(cfgs)}
    h = np.zeros((len(cfgs), len(cfgs)))
    terms = [(np.asarray(t), pbc_bonds(ly, lx, kind).numpy())
             for t, kind in ((mt.h_h, "h"), (mt.h_v, "v"), (mt.h_d, "d"),
                             (mt.h_ad, "ad")) if t is not None]
    for i, c in enumerate(cfgs):
        for t, bonds in terms:
            for y1, x1, y2, x2 in bonds:
                s1, s2 = y1 * lx + x1, y2 * lx + x2
                for p in range(d):
                    for q in range(d):
                        c2 = list(c)
                        c2[s1], c2[s2] = p, q
                        h[i, index[tuple(c2)]] += t[c[s1], c[s2], p, q]
        if mt.h_site is not None:
            hs = np.asarray(mt.h_site)
            for s_ in range(n):
                for p in range(d):
                    c2 = list(c)
                    c2[s_] = p
                    h[i, index[tuple(c2)]] += hs[c[s_], p]
    return h, np.array(cfgs).reshape(-1, ly, lx)


def pbc_su_state(device):
    """Phase 12 (a): the 4x4 Heisenberg torus SU from the Neel state at
    examples/heisenberg_pbc_vmc.py's width (D=3, tau 0.2 then 0.05,
    energy_abs_tol 1e-8), 40 + 40 steps; then to_tps_pbc in float32,
    scaled to max |T| = 1. Returns the TPS."""
    import numpy as np
    import torch
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.peps import (SimpleUpdateParams, product_peps_pbc,
                                     simple_update, to_tps_pbc)
    L, D = PBC["L"], PBC["D"]
    model = spin.heisenberg(1.0)
    peps = product_peps_pbc(L, L, D, np.indices((L, L)).sum(0) % 2, 2,
                            dtype=torch.float32, device=device)
    stamps, stages = [], []

    def observe(step, e0, en, trunc_err):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    read = fermion_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for steps, tau in PBC["su"]:
        out = simple_update(peps, model.h_h, model.h_v, SimpleUpdateParams(
            steps, tau, TruncParams(D, 1, 1e-10), energy_abs_tol=1e-8),
            step_observer=observe)
        peps = out.peps
        stages.append({"tau": tau, "steps": out.executed_steps,
                       "estimated_e0_per_site": out.estimated_e0 / L ** 2})
    torch.cuda.synchronize()
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    e_site = out.estimated_e0 / L ** 2
    log("pbc", step="su", lattice=[L, L], D=D, stages=stages,
        seconds=time.perf_counter() - t0,
        seconds_per_su_step=sum(steps_s) / max(len(steps_s), 1),
        neel_energy_per_site=-0.5, launches=read(),
        peak_mem_GB=torch.cuda.max_memory_allocated(device) / 1e9)
    if not (math.isfinite(e_site) and e_site < -0.5):
        fail(f"pbc SU: estimated e0 per site {e_site}, not below the Neel "
             "state's -0.5")
    tps = to_tps_pbc(peps).to(torch.float32)
    return tps / tps.abs().max()


def pbc_energies(tps, device):
    """Phase 12 (b): local_energy_and_holes_pbc of 8 and 32 Sz = 0
    configurations (init_configs_occupancy, not drawn from |psi|^2: their
    mean E_loc is a number, not an energy) at chi=12 under the fast scheme
    (one power iteration) and the svd scheme; seconds per evaluation
    (one warm call first), peak memory, launches; E_loc and holes finite."""
    import torch
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.energy_pbc import \
        local_energy_and_holes_pbc
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.engine import init_configs_occupancy
    L, chi = PBC["L"], PBC["chi"]
    mt = ModelTensors.from_model(spin.heisenberg(1.0), tps.dtype, device)
    gen = torch.Generator(device=device).manual_seed(12)
    half = L * L // 2
    out = {}
    for scheme, nconfs in (("fast", PBC["nconf"]), ("svd", PBC["svd_nconf"])):
        trunc = TruncParams(chi, 1, 1e-6, scheme=scheme, rsvd_power=1)
        for nc in nconfs:
            cfg = init_configs_occupancy(gen, nc, L, L, {0: half, 1: half},
                                         device)
            if nc == nconfs[0]:
                local_energy_and_holes_pbc(tps, cfg, mt, chi, trunc)
            read = fermion_counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res = local_energy_and_holes_pbc(tps, cfg, mt, chi, trunc)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            finite = bool(torch.isfinite(res.e_loc).all()
                          and torch.isfinite(res.o_tensor).all())
            log("pbc", step="local_energy", scheme=scheme, configurations=nc,
                chi=chi, dtype=str(tps.dtype).replace("torch.", ""),
                seconds_per_evaluation=sec, seconds_per_configuration=sec / nc,
                mean_e_loc_per_site=float(res.e_loc.mean()) / L ** 2,
                finite=finite, launches=read(),
                peak_mem_GB=torch.cuda.max_memory_allocated(device) / 1e9)
            if not finite:
                fail(f"pbc local energy ({scheme}, {nc} configurations): "
                     "non-finite E_loc or holes")
            out[(scheme, nc)] = (cfg, res, sec)
    return out


def pbc_card_vs_cpu(tps, cfg, device):
    """Phase 12 (c): the float64 torus local energy of the same state and
    configurations on the card and on the CPU (the same default test
    matrix): amplitudes (log|psi| and the mantissa's sign), holes (O) and
    E_loc within 1e-8 relative."""
    import torch
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.energy_pbc import \
        local_energy_and_holes_pbc
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    chi = PBC["chi"]
    trunc = TruncParams(chi, 1, 1e-6, scheme="fast", rsvd_power=1)
    card, cpu = (local_energy_and_holes_pbc(
        tps.double().to(where), cfg.to(where), ModelTensors.from_model(
            spin.heisenberg(1.0), torch.float64, where), chi, trunc)
        for where in (device, torch.device("cpu")))
    errs = {"log_abs_psi": float((card.log_abs_psi.cpu() - cpu.log_abs_psi)
                                 .abs().max()),
            "e_loc": _rel_diff(card.e_loc.cpu(), cpu.e_loc),
            "o": _rel_diff(card.o_tensor.cpu(), cpu.o_tensor)}
    signs = bool(torch.equal(torch.sign(card.psi_mant.cpu()),
                             torch.sign(cpu.psi_mant)))
    log("pbc", step="card_vs_cpu", configurations=cfg.shape[0], chi=chi,
        dtype="float64", errors=errs, signs_equal=signs)
    if not (signs and all(v < 1e-8 for v in errs.values())):
        fail(f"pbc card vs CPU: {errs}, signs equal {signs}")


def pbc_tfim_exact(device):
    """Phase 12 (d): examples/tfim_pbc_trg.py at its width (2x2 torus TFIM
    J=1, h=3, D=2, chi=16, float64): 20 SR iterations (CG 200, tol 1e-8,
    shift 1e-3, lr 0.1) of iterative_optimize over
    exact_sum_evaluation(bc=PERIODIC); the final state's exact-sum energy
    against ED of the same state (its dense wave function from the exact
    torus contraction) within 1e-6, and the ED ground energy printed."""
    import numpy as np
    import torch
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.exact_sum import (
        all_configs, exact_sum_energy_gradient, exact_sum_evaluation)
    from peps_tpu_torch.lattice import BoundaryCondition
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import (OptimizerParams,
                                                    SRParams,
                                                    iterative_optimize)
    from peps_tpu_torch.tps import exact_contract_pbc, random_tps
    p = TFIM_PBC
    n, pbc_bc = p["L"], BoundaryCondition.PERIODIC
    model = spin.transverse_field_ising(1.0, 3.0)
    configs = all_configs(n, n, 2)
    trunc = TruncParams(p["chi"], 1, 0.0)
    tps = random_tps(torch.Generator().manual_seed(0), n, n, 2, p["D"],
                     dtype=torch.float64, bc=pbc_bc, scale=0.5,
                     device="cpu").to(device)

    def evaluate(state, step):
        return exact_sum_evaluation(state, configs, model, p["chi"], trunc,
                                    with_sr_buffers=True, bc=pbc_bc)

    params = OptimizerParams(p["iters"], SRParams(CGParams(p["cg"], 1e-8),
                                                  1e-3), lr=p["lr"])
    read = fermion_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = iterative_optimize(tps, evaluate, params)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    state = res.state
    e_sum = float(exact_sum_energy_gradient(state, configs, model, p["chi"],
                                            trunc, with_grad=False,
                                            bc=pbc_bc).energy)
    mt = ModelTensors.from_model(model, torch.float64, "cpu")
    h, cfgs = dense_hamiltonian_pbc(mt, n, n)
    st = state.cpu().numpy()
    psi = np.array([exact_contract_pbc(st[np.arange(n)[:, None],
                                          np.arange(n)[None, :], c])
                    for c in cfgs])
    e_ed_state = float(psi @ h @ psi / (psi @ psi))
    e_ground = float(np.linalg.eigvalsh(h)[0])
    log("pbc", step="tfim_exact_sr", lattice=[n, n], D=p["D"], chi=p["chi"],
        iterations=len(res.energies), energies=[float(e) for e in
                                                res.energies],
        lowest_energy=float(res.lowest_energy), seconds=sec,
        seconds_per_iteration=sec / max(len(res.energies), 1),
        exact_sum_energy=e_sum, ed_energy_of_state=e_ed_state,
        ed_ground_energy=e_ground, launches=read())
    if abs(e_sum - e_ed_state) > 1e-6 * max(1.0, abs(e_ed_state)):
        fail(f"pbc TFIM: exact-sum energy {e_sum} against ED of the state "
             f"{e_ed_state}")


def pbc_contract_exact(device):
    """Phase 12 (e): contract_pbc of a random 4x4 D=2 torus network in
    float64 on the card, both schemes at chi=16 (every bond's rank),
    against exact_contract_pbc within 1e-10."""
    import numpy as np
    import torch
    from peps_tpu_torch.contraction.pbc import contract_pbc
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.tps import exact_contract_pbc
    tn = np.random.default_rng(44).normal(size=(4, 4, 2, 2, 2, 2)) * 0.5
    want = exact_contract_pbc(tn)
    errs = {}
    for scheme in ("svd", "fast"):
        m, lw = contract_pbc(torch.as_tensor(tn, device=device), 16,
                             TruncParams(16, 1, 0.0, scheme=scheme,
                                         rsvd_power=1))
        got = float(m) * math.exp(float(lw))
        errs[scheme] = abs(got - want) / abs(want)
    log("pbc", step="contract_vs_exact", lattice=[4, 4], D=2, chi=16,
        relative_errors=errs)
    if not all(v < 1e-10 for v in errs.values()):
        fail(f"pbc contract_pbc against the exact torus contraction: {errs}")


def phase_pbc(device):
    """Phase 12: the torus ((a)-(e) above). Returns the launches of every
    hand kernel over the phase (the torus runs on torch's products and
    factorizations alone) and (a)'s state, which phase 13 samples."""
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    read = fermion_counters()
    tps = pbc_su_state(device)
    energies = pbc_energies(tps, device)
    pbc_card_vs_cpu(tps, energies[("fast", PBC["card_cpu_nconf"])][0], device)
    add(read())
    read = fermion_counters()
    pbc_tfim_exact(device)
    pbc_contract_exact(device)
    add(read())
    log("pbc", step="launches", launches=totals)
    return totals, tps


def _torus_setup():
    """Phase 13's model, chi, truncation (the example's) and boundary."""
    from peps_tpu_torch.lattice import BoundaryCondition
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    chi = PBC["chi"]
    return (spin.heisenberg(1.0), chi,
            TruncParams(chi, 1, 1e-6, scheme="fast", rsvd_power=1),
            BoundaryCondition.PERIODIC)


def pbc_sampler_vmc(tps, device):
    """Phase 13 (a): vmc_optimize(bc=PERIODIC) from phase 12's state (see
    PBC_SAMPLER): seconds of each iteration (the first also holds the
    state normalization and the warm-up), E/site of each iteration in
    (-0.75, -0.60) (the SU estimate of the state is -0.667, the 4x4 torus
    ED -0.7018), acceptance in (0, 1), Sz kept in every chain, K2
    launched. Returns (final state, launches)."""
    import torch
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
    p, L = PBC_SAMPLER, PBC["L"]
    model, chi, trunc, bc = _torus_setup()
    params = VMCParams(
        chi, trunc, MCParams(num_samples=p["samples"],
                             num_warmup_sweeps=p["warmup"],
                             nchains=p["nchains"]),
        OptimizerParams(p["iters"], SRParams(CGParams(p["cg"], 1e-5),
                                             diag_shift=1e-3), lr=p["lr"]),
        rule=UpdateRule("exchange"),
        occupancy=((0, L * L // 2), (1, L * L - L * L // 2)), bc=bc)
    stamps = []

    def observe(rec, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gen = torch.Generator(device=device).manual_seed(13)
    read = fermion_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = vmc_optimize(tps, model, params, generator=gen, callback=observe)
    torch.cuda.synchronize()
    launches = read()
    seconds = [b - a for a, b in zip([t0] + stamps, stamps)]
    e_site = [e / L ** 2 for e in res.energies]
    accept = [r.accept_rate for r in res.records]
    sz = res.final_configs.sum((1, 2)).tolist()
    log("pbc_sampler", step="vmc", lattice=[L, L], D=PBC["D"], chi=chi,
        dtype=str(tps.dtype).replace("torch.", ""), nchains=p["nchains"],
        warmup_sweeps=p["warmup"], samples=p["samples"],
        iterations=len(res.energies), energies_per_site=e_site,
        energy_errors=[r.energy_error for r in res.records],
        accept_rates=accept, sr_iters=[r.sr_iters for r in res.records],
        eval_seconds=[r.eval_seconds for r in res.records],
        update_seconds=[r.update_seconds for r in res.records],
        iteration_seconds=seconds,
        seconds_per_iteration_after_first=(sum(seconds[1:])
                                           / max(len(seconds) - 1, 1)),
        launches=launches,
        peak_mem_GB=torch.cuda.max_memory_allocated(device) / 1e9)
    if not all(-0.75 < e < -0.60 for e in e_site):
        fail(f"pbc VMC: E/site {e_site} outside (-0.75, -0.60)")
    if not all(0 < a < 1 for a in accept):
        fail(f"pbc VMC: acceptance {accept} outside (0, 1)")
    if sz != [L * L // 2] * p["nchains"]:
        fail(f"pbc VMC: the chains' particle counts {sz} moved")
    if launches["centered_o"] == 0:
        fail("pbc VMC: the SR buffer did not go through K2")
    return res.state, launches


def pbc_sampler_measure(state, device):
    """Phase 13 (b): measure(bc=PERIODIC) of the optimized state: 8 chains
    (PBC_SAMPLER), samples/s and sampling_wall_s; E/site in (-0.75, -0.60)
    as in (a), |sum <Sz>| < 1e-5 and the nearest-neighbour <SzSz> of the
    torus below 0."""
    import torch
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.montecarlo.engine import init_configs_occupancy
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    p, L = PBC_SAMPLER, PBC["L"]
    model, chi, trunc, bc = _torus_setup()
    gen = torch.Generator(device=device).manual_seed(14)
    cfgs = init_configs_occupancy(gen, p["nchains"], L, L,
                                  {0: L * L // 2, 1: L * L - L * L // 2},
                                  device)
    mp = MeasurementParams(num_samples=p["measure_samples"],
                           num_warmup_sweeps=p["measure_warmup"],
                           nchains=p["nchains"], measure_offdiag_corr=False)
    read = fermion_counters()
    t0 = time.perf_counter()
    out = measure(state, model, mp, chi, trunc, UpdateRule("exchange"), cfgs,
                  generator=gen, bc=bc)
    seconds = time.perf_counter() - t0
    szsz = out.stats["szsz"][0]
    nn = [szsz[y * L + x, y * L + (x + 1) % L] for y in range(L)
          for x in range(L)]
    nn += [szsz[y * L + x, ((y + 1) % L) * L + x] for y in range(L)
           for x in range(L)]
    nn_szsz = float(sum(nn) / len(nn))
    sz_sum = float(out.stats["sz"][0].sum())
    e, err = out.stats["energy"]
    n = p["measure_samples"] * p["nchains"]
    log("pbc_sampler", step="measure", nchains=p["nchains"],
        warmup_sweeps=p["measure_warmup"], samples=p["measure_samples"],
        seconds=seconds, sampling_wall_s=out.sampling_wall_s,
        samples_per_s=n / out.sampling_wall_s,
        energy_per_site=float(e) / L ** 2,
        energy_error_per_site=float(err) / L ** 2,
        accept_rate=out.accept_rate, sz_sum=sz_sum, nn_szsz=nn_szsz,
        observables=sorted(out.stats), launches=read())
    if not -0.75 < float(e) / L ** 2 < -0.60:
        fail(f"pbc measure: E/site {float(e) / L ** 2} outside (-0.75, -0.60)")
    if not abs(sz_sum) < 1e-5:
        fail(f"pbc measure: sum <Sz> = {sz_sum}")
    if not nn_szsz < 0:
        fail(f"pbc measure: nearest-neighbour <SzSz> = {nn_szsz}")


def pbc_sampler_sweeps(tps, device):
    """Phase 13 (c): one sweep of 8 and of 32 chains (random Sz = 0
    configurations) of phase 12's state under the full recompute, the
    frozen trial and the exact trial sweeps: seconds and chain-sweeps/s
    each. Then, in float64 at 4x4 D=2 chi=16 (no truncation), the frozen
    and the full sweeps of 8 chains from the same uniforms reach the same
    configurations."""
    import torch
    from peps_tpu_torch.lattice import BoundaryCondition
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.montecarlo.engine import init_configs_occupancy
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.montecarlo.sweep_pbc import (draw_uniforms_pbc,
                                                     mc_sweep_pbc,
                                                     mc_sweep_pbc_trial)
    from peps_tpu_torch.tps import random_tps
    L = PBC["L"]
    _, chi, trunc, _ = _torus_setup()
    gen = torch.Generator(device=device).manual_seed(15)
    half = {0: L * L // 2, 1: L * L - L * L // 2}
    rule = UpdateRule("exchange")
    samplers = {
        "full": lambda t, c, u, x, tr: mc_sweep_pbc(t, c, x, tr, rule, u),
        "frozen": lambda t, c, u, x, tr: mc_sweep_pbc_trial(t, c, x, tr, rule,
                                                            u),
        "exact": lambda t, c, u, x, tr: mc_sweep_pbc_trial(t, c, x, tr, rule,
                                                           u, exact=True)}
    rates = {}
    for nc in PBC_SAMPLER["sweep_chains"]:
        cfg = init_configs_occupancy(gen, nc, L, L, half, device)
        u = draw_uniforms_pbc(gen, nc, L, L, tps.dtype, device)
        for name, sweep in samplers.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            out, st = sweep(tps, cfg, u, chi, trunc)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rates[f"{name}_{nc}"] = nc / sec
            log("pbc_sampler", step="sweep", sampler=name, nchains=nc,
                chi=chi, dtype=str(tps.dtype).replace("torch.", ""),
                seconds=sec, chain_sweeps_per_s=nc / sec,
                accept_rate=float(st.accepted.sum()
                                  / st.trials.sum().clamp(min=1)),
                peak_mem_GB=torch.cuda.max_memory_allocated(device) / 1e9)
            if not torch.equal(out.sum((1, 2)), cfg.sum((1, 2))):
                fail(f"pbc {name} sweep moved the particle count")
    q = PBC_SAMPLER["equal"]
    t64 = random_tps(torch.Generator(device=device).manual_seed(16), L, L, 2,
                     q["D"], dtype=torch.float64,
                     bc=BoundaryCondition.PERIODIC, scale=0.5, device=device)
    cfg = init_configs_occupancy(gen, 8, L, L, half, device)
    u = draw_uniforms_pbc(gen, 8, L, L, torch.float64, device)
    tr = TruncParams(q["chi"], 1, 0.0, scheme="fast", rsvd_power=1)
    full, fst = samplers["full"](t64, cfg, u, q["chi"], tr)
    frozen, tst = samplers["frozen"](t64, cfg, u, q["chi"], tr)
    same = bool(torch.equal(full, frozen)
                and torch.equal(fst.accepted, tst.accepted))
    log("pbc_sampler", step="frozen_equals_full", lattice=[L, L], D=q["D"],
        chi=q["chi"], dtype="float64", equal=same,
        accepted=int(fst.accepted.sum()))
    if not same or int(fst.accepted.sum()) == 0:
        fail("pbc sweeps: the frozen trial sweep left the full recompute's "
             "trajectories at a chi that does not truncate")
    return rates


def pbc_sampler_card_vs_cpu(tps, device):
    """Phase 13 (d): one mc_energy_grad(bc=PERIODIC) with SR buffers of 4
    chains (one sample, one sweep) of phase 12's state in float64 on the
    card and on the CPU from the same uniforms, under both samplers: the
    same configurations; the energy and the scaled energies within 1e-8;
    each chain's O (holes over the mantissa, evaluated again at the
    returned configurations) and the gradient within 1e-8. The frozen
    sweep can leave a chain at a configuration of negligible weight (in
    this draw one chain at log|psi| -28.9, the others at -7.4 and 0.03;
    the full recompute does not go there), where O is ill-conditioned and
    the two sides agree only to about 2.5e-8: a chain more than 10
    e-folds below the step's largest |psi| is held to 1e-6 in its O, and
    the gradient, which its O then rules, is held over the other chains
    instead: 2 Re sum O (E_loc - mean E_loc) from their O and local
    energies, within 1e-8 (at least two such chains, with different
    energies). Logs each chain's configuration, log|psi| and errors."""
    import torch
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.energy_pbc import pbc_energy_and_holes
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams, mc_energy_grad
    from peps_tpu_torch.montecarlo.engine import init_configs_occupancy
    from peps_tpu_torch.montecarlo.sweep_pbc import draw_uniforms_pbc
    L, nc = PBC["L"], PBC_SAMPLER["card_cpu_chains"]
    model, chi, trunc, bc = _torus_setup()
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(17)
    cfg = init_configs_occupancy(gen, nc, L, L,
                                 {0: L * L // 2, 1: L * L - L * L // 2}, cpu)
    u = draw_uniforms_pbc(gen, nc, L, L, torch.float64, cpu)
    errs, ok = {}, True
    for trial in (False, True):
        out = []
        for where in (device, cpu):
            mt = ModelTensors.from_model(model, torch.float64, where)
            t = tps.double().to(where)
            ev, cfgs, _ = mc_energy_grad(
                t, cfg.to(where), mt, chi, trunc,
                MCParams(num_samples=1, nchains=nc, trial_sweep=trial),
                lambda: u.to(where), with_sr_buffers=True, bc=bc)
            e_loc, holes, mant, log_psi = pbc_energy_and_holes(t, cfgs, mt,
                                                               chi, trunc)
            o = (holes / mant[:, None, None, None, None, None, None]) \
                .reshape(nc, -1)
            out.append((ev, cfgs.cpu(), o.cpu(), e_loc.cpu(), log_psi.cpu()))
        (ev_d, c_d, o_d, e_d, _), (ev_c, c_c, o_c, e_c, log_psi) = out
        low = log_psi < log_psi.max() - 10
        keep = ~low
        o_err = (o_d - o_c).norm(dim=1) / o_c.norm(dim=1)
        e = {"configs_equal": bool(torch.equal(c_d, c_c)),
             "configs": c_c.reshape(nc, -1).tolist(),
             "log_psi": log_psi.tolist(),
             "energy": abs(float(ev_d.energy) - float(ev_c.energy))
             / abs(float(ev_c.energy)),
             "e_samples": _rel_diff(ev_d.e_samples.cpu(), ev_c.e_samples),
             "o_rows": o_err.tolist(),
             "gradient": _rel_diff(ev_d.gradient.cpu(), ev_c.gradient)}
        if bool(low.any()):
            def kept_grad(o, e_loc):
                de = e_loc[keep] - e_loc[keep].mean()
                return 2.0 * (o[keep] * de[:, None]).sum(0)
            e["gradient_kept_chains"] = int(keep.sum())
            e["gradient_kept"] = _rel_diff(kept_grad(o_d, e_d),
                                           kept_grad(o_c, e_c))
            grad_ok = int(keep.sum()) >= 2 \
                and float(e_c[keep].max() - e_c[keep].min()) > 0 \
                and e["gradient_kept"] < 1e-8
        else:
            grad_ok = e["gradient"] < 1e-8
        errs["trial" if trial else "full"] = e
        o_ok = bool((o_err < torch.where(low, 1e-6, 1e-8)).all())
        ok = ok and e["configs_equal"] and e["energy"] < 1e-8 \
            and e["e_samples"] < 1e-8 and o_ok and grad_ok
    log("pbc_sampler", step="card_vs_cpu", nchains=nc, chi=chi,
        dtype="float64", errors=errs)
    if not ok:
        fail(f"pbc card vs CPU: {errs}")


def phase_pbc_sampler(tps, device):
    """Phase 13: the torus sampler ((a)-(d) above). Returns the launches of
    every hand kernel in (a), the torus VMC (K2 writes its SR buffer)."""
    state, launches = pbc_sampler_vmc(tps, device)
    pbc_sampler_measure(state, device)
    pbc_sampler_sweeps(tps, device)
    pbc_sampler_card_vs_cpu(tps, device)
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs only on a GPU")
    try:
        import peps_tpu_torch  # noqa: F401
        from peps_tpu_torch.kernels._build import cuda_library
    except ImportError as exc:
        fail(f"peps_tpu_torch is not importable here: {exc}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}", flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    built = cuda_library()
    log("build", device=name, nvcc_s=built.seconds,
        build_and_load_s=time.perf_counter() - t0, library=built.path.name,
        ptxas=[ln for ln in built.log.splitlines()
               if "ptxas info" in ln or "spill" in ln])

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log("phase_end", name=name, phase_wall_s=time.perf_counter() - t)
        return out

    kern = timed("kernels", phase_kernels, device)
    res, launches, su_s = timed("main_path", phase_main_path, device)
    e_svd = timed("gate", phase_gate, res)
    launches_measure = timed("measure", phase_measure, res, device)
    launches_opt = timed("optimizers", phase_optimizers, res, device)
    launches_j1j2, j1j2 = timed("j1j2", phase_j1j2, res, device)
    launches_rest = timed("bosonic_rest", phase_bosonic_rest, res, device,
                          j1j2, su_s, e_svd)
    launches_close, launches_cx = timed("bosonic_close",
                                        phase_bosonic_close, res, device)
    launches_f = timed("fermions", phase_fermions, device)
    launches_fm = timed("fermion_measure", phase_fermion_measure,
                        launches_f, device)
    launches_pbc, pbc_tps = timed("pbc", phase_pbc, device)
    launches_sampler = timed("pbc_sampler", phase_pbc_sampler, pbc_tps,
                             device)
    graded = launches_f["graded_vmc"]
    k4 = kern["fermion"]["fermion_dress"]
    k5 = kern["fermion"]["bmps_overlap"]
    bwd = kern["fermion"]["col_transfer_backward"]

    record = {"kernels": [
        {"name": "col_transfer", "route": "cuda",
         "source": "peps_tpu_torch/csrc/col_transfer.cu",
         "replaces": "peps_tpu/contraction/bmps.py:250",
         "launches": launches["col_transfer"],
         "launches_measure": launches_measure,
         "launches_optimizers": launches_opt["col_transfer"],
         "launches_j1j2": launches_j1j2["col_transfer"],
         "launches_bosonic_rest": launches_rest["col_transfer"],
         "launches_bosonic_close": launches_close["col_transfer"],
         "launches_complex": launches_cx["col_transfer"],
         "launches_fermions": graded["col_transfer_forward"],
         "launches_fermion_measure": launches_fm["col_transfer_forward"],
         **kern["col_transfer"]},
        {"name": "col_transfer_backward", "route": "cuda",
         "source": "peps_tpu_torch/csrc/col_transfer_backward.cu",
         "replaces": "peps_tpu/fermion/vmc.py:301",
         "launches": graded["col_transfer_backward"],
         "launches_fermion_measure": launches_fm["col_transfer_backward"],
         **{k: bwd[k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "cases")}},
        {"name": "centered_o", "route": "cuda",
         "source": "peps_tpu_torch/csrc/centered_o.cu",
         "replaces": "peps_tpu/algorithm/mc_evaluator.py:316",
         "launches": launches["centered_o"],
         "launches_optimizers": launches_opt["centered_o"],
         "launches_j1j2": launches_j1j2["centered_o"],
         "launches_bosonic_rest": launches_rest["centered_o"],
         "launches_bosonic_close": launches_close["centered_o"],
         "launches_complex": launches_cx["centered_o"],
         "launches_fermions": graded["centered_o"],
         "launches_fermion_measure": launches_fm["centered_o"],
         "launches_pbc_sampler": launches_sampler["centered_o"],
         **kern["centered_o"]},
        {"name": "pair_transfer", "route": "cuda",
         "source": "peps_tpu_torch/csrc/pair_transfer.cu",
         "replaces": "peps_tpu/algorithm/energy.py:132",
         "launches": launches_j1j2["pair_transfer"],
         "launches_bosonic_rest": launches_rest["pair_transfer"],
         "launches_bosonic_close": launches_close["pair_transfer"],
         "launches_complex": launches_cx["pair_transfer"],
         "launches_fermions": graded["pair_transfer"],
         "launches_fermion_measure": launches_fm["pair_transfer"],
         **kern["pair_transfer"]},
        {"name": "fermion_dress", "route": "cuda",
         "source": "peps_tpu_torch/csrc/fermion_dress.cu",
         "replaces": "peps_tpu/fermion/convert.py:123",
         "launches": graded["fermion_dress"],
         "launches_jw": launches_f["jw_hubbard"]["fermion_dress"],
         "launches_graded_su": launches_f["graded_su"]["fermion_dress"],
         "launches_fermion_measure": launches_fm["fermion_dress"],
         **{k: k4[k] for k in ("case", "max_abs_err", "ms", "host_us",
                               "stream_ms", "plain_ms", "copy_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "cases")}},
        {"name": "bmps_overlap", "route": "cuda",
         "source": "peps_tpu_torch/csrc/bmps_overlap.cu",
         "replaces": "peps_tpu/algorithm/measure_fermion.py:386",
         "launches": launches_fm["bmps_overlap"],
         "launches_fermion_measure": launches_fm["bmps_overlap"],
         **{k: k5[k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
