"""Where the port's torus sampler spends its time on one GPU: one sweep of
each sampler and one torus VMC iteration traced, and the frozen trial
sweep timed at 8x8.

    python scripts/profile_pbc_sweep.py [--chains 8] [--samples 4]
        [--big-seconds 600] [--out DIR]

Builds chip_smoke.py's phase 12 (a) state (the 4x4 Heisenberg torus SU at
D=3 from the Neel state, float32) and, at chi=12 under the fast scheme
with one power iteration (examples/heisenberg_pbc_vmc.py's width):

* for the full recompute, the frozen trial and the exact trial sweeps,
  one sweep of --chains chains untraced (host seconds around a
  synchronize; a first sweep of each warms it) and one under
  torch.profiler, tracing the device only;
* one local-energy pass (with holes) of those chains, untraced, so that an
  iteration's time can be split into sweeps and evaluations;
* one vmc_optimize iteration (no warm-up sweep, --samples samples, SR by
  CG 60), untraced and traced.

Each traced run prints its host seconds, the device's busy seconds (the
union of its kernels' intervals), its idle share (1 - busy / host), the
kernel count and the top kernels by device time. The profiler slows the
host, so a traced idle share is an upper limit of the untraced one.

Then the frozen trial sweep of 8 chains at 8x8, D=8, chi=32 (fast scheme)
from a random torus TPS (scale 0.5, float32, random Sz = 0
configurations), in a child process stopped after --big-seconds: the
cache build and the sweep's seconds. Prints JSON lines, the first the
card's name and power limit; writes the profiler tables to DIR.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced(fn, name, out_dir):
    """Run fn under the device profiler; returns its summary dict and
    writes the profiler's table to out_dir/<name>.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from profile_graded_holes import union_us
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, host_s = timed(fn)
    kernels = [(e.time_range.start, e.time_range.end, e.name)
               for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        sys.exit(f"{name}: the trace holds no device kernel")
    start = min(k[0] for k in kernels)
    end = max(k[1] for k in kernels)
    busy = union_us([(a, b) for a, b, _ in kernels], start, end) / 1e6
    by_name = {}
    for a, b, n in kernels:
        ms, cnt = by_name.get(n[:80], (0.0, 0))
        by_name[n[:80]] = (ms + (b - a) / 1e3, cnt + 1)
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=60))
    return {"traced_host_s": host_s, "device_busy_s": busy,
            "idle_share": 1 - busy / host_s, "kernels": len(kernels),
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1][0])[:12]}


def big_sweep(chains):
    """The frozen trial sweep at 8x8 D=8 chi=32 (run in a child)."""
    import torch
    from peps_tpu_torch.contraction.pbc_trial import build_cache
    from peps_tpu_torch.lattice import BoundaryCondition
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.montecarlo.engine import init_configs_occupancy
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.montecarlo.sweep_pbc import (draw_uniforms_pbc,
                                                     mc_sweep_pbc_trial)
    from peps_tpu_torch.tps import project, random_tps
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    L, D, chi = 8, 8, 32
    tps = random_tps(gen, L, L, 2, D, dtype=torch.float32,
                     bc=BoundaryCondition.PERIODIC, scale=0.5, device=dev)
    cfg = init_configs_occupancy(gen, chains, L, L, {0: 32, 1: 32}, dev)
    trunc = TruncParams(chi, 1, 1e-6, scheme="fast", rsvd_power=1)
    torch.cuda.reset_peak_memory_stats(dev)
    cache, build_s = timed(lambda: build_cache(project(tps, cfg), chi,
                                               trunc))
    u = draw_uniforms_pbc(gen, chains, L, L, torch.float32, dev)
    (out, st), sweep_s = timed(lambda: mc_sweep_pbc_trial(
        tps, cfg, chi, trunc, UpdateRule(), u, caches=cache))
    print(json.dumps({
        "step": "big_frozen_sweep", "lattice": [L, L], "D": D, "chi": chi,
        "chains": chains, "cache_build_s": build_s,
        "sweep_s_from_built_cache": sweep_s,
        "chain_sweeps_per_s": chains / (build_s + sweep_s),
        "accept_rate": float(st.accepted.sum() / st.trials.sum()),
        "finite": bool(torch.isfinite(cache.log_abs).all()),
        "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9}),
        flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--big-seconds", type=float, default=600)
    ap.add_argument("--big-only", action="store_true")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.big_only:
        big_sweep(args.chains)
        return
    import chip_smoke as cs
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.energy_pbc import pbc_energy_and_holes
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.montecarlo.engine import init_configs_occupancy
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.montecarlo.sweep_pbc import (draw_uniforms_pbc,
                                                     mc_sweep_pbc,
                                                     mc_sweep_pbc_trial)
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    tps = cs.pbc_su_state(dev)
    model, chi, trunc, bc = cs._torus_setup()
    L, nc = cs.PBC["L"], args.chains
    gen = torch.Generator(device=dev).manual_seed(18)
    half = {0: L * L // 2, 1: L * L - L * L // 2}
    cfg = init_configs_occupancy(gen, nc, L, L, half, dev)
    rule = UpdateRule("exchange")
    sweeps = {
        "full": lambda u: mc_sweep_pbc(tps, cfg, chi, trunc, rule, u),
        "frozen": lambda u: mc_sweep_pbc_trial(tps, cfg, chi, trunc, rule, u),
        "exact": lambda u: mc_sweep_pbc_trial(tps, cfg, chi, trunc, rule, u,
                                              exact=True)}
    for name, sweep in sweeps.items():
        u = draw_uniforms_pbc(gen, nc, L, L, tps.dtype, dev)
        sweep(u)
        _, sec = timed(lambda: sweep(u))
        rec = traced(lambda: sweep(u), f"sweep_{name}", args.out)
        print(json.dumps({"step": "sweep", "sampler": name, "chains": nc,
                          "untraced_s": sec, "chain_sweeps_per_s": nc / sec,
                          **rec}), flush=True)
    mt = ModelTensors.from_model(model, tps.dtype, dev)
    _, e_s = timed(lambda: pbc_energy_and_holes(tps, cfg, mt, chi, trunc))
    print(json.dumps({"step": "local_energy", "chains": nc,
                      "untraced_s": e_s}), flush=True)
    params = VMCParams(
        chi, trunc, MCParams(num_samples=args.samples, num_warmup_sweeps=0,
                             nchains=nc),
        OptimizerParams(1, SRParams(CGParams(60, 1e-5), diag_shift=1e-3),
                        lr=0.1), rule=rule, bc=bc)

    def iteration():
        return vmc_optimize(tps, model, params, configs=cfg,
                            generator=torch.Generator(device=dev)
                            .manual_seed(19))

    res, it_s = timed(iteration)
    rec = traced(iteration, "vmc_iteration", args.out)
    r = res.records[0]
    print(json.dumps({"step": "vmc_iteration", "chains": nc,
                      "samples": args.samples, "untraced_s": it_s,
                      "energy": r.energy,
                      "eval_s": r.eval_seconds, "update_s": r.update_seconds,
                      "sr_iters": r.sr_iters, **rec}), flush=True)
    try:
        child = subprocess.run(
            [sys.executable, __file__, "--big-only", "--chains", "8"],
            capture_output=True, text=True, timeout=args.big_seconds)
        print(child.stdout.strip() or json.dumps(
            {"step": "big_frozen_sweep", "rc": child.returncode,
             "stderr": child.stderr[-2000:]}), flush=True)
    except subprocess.TimeoutExpired:
        print(json.dumps({"step": "big_frozen_sweep",
                          "not_finished_within_s": args.big_seconds}),
              flush=True)


if __name__ == "__main__":
    main()
