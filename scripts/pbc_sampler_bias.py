"""The frozen torus sampler's bias, measured against exact sums on one GPU.

    python scripts/pbc_sampler_bias.py [--chis 6 9 12] [--chains 64]
        [--warmup 5] [--sweeps 40] [--batch 1024] [--eloc-chains 32]
        [--eloc-samples 8] [--out DIR]

State: chip_smoke.py's phase 12 (a) state (the 4x4 Heisenberg torus SU
at D=3 from the Neel state), taken to float64. For each chi, under the
fast scheme with one power iteration and trunc_err 1e-6
(examples/heisenberg_pbc_vmc.py's truncation):

* the exact |psi|^2 of all 12,870 Sz = 0 configurations under that chi's
  contraction (contract_pbc in batches of --batch), and from it the exact
  nearest-neighbour <Sz Sz> (the mean over the 32 torus bonds) and the
  staggered <m^2>, m = (1/N) sum_i (-1)^(x+y) Sz_i: diagonal
  observables, which need amplitudes only;
* the same observables sampled by the full-recompute sweep (which
  samples exactly that |psi|^2) and by the frozen trial sweep: --chains
  chains started from configurations drawn from the exact distribution,
  --warmup sweeps, then --sweeps sweeps each read once; binned means and
  errors (montecarlo.statistics.mean_and_binned_error over sweeps and
  chains);
* z = (sampled - exact) / binned error for each, the acceptance and the
  seconds a sweep.

Then the local energies that each sampler's chains meet, at the
example's precision (float32, chi=12): --eloc-chains chains from random
Sz = 0 configurations, 2 warm-up sweeps, --eloc-samples samples, the
torus local energy of every sample; a sample whose E_loc is not finite
or whose |E_loc| per site passes 2 (no configuration of the Heisenberg
torus reaches that in float64) is an outlier, and its E_loc and log|psi|
are taken again in float64 on the card and in float32 on the CPU. The
outliers' configurations and the state go to DIR/eloc_outliers.pt.

Prints JSON lines, the first the card's name and power limit, and writes
them to DIR/pbc_sampler_bias.jsonl.
"""
import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def observables(cfg, L):
    """(nearest-neighbour Sz Sz [n], staggered m^2 [n]) of configurations
    [n, L, L] (state 0 is Sz = +1/2)."""
    import torch
    sz = 0.5 - cfg.double()
    nn = (sz * torch.roll(sz, -1, 2) + sz * torch.roll(sz, -1, 1)) \
        .sum((1, 2)) / (2 * L * L)
    sign = 1.0 - 2.0 * (torch.arange(L)[:, None] + torch.arange(L)[None, :]
                        ).remainder(2).double().to(cfg.device)
    m = (sz * sign).sum((1, 2)) / (L * L)
    return nn, m * m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chis", type=int, nargs="*", default=[6, 9, 12])
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--eloc-chains", type=int, default=32)
    ap.add_argument("--eloc-samples", type=int, default=8)
    ap.add_argument("--out", default="build/bias")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.energy_pbc import pbc_energy_and_holes
    from peps_tpu_torch.contraction.pbc import contract_pbc
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.montecarlo.statistics import mean_and_binned_error
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.montecarlo.sweep_pbc import (draw_uniforms_pbc,
                                                     mc_sweep_pbc,
                                                     mc_sweep_pbc_trial)
    from peps_tpu_torch.tps import project
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    os.makedirs(args.out, exist_ok=True)
    sink = open(os.path.join(args.out, "pbc_sampler_bias.jsonl"), "w")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    sink.write(json.dumps({"card": smi.stdout.strip()}) + "\n")
    L = cs.PBC["L"]
    tps32 = cs.pbc_su_state(dev)
    tps = tps32.double()
    ones = [c for c in itertools.combinations(range(L * L), L * L // 2)]
    allc = torch.zeros(len(ones), L * L, dtype=torch.int64)
    for i, c in enumerate(ones):
        allc[i, list(c)] = 1
    allc = allc.reshape(-1, L, L).to(dev)
    nn_all, m2_all = observables(allc, L)
    rule = UpdateRule("exchange")
    for chi in args.chis:
        trunc = TruncParams(chi, 1, 1e-6, scheme="fast", rsvd_power=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        las = []
        for i in range(0, allc.shape[0], args.batch):
            mant, logw = contract_pbc(project(tps, allc[i:i + args.batch]),
                                      chi, trunc)
            las.append(torch.log(mant.abs()) + logw)
        la = torch.cat(las)
        p = torch.exp(2 * (la - la.max()))
        p = p / p.sum()
        exact = {"nn_szsz": float((p * nn_all).sum()),
                 "m2_stag": float((p * m2_all).sum())}
        torch.cuda.synchronize()
        emit({"chi": chi, "step": "exact", "configurations": allc.shape[0],
              "seconds": time.perf_counter() - t0, **exact,
              "max_weight": float(p.max())})
        gen = torch.Generator(device=dev).manual_seed(chi)
        start = allc[torch.multinomial(p, args.chains, replacement=True,
                                       generator=gen)]
        for name in ("full", "frozen"):
            cfg = start.clone()
            acc = tri = 0
            vals = {"nn_szsz": [], "m2_stag": []}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for s in range(args.warmup + args.sweeps):
                u = draw_uniforms_pbc(gen, args.chains, L, L, torch.float64,
                                      dev)
                if name == "full":
                    cfg, st = mc_sweep_pbc(tps, cfg, chi, trunc, rule, u)
                else:
                    cfg, st = mc_sweep_pbc_trial(tps, cfg, chi, trunc, rule,
                                                 u)
                if s < args.warmup:
                    continue
                acc += int(st.accepted.sum())
                tri += int(st.trials.sum())
                nn, m2 = observables(cfg, L)
                vals["nn_szsz"].append(nn)
                vals["m2_stag"].append(m2)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rec = {"chi": chi, "step": "sampled", "sampler": name,
                   "chains": args.chains, "warmup": args.warmup,
                   "sweeps": args.sweeps,
                   "seconds_per_sweep": sec / (args.warmup + args.sweeps),
                   "accept_rate": acc / max(tri, 1)}
            for key, xs in vals.items():
                mean, err = mean_and_binned_error(torch.stack(xs).cpu())
                rec[key] = float(mean)
                rec[key + "_err"] = float(err)
                rec[key + "_z"] = (float(mean) - exact[key]) / float(err)
            emit(rec)
    model, chi, trunc, _ = cs._torus_setup()
    mts = {dt: ModelTensors.from_model(model, dt, dev)
           for dt in (torch.float32, torch.float64)}
    gen = torch.Generator(device=dev).manual_seed(20)
    start = allc[torch.randint(allc.shape[0], (args.eloc_chains,),
                               generator=gen, device=dev)]
    flagged = []
    for name in ("full", "frozen"):
        cfg = start.clone()
        e_all = []
        for s in range(2 + args.eloc_samples):
            u = draw_uniforms_pbc(gen, args.eloc_chains, L, L,
                                  torch.float32, dev)
            if name == "full":
                cfg, _ = mc_sweep_pbc(tps32, cfg, chi, trunc, rule, u)
            else:
                cfg, _ = mc_sweep_pbc_trial(tps32, cfg, chi, trunc, rule, u)
            if s < 2:
                continue
            e, _, _, la = pbc_energy_and_holes(tps32, cfg,
                                               mts[torch.float32], chi,
                                               trunc, with_holes=False)
            e_all.append(e / L ** 2)
            bad = (~torch.isfinite(e) | (e.abs() / L ** 2 > 2)) \
                .nonzero().squeeze(1)
            if bad.numel():
                e64, _, _, la64 = pbc_energy_and_holes(
                    tps, cfg[bad], mts[torch.float64], chi, trunc,
                    with_holes=False)
                e_cpu, _, _, la_cpu = pbc_energy_and_holes(
                    tps32.cpu(), cfg[bad].cpu(), ModelTensors.from_model(
                        model, torch.float32, "cpu"), chi, trunc,
                    with_holes=False)
                for i, j in enumerate(bad.tolist()):
                    flagged.append({"sampler": name, "config": cfg[j].cpu(),
                                    "e32": float(e[j]) / L ** 2,
                                    "e64": float(e64[i]) / L ** 2,
                                    "e32_cpu": float(e_cpu[i]) / L ** 2,
                                    "log_psi32": float(la[j]),
                                    "log_psi64": float(la64[i]),
                                    "log_psi32_cpu": float(la_cpu[i])})
        e_all = torch.stack(e_all)
        emit({"step": "eloc", "sampler": name, "chi": chi,
              "dtype": "float32", "chains": args.eloc_chains,
              "samples": args.eloc_samples,
              "median_e_per_site": float(e_all.nanmedian()),
              "outliers": sum(f["sampler"] == name for f in flagged),
              "of": e_all.numel(),
              "flagged": [{k: v for k, v in f.items() if k != "config"}
                          for f in flagged if f["sampler"] == name][:8]})
    torch.save({"tps": tps32.cpu(), "flagged": flagged},
               os.path.join(args.out, "eloc_outliers.pt"))
    sink.close()


if __name__ == "__main__":
    main()
