"""Profile the port's VMC train step on one GPU (peps_tpu_torch).

    python scripts/profile_torch_train_step.py [--plain-k1] [--iters 6]
                                               [--out DIR]

Runs the main path of chip_smoke.py (8x8 Heisenberg, D=8, chi=32, 32 chains,
sketch, f32, SR by CG): iterations 1 and 2 are timed untraced, iterations
3..iters are traced with torch.profiler. Prints JSON lines: seconds per
train step (untraced and traced), device busy share (device-kernel time over
the traced wall time; the profiler slows the host, so the untraced share is
higher), K1's device time per traced step (kernels whose name holds
"col_transfer"; zero with --plain-k1), and the device time by kernel name;
writes the full table to
DIR/profile_<variant>.txt.
--plain-k1 routes every column transfer through K1's plain PyTorch version
instead of the CUDA kernel, for an end-to-end comparison in one call.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def use_plain_k1():
    """Send every K1 call site to the plain einsum chain."""
    from peps_tpu_torch.contraction import bmps
    from peps_tpu_torch.kernels import col_transfer as k1
    from peps_tpu_torch.montecarlo import sweep

    def right(renv, top, site, bot):
        return k1.col_transfer_right(renv, top, site, bot,
                                     transfer=k1.col_transfer_plain)
    for mod in (bmps, sweep):
        mod.col_transfer = k1.col_transfer_plain
        mod.col_transfer_right = right


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plain-k1", action="store_true")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.plain_k1:
        use_plain_k1()
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
    from peps_tpu_torch.peps import (SimpleUpdateParams, product_peps,
                                     simple_update, to_tps)

    variant = "plain_k1" if args.plain_k1 else "kernels"
    dev = torch.device("cuda", 0)
    ly = lx = 8
    model = spin.heisenberg()
    occ = np.indices((ly, lx)).sum(0) % 2
    su = simple_update(product_peps(ly, lx, 8, occ, 2, device=dev),
                       model.h_h, model.h_v,
                       SimpleUpdateParams(40, 0.1, TruncParams(8, 1, 1e-8)))
    tps = to_tps(su.peps)
    tps = tps / tps.abs().max()
    params = VMCParams(
        32, TruncParams(32, 1, 1e-6, scheme="sketch"),
        MCParams(num_samples=1, num_warmup_sweeps=1, nchains=32),
        OptimizerParams(args.iters, SRParams(CGParams(30, 1e-5), 1e-3),
                        lr=0.05),
        occupancy=((0, 32), (1, 32)))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    stamps = []

    def on_iter(rec, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if rec.step == 2:
            prof.start()
        print(json.dumps({"variant": variant, "iteration": rec.step,
                          "energy_per_site": rec.energy / 64,
                          "sr_iters": rec.sr_iters}), flush=True)

    vmc_optimize(tps, model, params, torch.Generator(device=dev).manual_seed(2),
                 callback=on_iter)
    prof.stop()
    wall = stamps[-1] - stamps[2]
    steps = [b - a for a, b in zip(stamps, stamps[1:])]

    def self_dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # device-side kernel records only (operator records carry their
    # kernels' time too and would count it twice)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and self_dev(e) > 0]
    dev_us = sum(self_dev(e) for e in events)
    top = sorted(events, key=lambda e: -self_dev(e))[:15]
    k1_us = sum(self_dev(e) for e in events if "col_transfer" in e.key)
    print(json.dumps({
        "variant": variant, "seconds_per_train_step_untraced": steps[:2],
        "k1_device_ms_per_traced_step": k1_us / 1e3 / len(steps[2:]),
        "seconds_per_train_step_traced": steps[2:], "traced_wall_s": wall,
        "device_busy_s": dev_us / 1e6,
        "device_busy_share": dev_us / 1e6 / wall,
        "top_device_ms": [(e.key[:70], self_dev(e) / 1e3, e.count)
                          for e in top]}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_{variant}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
        f.write("\n" + "\n".join(f"{e.key}\t{self_dev(e) / 1e3:.3f} ms\t"
                                  f"{e.count}" for e in top) + "\n")


if __name__ == "__main__":
    main()
