"""Trace one torus local-energy evaluation of the port on one GPU: where
its time goes and how much of it the device is idle.

    python scripts/profile_pbc_energy.py [--configs 8] [--scheme fast]
        [--out DIR]

Builds chip_smoke.py's phase 12 (a) state (the 4x4 Heisenberg torus SU at
D=3 from the Neel state, 40 + 40 steps, float32), draws --configs Sz = 0
configurations and runs local_energy_and_holes_pbc at chi=12 (--scheme,
one power iteration) once untraced (host seconds around a synchronize)
and once under torch.profiler, tracing the device only (a CPU trace of
the evaluation's operators did not finish in 20 minutes at 32
configurations on an H100 machine). Prints JSON lines: the card's name
and power limit; the untraced seconds; the traced evaluation's host
seconds, the device's busy seconds (the union of its kernels' intervals)
and idle share (1 - busy / host), the kernel count, and the top kernels
by device time (name, ms, count). The profiler slows the host, so the
traced idle share is an upper limit of the untraced one. Writes the
profiler's table to DIR/profile_pbc_energy.txt.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, default=8)
    ap.add_argument("--scheme", default="fast")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from profile_graded_holes import union_us
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.energy_pbc import \
        local_energy_and_holes_pbc
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.engine import init_configs_occupancy
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    tps = cs.pbc_su_state(dev)
    L, chi = cs.PBC["L"], cs.PBC["chi"]
    cfg = init_configs_occupancy(torch.Generator(device=dev).manual_seed(12),
                                 args.configs, L, L,
                                 {0: L * L // 2, 1: L * L // 2}, dev)
    mt = ModelTensors.from_model(spin.heisenberg(1.0), tps.dtype, dev)
    trunc = TruncParams(chi, 1, 1e-6, scheme=args.scheme, rsvd_power=1)

    def step():
        return local_energy_and_holes_pbc(tps, cfg, mt, chi, trunc)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    print(json.dumps({"untraced_s": time.perf_counter() - t0,
                      "configurations": args.configs,
                      "scheme": args.scheme}), flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        lo = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - lo
    events = prof.events()
    kernels = [(e.time_range.start, e.time_range.end, e.name)
               for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        sys.exit("the trace holds no device kernel")
    start = min(k[0] for k in kernels)
    end = max(k[1] for k in kernels)
    busy = union_us([(a, b) for a, b, _ in kernels], start, end)
    by_name = {}
    for a, b, n in kernels:
        ms, cnt = by_name.get(n[:80], (0.0, 0))
        by_name[n[:80]] = (ms + (b - a) / 1e3, cnt + 1)
    top_kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "traced_host_s": host_s, "device_span_s": (end - start) / 1e6,
        "device_busy_s": busy / 1e6, "idle_share": 1 - busy / 1e6 / host_s,
        "kernels": len(kernels), "top_kernels_ms": top_kernels}),
        flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_pbc_energy.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=60))


if __name__ == "__main__":
    main()
