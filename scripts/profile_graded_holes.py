"""Trace one graded SR evaluation of the port on one GPU: how much of each
part's host time the device is busy, the graded holes above all.

    python scripts/profile_graded_holes.py [--out DIR]

Runs chip_smoke.py's phase 10 for its flagship-width state (6x6 t-J, D=8,
chi=32, 32 chains, eval_chunk 8, float32, after 3 SR iterations) and final
configurations, then chip_smoke.graded_breakdown (one mc_energy_grad with
SR buffers and the SR solve, each part wrapped with synchronized host
stamps and a named profiler range) once untraced and once under
torch.profiler. Prints JSON lines: the card's name and power limit; the
untraced breakdown; and for each part of the traced one (evaluation,
sweep, local, holes, tables, k2, sr_solve) its host seconds, the device
busy seconds (the union of the intervals of the kernels that ran inside
its range), the idle share (1 - busy / host) and the kernels it launched,
with the holes' kernels by name (device ms and count). The profiler slows
the host, so the traced idle shares are upper limits of the untraced
ones. Writes the profiler's table to DIR/profile_graded_holes.txt.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PARTS = ("evaluation", "sweep", "local", "holes", "tables", "k2",
         "sr_solve")


def union_us(intervals, lo, hi):
    """Length of the union of the intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    res, gm, vp = cs.phase_fermions(dev)["flagship"][:3]
    print(json.dumps({"untraced": cs.graded_breakdown(res, gm, vp, dev)}),
          flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.graded_breakdown(res, gm, vp, dev)
    events = prof.events()
    # device activity only: the named ranges also show on the device's
    # timeline, as annotations spanning their kernels
    kernels = [(e.time_range.start, e.time_range.end, e.name)
               for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in PARTS]
    ranges = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in PARTS:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    for name in PARTS:
        host = busy = 0.0
        inside = []
        for lo, hi in ranges.get(name, []):
            host += hi - lo
            ks = [k for k in kernels if k[0] < hi and k[1] > lo]
            busy += union_us([(a, b) for a, b, _ in ks], lo, hi)
            inside += ks
        by_name = {}
        for a, b, n in inside:
            ms, cnt = by_name.get(n[:80], (0.0, 0))
            by_name[n[:80]] = (ms + (b - a) / 1e3, cnt + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        print(json.dumps({
            "part": name, "host_s": host / 1e6, "device_busy_s": busy / 1e6,
            "idle_share": 1 - busy / host if host else None,
            "kernels": len(inside),
            "by_kernel": top[:12] if name == "holes" else top[:5]}),
            flush=True)
    if not kernels:
        sys.exit("the trace holds no device kernel")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_graded_holes.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))


if __name__ == "__main__":
    main()
