"""Rerun the fermion flagship's three graded SR iterations with more
warm-up sweeps, to tell an unmixed start from a fault of the port.

    python scripts/flagship_warmup.py [--warmups 2,20]

For each warm-up count, chip_smoke.py's phase 10 (b) as it stands (the 6x6
t-J graded SU at D=4, expanded to D=8, then vmc_optimize with SR: 3
iterations of 32 chains, 1 sample step, chi=32, sketch, eval_chunk 8,
float32, the same seeds) with FLAG["warmup"] set to that count; phase 10
(a) and (c) run too, as the phase does. Prints chip_smoke's lines (the
SR iterations' E/site among them) and one JSON summary a count: the
energies per site of the iterations, whether they fall, and the seconds.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmups", default="2,20")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    n = cs.FLAG["L"] ** 2
    for w in (int(v) for v in args.warmups.split(",")):
        cs.FLAG["warmup"] = w
        t0 = time.perf_counter()
        res = cs.phase_fermions(dev)["flagship"][0]
        e = [float(x) / n for x in res.energies]
        print(json.dumps({"warmup_sweeps": w, "energy_per_site": e,
                          "falls": all(b <= a for a, b in zip(e, e[1:])),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
