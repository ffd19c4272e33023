"""Time a K2 (centered_o) module at chip_smoke.py's K2 cases on one GPU.

    python scripts/bench_centered_o.py [--k2-module PATH] [--label NAME]

Runs chip_smoke.k2_case for every case and dtype of chip_smoke.K2_CASES
(the main path 8x8 D=8, the stretch run 12x12 D=10, and 16x16 D=12 past
2^31 elements) and prints one JSON line per case: the kernel's ms, the
plain version's, a copy_ of as many bytes, the bound and the error against
the plain version. --k2-module loads another commit's
``peps_tpu_torch/kernels/centered_o.py`` by path, so that two versions are
timed in one call, in turns. It takes only a file that stands alone, as the
Triton K2 of earlier commits does: a file that imports ``peps_tpu_torch``
(the CUDA K2 imports ``kernels._build``) would build and time this
checkout's ``csrc/centered_o.cu``, so it is refused. To time two CUDA
versions, run this script from a checkout of each commit, in turns, in one
call. A version that refuses a case (the Triton K2 raised ValueError past
2^31 elements) is recorded as refusing it.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def load_k2(path):
    if path is None:
        from peps_tpu_torch.kernels import centered_o
        return centered_o
    if "peps_tpu_torch" in Path(path).read_text():
        sys.exit(f"{path} imports peps_tpu_torch, so it would time this "
                 f"checkout's kernel: run the script from its own checkout")
    spec = importlib.util.spec_from_file_location("k2_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k2-module", default=None)
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()

    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    k2 = load_k2(args.k2_module)
    gen = torch.Generator(device=device).manual_seed(1234)
    for case in chip_smoke.K2_CASES:
        for dt in case[4]:
            try:
                rec = chip_smoke.k2_case(k2, case, getattr(torch, dt), device,
                                         gen)
            except ValueError as exc:
                rec = {"case": case[0], "dtype": f"torch.{dt}",
                       "refused": str(exc)}
            torch.cuda.empty_cache()
            print(json.dumps({"bench": "centered_o", "label": args.label,
                              "card": card, **rec}), flush=True)


if __name__ == "__main__":
    main()
