"""Where K3's (pair_transfer) time goes: this checkout's kernel against
copies of it with one part taken out, timed in turns on one GPU.

    python scripts/ablate_pair_transfer.py [--reps 5]

Each variant is ``csrc/pair_transfer.cu``, with the headers it includes
pasted in (``inline_headers``), and a text substitution (the script stops
if the text is not there), built alone into
``build/other_k3/`` and launched through the K3 wrapper
(``bench_pair_transfer.with_k3``):

  kernel             unchanged;
  no_env_refill      env copied for the first chunks only;
  no_bot_refill      bot copied for the first chunk only;
  no_refills         both;
  no_scatter_stores  steps 1-3 compute their products but store nothing;
  no_fragment_loads  the products' k-loops keep their first fragments in
                     registers instead of loading each k's from shared
                     memory (the FMAs or MMAs and the loop remain; in
                     complex128 step 4, one k-step a chunk, keeps its
                     loads);
  no_inner_barriers  the three barriers between a chunk's products gone.

Every variant but the first computes a wrong result (each line says
whether it matched the plain version); the differences in time are what
each part costs. Cases: chip_smoke.k3_cases' env step and diagonal block,
f32, f64, complex64 and complex128 (at the complex128 block the plain
chain runs on chip_smoke.K3_SUBSET_CHAINS chains' items). One JSON line
per (case, dtype) with each variant's ms (the mean of two turns of --reps
launches); the first line is the card's name and power limit.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

REFILL_ENV = ("    if (ch + 1 < n_ch && (ch + 1) % G == 0) {\n      stage_env",
              "    if (false) {\n      stage_env")
REFILL_BOT = ("    if (ch + 1 < n_ch) {\n      stage_bot(ch + 1);",
              "    if (false) {\n      stage_bot(ch + 1);")
VARIANTS = {
    "kernel": [],
    "no_env_refill": [REFILL_ENV],
    "no_bot_refill": [REFILL_BOT],
    "no_refills": [REFILL_ENV, REFILL_BOT],
    "no_scatter_stores": [
        ("    simt_store<4, 4>(acc, mi * 4, ni * 4, M, N, dst, ro, co);",
         "    if (acc[0][0] == 12345.f)\n"
         "      simt_store<4, 4>(acc, mi * 4, ni * 4, M, N, dst, ro, co);"),
        ("        const int o = r + co[n];\n",
         "        const int o = r + co[n];\n"
         "        if (acc[i][j][0] != 12345.0) continue;\n"),
        ("    cx_store<kStagger>(acc, m0, n0, M, N, dst, ro, co);",
         "    if (acc[0][0].x == 12345.f)\n"
         "      cx_store<kStagger>(acc, m0, n0, M, N, dst, ro, co);"),
        ("          if (m < M && n < N)\n",
         "          if (m < M && n < N && acc[i][j][0][v] == 12345.0)\n")],
    "no_fragment_loads": [
        ("      load_x<kPairs>(x1, x + ldx, xs);\n"
         "      load_frag<TN>(y1, y + ldy);",
         "      for (int i = 0; i < 4; ++i) x1[i] = x0[i];\n"
         "      for (int j = 0; j < TN; ++j) y1[j] = 0.5f * y0[j];"),
        ("    if (k + 2 < K) {\n      load_x<kPairs>(x0, x, xs);\n"
         "      load_frag<TN>(y0, y);\n    }\n", ""),
        ("      for (int i = 0; i < WM; ++i) a1[i] = x[sx + xt * i];",
         "      for (int i = 0; i < WM; ++i) a1[i] = a0[i];"),
        ("      for (int j = 0; j < WN; ++j) b1[j] = y[sy + 8 * j];",
         "      for (int j = 0; j < WN; ++j) b1[j] = 0.5 * b0[j];"),
        ("    if (k + 8 < K) {\n#pragma unroll\n"
         "      for (int i = 0; i < WM; ++i) a0[i] = x[xt * i];\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < WN; ++j) b0[j] = y[8 * j];\n    }\n", ""),
        ("      load_cx4(x1, x + ldx);\n      load_cx4(y1, y + ldy);",
         "      for (int i = 0; i < 4; ++i) x1[i] = x0[i];\n"
         "      for (int j = 0; j < 4; ++j)\n"
         "        y1[j] = make_float2(0.5f * y0[j].x, y0[j].y);"),
        ("    if (k + 2 < K) {\n      load_cx4(x0, x);\n"
         "      load_cx4(y0, y);\n    }\n", ""),
        ("    if (two) zmma_frags<WM, WN>(a1, b1, x + sx, ldx, y + sy, ldy);",
         "    if (two) {\n"
         "      for (int i = 0; i < WM; ++i)\n"
         "        for (int v = 0; v < 4; ++v) a1[i][v] = a0[i][v];\n"
         "      for (int j = 0; j < WN; ++j)\n"
         "        for (int v = 0; v < 2; ++v)\n"
         "          b1[j][v] = make_double2(0.5 * b0[j][v].x, b0[j][v].y);\n"
         "    }"),
        ("    if (k + 16 < K) zmma_frags<WM, WN>(a0, b0, x, ldx, y, ldy);\n",
         "")],
    "no_inner_barriers": [
        ("co2);\n      __syncthreads();", "co2);"),
        ("co3);\n      __syncthreads();", "co3);"),
        ("    __syncthreads();\n    if (ch + 1 < n_ch && (ch + 1) % G == 0)",
         "    if (ch + 1 < n_ch && (ch + 1) % G == 0)")],
}


def inline_headers(path):
    """A kernel source with the headers it includes from its own directory
    (``#include "x.cuh"``) pasted in, so that a variant compiles alone from
    any directory and a substitution reaches the headers' code too."""
    out = []
    for line in Path(path).read_text().splitlines(keepends=True):
        m = re.match(r'#include "([\w.]+)"', line)
        if m:
            out.append(inline_headers(Path(path).parent / m.group(1))
                       .replace("#pragma once\n", ""))
        else:
            out.append(line)
    return "".join(out)


def variant_source(src, subs):
    for old, new in subs:
        if old not in src:
            sys.exit(f"ablation target not in the kernel source: {old!r}")
        src = src.replace(old, new)
    return src


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    import bench_pair_transfer as bench
    import chip_smoke as cs
    from peps_tpu_torch.kernels import pair_transfer as k3
    from peps_tpu_torch.kernels._build import cuda_library
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    cuda_library()
    src = inline_headers(ROOT / "peps_tpu_torch" / "csrc" / "pair_transfer.cu")
    out = ROOT / "build" / "other_k3"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, subs in VARIANTS.items():
        path = out / f"ablate_{name}.cu"
        path.write_text(variant_source(src, subs))
        libs[name] = bench.build_other(path)
    gen = torch.Generator(device=device).manual_seed(1234)
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128):
        tol = cs.TOL[str(dtype).split(".")[1]]
        cases = {c[0]: c for c in cs.k3_cases(dtype, device, gen)}
        for case in ("env_step", "diag_block"):
            _, form, *ops = cases[case]
            views = cs.k3_views(form, ops)
            sub = views
            if "block" in case and dtype == torch.complex128:
                sub = cs.k3_subset(views)
            ref = k3.pair_transfer_plain(*sub)
            rec = {"case": case, "dtype": str(dtype), "ms": {},
                   "matches_plain": {}}
            runs = {}
            for name, lib in libs.items():
                def run(lib=lib):
                    with bench.with_k3(lib):
                        return k3.pair_transfer(*views)
                runs[name] = run
                got = run()
                torch.cuda.synchronize()
                if sub is not views:
                    got = got[:cs.K3_SUBSET_CHAINS]
                rec["matches_plain"][name] = cs.max_err(got, ref)[1] <= tol
                del got
            del ref
            for _ in range(2):
                for name, run in runs.items():
                    rec["ms"].setdefault(name, []).append(
                        cs.time_ms(run, args.reps))
            rec["ms"] = {k: sum(v) / len(v) for k, v in rec["ms"].items()}
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
