"""Where K1's (col_transfer) complex bodies spend their time: this
checkout's kernel against copies of it with one part taken out, timed in
turns on one GPU.

    python scripts/ablate_col_transfer.py [--reps 10]

Each variant is ``csrc/col_transfer.cu``, with the headers it includes
pasted in (ablate_pair_transfer.inline_headers), and a text substitution
(the script stops if the text is not there); the variants compile in
parallel, each alone into ``build/other_k1/``, and launch through the K1
wrapper (bench_col_transfer.other_library):

  kernel             unchanged;
  no_refills         env and bot copied for the first chunk only;
  no_stores          steps 1 and 2 compute their products but store
                     nothing into T1 and T2;
  no_fragment_loads  the products' k-loops keep their first fragments in
                     registers instead of loading each k's from shared
                     memory (the FMAs or MMAs and the loop remain;
                     complex128's step 3, two k-steps a chunk, keeps its
                     loads);
  no_inner_barriers  the barriers between a chunk's products gone (step
                     2's, before it overwrites T1, included);
  no_step1 / no_step2 / no_step3
                     one product left out (with step 2 its barrier).

Every variant but the first computes a wrong result (each line says
whether it matched the plain version); the differences in time are what
each part costs. Cases: chip_smoke.k1_cases' pair traces (3,584 items,
one CTA an item) and bond step (64 items, one CTA an A tile), complex64
and complex128. One JSON line per (case, dtype) with each variant's ms
(the mean of two turns of --reps launches); the first line is the card's
name and power limit.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

REFILLS = ("        if (ch + 1 < n_ch) {\n          stage_chunk(ch + 1);",
           "        if (false) {\n          stage_chunk(ch + 1);")
VARIANTS = {
    "kernel": [],
    "no_refills": [REFILLS],
    "no_stores": [
        ("    cx_store<kStagger>(acc, m0, n0, M, N, dst, ro, co);",
         "    if (acc[0][0].x == 12345.f)\n"
         "      cx_store<kStagger>(acc, m0, n0, M, N, dst, ro, co);"),
        ("          if (m < M && n < N)\n",
         "          if (m < M && n < N && acc[i][j][0][v] == 12345.0)\n"),
        ("      cx_tiles::cx_store<true>(acc[t], m0[t], n0[t], M, N, dst, ro, co);",
         "      if (acc[t][0][0].x == 12345.f)\n"
         "        cx_tiles::cx_store<true>(acc[t], m0[t], n0[t], M, N, dst, ro,"
         " co);"),
        ("      if (m < M && n < N)\n        dst[ro[m] + co[n]]",
         "      if (m < M && n < N && acc[t][0][0][0][v] == 12345.0)\n"
         "        dst[ro[m] + co[n]]")],
    "no_fragment_loads": [
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
        ("co1);\n        __syncthreads();", "co1);"),
        ("co2);\n        __syncthreads();", "co2);"),
        ("  }\n  __syncthreads();\n#pragma unroll\n  for (int t = 0; t < R; ++t)",
         "  }\n#pragma unroll\n  for (int t = 0; t < R; ++t)")],
    "no_step1": [
        ("        step1_product(Ts, p.ldT, E, p.ldE, K1, M1, N1, T1, ro1, co1);\n",
         "")],
    "no_step2": [
        ("        held_product<Body<T>::R2>(T1, p.ld1, Ss, p.ldS, K2, M2, N2, X2, "
         "ro2,\n                                  co2);\n", "")],
    "no_step3": [("        acc3.add(X2, p.ld2, B, p.ldB, K3);\n", "")],
}


def build_all(srcs):
    """Compile the variants in parallel, one nvcc each; {name: library}."""
    from bench_col_transfer import ENTRIES
    from peps_tpu_torch.kernels import _build
    procs = {}
    for name, path in srcs.items():
        lib = path.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 7
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from ablate_pair_transfer import inline_headers, variant_source
    from bench_col_transfer import other_library
    from peps_tpu_torch.kernels import col_transfer as k1
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
    src = inline_headers(ROOT / "peps_tpu_torch" / "csrc" / "col_transfer.cu")
    out = ROOT / "build" / "other_k1"
    out.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for name, subs in VARIANTS.items():
        srcs[name] = out / f"ablate_{name}.cu"
        srcs[name].write_text(variant_source(src, subs))
    libs = build_all(srcs)
    gen = torch.Generator(device=device).manual_seed(1234)
    for dtype in (torch.complex64, torch.complex128):
        tol = cs.TOL[str(dtype).split(".")[1]]
        cases = {c[0]: c for c in cs.k1_cases(dtype, device, gen)}
        for case in ("nn_traces", "bond_step"):
            _, form, *ops = cases[case]
            views = cs.k1_views(form, ops)
            ref = k1.col_transfer_plain(*views)
            rec = {"case": case, "dtype": str(dtype), "ms": {},
                   "matches_plain": {}}
            for name, lib in libs.items():
                with other_library(lib):
                    got = k1.col_transfer(*views)
                    torch.cuda.synchronize()
                rec["matches_plain"][name] = cs.max_err(got, ref)[1] <= tol
                del got
            del ref
            for _ in range(2):
                for name, lib in libs.items():
                    with other_library(lib):
                        rec["ms"].setdefault(name, []).append(cs.time_ms(
                            lambda: k1.col_transfer(*views), args.reps))
            rec["ms"] = {k: sum(v) / len(v) for k, v in rec["ms"].items()}
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
