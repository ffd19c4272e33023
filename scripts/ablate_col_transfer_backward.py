"""Where K1's backward kernel (csrc/col_transfer_backward.cu) spends its
time: this checkout's kernel against copies of it with one part taken out,
the kernel alone (one launch between CUDA events) on one GPU.

    python scripts/ablate_col_transfer_backward.py [--dtypes float32,...]
        [--reps 5]

Each variant is ``csrc/col_transfer_backward.cu`` with a text substitution
(the script stops if the text is not there), compiled alone into
``build/other_ctb/`` (the headers it includes copied beside it), all in
parallel; the kernel has internal linkage, so the variants loaded into one
process stay apart:

  kernel        unchanged;
  no_compute    the tile products left out (the copies, barriers, tables
                and stores remain);
  no_copies     no cp.async copy issued (the stages keep what they hold);
  no_loop_sync  the barrier of each K chunk gone.

Every variant but the first computes a wrong result; the differences in
time are what each part costs. Cases: chip_smoke.k1_backward_cases (the
graded holes' sketch V and W scans and the pair traces) at the plan's
cluster size. One JSON line per (case, dtype) with each variant's ms and
the registers each variant's kernel takes; the first line is the card's
name and power limit.
"""
import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "kernel": [],
    "no_compute": [("    acc.chunk(as, as + BK * LA, sa, sb);\n", "")],
    "no_copies": [
        ("    cp_async_elem<sizeof(T)>(dst + kk * LD + rr, src, keep);",
         "    if (keep && ro == -7)\n"
         "      cp_async_elem<sizeof(T)>(dst + kk * LD + rr, src, keep);")],
    "no_loop_sync": [
        ("    __syncthreads();   // chunk c landed; "
         "chunk c - 1's stage is free", "")],
}
NAMES = {"float": "float32", "double": "float64", "float2": "complex64",
         "double2": "complex128"}


def build(src_text):
    """Compile every variant in parallel; returns {name: (library,
    {dtype: registers})}."""
    from peps_tpu_torch.kernels import _build
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    out = ROOT / "build" / "other_ctb"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "complex_tiles.cuh", out / "complex_tiles.cuh")
    procs = {}
    for name, subs in VARIANTS.items():
        text = src_text
        for a, b in subs:
            if a not in text:
                sys.exit(f"variant {name}: text not found:\n{a}")
            text = text.replace(a, b)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed on variant {name}:\n{log[-4000:]}")
        regs, kind = {}, None
        for line in log.splitlines():
            if "Compiling entry" in line and "backward_kernel" in line:
                kind = next((v for k, v in NAMES.items()
                             if f"backward_kernelI{len(k)}{k}E" in line
                             or f"backward_kernelI{k[0]}E" in line), None)
            if kind and "Used" in line and "registers" in line:
                regs[kind] = int(line.split("Used")[1].split()[0])
                kind = None
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for entry in kb.ENTRIES.values():
            getattr(lib, entry).argtypes = [ctypes.c_void_p] * 12
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, regs)
    return libs


def main():
    import torch
    import chip_smoke as cs
    from peps_tpu_torch.kernels import _build
    from peps_tpu_torch.kernels import col_transfer as k1
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes",
                    default="float32,float64,complex64,complex128")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    libs = build((_build.CSRC / "col_transfer_backward.cu").read_text())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for dt in args.dtypes.split(","):
        dtype = getattr(torch, dt)
        for name, form, ops, needs in cs.k1_backward_cases(dtype, dev, gen):
            views = cs.k1_views(form, ops)
            batch = torch.broadcast_shapes(*(
                o.shape[:o.dim() - n] for o, n in zip(views, (3, 3, 4, 3))))
            g = torch.randn(*batch, views[1].shape[-1], views[2].shape[-1],
                            views[3].shape[-1], generator=gen, device=dev,
                            dtype=torch.float64).to(dtype)
            plan, meta = kb.launch_meta(g, *views, needs, k1.sm_count(dev))
            grads = [torch.empty(o.shape, dtype=dtype, device=dev) if n
                     else None for o, n in zip(views, needs)]
            scratch = torch.empty(plan["scratch"], dtype=dtype, device=dev)
            ptrs = (*(t.data_ptr() for t in (*views, g)),
                    *(x.data_ptr() if x is not None else None for x in grads),
                    scratch.data_ptr())
            ms, regs = {}, {}
            for vname, (lib, vregs) in libs.items():
                fn = getattr(lib, kb.ENTRIES[dtype])

                def call(fn=fn):
                    code = fn(*ptrs, meta,
                              torch.cuda.current_stream().cuda_stream)
                    if code != 0:
                        sys.exit(f"{vname} {name} {dt}: launch failed "
                                 f"({code})")
                ms[vname] = cs.time_ms(call, args.reps)
                regs[vname] = vregs.get(dt)
            print(json.dumps({"case": name, "dtype": dt,
                              "cluster": plan["cluster"], "ms": ms,
                              "registers": regs}), flush=True)


if __name__ == "__main__":
    main()
