"""Time K1's backward kernel and K5 (bmps_overlap) on one GPU against another
commit's versions, in turns.

    python scripts/bench_backward_overlap.py [--other-k1-py PATH]
        [--other-k5-src PATH] [--other-k5-py PATH] [--label NAME]
        [--reps 10] [--dtypes float32,...] [--lanes 1,2,3,5]
        [--clusters 1,2,4,8] [--skip backward|overlap] [--rounds 1]

K1's backward at chip_smoke.k1_backward_cases (the graded holes' sketch V
and W scans and the pair traces, 6x6, D=8, chi=32, a chunk of 8 chains) in
float32, float64, complex64 and complex128: this checkout's backward (one
launch of csrc/col_transfer_backward.cu through ColTransferFunction) held
to autograd of col_transfer_plain (chip_smoke's tolerance, else the
script exits non-zero), timed in turns (other, this, this, other) with the
backward of another commit's ``kernels/col_transfer.py`` (--other-k1-py,
for example the parent's, written out with ``git show``: its
ColTransferFunction launches K1 on permuted views for three gradients and
runs the site gradient as einsums) and with the plain chain's backward;
one JSON line a case with each ms, the bound, the kernel's launch plan and
the kernel alone (one launch between CUDA events) at the plan's cluster
size and at each --clusters size (at most 8). --rounds repeats the K1
backward cases, each line tagged with its round, so that a case timed
first in the process can be told from a warm one.

K5 at chip_smoke.k5_phase's per-k shape (960 closures, Lx=6, chi=32, D=8,
b broadcast over the 5 start lanes) in the same dtypes: this checkout's
kernel held to the plain version and timed in turns with another K5
source (--other-k5-src, for example the parent's ``csrc/bmps_overlap.cu``
beside the headers it includes, compiled alone into
``build/other_k5/``; its launch meta from --other-k5-py, that commit's
``kernels/bmps_overlap.py``) and with the plain loop; then this checkout's
kernel at each --lanes count a CTA (the plan's choice marked). The first
line is the card's name and power limit.
"""
import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

K5_ENTRIES = ("bmps_overlap_f32", "bmps_overlap_f64", "bmps_overlap_c64",
              "bmps_overlap_c128")


def load_module(path, name):
    """A wrapper module loaded from a file (another commit's), with its own
    caches and counters."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_other_k5(src):
    """Compile one K5 source alone (its headers beside it) into a shared
    library; its bmps_overlap_* take (a, b, mant, logw, meta, stream)."""
    from peps_tpu_torch.kernels import _build
    text = Path(src).read_bytes()
    out = ROOT / "build" / "other_k5" / \
        f"libk5_{hashlib.sha1(text).hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                               "-o", str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for name in K5_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    return lib


def k5_call(lib, meta_of, a, b):
    """One K5 launch of `lib` with the meta `meta_of` builds (a module's
    launch_meta); returns (mant, logw)."""
    import torch
    batch, a2, b2, meta = meta_of(a, b)
    rdt = a.real.dtype if a.is_complex() else a.dtype
    mant = torch.empty(batch, dtype=a.dtype, device=a.device)
    logw = torch.empty(batch, dtype=rdt, device=a.device)
    meta_c = (ctypes.c_int64 * len(meta))(*meta)
    code = getattr(lib, K5_ENTRIES[(torch.float32, torch.float64,
                                    torch.complex64, torch.complex128)
                                   .index(a.dtype)])(
        a2.data_ptr(), b2.data_ptr(), mant.data_ptr(), logw.data_ptr(),
        meta_c, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        sys.exit(f"K5 launch failed: {code}")
    return mant, logw


def bench_backward(args, peak, gen, other, rnd):
    import torch
    import chip_smoke as cs
    from peps_tpu_torch.kernels import col_transfer as k1
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    for dt in args.dtypes:
        dtype = getattr(torch, dt)
        for name, form, ops, needs in cs.k1_backward_cases(dtype, args.device,
                                                           gen):
            with torch.no_grad():
                shape = (k1.col_transfer_right(
                    *ops, transfer=k1.col_transfer_plain) if form == "right"
                    else k1.col_transfer_plain(*ops)).shape
            w = torch.randn(shape, generator=gen, device=args.device,
                            dtype=torch.float64).to(dtype)
            paths = {"this": k1.ColTransferFunction.apply,
                     "plain": k1.col_transfer_plain}
            if other is not None:
                paths[args.label] = lambda *x: other.ColTransferFunction.apply(
                    *x, other._launch)
            graphs, grads = {}, {}
            for path, fn in paths.items():
                xs = [o.detach().clone().requires_grad_(n)
                      for o, n in zip(ops, needs)]
                if form == "right":
                    out = k1.col_transfer_right(*xs, transfer=fn)
                else:
                    out = fn(*xs)
                req = [x for x in xs if x.requires_grad]
                before = kb.col_transfer_backward.launches
                grads[path] = torch.autograd.grad(out, req, w,
                                                  retain_graph=True)
                launched = kb.col_transfer_backward.launches - before
                if path == "this" and launched != 1:
                    sys.exit(f"{name} {dt}: {launched} backward launches")
                graphs[path] = (out, req)
            torch.cuda.synchronize()
            rels = {p: max(((a - b).abs().max() / b.abs().max()).item()
                           for a, b in zip(grads[p], grads["plain"]))
                    for p in paths if p != "plain"}
            if rels["this"] > cs.TOL[dt]:
                sys.exit(f"{name} {dt}: rel err {rels['this']}")

            def bw(path):
                out, req = graphs[path]
                return lambda: torch.autograd.grad(out, req, w,
                                                   retain_graph=True)

            t = cs._in_turns({p: bw(p) for p in paths}, args.reps)
            views = cs.k1_views(form, ops)
            flops, nbytes = cs.k1_backward_work(views, needs,
                                                graphs["plain"][0])
            flop_s = flops / cs._rate(peak, dtype)
            byte_s = nbytes / cs.HBM_BPS
            plan, _ = kb.launch_meta(graphs["plain"][0].detach(), *views,
                                     needs, k1.sm_count(args.device))
            # the kernel alone (one launch between CUDA events, no autograd)
            # at the plan's cluster size and at each --clusters size
            kernel = {}
            for cs_ in [None] + args.clusters:
                plan_fn = kb.backward_plan
                kb.backward_plan = (lambda *a, c=cs_, **k: plan_fn(
                    *a, **{**k, "cluster": c})) if cs_ else plan_fn
                kb._META_CACHE.clear()
                try:
                    kernel["plan" if cs_ is None else cs_] = cs.time_ms(
                        lambda: kb._launch(w, *views, needs), args.reps)
                finally:
                    kb.backward_plan = plan_fn
                    kb._META_CACHE.clear()
            print(json.dumps({
                "phase": "backward", "round": rnd, "case": name, "dtype": dt,
                "kernel_ms_by_cluster": kernel,
                "rel_err": rels, "ms": t,
                "bound_ms": max(flop_s, byte_s) * 1e3,
                "bound_by": "operations" if flop_s >= byte_s else "bytes",
                "plan": {k: plan[k] for k in ("cluster", "clusters", "ctas",
                                              "group_items", "groups",
                                              "scratch", "smem_bytes")},
                "diagnostic": kb.backward_diagnostic(dtype)}), flush=True)


def bench_overlap(args, peak, gen, other_lib, other_mod):
    import torch
    import chip_smoke as cs
    from peps_tpu_torch.kernels import bmps_overlap as k5
    from peps_tpu_torch.kernels._build import cuda_library
    nc, nb, lx, chi, D = 8, 5, cs.FLAG["L"], cs.FLAG["chi"], cs.FLAG["D"]
    lib = cuda_library().lib
    for dt in args.dtypes:
        dtype = getattr(torch, dt)
        real = torch.float32 if dt in ("float32", "complex64") \
            else torch.float64
        a = torch.randn(nc, nb, lx, 4, lx, chi, D, chi, generator=gen,
                        device=args.device, dtype=real)
        b = torch.randn(nc, 1, lx, 4, lx, chi, D, chi, generator=gen,
                        device=args.device, dtype=real)
        if dtype.is_complex:
            a = torch.complex(a, torch.randn_like(a))
            b = torch.complex(b, torch.randn_like(b))
        rm, rl = k5.bmps_overlap_plain(a, b)
        shift = rl.max()
        ref = rm * torch.exp(rl - shift)

        def err(res):
            mant, logw = res
            psi = mant * torch.exp(logw - shift)
            return ((psi - ref).abs().max() / ref.abs().max()).item()

        fns = {"this": lambda: k5.bmps_overlap(a, b),
               "plain": lambda: k5.bmps_overlap_plain(a, b)}
        if other_lib is not None:
            fns[args.label] = lambda: k5_call(other_lib, other_mod.launch_meta,
                                              a, b)
        errs = {p: err(f()) for p, f in fns.items() if p != "plain"}
        torch.cuda.synchronize()
        if errs["this"] > cs.TOL[dt]:
            sys.exit(f"K5 {dt}: rel err {errs['this']}")
        t = cs._in_turns(fns, args.reps)
        items = rm.numel()
        flops = 2 * 2 * lx * chi ** 3 * D * items * (4 if dtype.is_complex
                                                     else 1)
        nbytes = (a.numel() + b.numel() + items) * a.element_size() \
            + items * rl.element_size()
        flop_s = flops / cs._rate(peak, dtype)
        byte_s = nbytes / cs.HBM_BPS
        _, _, _, meta = k5.launch_meta(a, b)
        plan = dict(zip(("body", "lanes", "nbuf", "vec", "chi_p",
                         "smem_bytes"), meta[-6:]))
        lanes = {}
        for n in args.lanes:
            smem = k5.staged_smem(dtype, plan["chi_p"], n, plan["nbuf"])
            if plan["body"] != 1 or smem > k5.SMEM_PER_BLOCK:
                continue

            def forced(a2, b2, n=n, smem=smem):
                batch, a3, b3, m = k5.launch_meta(a2, b2)
                m[-5], m[-1] = n, smem
                return batch, a3, b3, m

            res = k5_call(lib, forced, a, b)
            if err(res) > cs.TOL[dt]:
                sys.exit(f"K5 {dt} at {n} lanes: rel err {err(res)}")
            lanes[n] = cs.time_ms(lambda: k5_call(lib, forced, a, b),
                                  args.reps)
        print(json.dumps({
            "phase": "overlap", "dtype": dt, "items": items, "rel_err": errs,
            "ms": t, "bound_ms": max(flop_s, byte_s) * 1e3,
            "bound_by": "operations" if flop_s >= byte_s else "bytes",
            "plan": plan, "ms_by_lanes": lanes}), flush=True)
        del a, b, rm, rl, ref


def main():
    import torch
    import chip_smoke as cs
    from peps_tpu_torch.kernels._build import cuda_library
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-k1-py")
    ap.add_argument("--other-k5-src")
    ap.add_argument("--other-k5-py")
    ap.add_argument("--label", default="other")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtypes",
                    default="float32,float64,complex64,complex128")
    ap.add_argument("--lanes", default="1,2,3,5")
    ap.add_argument("--clusters", default="",
                    help="cluster sizes at which to time the backward "
                         "kernel alone, besides the plan's")
    ap.add_argument("--skip", default="")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    args.dtypes = args.dtypes.split(",")
    args.lanes = [int(x) for x in args.lanes.split(",") if x]
    args.clusters = [int(x) for x in args.clusters.split(",") if x]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    args.device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    built = cuda_library()
    print(json.dumps({"phase": "build", "nvcc_s": built.seconds,
                      "ptxas": [ln for ln in built.log.splitlines()
                                if ("ptxas info" in ln or "spill" in ln)
                                and ("backward" in ln or "overlap" in ln
                                     or "spill" in ln)]}), flush=True)
    peak = cs.peak_rates(args.device)
    gen = torch.Generator(device=args.device).manual_seed(11)
    if "backward" not in args.skip:
        other = load_module(args.other_k1_py, "other_col_transfer") \
            if args.other_k1_py else None
        for rnd in range(args.rounds):
            bench_backward(args, peak, gen, other, rnd)
    if "overlap" not in args.skip:
        other_lib = build_other_k5(args.other_k5_src) \
            if args.other_k5_src else None
        other_mod = load_module(args.other_k5_py, "other_bmps_overlap") \
            if args.other_k5_py else None
        bench_overlap(args, peak, gen, other_lib, other_mod)


if __name__ == "__main__":
    main()
