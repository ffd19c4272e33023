"""Time K1 (col_transfer) at chip_smoke.py's K1 cases on one GPU, against
another K1 source in turns.

    python scripts/bench_col_transfer.py [--other-src PATH] [--other-py PATH]
        [--label NAME] [--reps 10] [--dtypes float32,...] [--paths]
    [--passes 1]

Every case of chip_smoke.k1_cases (the sketch's v and w steps, the right
BTens, the bond step, the row envs, the right blocks, the pair traces, the
walker and the 3-site window's two transfers at 8x8, D=8, chi=32, 32
chains), in float32, float64, complex64 and complex128: this checkout's K1
against its plain version (the error must meet chip_smoke's tolerance,
else the script exits non-zero), then its ms, the plain chain's, one
torch.einsum's, the bound, the launch diagnostic (plan, registers, spill
bytes, CTAs an SM) and the SM clock and board power nvidia-smi reads while
this checkout's K1 keeps the card busy; one JSON line per case.
--other-src names another K1 source (for example the parent commit's
``csrc/col_transfer.cu``, written out with ``git show`` beside the headers
it includes): it is compiled alone into ``build/other_k1/`` and timed on
the same operands in turns with this checkout's (other, this, this,
other), held to the plain version as well. Its launch meta comes from
--other-py, that commit's ``kernels/col_transfer.py``, whose wrapper then
launches the other library's entries (the plan after the sizes differs
from commit to commit); without it, this checkout's wrapper builds the
meta. With --paths, then --passes turns of chip_smoke phase 9's complex64
path on a noisy complex64 Neel product state (8x8, D=8, chi=32, 32 chains,
sketch): vmc_optimize for 2 SR iterations and measure() of 8 samples with
the walkers, each with K1's launches between CUDA events
(chip_smoke.k1_device_ms): K1's device ms, its launches, both by batch
size, and the synchronized wall seconds (which include the events' host
cost), with each
K1 (the other through the other module's wrappers in every module of the
port that calls K1). The first line is the card's name and power limit.
"""
import argparse
import contextlib
import ctypes
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ENTRIES = ("col_transfer_f32", "col_transfer_f64", "col_transfer_c64",
           "col_transfer_c128")


def build_other(src):
    """Compile one K1 source alone into a shared library; its
    col_transfer_f32/_f64/_c64/_c128 take (env, top, site, bot, out, meta,
    stream)."""
    from peps_tpu_torch.kernels import _build
    text = Path(src).read_bytes()
    out = ROOT / "build" / "other_k1" / \
        f"libk1_{hashlib.sha1(text).hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                               "-o", str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        print(json.dumps({"phase": "build_other", "src": str(src),
                          "ptxas": [ln for ln in (proc.stdout + proc.stderr)
                                    .splitlines() if "ptxas info" in ln
                                    or "spill" in ln]}), flush=True)
    lib = ctypes.CDLL(str(out))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    return lib


class _Swap:
    """The kernel library with K1's entry points taken from another library
    (the others forwarded)."""

    def __init__(self, lib, other):
        self._lib = lib
        for name in ENTRIES:
            setattr(self, name, getattr(other, name))

    def __getattr__(self, name):
        return getattr(self._lib, name)


@contextlib.contextmanager
def other_library(other):
    """K1's wrappers launch `other`'s entries inside the context."""
    from peps_tpu_torch.kernels import _build
    real = _build.cuda_library
    swapped = real()._replace(lib=_Swap(real().lib, other))
    _build.cuda_library = lambda: swapped
    try:
        yield
    finally:
        _build.cuda_library = real


def load_module(path):
    """A K1 wrapper module loaded from a file (another commit's
    kernels/col_transfer.py), with its own meta cache and counter."""
    spec = importlib.util.spec_from_file_location("other_col_transfer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def other_wrappers(module):
    """Every module of the port that calls K1 calls `module`'s wrappers
    (its launch meta) inside the context."""
    from peps_tpu_torch.kernels import col_transfer as k1
    swaps = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("peps_tpu_torch.") or mod is k1:
            continue
        for attr, new in (("col_transfer", module.col_transfer),
                          ("col_transfer_right", module.col_transfer_right)):
            if getattr(mod, attr, None) is getattr(k1, attr):
                swaps.append((mod, attr))
                setattr(mod, attr, new)
    try:
        yield
    finally:
        for mod, attr in swaps:
            setattr(mod, attr, getattr(k1, attr))


def complex_paths(device, gen, other, other_k1, label, passes):
    """chip_smoke phase 9's complex64 SR run and measure() with each K1 in
    turns, K1's launches timed (chip_smoke.k1_device_ms)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.peps import PEPS, product_peps, to_tps
    ly, lx, n = cs.LY, cs.LX, cs.LY * cs.LX
    neel = np.indices((ly, lx)).sum(axis=0) % 2
    g, lam_v, lam_h = product_peps(ly, lx, cs.D, neel, cs.PHYS,
                                   dtype=torch.complex64, device=device)
    noise = torch.randn(g.shape, generator=gen, device=device) \
        + 1j * torch.randn(g.shape, generator=gen, device=device)
    g = g + 0.05 * noise.to(torch.complex64)
    tps = to_tps(PEPS(g, torch.ones_like(lam_v), torch.ones_like(lam_h)))
    tps = tps / tps.abs().max()
    model = spin.heisenberg()
    trunc = TruncParams(cs.CHI, 1, 1e-6, scheme="sketch")
    params = VMCParams(
        cs.CHI, trunc, MCParams(num_samples=1,
                                num_warmup_sweeps=cs.WARMUP_SWEEPS,
                                nchains=cs.NCHAINS),
        OptimizerParams(cs.CLOSE_SR_ITERS, SRParams(CGParams(30, 1e-5),
                                                    diag_shift=1e-3),
                        lr=0.05),
        occupancy=((0, n // 2), (1, n - n // 2)))
    mp = MeasurementParams(num_samples=cs.MEASURE_SAMPLES,
                           num_warmup_sweeps=0, nchains=cs.NCHAINS,
                           chunk_size=cs.MEASURE_CHUNK,
                           measure_offdiag_corr=True)

    def sr():
        return vmc_optimize(tps, model, params,
                            torch.Generator(device=device).manual_seed(91))

    configs = sr().final_configs        # warm-up, and measure()'s chains

    def meas():
        return measure(tps, model, mp, cs.CHI, trunc, UpdateRule("exchange"),
                       configs,
                       generator=torch.Generator(device=device).manual_seed(92))

    turn = ["this"] if other is None else [label, "this", "this", label]
    for i, kind in enumerate(turn * passes):
        for path, fn in (("vmc_sr_complex64", sr), ("measure_complex64", meas)):
            ctx = contextlib.ExitStack()
            if kind != "this":
                ctx.enter_context(other_library(other))
                ctx.enter_context(other_wrappers(other_k1))
            by_items = {}
            with ctx:
                _, ms, calls, wall = cs.k1_device_ms(fn, by_items)
            print(json.dumps({"phase": "path", "path": path, "turn": i,
                              "k1": kind, "k1_device_ms": ms,
                              "k1_launches": calls,
                              "seconds_with_events": wall,
                              "k1_by_items": {str(k): v for k, v in
                                              sorted(by_items.items())}}),
                  flush=True)


def clock_under_load(fn, seconds=0.6):
    """The SM clock (MHz) and board power (W) nvidia-smi reads while fn's
    launches keep the card busy for about `seconds`."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(1, int(seconds / max(time.perf_counter() - t0, 1e-4)))
    for _ in range(reps):
        fn()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    mhz, watts = (float(x) for x in smi.stdout.strip().split(","))
    return mhz, watts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-src", default=None)
    ap.add_argument("--other-py", default=None)
    ap.add_argument("--label", default="other")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtypes",
                    default="float32,float64,complex64,complex128")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--passes", type=int, default=1)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    from peps_tpu_torch.kernels import col_transfer as k1
    from peps_tpu_torch.kernels._build import cuda_library
    built = cuda_library()
    print(json.dumps({"phase": "build", "seconds": built.seconds,
                      "ptxas": [ln for ln in built.log.splitlines()
                                if "ptxas info" in ln or "spill" in ln]}),
          flush=True)
    other = build_other(args.other_src) if args.other_src else None
    other_k1 = load_module(args.other_py) if args.other_py else k1
    peak = cs.peak_rates(device)
    gen = torch.Generator(device=device).manual_seed(1234)
    bad = []
    for dt in filter(None, args.dtypes.split(",")):
        dtype = getattr(torch, dt)
        rate = cs._rate(peak, dtype)
        for name, form, env, top, site, bot in cs.k1_cases(dtype, device,
                                                           gen):
            views = cs.k1_views(form, (env, top, site, bot))
            ref = k1.col_transfer_plain(*views)
            fns = {"this": lambda: k1.col_transfer(*views),
                   "plain": lambda: k1.col_transfer_plain(*views),
                   "one": lambda: torch.einsum(cs.EINSUM_1CALL, *views)}
            if other is not None:
                fns[args.label] = lambda: other_k1.col_transfer(*views)
            rec = {"case": name, "form": form, "dtype": str(dtype),
                   "items": math.prod(ref.shape[:-3])}
            # the other K1 runs inside one swap of the library's entries,
            # so that its calls cost the host what this K1's do
            def swap(key):
                return other_library(other) if key == args.label \
                    else contextlib.nullcontext()
            for key in [k for k in fns if k not in ("plain", "one")]:
                with swap(key):
                    out = fns[key]()
                torch.cuda.synchronize()
                rec[f"rel_err_{key}"] = cs.max_err(out, ref)[1]
                if not rec[f"rel_err_{key}"] <= cs.TOL[dt]:
                    bad.append((name, dt, key))
                flops, nbytes = cs.k1_work(*views, out)
                del out
            del ref
            order = ["plain", "one"]
            if other is not None:
                order += [args.label, "this", "this", args.label]
            else:
                order += ["this", "this"]
            order += ["one", "plain"]
            times = {}
            for key in order:
                with swap(key):
                    times.setdefault(key, []).append(cs.time_ms(fns[key],
                                                                args.reps))
            bound = max(flops / rate, nbytes / cs.HBM_BPS) * 1e3
            rec.update({f"ms_{k}": v for k, v in times.items()})
            mhz, watts = clock_under_load(fns["this"])
            rec.update(bound_ms=bound, pct_of_bound_this=100 * bound / (
                sum(times["this"]) / len(times["this"])),
                sm_clock_MHz_this=mhz, power_W_this=watts,
                diagnostic=k1.col_transfer_diagnostic(*views))
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    if args.paths:
        complex_paths(device, gen, other, other_k1, args.label, args.passes)
    if bad:
        sys.exit(f"K1 disagrees with the plain version: {bad}")


if __name__ == "__main__":
    main()
