"""Time K3 (pair_transfer) at chip_smoke.py's K3 cases on one GPU, against
another K3 source in turns, and one J1-J2 local-energy pass with each.

    python scripts/bench_pair_transfer.py [--other-src PATH]
        [--other-py PATH] [--label NAME] [--reps 3] [--passes 2]

Every case of chip_smoke.k3_cases (the BTen2 scan step in both forms, the
diagonal block's lblk and rblk and the anti-diagonal block's lblk at 8x8,
D=8, chi=32, 32 chains), f32, f64, complex64 and complex128: this
checkout's K3 against its plain version (the error must meet chip_smoke's
tolerance, else the script exits non-zero; at the complex128 blocks the
plain chain and the einsum run on chip_smoke.K3_SUBSET_CHAINS chains' items,
as in chip_smoke, since the whole block's intermediates pass 80 GB), then
its ms, the plain chain's, one torch.einsum's, the bound,
the launch diagnostic (plan, registers, spill bytes, CTAs an SM) and the
SM clock and board power nvidia-smi reads while this checkout's K3 keeps
the card busy; one JSON line per case. --other-src names another K3
source (for example the parent commit's ``csrc/pair_transfer.cu``,
written out with ``git show``): it is compiled alone into
``build/other_k3/`` and timed on the same operands in turns with this
checkout's (other, this, this, other), held to the plain version as well;
it reads the meta's sizes and strides, which every K3 so far takes first.
A source whose plan after the sizes differs from this checkout's (the
complex bodies before this layout) needs its own wrapper: --other-py names
that K3 module (``kernels/pair_transfer.py`` of the same commit), which
then builds the meta of every launch of the other source, in the cases
and in the energy passes.
Then ``--passes`` turns of one J1-J2 (j1j2_xxz(1, 1, .5, .5)) and one
Heisenberg local-energy pass with holes
(algorithm/energy.local_energy_and_holes, 8x8 D=8 chi=32, 32 chains, f32,
a noisy Neel product state), and of the J1-J2 pass on that state in
complex64 (imaginary noise 0.05 added), with each K3, CUDA-synchronized
host seconds.
The first line is the card's name and power limit.
"""
import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build_other(src):
    """Compile one K3 source alone into a shared library; its
    pair_transfer_f32/_f64/_c64/_c128 take (env, top, row1, row2, bot, out,
    meta, stream)."""
    from peps_tpu_torch.kernels import _build
    text = Path(src).read_bytes()
    out = ROOT / "build" / "other_k3" / \
        f"libk3_{hashlib.sha1(text).hexdigest()[:12]}.so"
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
    ptr = ctypes.c_void_p
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8
        fn.restype = ctypes.c_int
    return lib


ENTRIES = ("pair_transfer_f32", "pair_transfer_f64", "pair_transfer_c64",
           "pair_transfer_c128")


class _Swap:
    """The kernel library with K3's entry points taken from another library
    (the others forwarded)."""

    def __init__(self, lib, other):
        self._lib = lib
        for name in ENTRIES:
            setattr(self, name, getattr(other, name))

    def __getattr__(self, name):
        return getattr(self._lib, name)


def load_module(path):
    """A K3 wrapper module loaded from a file (another commit's
    kernels/pair_transfer.py), with its own meta cache and counter."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("other_pair_transfer",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def with_k3(other, module=None):
    """A context in which K3 launches `other`'s kernel (None: this
    checkout's); with `module`, energy.py's K3 calls go through that
    module's wrappers (and so its launch meta)."""
    import contextlib

    from peps_tpu_torch.algorithm import energy
    from peps_tpu_torch.kernels import _build

    @contextlib.contextmanager
    def ctx():
        if other is None:
            yield
            return
        real = _build.cuda_library
        built = real()
        _build.cuda_library = lambda: built._replace(lib=_Swap(built.lib,
                                                               other))
        calls = energy.pair_transfer, energy.pair_transfer_right
        if module is not None:
            energy.pair_transfer = module.pair_transfer
            energy.pair_transfer_right = module.pair_transfer_right
        try:
            yield
        finally:
            _build.cuda_library = real
            energy.pair_transfer, energy.pair_transfer_right = calls
    return ctx()


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


def energy_pass_inputs(device, gen):
    """A Neel product state with noise 0.05 on every bond (boundary legs
    masked by to_tps) at chip_smoke's size, and 32 Sz = 0 configurations."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from peps_tpu_torch.peps import PEPS, product_peps, to_tps
    ly, lx = cs.LY, cs.LX
    neel = np.indices((ly, lx)).sum(axis=0) % 2
    g, lam_v, lam_h = product_peps(ly, lx, cs.D, neel, cs.PHYS,
                                   dtype=torch.float32, device=device)
    g = g + 0.05 * torch.randn(g.shape, generator=gen, device=device)
    tps = to_tps(PEPS(g, torch.ones_like(lam_v), torch.ones_like(lam_h)))
    perm = torch.stack([torch.randperm(ly * lx, generator=gen, device=device)
                        for _ in range(cs.NCHAINS)])
    cfg = torch.as_tensor(neel.ravel(), device=device)[perm]
    return tps, cfg.reshape(cs.NCHAINS, ly, lx)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-src", default=None)
    ap.add_argument("--other-py", default=None)
    ap.add_argument("--label", default="other")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--passes", type=int, default=2)
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
    from peps_tpu_torch.kernels import pair_transfer as k3
    from peps_tpu_torch.kernels._build import cuda_library
    cuda_library()
    other = build_other(args.other_src) if args.other_src else None
    other_mod = load_module(args.other_py) if args.other_py else None
    other_k3 = k3 if other_mod is None else other_mod
    peak = cs.peak_rates(device)
    gen = torch.Generator(device=device).manual_seed(1234)
    bad = []
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128):
        tol = cs.TOL[str(dtype).split(".")[1]]
        rate = cs._rate(peak, dtype)
        for name, form, *ops in cs.k3_cases(dtype, device, gen):
            views = cs.k3_views(form, ops)
            sub = views
            if "block" in name and dtype == torch.complex128:
                sub = cs.k3_subset(views)
            ref = k3.pair_transfer_plain(*sub)
            fns = {"this": lambda: k3.pair_transfer(*views),
                   "plain": lambda: k3.pair_transfer_plain(*sub),
                   "one": lambda: torch.einsum(cs.EINSUM_K3, *sub)}
            if other is not None:
                def run_other():
                    with with_k3(other):
                        return other_k3.pair_transfer(*views)
                fns[args.label] = run_other
            rec = {"case": name, "form": form, "dtype": str(dtype),
                   "plain_items": math.prod(ref.shape[:-4])}
            for key in [k for k in fns if k not in ("plain", "one")]:
                out = fns[key]()
                torch.cuda.synchronize()
                rec[f"rel_err_{key}"] = cs.max_err(
                    out[:cs.K3_SUBSET_CHAINS] if sub is not views else out,
                    ref)[1]
                if not rec[f"rel_err_{key}"] <= tol:
                    bad.append((name, str(dtype), key))
                flops, nbytes = cs.k3_work(*views, out)
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
                times.setdefault(key, []).append(cs.time_ms(fns[key],
                                                            args.reps))
            bound = max(flops / rate, nbytes / cs.HBM_BPS) * 1e3
            rec.update({f"ms_{k}": v for k, v in times.items()})
            mhz, watts = clock_under_load(fns["this"])
            diag = k3.pair_transfer_diagnostic(*views)
            rec.update(bound_ms=bound, pct_of_bound_this=100 * bound / (
                sum(times["this"]) / len(times["this"])),
                sm_clock_MHz_this=mhz, power_W_this=watts,
                diagnostic={k: v for k, v in diag.items() if k != "dtype"})
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()

    from peps_tpu_torch.algorithm.energy import (ModelTensors,
                                                 local_energy_and_holes)
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    tps, cfg = energy_pass_inputs(device, gen)
    tps_c64 = (tps + 0.05j * torch.randn(tps.shape, generator=gen,
                                         device=device)
               * (tps != 0)).to(torch.complex64)
    trunc = TruncParams(cs.CHI, 1, 1e-6, scheme="sketch")
    for model_name, model, state in (
            ("j1j2", spin.j1j2_xxz(1, 1, 0.5, 0.5), tps),
            ("heisenberg", spin.heisenberg(), tps),
            ("j1j2_complex64", spin.j1j2_xxz(1, 1, 0.5, 0.5), tps_c64)):
        mt = ModelTensors.from_model(model, state.dtype, device)
        turn = [None] if other is None else [other, None, None, other]
        for i, kind in enumerate([None] + turn * args.passes):
            with with_k3(kind, other_mod):     # pass 0 warms up
                k3.pair_transfer.launches = 0
                other_k3.pair_transfer.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = local_energy_and_holes(state, cfg, mt, cs.CHI, trunc)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            print(json.dumps({"phase": "energy_pass", "model": model_name,
                              "pass": i,
                              "k3": "this" if kind is None else args.label,
                              "seconds": sec,
                              "k3_launches": (k3.pair_transfer.launches
                                              + (other_k3.pair_transfer
                                                 .launches if other_mod
                                                 else 0)),
                              "finite": bool(torch.isfinite(res.e_loc)
                                             .all())}), flush=True)
    if bad:
        sys.exit(f"K3 disagrees with the plain version: {bad}")


if __name__ == "__main__":
    main()
