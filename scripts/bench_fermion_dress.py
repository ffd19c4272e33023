"""Time K4 (fermion_dress) on one GPU against another commit's K4, source
and wrapper, in turns.

    git show HEAD~1:peps_tpu_torch/csrc/fermion_dress.cu \
        > build/parent_k4/fermion_dress.cu
    git show HEAD~1:peps_tpu_torch/kernels/fermion_dress.py \
        > build/parent_k4/fermion_dress.py
    python scripts/bench_fermion_dress.py \
        --other-src build/parent_k4/fermion_dress.cu \
        --other-py build/parent_k4/fermion_dress.py [--other-args 7] \
        [--label parent] [--rounds 2] [--dtypes float32,...]

At chip_smoke's K4 cases (6x6, D=8, d=3, 32 chains: the projection with
either flag, one row's candidates, a per-chain gradient undressed through
a stride-0 physical axis) in float32, float64, complex64 and complex128:
this checkout's K4 and the other one, each held exactly to this
checkout's plain version (else the script exits non-zero), timed in
turns (other, this, this, other) three ways: the device time alone
(chip_smoke.graph_ms: a CUDA graph of 20 launches, events around its
replays), the host microseconds a call (chip_smoke.host_us: no
synchronisation between calls) and back-to-back calls between CUDA events.
The other source is compiled alone into build/other_k4/ and its entries
take --other-args pointers (7 in the K4 before its redesign: tps,
config, codes, leg parities, out, meta, stream); the other wrapper is
loaded from
--other-py with its ``cuda_library().lib`` pointed at that library,
so each wrapper drives its own kernel. One JSON line a case and round, with
the bound (chip_smoke.k4_bytes over 3.35 TB/s); the first line is the
card's name and power limit, the next the registers of this checkout's
K4 kernels from the build's ptxas output (empty where the library was
already built).
"""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ENTRIES = ("fermion_dress_f32", "fermion_dress_f64", "fermion_dress_c64",
           "fermion_dress_c128")


def build_other(src, nargs):
    """Compile one K4 source alone into a shared library."""
    from peps_tpu_torch.kernels import _build
    text = Path(src).read_bytes()
    out = ROOT / "build" / "other_k4" / \
        f"libk4_{hashlib.sha1(text).hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                               "-o", str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * nargs
        fn.restype = ctypes.c_int
    return lib


def load_other_wrapper(path, lib):
    """The other commit's wrapper module, its launches going to `lib`."""
    text = Path(path).read_text().replace("cuda_library().lib", "_OTHER_LIB")
    mod = types.ModuleType("other_fermion_dress")
    mod.__file__ = str(path)
    mod._OTHER_LIB = lib
    sys.modules[mod.__name__] = mod
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-src")
    ap.add_argument("--other-py")
    ap.add_argument("--other-args", type=int, default=7)
    ap.add_argument("--label", default="other")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--dtypes",
                    default="float32,float64,complex64,complex128")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke as cs
    from peps_tpu_torch.fermion.convert import dress_tables
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.kernels import fermion_dress as k4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    other = None
    if args.other_src:
        if not args.other_py:
            sys.exit("--other-src needs --other-py")
        other = load_other_wrapper(args.other_py,
                                   build_other(args.other_src,
                                               args.other_args))
    from peps_tpu_torch.kernels._build import cuda_library
    regs, fn = {}, None
    for line in cuda_library().log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else None
        elif "Used" in line and "registers" in line and fn \
                and "dress_kernel" in fn:
            regs[fn] = line.split("ptxas info    :")[-1].strip()
    print(json.dumps({"ptxas": regs}), flush=True)
    L, D = cs.FLAG["L"], cs.FLAG["D"]
    tab = dress_tables(FermionSpace((0, 1, 1), D // 2, D // 2), L, L)
    gen = torch.Generator(device=device).manual_seed(4321)
    for rnd in range(args.rounds):
        for dt in args.dtypes.split(","):
            for name, kw in cs.K4_CASES:
                tps, cfg = cs.k4_operands(name, dt, device, gen)
                ref = k4.fermion_dress_plain(tps, cfg, tab, **kw)
                paths = {"this": k4.fermion_dress}
                if other is not None:
                    paths[args.label] = other.fermion_dress
                calls = {}
                for path, fn in paths.items():
                    out = fn(tps, cfg, tab, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        sys.exit(f"{path} {name} {dt}: not equal to the "
                                 "plain version")
                    calls[path] = (lambda f=fn: f(tps, cfg, tab, **kw))
                order = list(paths) + list(paths)[::-1]
                dev = {p: [] for p in paths}
                host = {p: [] for p in paths}
                for p in order:
                    dev[p].append(cs.graph_ms(calls[p]))
                    host[p].append(cs.host_us(calls[p]))
                stream = cs._in_turns(calls, 10)
                bound_ms = cs.k4_bytes(tps, cfg, ref, **kw) / cs.HBM_BPS * 1e3
                print(json.dumps({
                    "round": rnd, "case": name, "dtype": dt,
                    "device_ms": {p: sum(v) / len(v) for p, v in dev.items()},
                    "host_us": {p: sum(v) / len(v) for p, v in host.items()},
                    "stream_ms": stream, "bound_ms": bound_ms,
                    "pct_of_bound": {p: 100 * bound_ms * len(v) / sum(v)
                                     for p, v in dev.items()}}),
                    flush=True)
                del ref


if __name__ == "__main__":
    main()
