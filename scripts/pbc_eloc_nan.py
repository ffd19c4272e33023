"""Where a float32 torus local energy turns NaN on the card.

    python scripts/pbc_eloc_nan.py [--fixture tests/data/pbc_eloc_nan.pt]
        [--replay] [--device cuda] [--out DIR]

The fixture holds a float32 4x4 D=3 torus state (chip_smoke.py's phase 12
state as an H100 built it) and one Sz = 0 configuration whose float32
local energy (chi=12, examples/heisenberg_pbc_vmc.py's fast scheme) came
out NaN on the card while float64 and the CPU's float32 are finite. The
script evaluates that configuration on --device in float32 under a
dispatch mode that records every operation whose output is not finite
while its inputs are (the operation, its shapes, the port's frames that
called it), counts the fast scheme's Cholesky factorizations that needed
the grown jitter or failed it, and, for every SVD on a CUDA tensor, the
matrices whose default result differs from cuSOLVER's gesvdj
result (torch recomputes a matrix by gesvd where gesvdj did not
converge). It prints the non-finite entries of the bond tables with the
Hamiltonian entry that multiplies each, then the same energy in float64
on --device and in float32 on the CPU.

With --replay it replays scripts/pbc_sampler_bias.py's local-energy run
(32 chains from random Sz = 0 configurations, seed 20, the full-recompute
sweep, 8 samples after 2 warm-up sweeps): for each sample batch the
chains whose local energy is not finite and the bond tables' non-finite
entries, each with the Hamiltonian entry that multiplies it, up to the
first batch with such an entry, which is traced whole as above; the
first operation there that turns finite input into a non-finite output
is taken apart (the same call again, cuSOLVER's other SVD methods, the
bad items alone) and its bad items saved to DIR/first_nan_items.pt.
Prints JSON lines, the first the card's name and power limit.
"""
import argparse
import itertools
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


# operations that write a NaN on purpose (the failed-Cholesky and
# non-finite-SVD markers) or leave memory unwritten, not from arithmetic
CONSTANTS = {"full", "full_like", "fill", "scalar_tensor", "lift_fresh",
             "empty", "empty_like", "new_empty", "empty_strided"}


def emit(rec):
    print(json.dumps(rec), flush=True)


class Counters:
    """The grown-jitter and SVD-method counts of one evaluation."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.chol_calls = self.chol_grown = self.chol_failed = 0
        self.svd_calls = self.svd_matrices = self.svd_fallback = 0
        self.svd_nonfinite_from_finite = 0

    def as_dict(self):
        return dict(vars(self))


def install_counters(counters):
    """Wraps contraction.pbc._jittered_cholesky to count its matrices that
    fail the first jitter (grown) and every jitter (failed, NaN)."""
    import torch
    from peps_tpu_torch.contraction import pbc
    first = pbc._jittered_cholesky

    def counted(m, eps_rel):
        eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
        _, info = torch.linalg.cholesky_ex(m + eps_rel * eye)
        out = first(m, eps_rel)
        counters.chol_calls += 1
        counters.chol_grown += int((info > 0).sum())
        counters.chol_failed += int((~torch.isfinite(out)).any(-1).any(-1)
                                    .sum())
        return out

    pbc._jittered_cholesky = counted


def nan_trace_mode(counters, events, limit=40, probe_dir=None):
    """A TorchDispatchMode that records operations with a non-finite
    output from finite inputs (the first one taken apart by :func:`probe`
    where probe_dir is given), and compares each CUDA SVD with gesvdj."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def floats(xs):
        return [x for x in tree_leaves(xs) if isinstance(x, torch.Tensor)
                and (x.is_floating_point() or x.is_complex())]

    def finite(ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    def frames():
        return [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                for f in traceback.extract_stack()
                if "peps_tpu_torch" in f.filename][-4:]

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = str(func.overloadpacket.__name__)
            ins, outs = floats((args, kwargs)), floats(out)
            ins_ok = finite(ins)
            if name == "_linalg_svd":
                a = ins[0]
                n = a.reshape(-1, *a.shape[-2:]).shape[0]
                counters.svd_calls += 1
                counters.svd_matrices += n
                if ins_ok and not finite(outs):
                    counters.svd_nonfinite_from_finite += 1
                if a.is_cuda and ins_ok:
                    s_j = torch.linalg.svd(a, full_matrices=False,
                                           driver="gesvdj")[1]
                    s_d = out[1]
                    diff = (s_j != s_d).reshape(n, -1).any(-1)
                    counters.svd_fallback += int(diff.sum())
            if ins_ok and outs and name not in CONSTANTS \
                    and not finite(outs) and len(events) < limit:
                events.append({"op": name,
                               "in_shapes": [list(t.shape) for t in ins],
                               "out_shapes": [list(t.shape) for t in outs],
                               "frames": frames()})
                if len(events) == 1 and probe_dir is not None:
                    events[0]["probe"] = probe(name, ins[0], outs,
                                               probe_dir)
            return out

    return Mode()


def probe(name, a, outs, out_dir):
    """The first operation that turned finite input into a non-finite
    output, taken apart: its batch items [.., m, n] with a non-finite
    output, whether the same call gives them again, whether each of
    cuSOLVER's SVD methods (for an SVD) or the call on those items alone
    gives them, and those items saved to out_dir/first_nan_items.pt."""
    import torch
    m, n = a.shape[-2], a.shape[-1]
    flat = a.reshape(-1, m, n)
    nb = flat.shape[0]

    def bad_items(ts):
        bad = torch.zeros(nb, dtype=torch.bool, device=a.device)
        for t in ts:
            if t.numel() % nb == 0:
                bad |= ~torch.isfinite(t.reshape(nb, -1)).all(-1)
        return bad

    bad = bad_items(outs)
    idx = bad.nonzero().squeeze(1)
    rec = {"op": name, "items": nb, "shape": [m, n],
           "bad_items": idx.tolist()[:64], "n_bad": int(idx.numel())}

    def count(fn, x):
        try:
            res = fn(x)
            res = res if isinstance(res, (tuple, list)) else (res,)
            xb = x.reshape(-1, m, n).shape[0]
            return int((~torch.isfinite(torch.cat(
                [r.reshape(xb, -1).float() for r in res
                 if r.is_floating_point() or r.is_complex()], 1))
                .all(-1)).sum())
        except RuntimeError as exc:
            return f"raised: {str(exc)[:200]}"

    if name == "_linalg_svd":
        def svd(drv=None):
            return lambda x: torch.linalg.svd(x, full_matrices=False,
                                              driver=drv)
        rec["again"] = count(svd(), flat)
        for drv in ("gesvdj", "gesvd", "gesvda"):
            rec[f"method_{drv}"] = count(svd(drv), flat)
        rec["bad_items_alone"] = count(svd(), flat[idx])
        rec["first_bad_item_alone"] = count(svd(), flat[idx[:1]])
        rec["s_max_of_bad"] = [float(x) for x in
                               torch.linalg.matrix_norm(flat[idx[:8]], 2)]
    elif name.startswith("linalg_cholesky") or name == "cholesky":
        chol = lambda x: torch.linalg.cholesky_ex(x)[0]   # noqa: E731
        rec["again"] = count(chol, flat)
        rec["bad_items_alone"] = count(chol, flat[idx])
    else:
        rec["again"] = "not probed"
    torch.save({"items": flat[idx[:64]].cpu(), "rec": rec},
               Path(out_dir) / "first_nan_items.pt")
    return rec


def traced_energy(tps, cfg, mt, chi, trunc, counters, probe_dir=None):
    """E_loc [nc] of cfg under the trace; returns (e, events, counts)."""
    import torch
    from peps_tpu_torch.algorithm.energy_pbc import pbc_energy_and_holes
    events = []
    counters.reset()
    with torch.no_grad(), nan_trace_mode(counters, events,
                                         probe_dir=probe_dir):
        e = pbc_energy_and_holes(tps, cfg, mt, chi, trunc,
                                 with_holes=False)[0]
    return e, events, counters.as_dict()


def bond_table_report(tps, cfg, mt, chi, trunc):
    """The non-finite bond-table entries of each configuration: chain,
    bond kind and index, (p, q), and the Hamiltonian entry h[c1, c2, p, q]
    that multiplies the entry in the local energy."""
    import torch
    from peps_tpu_torch.algorithm.energy_pbc import (_bond_tables_pbc,
                                                     pbc_bonds)
    from peps_tpu_torch.tps import project
    ly, lx = tps.shape[:2]
    tn = project(tps, cfg)
    rows = []
    for name, kind in (("h_h", "h"), ("h_v", "v")):
        bonds = pbc_bonds(ly, lx, kind).to(tn.device)
        with torch.no_grad():
            tab = _bond_tables_pbc(tps, tn, bonds, chi, trunc)
        h = getattr(mt, name)
        c1 = cfg[:, bonds[:, 0], bonds[:, 1]]
        c2 = cfg[:, bonds[:, 2], bonds[:, 3]]
        for n, b, p, q in (~torch.isfinite(tab)).nonzero().tolist():
            rows.append({"chain": n, "kind": kind, "bond": b,
                         "sites": bonds[b].tolist(), "p": p, "q": q,
                         "c1": int(c1[n, b]), "c2": int(c2[n, b]),
                         "h": float(h[c1[n, b], c2[n, b], p, q]),
                         "value": float(tab[n, b, p, q])})
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixture", default=str(ROOT / "tests" / "data"
                                             / "pbc_eloc_nan.pt"))
    ap.add_argument("--replay", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/eloc_nan")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from peps_tpu_torch.algorithm.energy import ModelTensors
    from peps_tpu_torch.algorithm.energy_pbc import pbc_energy_and_holes
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        torch.cuda.set_device(dev)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    counters = Counters()
    install_counters(counters)
    model, chi, trunc, _ = cs._torus_setup()
    fx = torch.load(args.fixture)
    tps32 = fx["tps"].to(dev)
    cfg = fx["config"][None].to(dev)
    mts = {(dt, d.type): ModelTensors.from_model(model, dt, d)
           for dt in (torch.float32, torch.float64)
           for d in (dev, torch.device("cpu"))}
    e, events, counts = traced_energy(tps32, cfg, mts[torch.float32,
                                                      dev.type],
                                      chi, trunc, counters)
    L = tps32.shape[0]
    emit({"step": "alone", "device": str(dev), "dtype": "float32",
          "e_per_site": e.tolist()[0] / L ** 2, "counts": counts,
          "events": events,
          "bond_tables": bond_table_report(
              tps32, cfg, mts[torch.float32, dev.type], chi, trunc)})
    e64 = pbc_energy_and_holes(tps32.double(), cfg,
                               mts[torch.float64, dev.type], chi, trunc,
                               with_holes=False)[0]
    e_cpu = pbc_energy_and_holes(tps32.cpu(), cfg.cpu(),
                                 mts[torch.float32, "cpu"], chi, trunc,
                                 with_holes=False)[0]
    emit({"step": "witnesses", "e64_per_site": float(e64[0]) / L ** 2,
          "e32_cpu_per_site": float(e_cpu[0]) / L ** 2})
    if args.replay:
        os.makedirs(args.out, exist_ok=True)
        replay(tps32, mts[torch.float32, dev.type], chi, trunc, counters,
               dev, args.out)


def replay(tps32, mt, chi, trunc, counters, dev, probe_dir, nc=32,
           samples=8):
    """scripts/pbc_sampler_bias.py's local-energy run, full recompute: for
    each sample batch, the chains whose E_loc is not finite and the bond
    tables' non-finite entries (with the Hamiltonian entry of each), up to
    the first batch with such an entry, which is traced whole."""
    import torch
    from peps_tpu_torch.algorithm.energy_pbc import pbc_energy_and_holes
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.montecarlo.sweep_pbc import (draw_uniforms_pbc,
                                                     mc_sweep_pbc)
    L = tps32.shape[0]
    ones = list(itertools.combinations(range(L * L), L * L // 2))
    allc = torch.zeros(len(ones), L * L, dtype=torch.int64)
    for i, c in enumerate(ones):
        allc[i, list(c)] = 1
    allc = allc.reshape(-1, L, L).to(dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    cfg = allc[torch.randint(allc.shape[0], (nc,), generator=gen,
                             device=dev)]
    rule = UpdateRule("exchange")
    for s in range(2 + samples):
        u = draw_uniforms_pbc(gen, nc, L, L, torch.float32, dev)
        cfg, _ = mc_sweep_pbc(tps32, cfg, chi, trunc, rule, u)
        if s < 2:
            continue
        e = pbc_energy_and_holes(tps32, cfg, mt, chi, trunc,
                                 with_holes=False)[0]
        rows = bond_table_report(tps32, cfg, mt, chi, trunc)
        emit({"step": "replay", "sample": s - 2,
              "nan_chains": (~torch.isfinite(e)).nonzero().squeeze(1)
              .tolist(), "e_per_site_range": [float(e.min()) / L ** 2,
                                              float(e.max()) / L ** 2],
              "nonfinite_table_entries": len(rows),
              "of_them_with_h_nonzero": sum(r["h"] != 0 for r in rows),
              "bond_tables": rows[:8]})
        if rows:
            e2, events, counts = traced_energy(tps32, cfg, mt, chi, trunc,
                                               counters, probe_dir)
            emit({"step": "replay_traced", "sample": s - 2,
                  "nan_chains_again": (~torch.isfinite(e2)).nonzero()
                  .squeeze(1).tolist(), "counts": counts,
                  "events": events})
            return


if __name__ == "__main__":
    main()
