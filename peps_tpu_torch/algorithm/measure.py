"""Monte Carlo measurement (port of ``peps_tpu/algorithm/measure.py``):
bosonic spin models, fermionic models in the Jordan-Wigner representation
and graded fermionic states; bosonic models on the torus too.

Warm-up sweeps, then a loop of sample steps in chunks: per step
``sweeps_between_samples`` sweeps of every chain, the env stacks of the
new configurations (both frames where needed), the local energies, the
diagonal observables and the walker observables, all from those same
stacks. At each chunk's end the chunk's outputs move to host memory, so
device memory does not grow with ``num_samples``. Binned statistics per
observable, the energy's autocorrelation time and CSV dumps follow.

The reference splits its graph (cheap observables in the sample scan, the
walkers in separately jitted passes over the collected configurations) and
caches compiled executables across calls; those are XLA:TPU workarounds.
The port is eager: nothing is compiled, nothing is cached, and the walkers
run in the sample loop on the stacks the energy pass built. For a graded
state that is one GradedEnvShared per configuration (the dressed nets,
their stacks and the candidates), which the energy tables and both pair
walkers share; the reference builds the stacks twice.

The S+S- walker (:func:`_row_offdiag_corr`) is a scan of column transfers
(kernel K1 on the card), batched over chains, rows and start columns; the
pair correlators are in :mod:`peps_tpu_torch.algorithm.measure_fermion`.

On the torus (``bc=PERIODIC``, bosonic models) the warm-up and the
samples take the sweep of ``MeasurementParams.trial_sweep`` (default: the
full recompute), the local energy is the torus one, and only
the observables that need no environments are kept (the S+S- walkers
read open-boundary env stacks), as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from peps_tpu_torch.algorithm.energy import (_local_energy, model_kind,
                                             model_tensors,
                                             needs_transposed_frame)
from peps_tpu_torch.algorithm.energy_fermion import jw_tables_and_energy
from peps_tpu_torch.algorithm.mc_evaluator import (_periodic, _sweep_fn,
                                                   require_bosonic_for_pbc)
from peps_tpu_torch.algorithm.registry import (MeasureContext,
                                               fermion_registry,
                                               graded_pair_observables,
                                               spin_registry)
from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.kernels.col_transfer import col_transfer
from peps_tpu_torch.lattice import BoundaryCondition, transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo.statistics import (
    integrated_autocorrelation_time, mean_and_binned_error,
    mean_and_binned_error_batch)
from peps_tpu_torch.montecarlo.sweep import UpdateRule, draw_uniforms
from peps_tpu_torch.montecarlo.sweep_pbc import draw_uniforms_pbc
from peps_tpu_torch.tps import project


@dataclasses.dataclass(frozen=True)
class ObservableMeta:
    key: str
    description: str
    shape: tuple
    index_labels: tuple = ()
    coords: object = None      # [K, ncoord] int array or None


class MeasureResult(NamedTuple):
    stats: dict        # key -> (mean ndarray, stderr ndarray), float64
    metas: dict        # key -> ObservableMeta
    energy_autocorr_time: float
    accept_rate: float
    psi_samples: np.ndarray   # log|psi| per (sample, chain)
    # wall seconds of the sample loop alone (sweeps, evaluations, walkers
    # and the chunk fetches), from after the warm-up and the kernel build
    sampling_wall_s: float = float("nan")


@dataclasses.dataclass(frozen=True)
class MeasurementParams:
    """The reference's MeasurementParams without its XLA:TPU-only fields
    (host_sweep, fuse_bonds). eval_chunk / env_chunk: chain batch of the
    energy pass / of the walker pass (None: all chains). trial_sweep (torus
    only): the warm-up and sample sweeps recompute the whole contraction
    per proposal (False) or go through the frozen trial/commit cache
    (True, biased at a truncating chi)."""
    num_samples: int = 500
    num_warmup_sweeps: int = 100
    sweeps_between_samples: int = 1
    nchains: int = 64
    measure_offdiag_corr: bool = True
    measure_pair_corr: bool = False   # t-J <Delta^dag Delta> walkers
    chunk_size: int = 0      # >0: collect in chunks, allowing graceful stop
    handle_signals: bool = False  # SIGINT/SIGTERM -> stop after the chunk
    progress: bool = False   # a console line per chunk
    eval_chunk: int | None = None
    env_chunk: int | None = None
    trial_sweep: bool = False


def _one_point_diag(config, site_values):
    """Diagonal one-point function, e.g. Sz: site_values[d] ->
    [..., Ly, Lx]."""
    return site_values[config]


def _row_offdiag_corr(tps, tn, config, op_a, op_b, chi, trunc, stacks):
    """In-row correlator <A(x1) B(x2)> for every chain, row and x1 < x2.

    tps [Ly, Lx, d, ...]; tn / config: the projected network and the
    configurations [nc, Ly, Lx, ...]; stacks: their env stacks; op_a/op_b
    [d, d] with <c|Op|p> = op[c, p]. Returns [nc, Ly, Lx, Lx], zero where
    x2 <= x1.

    One walker per start column x1 carries the left env with A at x1. The
    walkers of all (chain, row, x1) are one K1 batch: the start transfer is
    one call, then each column x > 0 takes one call to close the walkers
    with B at x and one (all but the last) to step them through the row's
    own site; a walker at x <= x1 is held still and its value masked, as
    the reference's scan does. 2*Lx - 2 K1 launches per call."""
    ly, lx = tps.shape[0], tps.shape[1]
    top, bot = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(top, bot, tn)
    # weighted candidates: ca[..., x] = sum_p op_a[c_x, p] tps[y, x, p]
    ca = torch.einsum("nyxp,yxpuldr->nyxuldr", op_a[config], tps)
    cb = torch.einsum("nyxp,yxpuldr->nyxuldr", op_b[config], tps)
    psi_loc = torch.einsum("...uldr,...uldr->...",
                           bmps.punch_holes_row(envs, top, bot), tn)
    walker = col_transfer(envs.lefts[:, :, :lx], top, ca, bot)
    x1 = torch.arange(lx, device=tps.device)
    vals = torch.zeros(psi_loc.shape + (lx,), dtype=tps.dtype,
                       device=tps.device)
    for x in range(1, lx):
        t_x, b_x = top[:, :, x, None], bot[:, :, x, None]
        closed = col_transfer(walker, t_x, cb[:, :, x, None], b_x)
        val = torch.einsum("nyialc,nyalc->nyi", closed,
                           envs.rights[:, :, x + 1])
        # the right envs dropped other log weights than the x1 closure
        val = val * torch.exp(envs.log_rights[:, :, x + 1, None]
                              - envs.log_rights[:, :, 1:])
        vals[..., x] = torch.where(x > x1, val, torch.zeros_like(val))
        if x < lx - 1:
            stepped = col_transfer(walker, t_x, tn[:, :, x, None], b_x)
            walker = torch.where((x > x1)[:, None, None, None], stepped,
                                 walker)
    psi_ref = torch.where(psi_loc == 0, torch.ones_like(psi_loc), psi_loc)
    mask = x1[None, :] > x1[:, None]                     # [x1, x2]
    return torch.where(mask, vals / psi_ref[..., None], torch.zeros_like(vals))


def standard_spin_observables(d: int = 2):
    """Operator set of spin-1/2 models: Sz values, S+ and S-."""
    sz = np.array([0.5, -0.5] if d == 2 else np.arange(d) - (d - 1) / 2)
    sp = np.array([[0.0, 1.0], [0.0, 0.0]])
    return {"sz_values": sz, "op_a": sp, "op_b": sp.T}


def _registry(mt, kind, params, d, periodic=False):
    """The observables of a model's evaluator form mt of kind ``kind``; on
    the torus those that need no environments."""
    if kind == "bosonic":
        registry = spin_registry(params) if d == 2 else []
        return [ob for ob in registry if not (periodic and ob.needs_envs)]
    ft = mt.ft if kind == "graded" else mt
    registry = fermion_registry(ft, params)
    if kind == "graded":
        # the Jordan-Wigner walkers read plain projections
        registry = [ob for ob in registry if not ob.needs_envs]
        if params.measure_pair_corr and not ft.spinless and d == 3:
            registry += graded_pair_observables(mt.space)
    return registry


def _energy_pass(tps, tps_t, c, mt, kind, chi, trunc, with_t,
                 periodic=False):
    """(e_loc [n], log|psi| [n], stacks, stacks_t) of configurations c: the
    stacks are the graded state's GradedEnvShared or the projection's env
    stacks (and the transposed frame's with with_t); None on the torus."""
    if periodic:
        from peps_tpu_torch.algorithm.energy_pbc import pbc_energy_and_holes
        e, _, _, log_abs = pbc_energy_and_holes(tps, c, mt, chi, trunc,
                                                with_holes=False)
        return e, log_abs, None, None
    if kind == "graded":
        from peps_tpu_torch.algorithm.measure_fermion import \
            graded_env_shared
        from peps_tpu_torch.fermion.vmc import graded_energy_and_holes
        shared = graded_env_shared(tps, c, mt.space, chi, trunc)
        e, _, log_abs, _ = graded_energy_and_holes(
            tps, c, mt, chi, trunc, with_holes=False, shared=shared)
        return e, log_abs, shared, None
    stacks = bmps.all_env_stacks(project(tps, c), chi, trunc)
    stacks_t = bmps.all_env_stacks(project(tps_t, c.transpose(1, 2)), chi,
                                   trunc) if with_t else None
    if kind == "jw":
        e, tabs = jw_tables_and_energy(tps, c, mt, chi, trunc, False, stacks)
        return e, tabs.log_abs_psi, stacks, stacks_t
    e, _, log_abs, _ = _local_energy(tps, c, mt, chi, trunc, stacks,
                                     stacks_t)
    return e, log_abs, stacks, stacks_t


def _sample_outputs(tps, tps_t, cfgs, mt, chi, trunc, registry, params,
                    periodic=False):
    """Outputs of one sample step for every chain (on the device) and the
    env stacks of cfgs (the next step's first sweep starts from their
    bottoms; a graded state's are its GradedEnvShared; None on the
    torus)."""
    kind = model_kind(mt)
    cheap = [ob for ob in registry if not ob.needs_envs]
    walkers = [ob for ob in registry if ob.needs_envs]
    with_t = (kind == "bosonic" and needs_transposed_frame(mt)) \
        or any(ob.uses_stacks_t for ob in walkers)
    outs = {"energy": [], "log_abs_psi": []}
    outs.update({ob.key: [] for ob in registry})
    stacks_all, stacks_t_all = [], []
    for sl in bmps.chain_slices(cfgs.shape[0], params.eval_chunk):
        c = cfgs[sl]
        e, log_abs, stacks, stacks_t = _energy_pass(tps, tps_t, c, mt, kind,
                                                    chi, trunc, with_t,
                                                    periodic)
        ctx = MeasureContext(tps, tps_t, c, e.real, chi, trunc)
        outs["energy"].append(e.real)
        outs["log_abs_psi"].append(log_abs)
        for ob in cheap:
            outs[ob.key].append(ob.compute(ctx))
        stacks_all.append(stacks)
        stacks_t_all.append(stacks_t)
    stacks = bmps.cat_stacks(stacks_all)
    stacks_t = bmps.cat_stacks(stacks_t_all)
    zero = torch.zeros((), dtype=outs["energy"][0].dtype, device=tps.device)
    for sl in bmps.chain_slices(cfgs.shape[0], params.env_chunk):
        ctx = MeasureContext(tps, tps_t, cfgs[sl], zero, chi, trunc,
                             bmps.sub_stacks(stacks, sl),
                             bmps.sub_stacks(stacks_t, sl))
        for ob in walkers:
            outs[ob.key].append(ob.compute(ctx))
    return {k: torch.cat(v) for k, v in outs.items()}, stacks


def measure(tps: torch.Tensor, model, params: MeasurementParams, chi: int,
            trunc: TruncParams, rule: UpdateRule, configs: torch.Tensor,
            generator: torch.Generator | None = None,
            sweep_uniforms: Callable[[], tuple] | None = None,
            dump_dir: str | None = None, bc=None) -> MeasureResult:
    """Run the measurement loop on tps.device and aggregate statistics.

    model: a bosonic square-lattice model or ModelTensors, a fermionic
    model or FermionTensors (Jordan-Wigner: the bosonic sweep under
    ``rule``, e.g. Suwa-Todo with a conservation mask), or a
    GradedFermionModel (the env-shared graded sweep, exchange moves; with
    measure_pair_corr on a t-J basis the graded pair walkers). bc:
    None or OPEN, or PERIODIC for a bosonic model on the torus (each
    sweep's uniforms then [nc, 2 Ly Lx]). configs
    [nc, Ly, Lx]: the chains' starting configurations (e.g. a
    VMCResult's final_configs). Random numbers as in vmc_optimize: each
    sweep's uniforms come from ``sweep_uniforms()`` when given (the parity
    tests replay the reference's key stream), else from ``generator`` (a
    ``torch.Generator`` on tps.device; default seeded 0). A CUDA state runs
    the card's kernels and raises if one fails; there is no CPU fallback.

    sampling_wall_s differs from the reference's: there it starts right
    after the warm-up is dispatched, so a cold call also counts the
    compilation of the sample loop and the tail of the warm-up. Here the
    kernel library is built (``cuda_library()``) and the warm-up finished
    (synchronized) before the clock starts, so it counts the sample loop
    alone, the walker observables included (the reference times its
    walker pass outside the clock)."""
    periodic = _periodic(bc)
    dev = tps.device
    mt = model_tensors(model, tps.dtype, dev, "measure")
    require_bosonic_for_pbc(mt, bc)
    kind = model_kind(mt)
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    registry = _registry(mt, kind, params, d, periodic)
    sweep, shares_stacks = _sweep_fn(tps, mt, chi, trunc, rule, bc,
                                     params.trial_sweep)
    tps_t = transpose_tps(tps)
    configs = configs.to(dev).long()
    nc = configs.shape[0]
    if sweep_uniforms is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        rdt = tps.real.dtype if tps.is_complex() else tps.dtype

        def sweep_uniforms():
            if periodic:
                return draw_uniforms_pbc(generator, nc, ly, lx, rdt, dev)
            return draw_uniforms(generator, nc, ly, lx, rdt, dev)

    if dev.type == "cuda":
        from peps_tpu_torch.kernels._build import cuda_library
        cuda_library()
    for _ in range(params.num_warmup_sweeps):
        configs, _, _ = sweep(configs, sweep_uniforms(), None)

    stop = {"stop": False}
    old_handlers = {}
    if params.handle_signals:
        def _handler(signum, frame):
            stop["stop"] = True
        for sig in (signal.SIGINT, signal.SIGTERM):
            old_handlers[sig] = signal.signal(sig, _handler)
    try:
        chunk = params.chunk_size if params.chunk_size > 0 \
            else params.num_samples
        collected = []
        done = acc = tri = 0
        bots = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_start = time.perf_counter()
        while done < params.num_samples and not stop["stop"]:
            n = min(chunk, params.num_samples - done)
            acc_c = torch.zeros((), dtype=torch.int64, device=dev)
            tri_c = torch.zeros_like(acc_c)
            steps = []
            for _ in range(n):
                for i in range(params.sweeps_between_samples):
                    configs, a, t = sweep(configs, sweep_uniforms(),
                                          bots if i == 0 else None)
                    acc_c = acc_c + a
                    tri_c = tri_c + t
                out, stacks = _sample_outputs(tps, tps_t, configs, mt, chi,
                                              trunc, registry, params,
                                              periodic)
                bots = stacks.bots if shares_stacks else None
                steps.append(out)
            collected.append({k: torch.stack([o[k] for o in steps]).cpu()
                              for k in steps[0]})
            acc, tri = acc + int(acc_c), tri + int(tri_c)
            done += n
            if params.progress and done < params.num_samples:
                dt = time.perf_counter() - t_start
                eta = dt / done * (params.num_samples - done)
                print(f"[measure] {done}/{params.num_samples} samples "
                      f"({dt:.0f}s, ~{eta:.0f}s left, accept "
                      f"{acc / max(tri, 1):.3f})", flush=True)
        t_sampling = time.perf_counter() - t_start
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    if not collected:
        raise RuntimeError("measure stopped before its first chunk")
    outs = {k: torch.cat([c[k] for c in collected]) for k in collected[0]}

    stats, metas = {}, {}
    by_key = {ob.key: ob for ob in registry}
    for key, arr in outs.items():
        if key == "log_abs_psi":
            continue
        s, c = arr.shape[:2]
        m, e = mean_and_binned_error_batch(arr.reshape(s, c, -1))
        means = m.numpy().astype(np.float64)
        errs = e.numpy().astype(np.float64)
        shape = tuple(arr.shape[2:])
        stats[key] = (means.reshape(shape) if shape else means[0],
                      errs.reshape(shape) if shape else errs[0])
        ob = by_key.get(key)
        metas[key] = ObservableMeta(
            key, ob.description if ob is not None else key, shape,
            ob.index_labels if ob is not None else (),
            ob.coords(ly, lx) if ob is not None and ob.coords is not None
            else None)
    e_samples = outs["energy"].numpy()
    tau = integrated_autocorrelation_time(
        e_samples.reshape(e_samples.shape[0], -1))
    result = MeasureResult(stats, metas, tau,
                           float(acc) / max(float(tri), 1.0),
                           outs["log_abs_psi"].numpy(), t_sampling)
    if dump_dir:
        dump_stats(result, dump_dir)
    return result


def dump_stats(result: MeasureResult, dump_dir: str) -> None:
    """stats/<key>.csv (index,mean,stderr), stats/<key>_coords.txt and
    samples/log_abs_psi.csv, as the reference lays them out. Values are
    written as plain floats (the reference's numpy-2 repr writes
    "np.float64(...)" into its CSVs)."""
    os.makedirs(os.path.join(dump_dir, "stats"), exist_ok=True)
    for key, (mean, err) in result.stats.items():
        m = np.atleast_1d(mean).reshape(-1)
        e = np.atleast_1d(err).reshape(-1)
        with open(os.path.join(dump_dir, "stats", f"{key}.csv"), "w") as f:
            f.write("index,mean,stderr\n")
            for i, (mi, ei) in enumerate(zip(m, e)):
                f.write(f"{i},{float(mi)!r},{float(ei)!r}\n")
    for key, meta in result.metas.items():
        if meta.coords is not None:
            np.savetxt(os.path.join(dump_dir, "stats", f"{key}_coords.txt"),
                       np.asarray(meta.coords), fmt="%d",
                       header=",".join(meta.index_labels))
    os.makedirs(os.path.join(dump_dir, "samples"), exist_ok=True)
    np.savetxt(os.path.join(dump_dir, "samples", "log_abs_psi.csv"),
               result.psi_samples.reshape(result.psi_samples.shape[0], -1),
               delimiter=",")


def replica_gap(e_samples: np.ndarray) -> float:
    """Ergodicity diagnostic: split the chains into two replicas and return
    |E1 - E2| / sqrt(err1^2 + err2^2); values >> 3 mean the chains did not
    mix."""
    x = np.asarray(e_samples)
    if x.ndim == 1:
        x = x[:, None]
    c = x.shape[1]
    if c < 2:
        raise ValueError("replica test needs >= 2 chains")
    h = c // 2
    m1, e1 = mean_and_binned_error(torch.as_tensor(x[:, :h]))
    m2, e2 = mean_and_binned_error(torch.as_tensor(x[:, h:]))
    denom = float(torch.sqrt(e1 ** 2 + e2 ** 2))
    return abs(float(m1) - float(m2)) / max(denom, 1e-12)


def particle_number_distribution(configs: np.ndarray,
                                 state: int) -> np.ndarray:
    """Histogram of the per-configuration count of a local state;
    configs [..., Ly, Lx]."""
    cfg = np.asarray(configs)
    n_sites = cfg.shape[-1] * cfg.shape[-2]
    counts = (cfg == state).sum(axis=(-1, -2)).reshape(-1)
    return np.bincount(counts, minlength=n_sites + 1) / counts.size


def structure_factor(szsz_mean: np.ndarray, sz_mean: np.ndarray,
                     ly: int, lx: int) -> np.ndarray:
    """S(q) = (1/N) sum_ij e^{iq(ri-rj)} <Sz_i Sz_j>_c from the measured
    correlation matrix; [Ly, Lx] over the q grid."""
    n = ly * lx
    c = szsz_mean.reshape(n, n) - np.outer(sz_mean.reshape(-1),
                                           sz_mean.reshape(-1))
    coords = np.array([(y, x) for y in range(ly) for x in range(lx)])
    qy = 2 * np.pi * np.fft.fftfreq(ly)
    qx = 2 * np.pi * np.fft.fftfreq(lx)
    out = np.zeros((ly, lx))
    for iy, qy_ in enumerate(qy):
        for ix, qx_ in enumerate(qx):
            phase = np.exp(1j * (coords[:, 0] * qy_ + coords[:, 1] * qx_))
            out[iy, ix] = np.real(phase.conj() @ c @ phase) / n
    return out
