"""One-call import surface of the port (port of ``peps_tpu/api.py``).

It holds the names of the reference's ``__all__`` that the port has so
far, the torus among them; later slices add the rest (the loop update).
"""
from __future__ import annotations

from peps_tpu_torch.algorithm.energy_fermion import FermionTensors
from peps_tpu_torch.algorithm.energy import (ModelTensors,
                                             local_energy_and_holes_dressed,
                                             psi_consistency_check)
from peps_tpu_torch.algorithm.exact_measure import exact_sum_measure
from peps_tpu_torch.algorithm.exact_sum import (all_configs,
                                                exact_sum_energy_gradient,
                                                exact_sum_evaluation,
                                                sector_configs)
from peps_tpu_torch.algorithm.mc_evaluator import MCParams
from peps_tpu_torch.algorithm.measure import (MeasurementParams,
                                              MeasureResult, measure)
from peps_tpu_torch.algorithm.measure_fermion import tj_singlet_pair_corr_row
from peps_tpu_torch.algorithm.registry import (Observable,
                                               structure_factor_spsm_row)
from peps_tpu_torch.algorithm.vmc_optimize import (VMCParams, VMCResult,
                                                   vmc_optimize)
from peps_tpu_torch.contraction.bmps import entanglement_entropy
from peps_tpu_torch.contraction.pbc import (amplitude_pbc, contract_pbc,
                                            punch_all_holes_pbc)
from peps_tpu_torch.lattice import BoundaryCondition
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.fermion.convert import fermion_project
from peps_tpu_torch.fermion.peps import (FermionSpace, fermion_simple_update,
                                         product_fermion_peps,
                                         space_for_model, to_tps_fermion)
from peps_tpu_torch.fermion.tables import fermion_ratio_tables
from peps_tpu_torch.fermion.vmc import (GradedFermionModel, amplitude_fermion,
                                        local_energy_and_holes_graded,
                                        mc_sweep_fermion)
from peps_tpu_torch.fermion.sweep import mc_sweep_fermion_shared
from peps_tpu_torch.models import fermion, spin
from peps_tpu_torch.montecarlo.engine import (init_configs_occupancy,
                                              init_configs_uniform,
                                              load_configs, save_configs)
from peps_tpu_torch.montecarlo.jastrow import JastrowDress
from peps_tpu_torch.montecarlo.sweep import UpdateRule
from peps_tpu_torch.optimizer.optimizer import (AdaGradParams, AdamParams,
                                                LBFGSParams, MinSRParams,
                                                OptimizerParams, SGDParams,
                                                SRParams)
from peps_tpu_torch.peps import (PEPS, SimpleUpdateParams, product_peps,
                                 product_peps_pbc, simple_update, to_tps,
                                 to_tps_pbc)
from peps_tpu_torch.peps_cluster import (simple_update_nnn,
                                         simple_update_triangle)
from peps_tpu_torch.tps import (expand_bond_dim, load_tps, project,
                                random_tps, save_tps, wavefunction_sum)

__all__ = [
    "BoundaryCondition", "TruncParams", "UpdateRule",
    "MCParams", "MeasurementParams", "MeasureResult", "measure",
    "VMCParams", "VMCResult", "vmc_optimize",
    "all_configs", "sector_configs", "exact_sum_evaluation",
    "exact_sum_energy_gradient",
    "init_configs_occupancy", "init_configs_uniform",
    "SGDParams", "AdaGradParams", "AdamParams", "SRParams", "MinSRParams",
    "LBFGSParams", "OptimizerParams",
    "PEPS", "SimpleUpdateParams", "product_peps", "simple_update", "to_tps",
    "random_tps", "project", "save_tps", "load_tps",
    "simple_update_nnn", "simple_update_triangle",
    "fermion", "spin", "FermionTensors", "ModelTensors",
    "local_energy_and_holes_dressed", "psi_consistency_check",
    "exact_sum_measure", "tj_singlet_pair_corr_row", "JastrowDress", "load_configs", "save_configs",
    "wavefunction_sum", "expand_bond_dim", "entanglement_entropy",
    "Observable", "structure_factor_spsm_row", "fermion_ratio_tables",
    "FermionSpace", "space_for_model", "product_fermion_peps",
    "fermion_simple_update", "to_tps_fermion", "fermion_project",
    "GradedFermionModel", "amplitude_fermion",
    "local_energy_and_holes_graded", "mc_sweep_fermion",
    "mc_sweep_fermion_shared",
    "product_peps_pbc", "to_tps_pbc", "contract_pbc", "amplitude_pbc",
    "punch_all_holes_pbc",
]
