"""Centralized physics-derived defaults.

The reference scatters these through keyword defaults
(/root/reference/pyGPA/geometric_phase_analysis.py:20,915-918,
property_extract.py:511,523); here they live in one dataclass so
pipelines and benchmarks stay consistent.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class GPAConfig:
    # Gaussian lock-in window width (px). Reference default sigma=22
    # (geometric_phase_analysis.py:20); pipelines usually derive
    # sigma = ceil(1 / min |k|) instead (geometric_phase_analysis.py:917).
    sigma: float = 22.0
    # WFR k-window: kw = mean|k| / kw_scale, kstep = kw / ksteps
    # (geometric_phase_analysis.py:915-918).
    kw_scale: float = 2.5
    ksteps: int = 3
    # Phase-unwrap CG iteration tiers (phase_unwrap.py:141,
    # geometric_phase_analysis.py:117,241).
    unwrap_kmax: int = 100
    unwrap_kmax_reconstruct: int = 10
    # coarsest-level CG iterations of the multigrid unwrap: 6 is
    # gate-identical to 10 on the reference fixtures (the finer levels
    # polish)
    unwrap_kmax_mg: int = 6
    # CG iterations at the coarse//2 mid level of the default multigrid
    # schedule. "auto" = skip the level on LARGE images (mid grid >=
    # 1024 px, where the V-branch finest level's coarse revisit absorbs
    # the defect) but keep 1 iteration on small ones (at 500^2
    # skipping fails the noisy reference gate: 0.907 > 0.9 px, CPU
    # float64). An int forces that many iterations at the mid level
    # everywhere (0 = always skip).
    unwrap_mg_mid: object = "auto"
    # finest-level strategy of the multigrid unwrap schedule: 1 = one
    # full-resolution DCT-preconditioned CG step, "v"/"vv" =
    # smooth/coarse-correct/smooth V-branch rounds (transform-free at
    # full resolution, slightly wider — but gate-green — error
    # margins; see solvers/unwrap.py).
    unwrap_mg_final: object = "v"
    # CG iterations of the V-branch's coarse-grid correction solve
    # (None = inherit kmax). Small-image gates verified by the CPU
    # suite (test_pipeline).
    unwrap_mg_v_kmax: object = 4
    unwrap_kmax_iterate: int = 25
    unwrap_kmax_final: int = 200
    # Graphene lattice constant in nm (geometric_phase_analysis.py:352-368).
    a_0: float = 0.246
    # Poisson ratio for heterostrain decompositions
    # (property_extract.py:181-217,511,523).
    poisson_ratio: float = 0.16
    # Wiener deconvolution regularization (geometric_phase_analysis.py:892).
    wiener_balance: float = 5000.0
    wiener_pad: int = 20


DEFAULTS = GPAConfig()
