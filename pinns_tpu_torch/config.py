"""Typed experiment configuration (mirror of ``pinns_tpu/config.py``).

The dataclasses, their defaults and ``override`` are the JAX package's, field
for field (``tests/test_torch_config.py`` holds them equal); the JAX module's
comments document each field. They are mirrored rather than imported because
``import pinns_tpu.config`` imports jax through ``pinns_tpu/__init__.py``, and
the machine that runs the port has no jax.

Fields that name a feature the port has not reached yet are carried so that a
JAX experiment maps one to one; the code that would act on such a field raises
``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class ModelConfig:
    layers: Tuple[int, ...] = (2, 20, 20, 20, 20, 20, 20, 20, 20, 1)
    precision: str = "highest"  # the port always runs full float32 (TF32 off)
    dtype: str = "float32"
    # the bf16 stream policy (ops/taylor.py): "" = none, or a dtype name
    # ("bfloat16"); keep_streams is a subset of ('value', 'xx')
    compute_dtype: str = ""
    keep_streams: Tuple[str, ...] = ()
    mixed_elementwise: bool = False
    n_fourier: int = 0  # Fourier features (models.mlp.fourier_matrix)
    fourier_sigma: float = 3.0
    fourier_seed: int = 0
    n_paths: int = 0  # trainable shock paths (slice 2b-ii)
    path_degree: int = 2
    path_sharpness: float = 8.0


@_frozen
class PDEConfig:
    kind: str = "burgers"  # 'burgers' | 'euler' (slice 2)
    lambda1: float = 1.0  # convection coefficient
    lambda2: float = 0.0  # viscosity
    gamma: float = 1.4  # ratio of specific heats (Euler)
    train_coeffs: bool = False  # identification mode: lambda1/2 trainable
    lambda2_transform: str = "identity"  # 'identity' | 'exp'


@_frozen
class SamplingConfig:
    n_f: int = 1000
    # 'resample_uniform' | 'fixed_uniform' | 'fixed_lhs' | 'fixed_lhs_anchored'
    # | 'rad' (redrawn at chunk boundaries: train.trainer.rad_resample)
    strategy: str = "resample_uniform"
    rad_pool_factor: int = 8
    rad_k: float = 1.0
    rad_c: float = 1.0
    seed: int = 1234
    t_curriculum_epochs: int = 0  # time curriculum: slice 2
    t_curriculum_floor: float = 0.05
    microbatch: int = 1  # residual chunks per batch (trainer._residual_term)
    microbatch_remat: str = "full"  # 'full' | 'dots' | 'none'
    microbatch_unroll: int = 1  # an XLA scan knob; the port ignores it


@_frozen
class LossConfig:
    data_kind: str = "mse_sum"  # 'mse_sum' | 'l2_norm'
    # 'mean_sq' | 'l2_sq_norm' | 'l1_sq_norm' | 'admm' | 'flux' (slice 2)
    residual_kind: str = "admm"
    flux_dx_frac: float = 0.02
    flux_dt_frac: float = 0.02
    flux_quad: int = 4
    admm_form: str = "strong"  # 'flux': slice 2
    strong_equations: Tuple[int, ...] = ()
    rho: float = 10.0  # ADMM penalty
    data_weight: float = 1.0
    residual_weight: float = 1.0
    data_field_weights: Tuple[float, ...] = ()
    grad_weight_kappa: float = 0.0  # gradient weighting: slice 2
    causal_eps: float = 0.0  # causal weighting: slice 2
    causal_bins: int = 32
    causal_relative: bool = False
    entropy_weight: float = 0.0  # entropy penalty: slice 2
    explicit_inner: bool = False  # Hwan ADMM's dual^T r term
    # 'resampled' (the reference: z/dual at the NEW points) | 'current'
    admm_update_points: str = "resampled"


@_frozen
class LBFGSConfig:
    max_iters: int = 5000
    history: int = 50
    max_ls: int = 50
    ftol: float = 1e-12
    gtol: float = 1e-7


@_frozen
class OptimizerConfig:
    kind: str = "adam"  # 'adam' | 'lbfgs' | 'hybrid' (L-BFGS: its own slice)
    learning_rate: float = 1e-3
    lr_schedule: str = "constant"  # 'constant' | 'cosine' | 'exponential'
    schedule_epochs: int = 50_000
    min_lr_fraction: float = 0.01
    switch_epoch: int = 50_000  # Adam -> L-BFGS switch
    lbfgs: LBFGSConfig = LBFGSConfig()


@_frozen
class DataConfig:
    dataset: str = "twosin_burgers_shock"  # key or path
    n_u: int = 100
    selection: str = "ic_bc"  # 'ic_bc' | 'interior'
    seed: int = 1234
    noise: float = 0.0


@_frozen
class MeshConfig:
    data_parallel: int = 1  # multi-GPU: slice 6
    ensemble: int = 1  # members of train's ensemble (slice 4a: parallel.ensemble)


@_frozen
class TrainConfig:
    epochs: int = 100_000
    chunk: int = 1000  # steps per chunk: metrics stay on the device in between
    scan_unroll: int = 0  # an XLA scan knob; the port ignores it
    log_every: int = 1000  # metrics-log cadence in epochs; <= 0 = final only
    snapshot_every: int = 0
    checkpoint_every: int = 0  # 0 = only final
    seed: int = 1234
    out_dir: str = ""  # empty = no file output
    profile_dir: str = ""  # trace the second chunk with torch.profiler into this directory
    stop_tol: float = 0.0  # stop once |loss| <= stop_tol, checked per chunk
    swa_frac: float = 0.0  # SWA over the tail: train.trainer.swa_update


@_frozen
class Experiment:
    name: str = "experiment"
    model: ModelConfig = ModelConfig()
    pde: PDEConfig = PDEConfig()
    sampling: SamplingConfig = SamplingConfig()
    loss: LossConfig = LossConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    data: DataConfig = DataConfig()
    mesh: MeshConfig = MeshConfig()
    train: TrainConfig = TrainConfig()

    def replace(self, **kw) -> "Experiment":
        return dataclasses.replace(self, **kw)


def override(exp: Experiment, updates: dict) -> Experiment:
    """Apply nested dotted-key overrides, e.g. {'sampling.n_f': 4000}."""
    for key, value in updates.items():
        parts = key.split(".")
        if len(parts) == 1:
            exp = dataclasses.replace(exp, **{parts[0]: value})
            continue
        # rebuild the nested frozen dataclasses along the path
        objs = [exp]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        value_ = value
        for i in range(len(parts) - 1, -1, -1):
            value_ = dataclasses.replace(objs[i], **{parts[i]: value_})
        exp = value_
    return exp
