"""The preset inventory (mirror of ``pinns_tpu/experiments/presets.py``).

Every preset of the JAX package, field for field (``tests/test_torch_config.py``
holds them equal); the JAX module's comments give each preset's reference
script and the reasons behind its settings. A preset whose features the port
has not reached yet is listed all the same: building its trainer raises
``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

import math

from pinns_tpu_torch.config import (
    DataConfig,
    Experiment,
    LBFGSConfig,
    LossConfig,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    PDEConfig,
    SamplingConfig,
    TrainConfig,
)

NARROW = (2,) + (20,) * 8 + (1,)  # [2, 20 x 8, 1]
WIDE = (2,) + (200,) * 8 + (1,)  # [2, 200 x 8, 1]
EULER_TRUNK = (2,) + (200,) * 5 + (3,)  # [2, 200 x 5, 3]
NU = 0.01 / math.pi  # 0.0031831, the canonical Burgers viscosity

# the Euler presets share their model, PDE, sampling and loss
_EULER_WEAK = dict(
    model=ModelConfig(layers=EULER_TRUNK, n_paths=2, path_sharpness=12.0),
    pde=PDEConfig(kind="euler", gamma=1.4, lambda2=1e-3),
    sampling=SamplingConfig(
        n_f=1000, strategy="resample_uniform", t_curriculum_epochs=100_000,
    ),
    loss=LossConfig(
        data_kind="mse_sum", residual_kind="flux",
        data_field_weights=(5.0, 1.0, 1.0), strong_equations=(0,),
    ),
    data=DataConfig(dataset="abgrall_eulers", n_u=200),
)

PRESETS = {
    # --- Burgers continuous_inference (forward) --------------------------
    "hwan_l2": Experiment(
        name="hwan_l2",
        model=ModelConfig(layers=NARROW),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=0.0),
        sampling=SamplingConfig(n_f=10_000, strategy="fixed_lhs_anchored"),
        loss=LossConfig(data_kind="l2_norm", residual_kind="mean_sq"),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="abgrall_burgers_shock", n_u=100),
        train=TrainConfig(epochs=100_000, stop_tol=1e-4),
    ),
    "hwan_admm": Experiment(
        name="hwan_admm",
        model=ModelConfig(layers=NARROW),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=0.0),
        sampling=SamplingConfig(n_f=10_000, strategy="fixed_lhs_anchored"),
        loss=LossConfig(
            data_kind="mse_sum", residual_kind="admm", rho=10.0,
            explicit_inner=True,
        ),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="burgers_shock", n_u=100),
        train=TrainConfig(epochs=100_000),
    ),
    # --- Burgers continuous_identification -------------------------------
    "abgrall_admm": Experiment(
        name="abgrall_admm",
        model=ModelConfig(layers=NARROW),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=0.0),
        sampling=SamplingConfig(n_f=1000, strategy="resample_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="admm", rho=10.0),
        optimizer=OptimizerConfig(kind="hybrid", switch_epoch=50_000),
        data=DataConfig(dataset="twosin_burgers_shock", n_u=100),
        train=TrainConfig(epochs=100_000),
    ),
    "abgrall_l1": Experiment(
        name="abgrall_l1",
        model=ModelConfig(layers=WIDE),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=0.0),
        sampling=SamplingConfig(n_f=1000, strategy="resample_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="l1_sq_norm"),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="abgrall_burgers_shock", n_u=100),
        train=TrainConfig(epochs=100_000),
    ),
    "abgrall_l2": Experiment(
        name="abgrall_l2",
        model=ModelConfig(layers=WIDE),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=0.0),
        sampling=SamplingConfig(n_f=1000, strategy="resample_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="l2_sq_norm"),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="abgrall_burgers_shock", n_u=100),
        train=TrainConfig(epochs=100_000),
    ),
    "abgrall_visc": Experiment(
        name="abgrall_visc",
        model=ModelConfig(layers=WIDE),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=4.8e-3),
        sampling=SamplingConfig(n_f=1000, strategy="resample_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="l2_sq_norm"),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="abgrall_burgers_shock", n_u=100),
        train=TrainConfig(epochs=100_000),
    ),
    "burgers_admm_batch": Experiment(
        name="burgers_admm_batch",
        model=ModelConfig(layers=NARROW),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=NU),
        sampling=SamplingConfig(n_f=5000, strategy="resample_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="admm", rho=40.0),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="burgers_shock", n_u=100),
        train=TrainConfig(epochs=100_000),
    ),
    "burgers_batch_l1sq": Experiment(
        name="burgers_batch_l1sq",
        model=ModelConfig(layers=NARROW),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=NU),
        sampling=SamplingConfig(n_f=1000, strategy="fixed_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="l1_sq_norm"),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="burgers_shock", n_u=100),
        train=TrainConfig(epochs=100_000),
    ),
    # --- Euler continuous_inference --------------------------------------
    "euler_admm": Experiment(
        name="euler_admm",
        model=ModelConfig(layers=EULER_TRUNK),
        pde=PDEConfig(kind="euler", gamma=1.4),
        sampling=SamplingConfig(n_f=1000, strategy="resample_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="admm", rho=40.0),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="abgrall_eulers", n_u=200),
        train=TrainConfig(epochs=100_000, chunk=250),
    ),
    "euler_admm_tuned": Experiment(
        name="euler_admm_tuned",
        model=ModelConfig(layers=EULER_TRUNK),
        pde=PDEConfig(kind="euler", gamma=1.4),
        sampling=SamplingConfig(
            n_f=1000, strategy="resample_uniform",
            t_curriculum_epochs=100_000,
        ),
        loss=LossConfig(
            data_kind="mse_sum", residual_kind="admm", rho=40.0,
            data_field_weights=(3.0, 1.0, 1.0),
        ),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="abgrall_eulers", n_u=200),
        train=TrainConfig(epochs=1_000_000, chunk=250),
    ),
    # --- framework-native presets ----------------------------------------
    "burgers_forward": Experiment(
        name="burgers_forward",
        model=ModelConfig(layers=NARROW),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=NU),
        sampling=SamplingConfig(n_f=10_000, strategy="fixed_lhs_anchored"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="mean_sq"),
        optimizer=OptimizerConfig(
            kind="hybrid", switch_epoch=200_000,
            lr_schedule="cosine", schedule_epochs=180_000,
            lbfgs=LBFGSConfig(max_iters=20_000),
        ),
        data=DataConfig(dataset="burgers_shock", n_u=100),
        train=TrainConfig(epochs=200_010),
    ),
    "burgers_inverse": Experiment(
        name="burgers_inverse",
        model=ModelConfig(layers=NARROW),
        pde=PDEConfig(
            kind="burgers", lambda1=0.0, lambda2=-6.0, train_coeffs=True,
            lambda2_transform="exp",
        ),
        sampling=SamplingConfig(n_f=10_000, strategy="fixed_lhs"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="mean_sq"),
        optimizer=OptimizerConfig(
            kind="hybrid", switch_epoch=50_000,
            lbfgs=LBFGSConfig(max_iters=20_000),
        ),
        data=DataConfig(dataset="burgers_shock", n_u=2000, selection="interior"),
        train=TrainConfig(epochs=50_010),
    ),
    "euler_inverse": Experiment(
        name="euler_inverse",
        model=ModelConfig(layers=EULER_TRUNK),
        pde=PDEConfig(
            kind="euler", gamma=1.4, lambda2=-6.0, train_coeffs=True,
            lambda2_transform="exp",
        ),
        sampling=SamplingConfig(n_f=1000, strategy="resample_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="flux"),
        optimizer=OptimizerConfig(
            kind="adam", lr_schedule="cosine", schedule_epochs=200_000,
        ),
        data=DataConfig(dataset="abgrall_eulers", n_u=2000, selection="interior"),
        train=TrainConfig(epochs=200_000, chunk=250),
    ),
    "twosin_weak": Experiment(
        name="twosin_weak",
        model=ModelConfig(layers=NARROW),
        pde=PDEConfig(kind="burgers", lambda1=0.377, lambda2=1e-3),
        sampling=SamplingConfig(n_f=1000, strategy="resample_uniform"),
        loss=LossConfig(data_kind="mse_sum", residual_kind="flux", causal_eps=30.0),
        optimizer=OptimizerConfig(
            kind="adam", lr_schedule="cosine", schedule_epochs=200_000,
        ),
        data=DataConfig(dataset="twosin_burgers_shock", n_u=100),
        train=TrainConfig(epochs=200_000, chunk=250),
    ),
    "euler_weak": Experiment(
        name="euler_weak",
        optimizer=OptimizerConfig(kind="adam"),
        train=TrainConfig(epochs=1_000_000, chunk=250),
        **_EULER_WEAK,
    ),
    "euler_weak_fast": Experiment(
        name="euler_weak_fast",
        optimizer=OptimizerConfig(
            kind="adam", lr_schedule="cosine", schedule_epochs=200_000,
        ),
        train=TrainConfig(epochs=200_000, chunk=250),
        **_EULER_WEAK,
    ),
    "euler_weak_tail": Experiment(
        name="euler_weak_tail",
        optimizer=OptimizerConfig(
            kind="hybrid", switch_epoch=200_000,
            lr_schedule="cosine", schedule_epochs=200_000,
        ),
        train=TrainConfig(epochs=200_050, chunk=250),
        **_EULER_WEAK,
    ),
    "burgers_scale": Experiment(
        name="burgers_scale",
        model=ModelConfig(layers=WIDE),
        pde=PDEConfig(kind="burgers", lambda1=1.0, lambda2=NU),
        sampling=SamplingConfig(
            n_f=1_048_576, strategy="resample_uniform", microbatch=128,
        ),
        loss=LossConfig(data_kind="mse_sum", residual_kind="mean_sq"),
        optimizer=OptimizerConfig(kind="adam"),
        data=DataConfig(dataset="burgers_shock", n_u=100),
        mesh=MeshConfig(data_parallel=1),
        train=TrainConfig(epochs=1000, chunk=100),
    ),
}

# The bf16 stream policies of burgers_scale as config overrides (``train
# --set``): float32; keep {xx}, the JAX package's recommended scale policy;
# keep {}, the TPU kernel's own case; max, bench.py's mixed run.
STREAM_POLICIES = {
    "f32": {},
    "keep_xx": {"model.compute_dtype": "bfloat16", "model.keep_streams": ("xx",)},
    "keep_none": {"model.compute_dtype": "bfloat16"},
    "max": {"model.compute_dtype": "bfloat16", "model.mixed_elementwise": True},
}


def get_preset(name: str) -> Experiment:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
