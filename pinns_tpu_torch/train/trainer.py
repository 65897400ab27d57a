"""The training core for the strong form of Burgers and of the Euler system
(port of ``pinns_tpu/train/trainer.py``).

One Adam epoch does what the JAX step does, in the reference's order
(``Abgrall_ADMM.py:220-226``):

  loss + gradient at the current collocation batch -> Adam update ->
  resample the batch -> ADMM z/dual update at the NEW points with the NEW
  params -> metrics

and one L-BFGS outer epoch (``make_lbfgs_step``) a whole inner solve of the
loss at the current batch and ADMM state, then the same resample -> z/dual
tail. A chunk of epochs (:func:`make_chunked`, the port of JAX's, whose
``lax.scan`` makes the chunk one device call) keeps its per-step metrics in
one device buffer, read back once per logged chunk: on the card the fused
step's chunk is replayed from captured CUDA graphs (K9), and so is the
generic step's inside ``ops.kernels.generic_chunk.generic_chunk_supported``
(one captured epoch replayed, ``GenericChunk``), the L-BFGS outer epochs
inside K10's chunk scope run on the device with K3's post-update mode as
their tail (``ops.kernels.lbfgs.LBFGSChunk``), and every other step's chunk
is the per-epoch loop (:func:`run_chunk`). ``Trainer.train`` switches from
Adam to L-BFGS chunks at ``optimizer.switch_epoch`` under 'hybrid'.

The loss goes through ``mlp_apply`` (data term) and ``mlp_taylor_2``
(Burgers residual) or ``mlp_taylor_1`` (Euler residuals), which dispatch on
the device: the plain PyTorch versions on the CPU, the hand-written kernels on
a CUDA device (K5 forward and backward; K1 forward and K2 backward; K7a
forward and backward), differentiated by ``torch.autograd`` around them.
``plain=True`` forces the plain versions on any device (the card's checks
hold the kernels against them). Two Adam steps compute an epoch:
- ``make_adam_step``: autograd through that loss, then Adam. The CPU trainer
  runs it, and so does the card for a configuration outside K3's scope.
- ``pinns_tpu_torch.ops.kernels.fused_step``: the whole epoch as the
  hand-written CUDA step K3 (the port of the TPU kernel
  ``make_fused_adam_step``). On a CUDA device the trainer takes it whenever
  the configuration is inside its scope.

Resampling draws with counter-based Philox keyed by the run's seed and the
epoch (``data.sampling.philox_uniform``; on the card K11,
``ops.kernels.sampling.philox_draw``, and K3's tail), so every step draws the
same points, inside the time curriculum's bounds when it is on
(``_curriculum_bounds``). The generic step takes the draw's seed, epoch and
bounds, its learning rate and Adam's bias corrections from a schedule row on
the device (``train.schedule``, :func:`adam_schedule`), not from host
scalars, so that one captured epoch serves every epoch of a chunk.

The Euler system (``pde.kind == 'euler'``) has three residuals (mass,
momentum, energy) from one Taylor-1 pass of a 3-output net: every residual
term sums over them, the ADMM state is a tuple, and the data term sums the
three fields' misfits, weighted by ``loss.data_field_weights``.

The residual term runs over ``sampling.microbatch`` chunks of the batch when
it is above 1 (``_residual_term``), each under the ``microbatch_remat``
policy, and the spec carries the model's stream policy (``compute_dtype``,
``keep_streams``, ``mixed_elementwise``), which ``mlp_taylor_2`` follows: K6 on
the card.

The weak form (``loss.residual_kind == 'flux'``, slice 2b-i) replaces the
strong residual by the cell-mean conservation residual at control volumes
centred on the batch (``ops.weakform``: K7b's edge points and quadrature
around K7a or K5 on the card), taken as a mean square or, with
``loss.causal_eps > 0``, by the causal-in-time penalty; it needs no ADMM
state. The Euler system's artificial viscosity rides the ``lambda2`` slot
through ``effective_coeffs`` and stays on the device. Slice 2b-ii adds the
mixed formulation (``loss.strong_equations``: the selected Euler equations
take the strong pointwise residual at the cell centres, one more Taylor-1
pass, K7a on the card) and the trainable shock-path features
(``model.n_paths``, computed inside K7a and K5 on the card): the
``euler_weak`` and ``euler_weak_fast`` presets.

Slice 2b-iii, part 1 brings the shock-capture terms of the loss and the
Euler L-BFGS branch: the entropy penalty (``loss.entropy_weight``: the strong
form's pointwise admissibility violation from the residual's own streams,
``Problem.residuals_and_entropy``; the weak form's from K7b's quadrature),
gradient weighting (``loss.grad_weight_kappa``: every consumer of the strong
residual sees the weighted field), and L-BFGS on the Euler system, whose
solve runs on K10's kernels around autograd through the loss on the card
(``ops.kernels.lbfgs.AutogradLBFGS``).

The rest of slice 2b-iii: Fourier features (``model.n_fourier``: the spec's
B from ``models.mlp.fourier_matrix``, computed inside K1/K2, K7a and K5's
wide design on the card); the weak-form ADMM (``loss.admm_form='flux'``: z
and the dual live on the weak-form cells, :meth:`Problem.training_residuals`
feeds the ADMM init and updates); RAD (``sampling.strategy='rad'``: the
batch is fixed within a chunk and redrawn at each chunk boundary by
residual-importance sampling from a Philox pool, :func:`rad_resample`); and
SWA (``train.swa_frac``: the float32 running mean of the params at the chunk
boundaries of the tail, ``Trainer.swa_params``, the summary's ``swa_*``
entries and the ``swa`` checkpoint).

Slice 6, collocation data parallelism (``parallel.sharding``): with a
``Problem.shard`` each rank holds its rows of the batch, drawn at its row
offset (:func:`_resample`), and its rows of the ADMM state; a step forms the
rank's share of the loss (the data term on data rank 0, every normalizer the
global row count: :func:`total_rows`) and sums the gradients and the loss
metrics over the data row in one flat all-reduce (:func:`make_adam_epoch`),
the ADMM misfit in a second one (:func:`_misfit`); ``l1_sq_norm``'s S is
summed before its square. The L-BFGS objective is the row's sum with its
gradient (``parallel.sharding.global_objective``), so every rank takes the
same decisions. Checkpoints gather the rows (``Trainer.save_checkpoint``).

What the port leaves to a later slice raises ``NotImplementedError`` with
the slice's name: the causal penalty and RAD under data parallelism (slice
6b, ``parallel.sharding.dp_later``), and float64 Adam training on the card
(:func:`make_step`; a float64 trainer still builds, for ``train.polish`` and
``evaluate``, and its L-BFGS solve takes K10's float64 mode over the float64
modes of the narrow K1, K2 and K5). Ensembles and sweeps train through
``pinns_tpu_torch.parallel`` (slice 4a; over several cards since slice 6)
and serve through ``serve.export_ensemble``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pinns_tpu_torch.config import Experiment
from pinns_tpu_torch.data.datasets import (
    GridDataset,
    build_ic_bc_training_set,
    ic_bc_candidates,
    interior_training_set,
    load_burgers_mat,
    load_euler_mat,
)
from pinns_tpu_torch.data.sampling import latin_hypercube, philox_uniform, scale_to_bounds, uniform_box
from pinns_tpu_torch.device import constant, pin_numerics, resolve_device
from pinns_tpu_torch.losses.admm import (
    ADMMState,
    admm_init,
    admm_misfit,
    admm_penalty,
    admm_update,
)
from pinns_tpu_torch.losses.misfit import causal_residual_penalty, data_misfit, residual_penalty
from pinns_tpu_torch.models.mlp import (
    MLPSpec,
    fourier_matrix,
    init_mlp,
    mlp_apply,
    mlp_apply_reference,
)
from pinns_tpu_torch.ops.kernels.sampling import philox_draw, philox_draw_reference
from pinns_tpu_torch.ops.residuals import euler_combine, euler_entropy_production
from pinns_tpu_torch.ops.taylor import (
    mlp_taylor_1,
    mlp_taylor_1_reference,
    mlp_taylor_2,
    mlp_taylor_2_reference,
)
from pinns_tpu_torch.ops.weakform import burgers_flux_residual, euler_flux_residuals
from pinns_tpu_torch.opt.adam import (
    AdamState,
    adam_init,
    adam_update,
    apply_updates,
    learning_rate_schedule,
    tree_leaves,
    tree_map,
)
from pinns_tpu_torch.opt.lbfgs import lbfgs_minimize, ravel_tree
from pinns_tpu_torch.parallel.sharding import dp_later, gather_state, global_objective
from pinns_tpu_torch.train import checkpoint as ckpt_io
from pinns_tpu_torch.train import schedule as epoch_schedule
from pinns_tpu_torch.train.evaluate import predict_fields, relative_l2
from pinns_tpu_torch.train.metrics import MetricsLogger

# the per-step metrics, in the sorted order the JAX chunk packs them
METRIC_KEYS = ("admm_misfit", "data_term", "lambda1", "lambda2", "lbfgs_iters",
               "loss", "res_term")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}
EULER_FIELDS = ("rho", "u", "E")


class TrainState(NamedTuple):
    params: Any  # {'net': [{'W','b'}, ...], 'coeffs': {'lambda1','lambda2'}}
    opt_state: AdamState
    admm: Optional[ADMMState]
    colloc: torch.Tensor  # (N_f, 2): the batch the NEXT step trains on
    key: int  # the run's Philox seed (JAX carries a PRNG key here)
    epoch: int
    rho: Optional[float] = None  # per-run ADMM penalty override


def check_slice(exp: Experiment) -> None:
    """Raise ``NotImplementedError`` naming the slice that brings a feature
    ``exp`` uses and the port does not have yet."""
    later = []
    m = exp.model
    checks = [
        (exp.pde.kind not in ("burgers", "euler"), f"pde.kind={exp.pde.kind!r}",
         "no slice (burgers and euler only)"),
        (m.dtype not in _DTYPES, f"model.dtype={m.dtype!r}", "no slice (float32/float64 only)"),
    ]
    for bad, what, where in checks:
        if bad:
            later.append(f"{what}: {where}")
    if exp.mesh.data_parallel > 1:
        later += dp_later(exp)
    if later:
        raise NotImplementedError(
            f"experiment {exp.name!r} uses features the port has not reached: "
            + "; ".join(later)
        )


@dataclasses.dataclass
class Problem:
    """An Experiment bound to its dataset and device-resident training data."""

    exp: Experiment
    dataset: GridDataset
    spec: MLPSpec
    x_data: torch.Tensor  # (N_u, 2)
    targets: Dict[str, torch.Tensor]  # field -> (N_u, 1)
    device: torch.device = torch.device("cpu")
    # this rank's part of a data-parallel run (parallel.sharding.DataShard), or None
    shard: Any = None

    @property
    def lb(self):
        return self.dataset.lb

    @property
    def ub(self):
        return self.dataset.ub

    def effective_coeffs(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lambda1, lambda2) with the freeze / transform policy applied."""
        coeffs = params["coeffs"]
        lam1, lam2 = coeffs["lambda1"], coeffs["lambda2"]
        if not self.exp.pde.train_coeffs:
            lam1, lam2 = lam1.detach(), lam2.detach()
        if self.exp.pde.lambda2_transform == "exp":
            lam2 = torch.exp(lam2)
        return lam1, lam2

    @property
    def euler(self) -> bool:
        return self.exp.pde.kind == "euler"

    @property
    def viscous_static(self) -> bool:
        """Config-level predicate: can the effective viscosity (the lambda2
        slot) differ from zero? ('exp' maps any raw value above zero;
        trainable coefficients can move it.)"""
        pde = self.exp.pde
        return pde.train_coeffs or pde.lambda2_transform == "exp" or pde.lambda2 != 0.0

    def flux_residuals_and_entropy(self, params, centers, want_entropy: bool = False,
                                   plain: bool = False, scale: float = 1.0):
        """Weak-form cell residuals at the cell centers (``ops.weakform``):
        Burgers' r (N, 1) or the Euler system's (r1, r2, r3), and the weak
        entropy violation relu(e)^2 (N, 1) (None unless asked for; K7b's
        entropy mode on the card). ``plain`` forces the plain versions on any
        device. ``scale`` multiplies the cells' half-widths: coarse control
        volumes, whose cell means see a misplaced shock, for ensemble
        selection's coarse battery (JAX's ``:196-215``).

        The mixed formulation (``loss.strong_equations``, Euler only; JAX's
        ``:235-251``): equation i in it takes the strong pointwise residual
        at the same centers, from one more Taylor-1 pass (K7a on the card)
        shared by the selected equations, in place of its cell mean."""
        cfg = self.exp.loss
        if cfg.strong_equations and not self.euler:
            raise ValueError(
                "loss.strong_equations is the Euler mixed formulation; "
                "Burgers has a single equation"
            )
        hx = cfg.flux_dx_frac * float(self.ub[0] - self.lb[0])
        ht = cfg.flux_dt_frac * float(self.ub[1] - self.lb[1])
        if scale != 1.0:
            hx, ht = hx * scale, ht * scale
        if not self.euler:
            lam1, lam2 = self.effective_coeffs(params)
            return burgers_flux_residual(self.spec, params["net"], centers, lam1, lam2, hx, ht,
                                         cfg.flux_quad, want_entropy, self.viscous_static, plain)
        # the Euler artificial viscosity rides the lambda2 slot (freeze, exp
        # transform and identification as for Burgers), a device tensor
        _, visc = self.effective_coeffs(params)
        rs, ent = euler_flux_residuals(self.spec, params["net"], centers, self.exp.pde.gamma,
                                       hx, ht, cfg.flux_quad, want_entropy, visc,
                                       self.viscous_static, plain)
        if cfg.strong_equations:
            if any(i not in (0, 1, 2) for i in cfg.strong_equations):
                raise ValueError(
                    "loss.strong_equations indices must be in {0, 1, 2} "
                    "(mass, momentum, energy)"
                )
            strong = self.residuals(params, centers, plain)
            rs = tuple(strong[i] if i in cfg.strong_equations else rs[i] for i in range(3))
        return rs, ent

    @property
    def admm_flux(self) -> bool:
        """ADMM regularizes the weak-form cell residual (``loss.admm_form``,
        JAX's ``:258-269``)."""
        form = self.exp.loss.admm_form
        if form not in ("strong", "flux"):
            raise ValueError(f"unknown loss.admm_form {form!r} (expected 'strong' or 'flux')")
        return self.exp.loss.residual_kind == "admm" and form == "flux"

    @property
    def flux(self) -> bool:
        """The training loss takes the weak-form residual."""
        return self.exp.loss.residual_kind == "flux" or self.admm_flux

    def training_residuals(self, params, pts, plain: bool = False):
        """Residuals of the trained objective at ``pts``: the weak-form cells
        when the loss is weak-form (the flux ADMM's z and dual live there),
        else the strong form over the microbatches: what the ADMM state and
        RAD's scoring read (JAX's ``:271-279``)."""
        if self.flux:
            return self.flux_residuals_and_entropy(params, pts, plain=plain)[0]
        return self.residuals_chunked(params, pts, plain)

    def residuals_and_entropy(self, params, colloc, want_entropy: bool = False,
                              plain: bool = False):
        """(residuals, per-point entropy_sq or None) from ONE Taylor pass
        (JAX's ``:136-189``): Burgers' f (N, 1) or the Euler system's (f1,
        f2, f3), each (N, 1).

        With ``loss.grad_weight_kappa`` > 0 the residual field is the
        gradient-weighted w f, w = 1 / (1 + kappa s^2), with the shock
        indicator s (u_x for Burgers, |(rho_x, u_x)| for Euler) detached, so
        that the penalty, the ADMM updates and the misfit all see the same
        weighted field. The entropy term (asked for when
        ``loss.entropy_weight`` > 0) is the squared admissibility violation,
        from the streams the residual already computed: Burgers relu(u u_t +
        lambda1 u^2 u_x)^2, or relu(u f - lambda2 u_x^2)^2 when the
        viscosity can be nonzero; Euler relu(-(S_t + u S_x))^2
        (``ops.residuals.euler_entropy_production``).

        ``plain`` forces the plain Taylor recurrence on any device; otherwise
        a CUDA tensor takes K1 (Burgers, differentiable through K2) or K7a
        (Euler, differentiable through its backward).
        """
        kappa = self.exp.loss.grad_weight_kappa
        if self.euler:
            taylor1 = mlp_taylor_1_reference if plain else mlp_taylor_1
            y, y_x, y_t = taylor1(self.spec, params["net"], colloc)
            residuals = euler_combine(y, y_x, y_t, self.exp.pde.gamma)[1]
            ent = None
            if want_entropy:
                d = euler_entropy_production(y, y_x, y_t, self.exp.pde.gamma)
                ent = torch.clamp(-d, min=0.0) ** 2
            if kappa > 0.0:
                s2 = y_x[:, 0:1].detach() ** 2 + y_x[:, 1:2].detach() ** 2
                w = 1.0 / (1.0 + kappa * s2)
                residuals = tuple(w * fi for fi in residuals)
            return residuals, ent
        lam1, lam2 = self.effective_coeffs(params)
        taylor = mlp_taylor_2_reference if plain else mlp_taylor_2
        u, u_x, u_t, u_xx = taylor(self.spec, params["net"], colloc)
        f = u_t + lam1 * u * u_x - lam2 * u_xx
        ent = None
        if want_entropy:
            if self.viscous_static:
                # u f - lambda2 u_x^2 completes -lambda2 (u u_x)_x, the
                # viscous entropy balance (zero on exact solutions)
                e = u * f - lam2 * u_x * u_x
            else:
                e = u * u_t + lam1 * u * u * u_x
            ent = torch.clamp(e, min=0.0) ** 2
        if kappa > 0.0:
            f = f / (1.0 + kappa * u_x.detach() ** 2)
        return f, ent

    def residuals(self, params, colloc, plain: bool = False):
        """Strong-form residual(s) at collocation points, gradient-weighted
        when ``loss.grad_weight_kappa`` > 0 (:meth:`residuals_and_entropy`)."""
        return self.residuals_and_entropy(params, colloc, False, plain)[0]

    def entropy_sq(self, params, colloc, plain: bool = False):
        """The per-point squared entropy-admissibility violation (N, 1)."""
        return self.residuals_and_entropy(params, colloc, True, plain)[1]

    def residuals_chunked(self, params, colloc, plain: bool = False):
        """Residuals over the full batch, evaluated microbatch by microbatch
        (``sampling.microbatch`` chunks), so peak activation memory is
        n_f / microbatch: the ADMM updates at large n_f."""
        m = self.exp.sampling.microbatch
        if m <= 1:
            return self.residuals(params, colloc, plain)
        parts = [self.residuals(params, ch, plain) for ch in _chunks(colloc, m)]
        if self.euler:
            return tuple(torch.cat(comp) for comp in zip(*parts))
        return torch.cat(parts)


def build_problem(exp: Experiment, device="cuda", dataset: Optional[str] = None) -> Problem:
    """Load the dataset (``dataset`` overrides ``exp.data.dataset``) and put
    the supervised training set on ``device`` (the card unless the caller
    asks for the CPU; raises without one)."""
    check_slice(exp)
    device = resolve_device(device)
    load = load_euler_mat if exp.pde.kind == "euler" else load_burgers_mat
    ds = load(dataset or exp.data.dataset)
    build = interior_training_set if exp.data.selection == "interior" else build_ic_bc_training_set
    x_data, targets = build(ds, exp.data.n_u, seed=exp.data.seed, noise=exp.data.noise)
    dtype = _DTYPES[exp.model.dtype]
    fourier = ()
    if exp.model.n_fourier > 0:  # JAX's build_problem (pinns_tpu/train/trainer.py:312-319)
        fourier = fourier_matrix(exp.model.n_fourier, in_dim=exp.model.layers[0],
                                 sigma=exp.model.fourier_sigma, seed=exp.model.fourier_seed)
    spec = MLPSpec(
        layers=exp.model.layers,
        lb=tuple(float(v) for v in ds.lb),
        ub=tuple(float(v) for v in ds.ub),
        dtype=dtype,
        compute_dtype=exp.model.compute_dtype or None,
        keep_streams=exp.model.keep_streams,
        mixed_elementwise=exp.model.mixed_elementwise,
        fourier=fourier,
        n_paths=exp.model.n_paths,
        path_degree=exp.model.path_degree,
        path_sharpness=exp.model.path_sharpness,
    )
    return Problem(
        exp=exp,
        dataset=ds,
        spec=spec,
        x_data=torch.as_tensor(x_data, dtype=dtype).to(device),
        targets={k: torch.as_tensor(v, dtype=dtype).to(device) for k, v in targets.items()},
        device=device,
    )


def _curriculum_bounds(problem: Problem, epoch: int):
    """(lb, ub) with the time curriculum applied (``pinns_tpu/train/
    trainer.py:343-357``): the sampled t-range grows linearly to the full
    domain over ``t_curriculum_epochs``, frac = clip((epoch + 1) / T, floor,
    1), in float32 as JAX computes it."""
    cfg = problem.exp.sampling
    if cfg.t_curriculum_epochs <= 0:
        return problem.lb, problem.ub
    f32 = np.float32
    lb = np.asarray(problem.lb, f32)
    ub = np.array(problem.ub, f32)
    frac = np.clip((f32(epoch) + f32(1.0)) / f32(cfg.t_curriculum_epochs),
                   f32(cfg.t_curriculum_floor), f32(1.0))
    ub[1] = lb[1] + (ub[1] - lb[1]) * frac
    return lb, ub


def _philox_points(problem: Problem, key: int, word: int, n: int, lb, ub,
                   row0: int = 0) -> torch.Tensor:
    """(n, 2) points of Philox(key, word) uniform in [lb, ub), rows [row0,
    row0 + n) of the draw: one launch of K11 from a one-row schedule on a
    CUDA device, ``philox_uniform`` (the same points) elsewhere."""
    dtype = problem.spec.dtype
    if problem.device.type != "cuda":
        return philox_uniform(key, word, n, lb, ub, dtype, problem.device, row0)
    rows = epoch_schedule.schedule_rows(key, 0, word - 1, 1, 0.0, lambda e: (lb, ub))
    return philox_draw(epoch_schedule.to_device(rows, problem.device),
                       _zero_cursor(problem.device), n, dtype, row0)


def local_rows(problem: Problem, total: int) -> slice:
    """This rank's rows of a batch of ``total`` rows (all of them without a
    shard)."""
    return slice(0, total) if problem.shard is None else problem.shard.rows(total)


def total_rows(problem: Problem, n: int) -> int:
    """The global row count of a batch of which this rank holds ``n`` rows:
    every normalizer of the loss and the ADMM threshold take it."""
    return n if problem.shard is None else n * problem.shard.size


def _resample(problem: Problem, key: int, draw: int) -> torch.Tensor:
    """The uniform collocation batch of ``draw``: Philox(key, draw), where
    draw 0 is the initial batch and draw e + 1 the batch drawn after step e,
    inside the curriculum's bounds of JAX's epoch argument for that batch (0
    for the initial one, e after step e). On a CUDA device one launch of K11
    (``ops.kernels.sampling.philox_draw``) from a one-row schedule, else
    ``philox_uniform``: the same points. Under a shard, this rank's rows of
    that batch (drawn at their row offset)."""
    lb, ub = _curriculum_bounds(problem, max(draw - 1, 0))
    rows = local_rows(problem, problem.exp.sampling.n_f)
    return _philox_points(problem, key, draw, rows.stop - rows.start, lb, ub, rows.start)


def adam_schedule(problem: Problem, learning_rate, key: int, count: int, epoch: int,
                  length: int) -> np.ndarray:
    """The epoch schedule (``train.schedule.schedule_rows``) of ``length``
    Adam epochs from Adam's ``count`` and the state's ``epoch``: the draws
    after them (Philox(key, epoch + 1 + i) in the curriculum's bounds of
    epoch + i), the learning rate and the bias corrections at count + i."""
    return epoch_schedule.schedule_rows(
        key, count, epoch, length, learning_rate,
        lambda e: _curriculum_bounds(problem, max(e, 0)))


def _zero_cursor(device: torch.device) -> torch.Tensor:
    """The cursor of a one-row schedule (a shared constant: never advanced)."""
    return constant((0,), torch.int64, device)


def init_collocation(problem: Problem, key: int) -> torch.Tensor:
    """Initial collocation set per the configured strategy: Philox(key, 0)
    under 'resample_uniform' and 'rad' (RAD starts uniform and is redrawn at
    chunk boundaries, :func:`rad_resample`); the fixed sets draw from
    ``torch.Generator().manual_seed(key + 1)`` (``Generator(key)`` draws the
    weights in ``Trainer.init_state``)."""
    exp = problem.exp
    n_f, strategy = exp.sampling.n_f, exp.sampling.strategy
    dtype, device = problem.spec.dtype, problem.device
    if strategy in ("resample_uniform", "rad"):
        return _resample(problem, key, 0)
    gen = torch.Generator().manual_seed(key + 1)
    if strategy == "fixed_uniform":
        pts = uniform_box(gen, n_f, problem.lb, problem.ub, dtype, device)
    elif strategy in ("fixed_lhs", "fixed_lhs_anchored"):
        pts = scale_to_bounds(latin_hypercube(gen, n_f, 2, dtype, device), problem.lb, problem.ub)
        if strategy == "fixed_lhs_anchored":
            # the reference anchors the FULL IC/BC candidate stack
            anchors = torch.as_tensor(ic_bc_candidates(problem.dataset), dtype=dtype).to(device)
            pts = torch.cat([pts, anchors], dim=0)
    else:
        raise ValueError(f"unknown sampling strategy: {strategy!r}")
    # a fixed batch is drawn whole on every rank; a shard keeps its rows
    return pts if problem.shard is None else pts[local_rows(problem, pts.shape[0])].clone()


def _chunks(a: torch.Tensor, m: int):
    """``a``'s rows as ``m`` equal consecutive chunks; raises unless m divides them."""
    n = a.shape[0]
    if n % m:
        raise ValueError(f"collocation count {n} not divisible by microbatch {m}")
    return a.split(n // m)


def _chunks_of(a, m: int):
    """``_chunks`` of a tensor, or of each component of a tuple, zipped into
    one tuple a chunk."""
    if isinstance(a, tuple):
        return list(zip(*(_chunks(c, m) for c in a)))
    return _chunks(a, m)


def _remat(policy: str, body: Callable, on_card: bool) -> Callable:
    """``body`` under a ``sampling.microbatch_remat`` policy: 'full' recomputes
    the whole body in the backward pass, 'dots' saves the matmul outputs and
    recomputes the rest (the counterpart of JAX's ``dots_saveable``), 'none'
    keeps everything. The math is the same under each.

    On the card the Taylor-2 kernels' autograd Functions save only the
    points and the params and recompute their streams in the backward
    kernel, so a checkpoint there would only launch every forward twice: the
    body runs unwrapped under every policy."""
    if policy not in ("full", "dots", "none"):
        raise ValueError(f"unknown sampling.microbatch_remat: {policy!r} "
                         "(expected 'full' | 'dots' | 'none')")
    if policy == "none" or on_card:
        return body
    from torch.utils import checkpoint as ckpt

    kw = {"use_reentrant": False}
    if policy == "dots":
        saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

        def save_dots(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             save_dots)
    return lambda *args: ckpt.checkpoint(body, *args, **kw)


def _l1_sq_share(s_local: torch.Tensor, n_f: int, shard) -> torch.Tensor:
    """This rank's share of S^2 / n_f, S the sum of |f| over the data row:
    S (2 S_r - S / D) / n_f with S all-reduced first and held constant, so
    that the row's shares sum to S^2 / n_f and their gradients to 2 S / n_f
    dS (at one rank, S (2 S - S) / n_f = S S / n_f bit for bit)."""
    s = shard.all_reduce(s_local.detach().clone())
    return s * (2.0 * s_local - s / shard.size) / n_f


def _penalty(problem: Problem, f: torch.Tensor, kind: str, n_f: int) -> torch.Tensor:
    """``residual_penalty`` of ``f`` with the normalizer ``n_f``; under a
    shard this rank's share of it (the mean over the global row count)."""
    if problem.shard is None:
        return residual_penalty(f, kind, n_f)
    if kind in ("mean_sq", "l2_sq_norm"):
        return torch.sum(f * f) / n_f
    if kind == "l1_sq_norm":
        return _l1_sq_share(torch.sum(torch.abs(f)), n_f, problem.shard)
    raise ValueError(f"unknown residual penalty kind: {kind!r}")


def _residual_term(problem: Problem, params, colloc, admm_state, rho=None, plain=False):
    """Residual loss term: the strong or the weak form, by the configured
    penalty (the causal one when ``loss.causal_eps > 0``), plus
    ``entropy_weight * sum(entropy_sq) / n_f`` when the entropy penalty is
    on, accumulated over ``sampling.microbatch`` chunks of the batch when it
    is above 1 (strong form only, in chunk order; ``microbatch_unroll`` is an
    XLA scan knob the port ignores). Under a shard: this rank's share of the
    term, n_f the global row count."""
    exp = problem.exp
    cfg = exp.loss
    # the ACTUAL row count, as the ADMM threshold uses (the whole batch's)
    n_f = total_rows(problem, colloc.shape[0])
    m = exp.sampling.microbatch
    rho = cfg.rho if rho is None else rho
    ew = cfg.entropy_weight
    if cfg.causal_eps > 0.0 and (cfg.residual_kind not in ("mean_sq", "flux") or m > 1):
        raise ValueError(
            "loss.causal_eps requires residual_kind='mean_sq' or 'flux' and "
            "sampling.microbatch=1 (the weights need the whole batch's "
            "time-bin losses in one pass)"
        )
    if problem.flux and m > 1:
        raise ValueError(
            "weak-form residuals (residual_kind='flux' / admm_form='flux') "
            "do not support microbatching yet"
        )
    if problem.flux and cfg.grad_weight_kappa > 0.0:
        raise ValueError(
            "grad_weight_kappa is a strong-form pointwise knob; it does "
            "not apply to the weak-form residuals"
        )
    if m <= 1:
        if problem.flux:
            residuals, ent = problem.flux_residuals_and_entropy(params, colloc, ew > 0.0, plain)
        else:
            residuals, ent = problem.residuals_and_entropy(params, colloc, ew > 0.0, plain)
        if cfg.residual_kind == "admm":
            term = admm_penalty(residuals, admm_state, rho, cfg.explicit_inner)
        elif cfg.causal_eps > 0.0:
            term = causal_residual_penalty(
                residuals, colloc[:, 1], problem.lb[1], problem.ub[1], cfg.causal_eps,
                cfg.causal_bins, relative=cfg.causal_relative)[0]
        else:
            # the weak-form cell residual takes the plain mean square
            kind = "mean_sq" if cfg.residual_kind == "flux" else cfg.residual_kind
            if isinstance(residuals, tuple):
                term = sum(_penalty(problem, f, kind, n_f) for f in residuals)
            else:
                term = _penalty(problem, residuals, kind, n_f)
        if ew > 0.0:
            term = term + ew * torch.sum(ent) / n_f
        return term

    chunks = _chunks(colloc, m)
    wrap = functools.partial(_remat, exp.sampling.microbatch_remat,
                             on_card=colloc.device.type == "cuda" and not plain)
    zero = torch.zeros((), dtype=problem.spec.dtype, device=colloc.device)
    if cfg.residual_kind == "admm":
        # the augmented-Lagrangian penalty is additive over points
        def admm_body(ch, z, dual):
            f, ent = problem.residuals_and_entropy(params, ch, ew > 0.0, plain)
            pen = admm_penalty(f, ADMMState(z=z, dual=dual), rho, cfg.explicit_inner)
            return pen + ew * torch.sum(ent) / n_f if ew > 0.0 else pen

        body = wrap(admm_body)
        term = zero
        for ch, z, dual in zip(chunks, _chunks_of(admm_state.z, m),
                               _chunks_of(admm_state.dual, m)):
            term = term + body(ch, z, dual)
        return term

    # accumulate the primitive sums (sum f^2, sum |f|) per residual component
    # and the entropy's sum; norms that are nonlinear in the batch (l1_sq)
    # assemble afterwards
    def sums_body(ch):
        f, ent = problem.residuals_and_entropy(params, ch, ew > 0.0, plain)
        sums = tuple((torch.sum(fi * fi), torch.sum(torch.abs(fi)))
                     for fi in (f if isinstance(f, tuple) else (f,)))
        return sums, (torch.sum(ent) if ew > 0.0 else zero)

    body = wrap(sums_body)
    accs, ent_sum = None, zero
    for ch in chunks:
        parts, ent_part = body(ch)
        if accs is None:
            accs = [(zero, zero)] * len(parts)
        accs = [(ssq + a, sabs + b) for (ssq, sabs), (a, b) in zip(accs, parts)]
        ent_sum = ent_sum + ent_part
    if cfg.residual_kind in ("mean_sq", "l2_sq_norm"):
        terms = [ssq / n_f for ssq, _ in accs]
    elif cfg.residual_kind == "l1_sq_norm":
        terms = [sabs * sabs / n_f if problem.shard is None
                 else _l1_sq_share(sabs, n_f, problem.shard) for _, sabs in accs]
    else:
        raise ValueError(f"unknown residual kind {cfg.residual_kind!r}")
    if ew > 0.0:  # JAX's order: the entropy's term first, then each component's
        return sum(terms, ew * ent_sum / n_f)
    return terms[0] if len(terms) == 1 else sum(terms, zero)


def make_data_term(problem: Problem, plain: bool = False) -> Callable:
    """The data-misfit term of the training loss as ``params -> scalar``
    (``plain`` forces the plain forward on any device)."""
    exp = problem.exp
    forward = mlp_apply_reference if plain else mlp_apply
    kind, n_u = exp.loss.data_kind, exp.data.n_u

    if not problem.euler:
        def term(params):
            u_pred = forward(problem.spec, params["net"], problem.x_data)
            return data_misfit(u_pred, problem.targets["u"], kind, n_u)

        return term

    field_w = exp.loss.data_field_weights

    def euler_term(params):
        y = forward(problem.spec, params["net"], problem.x_data)
        return sum(
            (field_w[i] if field_w else 1.0)
            * data_misfit(y[:, i:i + 1], problem.targets[name], kind, n_u)
            for i, name in enumerate(EULER_FIELDS)
        )

    return euler_term


def make_loss_fn(problem: Problem, plain: bool = False) -> Callable:
    """loss(params, colloc, admm, rho=None) -> (scalar, aux-metrics dict);
    ``plain`` forces the plain forward and Taylor-2 versions on any device.
    Under a shard, this rank's share of the loss and of its terms: their
    sums over the data row are the global ones."""
    loss_cfg = problem.exp.loss
    if loss_cfg.residual_weight != 1.0 and loss_cfg.residual_kind == "admm":
        raise ValueError(
            "residual_weight must be 1 with residual_kind='admm' — scale the "
            "penalty with loss.rho instead (the prox threshold tracks rho)"
        )
    if loss_cfg.grad_weight_kappa < 0.0:
        raise ValueError("grad_weight_kappa must be >= 0")
    field_w = loss_cfg.data_field_weights
    if field_w and not problem.euler:
        raise ValueError(
            "data_field_weights applies to the multi-output Euler system; "
            "for Burgers use loss.data_weight"
        )
    if field_w and len(field_w) != len(EULER_FIELDS):
        raise ValueError(
            f"data_field_weights needs {len(EULER_FIELDS)} entries, got {len(field_w)}"
        )
    dterm = make_data_term(problem, plain)

    def loss_fn(params, colloc, admm_state, rho=None):
        if problem.euler:  # the metrics' coefficient slots read 0, as in JAX
            lam1 = lam2 = torch.zeros((1,), dtype=problem.spec.dtype, device=colloc.device)
        else:
            lam1, lam2 = problem.effective_coeffs(params)
        if problem.shard is None or problem.shard.owner:
            data_term = dterm(params)
        else:  # under a shard data rank 0 alone counts the data term
            data_term = torch.zeros((), dtype=problem.spec.dtype, device=colloc.device)
        res_term = _residual_term(problem, params, colloc, admm_state, rho, plain)
        loss = loss_cfg.data_weight * data_term + loss_cfg.residual_weight * res_term
        aux = {
            "loss": loss,
            "data_term": data_term,
            # the weighted CONTRIBUTION, so loss = data_weight*data_term + res_term
            "res_term": res_term if loss_cfg.residual_weight == 1.0
            else loss_cfg.residual_weight * res_term,
            "lambda1": lam1.reshape(()),
            "lambda2": lam2.reshape(()),
        }
        return loss, aux

    return loss_fn


def _next_batch(problem: Problem, colloc, key, epoch, new_colloc):
    """The batch of epoch + 1: ``new_colloc`` when given (tests feed JAX's
    points), else the Philox draw; fixed strategies keep ``colloc``."""
    if problem.exp.sampling.strategy != "resample_uniform":
        return colloc
    return new_colloc if new_colloc is not None else _resample(problem, key, epoch + 1)


@torch.no_grad()
def _post_update(problem: Problem, params, admm_state, colloc, key, rho=None, epoch=0,
                 new_colloc=None, plain=False):
    """Shared tail of every step: resample, then ADMM updates at the new
    points (threshold normalizer = the actual residual row count)."""
    exp = problem.exp
    colloc = _next_batch(problem, colloc, key, epoch, new_colloc)
    mis = torch.zeros((), dtype=problem.spec.dtype, device=problem.device)
    if exp.loss.residual_kind == "admm":
        rho_val = exp.loss.rho if rho is None else rho
        f_new = problem.training_residuals(params, colloc, plain=plain)
        admm_state = admm_update(f_new, admm_state, rho_val,
                                 total_rows(problem, colloc.shape[0]))
        mis = _misfit(problem, f_new, admm_state)
    return admm_state, colloc, key, mis


def _misfit(problem: Problem, residuals, state: ADMMState) -> torch.Tensor:
    """``admm_misfit``: mean |r - z| averaged over the components; under a
    shard the sums of |r - z| all-reduced over the data row (one flat
    all-reduce) and divided by the global row count."""
    if problem.shard is None:
        return admm_misfit(residuals, state)
    rs = residuals if isinstance(residuals, tuple) else (residuals,)
    zs = state.z if isinstance(state.z, tuple) else (state.z,)
    sums = problem.shard.all_reduce(torch.stack([torch.sum(torch.abs(f - z))
                                                 for f, z in zip(rs, zs)]))
    parts = sums / total_rows(problem, rs[0].shape[0])
    return parts[0] if len(rs) == 1 else torch.sum(parts) / len(rs)


def metrics_row(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The step's metrics as one float32 row in METRIC_KEYS order."""
    return torch.stack([metrics[k].to(torch.float32) for k in METRIC_KEYS])


def _write_metrics(metrics: Dict[str, torch.Tensor], out: Optional[torch.Tensor]):
    """Stack the step's metrics (METRIC_KEYS order) into the float32 row
    ``out`` of a chunk's buffer; returns views of that row."""
    if out is None:
        out = torch.empty(len(METRIC_KEYS), dtype=torch.float32,
                          device=metrics["loss"].device)
    out.copy_(metrics_row(metrics))
    return {k: out[i] for i, k in enumerate(METRIC_KEYS)}


def _draw_at(problem: Problem, sched, cursor, plain: bool) -> torch.Tensor:
    """The batch that schedule row ``cursor`` draws (under a shard, this
    rank's rows of it): K11 on a CUDA schedule, its plain version on the CPU
    or under ``plain``."""
    draw = philox_draw_reference if plain else philox_draw
    rows = local_rows(problem, problem.exp.sampling.n_f)
    return draw(sched, cursor, rows.stop - rows.start, problem.spec.dtype, rows.start)


@torch.no_grad()
def _epoch_tail(problem: Problem, params, admm_state, colloc, rho, sched, cursor,
                new_colloc=None, plain=False):
    """The Adam epoch's tail after the weight step, in schedule form: the
    next batch (``new_colloc`` when given, else the draw of schedule row
    ``cursor``; fixed strategies keep ``colloc``) and the ADMM z/dual update
    with its misfit, at the new points (JAX's and the reference's order) or,
    under ``admm_update_points='current'``, at the points the step saw
    before the draw. Returns (admm_state, colloc, misfit)."""
    exp = problem.exp
    admm = exp.loss.residual_kind == "admm"
    current = admm and exp.loss.admm_update_points == "current"

    def next_batch(pts):
        if exp.sampling.strategy != "resample_uniform":
            return pts
        return new_colloc if new_colloc is not None else _draw_at(problem, sched, cursor, plain)

    if not current:
        colloc = next_batch(colloc)
    mis = torch.zeros((), dtype=problem.spec.dtype, device=colloc.device)
    if admm:
        f = problem.training_residuals(params, colloc, plain=plain)
        admm_state = admm_update(f, admm_state, exp.loss.rho if rho is None else rho,
                                 total_rows(problem, colloc.shape[0]))
        mis = _misfit(problem, f, admm_state)
    if current:
        colloc = next_batch(colloc)
    return admm_state, colloc, mis


def make_adam_epoch(problem: Problem, plain: bool = False):
    """The generic Adam epoch in schedule form: grad step -> resample -> ADMM
    updates, with every per-epoch value read from the device.

    ``epoch(state, sched, cursor, new_colloc=None) -> (params, opt_state,
    admm, colloc, metrics)``: the epoch that ``state`` steps, whose learning
    rate, bias corrections and draw (seed, epoch, curriculum bounds) are row
    ``cursor`` (a one-element int64 tensor) of the schedule ``sched``
    (``train.schedule``) on the state's device; ``state.opt_state.count`` and
    ``state.epoch`` are not read (the returned count is the input's plus 1).
    Nothing is read back to the host, so the per-epoch step
    (:func:`make_adam_step`) and the graphed chunk on the card
    (``ops.kernels.generic_chunk.GenericChunk``, which captures this
    function) run one code path. The loss runs the kernels on a CUDA device
    unless ``plain`` (then the plain versions everywhere, the draw
    included)."""
    loss_fn = make_loss_fn(problem, plain)
    train_coeffs = problem.exp.pde.train_coeffs
    dtype = problem.spec.dtype

    def epoch(state: TrainState, sched: torch.Tensor, cursor: torch.Tensor,
              new_colloc: Optional[torch.Tensor] = None):
        values = epoch_schedule.row_at(sched, cursor)
        lr, bc1, bc2 = (values[i].to(dtype) for i in (epoch_schedule.LR, epoch_schedule.BC1,
                                                      epoch_schedule.BC2))
        params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        loss, aux = loss_fn(params, state.colloc, state.admm, state.rho)
        # frozen coefficients get a zero gradient, as JAX's stop_gradient gives
        wanted = tree_leaves(params["net"]) + (tree_leaves(params["coeffs"]) if train_coeffs else [])
        # the Euler residuals do not read the coefficients: a zero gradient
        got = [g if g is not None else torch.zeros_like(p) for g, p in
               zip(torch.autograd.grad(loss, wanted, allow_unused=True), wanted)]
        if problem.shard is not None:
            got, aux = _reduce_shares(problem.shard, got, aux)
        got = iter(got)
        grads = {
            "net": tree_map(lambda p: next(got), params["net"]),
            "coeffs": tree_map(lambda p: next(got) if train_coeffs else torch.zeros_like(p),
                               params["coeffs"]),
        }
        with torch.no_grad():
            updates, opt_state = adam_update(grads, state.opt_state, lr, bias=(bc1, bc2))
            new_params = apply_updates(tree_map(lambda p: p.detach(), params), updates)
        admm_state, colloc, mis = _epoch_tail(problem, new_params, state.admm, state.colloc,
                                              state.rho, sched, cursor, new_colloc, plain)
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["admm_misfit"] = mis
        metrics["lbfgs_iters"] = torch.zeros((), device=mis.device)
        return new_params, opt_state, admm_state, colloc, metrics

    return epoch


# the loss metrics whose data-row sums are the global ones (the coefficients
# are replicated)
SHARED_METRICS = ("loss", "data_term", "res_term")


def _reduce_shares(shard, grads, aux):
    """The gradients and the loss metrics summed over the data row in ONE
    flat all-reduce (in the gradients' dtype): (grads, aux) of the whole
    batch from this rank's shares."""
    sizes = [g.numel() for g in grads]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [aux[k].detach().reshape(1).to(grads[0].dtype) for k in SHARED_METRICS])
    shard.all_reduce(flat)
    parts = flat.split(sizes + [1] * len(SHARED_METRICS))
    out = [p.view_as(g) for p, g in zip(parts, grads)]
    aux = dict(aux, **{k: parts[len(grads) + i].reshape(()).to(aux[k].dtype)
                       for i, k in enumerate(SHARED_METRICS)})
    return out, aux


def make_adam_step(problem: Problem, learning_rate, plain: bool = False):
    """The generic Adam epoch: grad step -> resample -> ADMM updates.

    ``step(state, out=None, new_colloc=None) -> (state, metrics)``. ``out``, a
    float32 row of len(METRIC_KEYS), receives the metrics when given;
    ``new_colloc`` replaces the Philox draw of the next batch.
    ``learning_rate`` is a float or a function of Adam's count
    (``opt.adam.learning_rate_schedule``). The step writes its epoch's row
    of the schedule (:func:`adam_schedule`) to the device and runs
    :func:`make_adam_epoch`'s epoch on it (``step.epoch``). The loss runs the
    kernels on a CUDA device unless ``plain`` (then it is the plain step
    everywhere).
    """
    epoch_fn = make_adam_epoch(problem, plain)

    def step(state: TrainState, out: Optional[torch.Tensor] = None,
             new_colloc: Optional[torch.Tensor] = None):
        device = state.colloc.device
        sched = epoch_schedule.to_device(
            adam_schedule(problem, learning_rate, state.key, state.opt_state.count,
                          state.epoch, 1), device)
        params, opt_state, admm_state, colloc, metrics = epoch_fn(
            state, sched, _zero_cursor(device), new_colloc)
        new_state = TrainState(
            params=params, opt_state=opt_state, admm=admm_state, colloc=colloc,
            key=state.key, epoch=state.epoch + 1, rho=state.rho,
        )
        return new_state, _write_metrics(metrics, out)

    step.epoch = epoch_fn
    return step


FLOAT64_ADAM_LATER = (
    "float64 Adam training on the card is left to a later slice (ROADMAP queue 2: float64 in "
    "K3, K9 and the generic epoch); the card's float64 path is polish's L-BFGS (python -m "
    "pinns_tpu_torch polish), and --device cpu trains in float64")


def _float64_adam_refused(state, out=None, new_colloc=None):
    """The Adam step of a float64 trainer on the card: it raises, naming the
    later slice (the trainer builds, for ``polish`` and ``evaluate``)."""
    raise NotImplementedError(FLOAT64_ADAM_LATER)


def make_step(problem: Problem, learning_rate):
    """The Adam step the trainer runs: on a CUDA device the fused CUDA step K3
    when the configuration is inside its scope, else the generic step over
    the kernel ops, which carries ``step.graphed`` (K9 for the generic
    step, ``ops.kernels.generic_chunk.GenericChunk``) inside
    ``generic_chunk_supported``; on the CPU the plain step. A float64
    problem on the card gets a step that raises (:data:`FLOAT64_ADAM_LATER`):
    its trainer serves ``polish`` and ``evaluate``."""
    if problem.device.type == "cuda":
        from pinns_tpu_torch.ops.kernels.fused_step import (
            fused_step_supported,
            make_fused_adam_step,
        )
        from pinns_tpu_torch.ops.kernels.generic_chunk import (
            GenericChunk,
            generic_chunk_supported,
        )

        if problem.spec.dtype == torch.float64:
            return _float64_adam_refused
        if not fused_step_supported(problem.exp, problem.spec):
            return make_fused_adam_step(problem, learning_rate)
        step = make_adam_step(problem, learning_rate)
        if not generic_chunk_supported(problem.exp, problem.spec):
            step.graphed = functools.partial(GenericChunk, problem, learning_rate, step.epoch)
        return step
    return make_adam_step(problem, learning_rate)


DP_LBFGS_NOTE = (
    "data parallelism: the L-BFGS outer epochs run one host call each (K10's solve on "
    "DeviceLBFGS, K3's value-and-grad all-reduced inside its graph, then the post-update), "
    "not as K10's outer-epoch chunks (LBFGSChunk), whose post-update is not split around an "
    "all-reduce yet (ROADMAP queue 2)")


def make_lbfgs_step(problem: Problem, host_loop: bool = False):
    """One outer epoch of the L-BFGS phase: the full inner solve of the loss
    at the current batch and ADMM state, then the shared resample -> z/dual
    tail (``_post_update``, whatever ``admm_update_points`` says), as
    ``Abgrall_ADMM.py:216-226`` and the JAX step do.

    The solve runs over every param, frozen coefficients included (they get a
    zero gradient). On a CUDA device the solve runs on K10's kernels: a
    configuration inside ``ops.kernels.lbfgs.lbfgs_device_supported`` with
    K3's value-and-grad (``DeviceLBFGS``), every other one (the Euler
    branch, ``euler_weak_tail``, and float64 in K10's float64 mode over the
    kernels' float64 modes among them) with autograd through the loss as the
    evaluation (``AutogradLBFGS``); each reads the device only for the done
    flag. The CPU and ``host_loop`` (the card's checks) run the host loop
    ``opt.lbfgs.lbfgs_minimize`` over the loss under autograd. The metrics
    rebuild the loss terms from the solver's own final value: one forward of
    the data term, ``res_term = f - data_weight * data_term``;
    ``lbfgs_iters`` is the solve's iteration count.

    On the card, a configuration inside
    ``ops.kernels.lbfgs.lbfgs_chunk_supported`` also carries
    ``step.graphed``, K10's chunk runner (``LBFGSChunk``: the outer epochs
    of a chunk on the device, K3's post-update mode as the tail), which
    :func:`make_chunked` takes as it takes K3's. The runner is chosen by
    that scope, never after a failure; ``step`` itself stays the per-outer-
    epoch drive (the card's comparisons).

    Under a shard the objective is the data row's sum of the ranks' shares
    with its gradient (``parallel.sharding.global_objective``: one flat
    all-reduce an evaluation; ``DeviceLBFGS`` splits K3's value-and-grad
    around its all-reduce), so every rank's solver takes the same decisions;
    the outer epochs run as this per-outer-epoch step, not as ``LBFGSChunk``
    (a line says so: :data:`DP_LBFGS_NOTE`).
    """
    loss_fn = make_loss_fn(problem)
    dterm = make_data_term(problem)
    exp = problem.exp
    cfg = exp.optimizer.lbfgs
    data_weight = exp.loss.data_weight
    solver, k3 = None, False
    if problem.device.type == "cuda" and not host_loop:
        from pinns_tpu_torch.ops.kernels import lbfgs as k_lbfgs

        if not k_lbfgs.lbfgs_device_supported(exp, problem.spec):
            solver, k3 = k_lbfgs.DeviceLBFGS(problem), True
        else:
            solver = k_lbfgs.AutogradLBFGS()

    def step(state: TrainState, out: Optional[torch.Tensor] = None,
             new_colloc: Optional[torch.Tensor] = None):
        x0, unravel = ravel_tree(state.params)
        opts = dict(max_iters=cfg.max_iters, history=cfg.history, ftol=cfg.ftol, gtol=cfg.gtol,
                    max_ls=cfg.max_ls)
        fun = lambda x: loss_fn(unravel(x), state.colloc, state.admm, state.rho)[0]  # noqa: E731
        if problem.shard is not None:
            fun = global_objective(fun, problem.shard)
        if k3:
            res = solver.minimize(x0.detach(), k_lbfgs.net_offset(state.params), state.colloc,
                                  state.admm, exp.loss.rho if state.rho is None else state.rho,
                                  **opts)
        elif solver is not None:
            res = solver.minimize(fun, x0.detach(), **opts)
        else:
            res = lbfgs_minimize(fun, x0.detach(), **opts)
        params = unravel(res.x)
        with torch.no_grad():
            lam1, lam2 = problem.effective_coeffs(params)
            data_term = dterm(params)
        admm_state, colloc, key, mis = _post_update(
            problem, params, state.admm, state.colloc, state.key, state.rho, state.epoch,
            new_colloc,
        )
        metrics = {
            "loss": res.f, "data_term": data_term, "res_term": res.f - data_weight * data_term,
            "lambda1": lam1.reshape(()), "lambda2": lam2.reshape(()), "admm_misfit": mis,
            "lbfgs_iters": torch.tensor(float(res.n_iters), device=mis.device),
        }
        new_state = TrainState(
            params=params, opt_state=state.opt_state, admm=admm_state, colloc=colloc,
            key=key, epoch=state.epoch + 1, rho=state.rho,
        )
        return new_state, _write_metrics(metrics, out)

    step.solver = solver  # K10's DeviceLBFGS or AutogradLBFGS, or None: the host loop
    if k3 and not k_lbfgs.lbfgs_chunk_supported(exp, problem.spec):
        if problem.shard is None:
            step.graphed = functools.partial(k_lbfgs.LBFGSChunk, problem)
        elif problem.shard.owner:
            print(DP_LBFGS_NOTE, flush=True)
    return step


@torch.no_grad()
def swa_update(avg, n: int, params):
    """One step of SWA's running mean (JAX's ``Trainer._swa_update``):
    ``avg += (p - avg) / (n + 1)`` over every leaf of ``params``, the
    accumulator in float32 whatever the working dtype; the first call copies
    the params. Returns (avg, n + 1). A stacked ensemble's params average
    member by member (the member axis rides along)."""
    if avg is None:
        return tree_map(lambda p: p.detach().to(torch.float32).clone(), params), 1
    # a 0-d tensor on the params' device: a true division, as JAX's (ATen
    # multiplies by the reciprocal of a host scalar on the card)
    count = torch.tensor(float(n + 1), dtype=torch.float32, device=tree_leaves(avg)[0].device)
    return tree_map(lambda a, p: a + (p.detach().to(torch.float32) - a) / count,
                    avg, params), n + 1


def swa_params(avg, params):
    """The SWA mean cast back to each leaf's dtype (new tensors)."""
    return tree_map(lambda a, p: a.to(p.dtype).clone(), avg, params)


# the Philox epoch words of RAD's draws (the 64-bit epoch word's high half
# set, so they never meet the uniform batches' draws 0, 1, 2, ...): the pool
# after epoch e draws (RAD_POOL + e), the categorical pick (RAD_PICK + e)
RAD_POOL = 1 << 32
RAD_PICK = 2 << 32


def rad_probabilities(problem: Problem, params, pool: torch.Tensor,
                      plain: bool = False) -> torch.Tensor:
    """RAD's sampling weights over ``pool`` (JAX's ``_get_rad_resample``):
    the TRAINED objective's residuals (the weak-form cells under a weak-form
    loss) in ``sampling.microbatch * sampling.rad_pool_factor`` pieces, the
    score the sum of the components' |f|, and p = |f|^k / (mean(|f|^k) +
    1e-12) + c, (M,) in the working dtype. ``plain`` forces the plain
    versions on any device."""
    cfg = problem.exp.sampling

    def one(pts):
        if problem.flux:
            return problem.flux_residuals_and_entropy(params, pts, plain=plain)[0]
        return problem.residuals(params, pts, plain)

    m = cfg.microbatch * cfg.rad_pool_factor
    if m <= 1:
        f = one(pool)
    else:
        parts = [one(ch) for ch in _chunks(pool, m)]
        f = (tuple(torch.cat(c) for c in zip(*parts)) if isinstance(parts[0], tuple)
             else torch.cat(parts))
    fs = f if isinstance(f, tuple) else (f,)
    score = sum(torch.abs(fi[:, 0]) for fi in fs)
    pk = score ** cfg.rad_k
    return pk / (torch.mean(pk) + 1e-12) + cfg.rad_c


def rad_pick(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices drawn from the weights ``p`` (M,) at the uniforms ``u`` (n,)
    in [0, 1): the inverse of the float64 cumulative sums (a categorical
    draw, as JAX's ``jax.random.categorical`` of log p)."""
    cdf = torch.cumsum(p.to(torch.float64), 0)
    idx = torch.searchsorted(cdf, u.to(torch.float64) * cdf[-1], right=True)
    return idx.clamp_(max=p.shape[0] - 1)


@torch.no_grad()
def rad_resample(problem: Problem, state: TrainState, plain: bool = False) -> TrainState:
    """RAD's redraw at a chunk boundary (JAX's ``Trainer._get_rad_resample``):
    a uniform pool of ``rad_pool_factor * n_f`` points inside the
    curriculum's bounds of ``state.epoch`` (Philox(key, RAD_POOL + epoch)),
    scored by :func:`rad_probabilities`, then n_f indices drawn from p by
    inverse CDF (float64 cumulative sums) at the uniforms of Philox(key,
    RAD_PICK + epoch); with ADMM, z and the dual re-initialize at the new
    points. The draw is the port's: JAX's threefry points differ, so parity
    is exact for p on one pool and statistical for the draw."""
    cfg = problem.exp.sampling
    epoch = int(state.epoch)
    lb, ub = _curriculum_bounds(problem, epoch)
    pool = _philox_points(problem, state.key, RAD_POOL + epoch, cfg.rad_pool_factor * cfg.n_f,
                          lb, ub)
    p = rad_probabilities(problem, state.params, pool, plain)
    u = _philox_points(problem, state.key, RAD_PICK + epoch, cfg.n_f, (0.0, 0.0), (1.0, 1.0))
    colloc = pool.index_select(0, rad_pick(p, u[:, 0]))
    admm = state.admm
    if admm is not None:
        admm = admm_init(problem.training_residuals(state.params, colloc, plain=plain))
    return state._replace(colloc=colloc, admm=admm)


def run_chunk(step, state: TrainState, length: int,
              new_colloc: Optional[torch.Tensor] = None):
    """``length`` steps, one host call of ``step`` an epoch: the per-epoch
    loop (K9's plain version). The per-step metrics go into ONE (length, 7)
    float32 device buffer, with no device->host sync inside the chunk;
    ``new_colloc`` (length, N_f, 2) replaces the Philox draws. A stacked
    ensemble state with its member-batched step (K8's,
    ``ops.kernels.fused_step.make_fused_ensemble_step``) runs the same way,
    with a member axis after the epoch's in the buffer and the feed.
    Returns (state, {metric: (length,) or (length, E) tensor})."""
    lead = tuple(state.colloc.shape[:-2])  # (E,) for a stacked state
    buf = torch.empty((length, *lead, len(METRIC_KEYS)), dtype=torch.float32,
                      device=state.colloc.device)
    for i in range(length):
        state, _ = step(state, buf[i], None if new_colloc is None else new_colloc[i])
    return state, {k: buf[..., j] for j, k in enumerate(METRIC_KEYS)}


def make_chunked(step, chunk: int):
    """``run(state, length=chunk, new_colloc=None) -> (state, {metric:
    (length,) tensor})``: ``length`` epochs of ``step`` as one unit, the
    port of JAX's ``make_chunked`` (its ``lax.scan`` over the step, one
    device call a chunk).

    The fused step on the card (K3, whose step carries ``graphed``) runs as
    K9: its epochs replayed from captured CUDA graphs
    (``ops.kernels.fused_step.FusedChunk``, made once here and kept for
    every chunk of up to ``chunk`` epochs), bit for bit the per-epoch loop's
    result. The generic step on the card inside ``generic_chunk_supported``
    carries ``graphed`` (``ops.kernels.generic_chunk.GenericChunk``: one
    captured epoch replayed ``length`` times), and so does the L-BFGS step
    inside K10's chunk scope: its outer epochs run as ``ops.kernels.lbfgs.
    LBFGSChunk``'s chunks. Every other step (the CPU's plain step,
    ``burgers_scale``, the other L-BFGS steps) runs the per-epoch loop,
    :func:`run_chunk`. ``new_colloc`` (length, N_f, 2) replaces the Philox
    draws."""
    graphed = getattr(step, "graphed", None)
    if graphed is not None:
        runner = graphed(max_len=chunk)

        def run(state, length: int = chunk, new_colloc: Optional[torch.Tensor] = None):
            return runner.run(state, length, new_colloc)

        run.runner = runner
        return run

    def run(state, length: int = chunk, new_colloc: Optional[torch.Tensor] = None):
        return run_chunk(step, state, length, new_colloc)

    return run


class Trainer:
    """End-to-end training orchestrator (host side): chunked stepping, metric
    logging, snapshots, checkpoints, final rel-L2 evaluation."""

    def __init__(self, exp: Experiment, problem: Optional[Problem] = None,
                 device="cuda", dataset: Optional[str] = None):
        self.exp = exp
        self.problem = problem if problem is not None else build_problem(exp, device, dataset)
        self.device = self.problem.device
        self.learning_rate = learning_rate_schedule(exp.optimizer)
        self._adam_step = make_step(self.problem, self.learning_rate)
        self._lbfgs_step = make_lbfgs_step(self.problem)
        # the chunk runners (make_chunked) by phase, as JAX's _get_chunk
        # caches them; parallel.ensemble keeps K8's here too
        self._chunks: Dict[Any, Any] = {}
        self.logger = MetricsLogger(out_dir=exp.train.out_dir or None, name=exp.name)
        # set by train() when train.swa_frac > 0: the tail average of the
        # params in the working dtype
        self.swa_params = None

    # -- state ------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None, rho: Optional[float] = None) -> TrainState:
        """Weights from ``torch.Generator().manual_seed(seed)``; the batch of
        epoch e is Philox(seed, e) under 'resample_uniform'; z = r(w_0) at the
        initial batch and dual = 1 under 'admm'."""
        exp = self.exp
        seed = exp.train.seed if seed is None else int(seed)
        dtype, device = self.problem.spec.dtype, self.device
        params = {
            "net": init_mlp(self.problem.spec, torch.Generator().manual_seed(seed), device),
            "coeffs": {
                "lambda1": torch.full((1,), exp.pde.lambda1, dtype=dtype, device=device),
                "lambda2": torch.full((1,), exp.pde.lambda2, dtype=dtype, device=device),
            },
        }
        colloc = init_collocation(self.problem, seed)
        admm_state = None
        if exp.loss.residual_kind == "admm":
            with torch.no_grad():
                admm_state = admm_init(self.problem.training_residuals(params, colloc))
        return TrainState(
            params=params, opt_state=adam_init(params), admm=admm_state, colloc=colloc,
            key=seed, epoch=0, rho=None if rho is None else float(rho),
        )

    # -- stepping ---------------------------------------------------------
    def _phase(self, epoch: int) -> str:
        opt = self.exp.optimizer
        if opt.kind == "adam":
            return "adam"
        if opt.kind == "lbfgs":
            return "lbfgs"
        return "adam" if epoch < opt.switch_epoch else "lbfgs"

    def _get_chunk(self, phase: str):
        """The phase's chunk runner (:func:`make_chunked`), made at first use."""
        if phase not in self._chunks:
            step = self._adam_step if phase == "adam" else self._lbfgs_step
            self._chunks[phase] = make_chunked(step, self.exp.train.chunk)
        return self._chunks[phase]

    def train(self, state: Optional[TrainState] = None, epochs: Optional[int] = None):
        """Run the configured schedule; returns (state, summary dict)."""
        exp = self.exp
        pin_numerics()
        if state is None:
            state = self.init_state()
        total = exp.train.epochs if epochs is None else epochs
        chunk = max(1, min(exp.train.chunk, total))
        # L-BFGS outer epochs are whole inner solves: keep their chunks short
        lbfgs_chunk = max(1, min(chunk // 100 or 1, 10))
        # SWA: the running mean of the params at the chunk boundaries past
        # swa_start (JAX's :1070-1078), between chunks, outside any step
        swa_start = (total - int(round(exp.train.swa_frac * total))
                     if exp.train.swa_frac > 0.0 else None)
        swa_avg, swa_n = None, 0
        t0 = time.time()
        epoch = int(state.epoch)
        n_chunks = 0
        last = None
        while epoch < total:
            phase = self._phase(epoch)
            length = min(chunk if phase == "adam" else lbfgs_chunk, total - epoch)
            if phase == "adam" and exp.optimizer.kind == "hybrid":
                length = min(length, exp.optimizer.switch_epoch - epoch)
            run = self._get_chunk(phase)
            if exp.train.profile_dir and n_chunks == 1:
                # the second chunk, past the first one's warm-up (as the JAX
                # trainer traces it with jax.profiler)
                state, metrics = self._profiled_chunk(run, state, length)
            else:
                state, metrics = run(state, length)
            n_chunks += 1
            epoch += length
            last = None
            if epoch >= total or self._crossed(epoch, length, exp.train.log_every):
                last = self._log_chunk(epoch, phase, metrics, t0)
                t0 = time.time()
            elif exp.train.stop_tol > 0.0:
                last = {"loss": float(metrics["loss"][-1])}
            if exp.train.stop_tol > 0.0 and abs(last["loss"]) <= exp.train.stop_tol:
                break
            self._maybe_snapshot(epoch, length, state)
            self._maybe_checkpoint(epoch, length, state)
            if swa_start is not None and epoch > swa_start:
                swa_avg, swa_n = swa_update(swa_avg, swa_n, state.params)
            if exp.sampling.strategy == "rad" and epoch < total:
                state = rad_resample(self.problem, state)
        shard = self.problem.shard
        owner = shard is None or shard.owner
        # under a shard data rank 0 evaluates; every rank reports its final
        # loss (the same on every rank: it is all-reduced)
        summary = self.evaluate(state) if owner else {}
        summary["epochs"] = epoch
        if shard is not None:
            summary.update(rank=shard.rank, loss=last["loss"] if last else None)
        if swa_n > 0:
            self.swa_params = swa_params(swa_avg, state.params)
            summary["swa_snapshots"] = swa_n
            if owner:
                for k, v in self.evaluate(state, params=self.swa_params).items():
                    summary[f"swa_{k}"] = v
            if exp.train.out_dir:
                # a loadable state at the averaged iterate (the optimizer and
                # ADMM state stay the final ones: SWA redefines only params)
                self.save_checkpoint(state._replace(params=self.swa_params), tag="swa")
        self.logger.write_summary(summary)
        if exp.train.out_dir:
            self.save_checkpoint(state, tag="final")
        return state, summary

    def _profiled_chunk(self, run, state, length):
        """A chunk runner's ``length`` epochs (:meth:`_get_chunk`: the
        replayed graphs of the fused step on the card, else the per-epoch
        loop) under torch.profiler (the card's kernels too, on a CUDA
        device); the trace goes to train.profile_dir as <name>_e<first
        epoch>.json, for chrome://tracing or Perfetto."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        first = int(state.epoch)
        with profile(activities=activities) as prof:
            state, metrics = run(state, length)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(self.exp.train.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.exp.train.profile_dir, f"{self.exp.name}_e{first}.json"))
        return state, metrics

    # -- reporting --------------------------------------------------------
    def _log_chunk(self, epoch, phase, metrics, t0):
        # ONE device->host transfer of the chunk's last row
        values = torch.stack([metrics[k][-1] for k in METRIC_KEYS]).cpu().numpy()
        elapsed = time.time() - t0  # after the sync: the chunk's device time
        last = {k: float(v) for k, v in zip(METRIC_KEYS, values)}
        self.logger.log(epoch=epoch, phase=phase, elapsed=elapsed, **last)
        return last

    @staticmethod
    def _crossed(epoch, length, every):
        # true when (epoch-length, epoch] contains a multiple of `every`
        return every > 0 and (epoch // every) != ((epoch - length) // every)

    def _maybe_snapshot(self, epoch, length, state):
        every = self.exp.train.snapshot_every
        shard = self.problem.shard
        if shard is not None and not shard.owner:
            return
        if every and self.exp.train.out_dir and self._crossed(epoch, length, every):
            self.record_snapshot(state, epoch)

    def _maybe_checkpoint(self, epoch, length, state):
        every = self.exp.train.checkpoint_every
        if every and self.exp.train.out_dir and self._crossed(epoch, length, every):
            self.save_checkpoint(state, tag=f"e{epoch}")

    def predict(self, params, x) -> Dict[str, np.ndarray]:
        pin_numerics()
        with torch.no_grad():
            xt = torch.as_tensor(np.asarray(x), dtype=self.problem.spec.dtype).to(self.device)
            out = predict_fields(self.problem, params, xt)
            return {k: v.cpu().numpy() for k, v in out.items()}

    def evaluate(self, state: TrainState, params=None) -> Dict[str, Any]:
        """Relative L2 error per field over the full exact grid, the PDE
        coefficients, and the grid's provenance."""
        params = state.params if params is None else params
        ds = self.problem.dataset
        preds = self.predict(params, ds.X_star)
        out: Dict[str, Any] = {
            f"rel_l2_{name}": relative_l2(preds[name], ds.star[name]) for name in ds.field_names
        }
        lam1, lam2 = self.problem.effective_coeffs(params)
        out["lambda1"] = float(lam1.reshape(-1)[0])
        out["lambda2"] = float(lam2.reshape(-1)[0])
        out["truth"] = getattr(ds, "provenance", "unknown")
        return out

    def record_snapshot(self, state: TrainState, epoch: int):
        """Append a full-grid prediction snapshot to <out>/<name>_snapshots.csv
        (columns x, t, <field>_pred..., epoch)."""
        ds = self.problem.dataset
        preds = self.predict(state.params, ds.X_star)
        cols = {"x": ds.X_star[:, 0], "t": ds.X_star[:, 1]}
        for name in ds.field_names:
            cols[f"{name}_pred"] = preds[name][:, 0]
        cols["epoch"] = np.full(ds.X_star.shape[0], epoch)
        self.logger.append_snapshot(cols)

    # -- checkpointing ----------------------------------------------------
    def save_checkpoint(self, state: TrainState, tag: str = "final") -> str:
        """``<out_dir>/<name>_<tag>.ckpt``. Under a shard every rank of the
        data row calls it: the batch and the ADMM state are gathered whole
        (``parallel.sharding.gather_state``) and data rank 0 writes them."""
        out_dir = self.exp.train.out_dir or "."
        path = os.path.join(out_dir, f"{self.exp.name}_{tag}.ckpt")
        shard = self.problem.shard
        state = gather_state(state, shard)
        if shard is not None and not shard.owner:
            return path
        ckpt_io.save_checkpoint(path, state, meta={
            "experiment": self.exp.name,
            "epoch": int(state.epoch),
            "rho": state.rho,
        })
        return path

    def load_checkpoint(self, path: str) -> TrainState:
        """The checkpoint on the trainer's device, its floating params, batch
        and ADMM state in the working dtype (a float64 trainer loads into
        float64 for ``polish``; a float32 one reads a polished checkpoint)."""
        return ckpt_io.load_checkpoint(path, self.device, self.problem.spec.dtype)
