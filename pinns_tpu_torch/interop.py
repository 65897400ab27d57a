"""The port's way in from a JAX run: parameter and training-state conversion,
and the params file.

JAX keeps an MLP as a list of ``{"W": (din, dout), "b": (1, dout)}`` arrays
(``pinns_tpu.models.mlp.init_mlp``), with a shock-path net's ``path_c`` (K,
D + 1) and ``path_a`` (K,) on the first layer's dict; the port keeps the same
layout in torch, so conversion is a copy in each direction. A whole training state
(params, optax Adam moments, ADMM z/dual, collocation batch) converts with
``train_state_from_jax`` / ``train_state_to_numpy``.

The params file (``.npz``) holds
  ``layers`` (int64), ``lb``/``ub`` (float64, as the spec holds them),
  ``W{i}``/``b{i}`` per layer, ``lambda1``/``lambda2`` (the Burgers
  coefficients), ``pde`` ('burgers' or 'euler') and ``gamma`` (the Euler
  system's ratio of specific heats), and optionally ``experiment`` (a name
  string). A shock-path net adds ``path_c``/``path_a`` and the spec's
  ``n_paths``, ``path_degree``, ``path_sharpness``; a net with Fourier
  features adds ``fourier``, the spec's B (F, 2) in float64 (as the spec
  holds it). A file without ``pde``
  is a Burgers one (``gamma`` 1.4). Other keys are ignored on load, so a file
  may carry extra arrays beside them.

An ensemble's file (:func:`save_ensemble_npz`, the served ensemble artifact's
weights) holds E member nets of one spec: the same keys with a leading member
axis on ``W{i}``, ``b{i}``, ``path_c``, ``path_a``, ``lambda1`` and
``lambda2`` (each member's own coefficients), and ``members`` (E).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pinns_tpu_torch.losses.admm import ADMMState
from pinns_tpu_torch.models.mlp import PATH_KEYS, MLPSpec, Params
from pinns_tpu_torch.opt.adam import AdamState, tree_map


def params_from_jax(
    layers: Sequence[Dict[str, np.ndarray]], device: torch.device
) -> Params:
    """JAX params (a list of ``{"W","b"}`` numpy arrays, the first with
    ``path_c``/``path_a`` for a shock-path net) -> float32 port params on
    ``device``."""
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32).to(  # noqa: E731
        device).contiguous()
    out = []
    for i, layer in enumerate(layers):
        w = np.asarray(layer["W"])
        b = np.asarray(layer["b"]).reshape(1, -1)
        if w.ndim != 2 or b.shape[1] != w.shape[1]:
            raise ValueError(f"layer {i}: W {w.shape} and b {b.shape} do not match")
        out.append({"W": f32(w), "b": f32(b)})
    first = layers[0] if layers else {}
    if any(k in first for k in PATH_KEYS):
        c, a = np.asarray(first["path_c"]), np.asarray(first["path_a"]).reshape(-1)
        if c.ndim != 2 or c.shape[0] != a.shape[0]:
            raise ValueError(f"path_c {c.shape} and path_a {a.shape} do not match")
        out[0].update(path_c=f32(c), path_a=f32(a))
    return out


def params_to_numpy(params: Params) -> List[Dict[str, np.ndarray]]:
    """Port params -> the JAX pytree layout as numpy arrays."""
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()} for layer in params]


def save_params_npz(
    path: str,
    spec: MLPSpec,
    params,
    lambda1: float,
    lambda2: float,
    experiment: Optional[str] = None,
    pde: str = "burgers",
    gamma: float = 1.4,
    **extra: np.ndarray,
) -> str:
    """Write ``params`` (port tensors or JAX-layout numpy) with the spec's
    widths and bounds, the Burgers coefficients and the PDE; ``extra`` arrays
    ride along under their own names."""
    return _save(path, spec, [params], [lambda1], [lambda2], experiment, pde, gamma, False,
                 extra)


def save_ensemble_npz(path: str, spec: MLPSpec, members: Sequence, lambda1s: Sequence[float],
                      lambda2s: Sequence[float], experiment: Optional[str] = None,
                      pde: str = "burgers", gamma: float = 1.4) -> str:
    """Write E member nets of ``spec`` (port tensors or JAX-layout numpy) and
    each member's Burgers coefficients into one params file with a leading
    member axis (the module docstring has the keys)."""
    if not members or len(members) != len(lambda1s) or len(members) != len(lambda2s):
        raise ValueError(f"{len(members)} members, {len(lambda1s)} lambda1, "
                         f"{len(lambda2s)} lambda2")
    return _save(path, spec, members, lambda1s, lambda2s, experiment, pde, gamma, True, {})


def _save(path, spec, members, lambda1s, lambda2s, experiment, pde, gamma, stacked, extra):
    members = [params_to_numpy(p) if p and isinstance(p[0]["W"], torch.Tensor) else p
               for p in members]
    for params in members:
        if len(params) != len(spec.layers) - 1:
            raise ValueError(
                f"{len(params)} layers of params for spec widths {spec.layers}"
            )
    # one member: the arrays as they are; an ensemble: stacked on axis 0
    join = (lambda xs: np.stack(xs)) if stacked else (lambda xs: xs[0])  # noqa: E731
    arrays = {
        "layers": np.asarray(spec.layers, np.int64),
        "lb": np.asarray(spec.lb, np.float64),
        "ub": np.asarray(spec.ub, np.float64),
        "lambda1": join([np.asarray(v, np.float32).reshape(()) for v in lambda1s]),
        "lambda2": join([np.asarray(v, np.float32).reshape(()) for v in lambda2s]),
        "pde": np.asarray(pde),
        "gamma": np.asarray(gamma, np.float64).reshape(()),
    }
    for i in range(len(spec.layers) - 1):
        arrays[f"W{i}"] = join([np.asarray(p[i]["W"], np.float32) for p in members])
        arrays[f"b{i}"] = join([np.asarray(p[i]["b"], np.float32).reshape(1, -1)
                                for p in members])
    if spec.n_paths:
        arrays["path_c"] = join([np.asarray(p[0]["path_c"], np.float32) for p in members])
        arrays["path_a"] = join([np.asarray(p[0]["path_a"], np.float32).reshape(-1)
                                 for p in members])
        arrays["n_paths"] = np.asarray(spec.n_paths, np.int64)
        arrays["path_degree"] = np.asarray(spec.path_degree, np.int64)
        arrays["path_sharpness"] = np.asarray(spec.path_sharpness, np.float64)
    if spec.fourier:
        arrays["fourier"] = np.asarray(spec.fourier, np.float64)
    if stacked:
        arrays["members"] = np.asarray(len(members), np.int64)
    if experiment is not None:
        arrays["experiment"] = np.asarray(experiment)
    np.savez(path, **arrays, **extra)
    return path


def load_params_npz(path: str) -> dict:
    """Read a params file: ``{"spec", "params" (numpy, JAX layout),
    "lambda1", "lambda2", "pde", "gamma", "experiment", "members"}``. For an
    ensemble's file ``members`` is E, every params array has the leading
    member axis and the coefficients are (E,) arrays; for one net it is None
    and they are floats."""
    with np.load(path, allow_pickle=False) as z:
        layers = tuple(int(w) for w in z["layers"])
        members = int(z["members"]) if "members" in z else None
        lead = () if members is None else (members,)
        paths = {}
        if "n_paths" in z:
            paths = {"n_paths": int(z["n_paths"]), "path_degree": int(z["path_degree"]),
                     "path_sharpness": float(z["path_sharpness"])}
        if "fourier" in z:
            paths["fourier"] = tuple(tuple(float(v) for v in row) for row in z["fourier"])
        spec = MLPSpec(layers=layers, lb=tuple(z["lb"]), ub=tuple(z["ub"]), **paths)
        params = [
            {"W": z[f"W{i}"], "b": z[f"b{i}"]} for i in range(len(layers) - 1)
        ]
        if spec.n_paths:
            params[0].update(path_c=z["path_c"], path_a=z["path_a"])
            want = (lead + (spec.n_paths, spec.path_degree + 1), lead + (spec.n_paths,))
            if (params[0]["path_c"].shape, params[0]["path_a"].shape) != want:
                raise ValueError(f"{path}: path_c {params[0]['path_c'].shape}, path_a "
                                 f"{params[0]['path_a'].shape}; the spec says {want}")
        widths = spec.widths
        for i, (din, dout) in enumerate(zip(widths[:-1], widths[1:])):
            if params[i]["W"].shape != lead + (din, dout) or \
                    params[i]["b"].shape != lead + (1, dout):
                raise ValueError(
                    f"{path}: layer {i} has W {params[i]['W'].shape}, "
                    f"b {params[i]['b'].shape}; widths say {lead + (din, dout)}"
                )
        coeff = float if members is None else (lambda a: np.asarray(a, np.float32))  # noqa: E731
        lam1, lam2 = coeff(z["lambda1"]), coeff(z["lambda2"])
        if members is not None and (lam1.shape, lam2.shape) != (lead, lead):
            raise ValueError(f"{path}: lambda1 {lam1.shape}, lambda2 {lam2.shape} for "
                             f"{members} members")
        return {
            "spec": spec,
            "params": params,
            "lambda1": lam1,
            "lambda2": lam2,
            "pde": str(z["pde"]) if "pde" in z else "burgers",
            "gamma": float(z["gamma"]) if "gamma" in z else 1.4,
            "experiment": str(z["experiment"]) if "experiment" in z else None,
            "members": members,
        }


def unstack_params(stacked: Sequence[Dict[str, np.ndarray]], members: int
                   ) -> List[List[Dict[str, np.ndarray]]]:
    """The member nets of JAX-layout params with a leading member axis
    (:func:`load_params_npz` of an ensemble's file), as numpy."""
    return [[{k: np.asarray(v)[i] for k, v in layer.items()} for layer in stacked]
            for i in range(members)]


def _to_torch(tree, device):
    return tree_map(lambda a: torch.tensor(np.asarray(a)).to(device).contiguous(), tree)


def train_state_from_jax(tree: dict, device: torch.device, key: Optional[int] = None):
    """A port ``TrainState`` from a JAX training state given as numpy:

      ``params``  {'net': [{'W','b'}...], 'coeffs': {'lambda1','lambda2'}}
      ``count``, ``mu``, ``nu``  optax's ``ScaleByAdamState`` (mu/nu shaped
                  like params)
      ``z``, ``dual``  the ADMM state, or absent/None
      ``colloc``  the (N_f, 2) batch the next step trains on
      ``epoch``   the step count; ``key`` (here or in the tree) the port's
                  Philox seed, since a JAX PRNG key has no port counterpart.

    Both packages then start one step from the same state.
    """
    from pinns_tpu_torch.train.trainer import TrainState

    z = tree.get("z")
    key = tree.get("key", 0) if key is None else key
    return TrainState(
        params=_to_torch(tree["params"], device),
        opt_state=AdamState(
            count=int(np.asarray(tree["count"])),
            mu=_to_torch(tree["mu"], device),
            nu=_to_torch(tree["nu"], device),
        ),
        admm=None if z is None else ADMMState(
            z=_to_torch(z, device), dual=_to_torch(tree["dual"], device)),
        colloc=_to_torch(tree["colloc"], device),
        key=int(np.asarray(key)),
        epoch=int(np.asarray(tree["epoch"])),
    )


def _member_of(tree, i: int):
    """Member ``i`` of a numpy tree with a leading member axis."""
    if isinstance(tree, dict):
        return {k: _member_of(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_member_of(v, i) for v in tree)
    return None if tree is None else np.asarray(tree)[i]


def ensemble_state_from_jax(stacked_tree: dict, device: torch.device, keys: Sequence[int]):
    """A port ensemble state (``parallel.ensemble.stack_states``) from JAX's
    stacked ``TrainState`` given as numpy: the tree of
    :func:`train_state_from_jax` with a leading member axis on every array
    (``count`` and ``epoch`` included) and, for a rho-swept ensemble,
    ``rho`` (E,). ``keys`` are the members' Philox seeds."""
    from pinns_tpu_torch.parallel.ensemble import stack_states

    rho = stacked_tree.get("rho")
    members = []
    for i, key in enumerate(keys):
        tree = _member_of({k: v for k, v in stacked_tree.items() if k not in ("key", "rho")}, i)
        state = train_state_from_jax(tree, device, key=int(key))
        if rho is not None:
            state = state._replace(rho=float(np.asarray(rho)[i]))
        members.append(state)
    return stack_states(members)


def train_state_to_numpy(state) -> dict:
    """The inverse of :func:`train_state_from_jax`: a port ``TrainState`` as
    the numpy tree that function takes."""
    cpu = lambda t: t.detach().cpu().numpy()  # noqa: E731
    conv = lambda tree: tree_map(cpu, tree)  # noqa: E731
    out = {
        "params": conv(state.params),
        "count": state.opt_state.count,
        "mu": conv(state.opt_state.mu),
        "nu": conv(state.opt_state.nu),
        "colloc": cpu(state.colloc),
        "epoch": state.epoch,
        "key": state.key,
    }
    if state.admm is not None:
        out["z"], out["dual"] = cpu(state.admm.z), cpu(state.admm.dual)
    return out
