"""Checkpoint / resume of the full ``TrainState`` in a torch-native format
(the JAX package writes flax msgpack, which the port cannot read: flax is not
on the machine with the card).

``<path>`` holds ``torch.save`` of a dict of CPU tensors, ints and None:
params, Adam count/mu/nu, ADMM z/dual, the collocation batch, the Philox
key, the epoch and the rho override. ``<path>.json`` holds the meta, as in
the JAX package. Loading uses ``weights_only=True`` and puts every tensor on
the requested device, so a run restores exactly and continues. A load with
a ``dtype`` also casts every floating leaf of the params, the batch and the
ADMM state to it (``polish`` loads into float64); the Adam moments stay as
they were saved, as JAX's ``state._replace`` keeps them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from pinns_tpu_torch.device import resolve_device
from pinns_tpu_torch.opt.adam import tree_map


def state_to_dict(state) -> dict:
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    opt = state.opt_state
    return {
        "params": tree_map(cpu, state.params),
        "adam": {"count": int(opt.count), "mu": tree_map(cpu, opt.mu),
                 "nu": tree_map(cpu, opt.nu)},
        "admm": None if state.admm is None
        else {"z": tree_map(cpu, state.admm.z), "dual": tree_map(cpu, state.admm.dual)},
        "colloc": cpu(state.colloc),
        "key": int(state.key),
        "epoch": int(state.epoch),
        "rho": state.rho,
    }


def state_from_dict(d: dict, device, dtype: Optional[torch.dtype] = None):
    """The ``TrainState`` of ``state_to_dict`` on ``device``; with ``dtype``,
    every floating leaf of the params, the batch and the ADMM state in it."""
    from pinns_tpu_torch.losses.admm import ADMMState
    from pinns_tpu_torch.opt.adam import AdamState
    from pinns_tpu_torch.train.trainer import TrainState

    dev = lambda t: t.to(device)  # noqa: E731

    def cast(t):
        t = t.to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    admm = d["admm"]
    return TrainState(
        params=tree_map(cast, d["params"]),
        opt_state=AdamState(count=int(d["adam"]["count"]), mu=tree_map(dev, d["adam"]["mu"]),
                            nu=tree_map(dev, d["adam"]["nu"])),
        admm=None if admm is None else ADMMState(z=tree_map(cast, admm["z"]),
                                                 dual=tree_map(cast, admm["dual"])),
        colloc=cast(d["colloc"]),
        key=int(d["key"]),
        epoch=int(d["epoch"]),
        rho=d["rho"],
    )


def save_checkpoint(path: str, state, meta: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(state_to_dict(state), path)
    with open(path + ".json", "w") as fh:
        json.dump(meta or {}, fh)


def load_checkpoint(path: str, device="cuda", dtype: Optional[torch.dtype] = None):
    """Restore the ``TrainState`` of ``save_checkpoint`` onto ``device`` (the
    card unless the caller asks for the CPU; raises without one), its
    floating params, batch and ADMM state in ``dtype`` when given."""
    device = resolve_device(device)
    return state_from_dict(torch.load(path, map_location="cpu", weights_only=True), device,
                           dtype)


def load_meta(path: str) -> Dict:
    try:
        with open(path + ".json") as fh:
            return json.load(fh)
    except FileNotFoundError:  # checkpoints written without a sidecar
        return {}
