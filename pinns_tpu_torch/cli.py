"""Command line of the port: ``python -m pinns_tpu_torch <command>``.

  train    --preset NAME [--set KEY=VALUE ...] [--epochs N] [--chunk C] [--data GRID]
           [--device cuda|cpu] [--out-dir D] [--seed S] [--resume CKPT]
                                                  train; prints the JSON summary
  train    --preset NAME --ensemble E [--select] [--resume PREFIX] [...]
                                                  E members, seeds S .. S + E - 1
  python -m torch.distributed.run --nproc-per-node N -m pinns_tpu_torch train
           --preset NAME --mesh-data D [--ensemble E] [...]
                                                  D ranks a model; members over N / D
  sweep    --preset NAME --grid KEY=V1,V2,... [--grid ...] [--retries R] [--out F.jsonl]
           [--epochs N] [--serial] [--set ...] [--device cuda|cpu]
                                                  the cartesian grid; one line a config
  export   --params P.npz --out D                 write a serving artifact
  export   --preset NAME [--set ...] --checkpoint CKPT --out D [--device cuda|cpu]
                                                  the same artifact from a checkpoint
  export   --preset NAME --checkpoint M0 ... ME-1 --out D [--calibrate]
           [--mond-feature dx|std]                an ensemble artifact (mean, std, bands)
  export   --preset NAME --checkpoint M0 ... --select score|consensus|rank
           [--anchor A0 ...] --out D              the member picked without ground truth
  eval     --preset NAME [--set ...] --checkpoint CKPT [--device cuda|cpu]
  eval     --artifact D [--preset NAME] [--device cuda|cpu]
                                                  rel-L2 (and band coverage) per field
  serve    --artifact D --port N --device cuda    HTTP server (GET /meta, POST /predict)
  predict  --artifact D --points P.npz --out O.npz [--bands] --device cuda
                                                  batch inference, npz/csv in and out
  polish   --preset NAME [--set ...] --checkpoint CKPT [--max-iters N] [--out O]
           [--device cuda|cpu]                    float64 L-BFGS polish of a checkpoint

``train`` runs the preset's schedule (on cuda, an Adam epoch inside the fused
step's scope is one call of K3, any other goes through the kernels under
autograd: K5 and K1/K2, K7a for the Euler presets, K7b around K7a or K5 for
the weak-form presets) and prints the summary keys of the JAX CLI
(``rel_l2_u``, or ``rel_l2_rho`` / ``rel_l2_u`` / ``rel_l2_E`` for Euler,
``lambda1``, ``lambda2`` (the effective coefficients: the identified
viscosity of ``euler_inverse``), ``truth``, ``epochs``). ``--resume CKPT``
continues a checkpoint (``train.out_dir`` writes them) from its epoch to the
schedule's end. ``--set`` overrides any config field by its dotted key, as
the JAX CLI's does: the value is a Python literal, else a string, e.g. the
bf16 stream policy of ``burgers_scale``:

  --set model.compute_dtype=bfloat16 --set "model.keep_streams=('xx',)"

``train --ensemble E`` (default ``mesh.ensemble``) trains E members, seeds
``train.seed`` to ``train.seed + E - 1``, through the whole schedule
(``parallel.ensemble.run_ensemble``: on the card an Adam epoch of a preset
inside the fused step's narrow scope is one call of K8 for all members, any
other runs each member's solo step in turn); each member prints its summary
line, and ``--select`` prints the member that the ground-truth-free score
picks. ``--resume PREFIX`` continues the ``PREFIX_m<i>.ckpt`` set that
``train.checkpoint_every`` wrote.

Under torchrun (one process a card, NCCL; gloo with ``--device cpu``)
``train --mesh-data D`` (default ``mesh.data_parallel``) trains one model
data-parallel over the D ranks (``parallel.sharding``): each rank its rows
of the collocation batch, the gradients summed by an all-reduce; every rank
prints its summary line with its final ``loss`` (the same on every rank),
data rank 0's with the evaluation. Checkpoints are whole (written by rank 0)
and ``--resume`` cuts them to the ranks' rows again. With ``--ensemble E``
the world's N / D ensemble coordinates each train their block of the
members (data-parallel when D > 1), and rank 0 prints every member's line.
A mesh larger than the world raises. ``sweep`` runs the cartesian product of the
``--grid`` lists (``parallel.sweep.run_sweep``): configurations that differ
only in ``train.seed`` and ``loss.rho`` train as one ensemble; it exits 1 if
any configuration failed.

``export`` takes a params file (``pinns_tpu_torch.interop`` format, e.g.
written from a JAX run by ``scripts/make_torch_port_fixture.py``; its ``pde``
key makes a Burgers or an Euler artifact) or a checkpoint of the port's own
training with its preset. Several checkpoints (the ``<name>_final_m<i>.ckpt``
that ``train --ensemble`` writes) make an ensemble artifact
(``serve.export_ensemble``); ``--calibrate`` bakes the split-conformal and
Mondrian band factors measured on the preset's grid into it
(``parallel.ensemble.uq_calibration``, binned on ``--mond-feature``, by
default the predicted |d/dx|) and prints one row a field; ``--select``
scores the members without ground truth (seed ``train.seed + 777``, the
consensus against ``--anchor``'s members or the members themselves) and
exports the pick as a point artifact with ``meta["selection"]``. ``eval``
prints ``Trainer.evaluate``'s JSON for a checkpoint, or grades an artifact
against its dataset's grid (with the coverage of the served bands for an
ensemble: ``band_k_*``, ``band_cov_*``, ``band_cov_mond_*``). ``predict
--bands`` adds each calibrated field's ``{name}_band`` half-width.
``polish`` is JAX's float64 L-BFGS polish of a trained checkpoint
(``train.polish``): ``model.dtype=float64`` (``model.precision`` is accepted
and ignored, as everywhere in the port), the checkpoint's params, batch and
ADMM state loaded into float64, the loss minimized at ``ftol=1e-15``,
``gtol=1e-12`` with ``optimizer.lbfgs.history``; on the card in K10's
float64 mode over the float64 modes of K1, K2 and K5, on the CPU by the
host loop. It prints the iterations / loss / converged line, the
``evaluate`` JSON and the path of ``<checkpoint>.polished.ckpt`` (or
``--out``), written with meta ``{"polished": true}``.
``--device`` defaults to cuda and raises when no card is visible; pass
``--device cpu`` for the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

import numpy as np


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_sets(pairs) -> dict:
    """``--set key=value`` pairs as overrides: a Python literal, else a string."""
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        key, value = pair.split("=", 1)
        out[key] = _parse_value(value)
    return out


def _build_exp(args):
    """The preset with ``--set`` and the command's own overrides applied."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.experiments import get_preset

    updates = parse_sets(args.set)
    for key, attr in (("train.epochs", "epochs"), ("train.chunk", "chunk"),
                      ("train.out_dir", "out_dir"), ("train.seed", "seed")):
        value = getattr(args, attr, None)
        if value is not None:
            updates[key] = value
    return override(get_preset(args.preset), updates)


def _mesh(args, n: int, data: int):
    """The process mesh of ``train`` (None for one process without a data
    axis): ``--mesh-data`` ranks a model, the rest of the world on the
    ensemble axis, the members spread over it. Joins torchrun's process
    group first (``parallel.mesh.multihost_init``). A mesh larger than the
    world raises ``ValueError``. Returns (mesh, this rank's device)."""
    from pinns_tpu_torch.parallel.mesh import make_mesh, multihost_init

    _, size, device = multihost_init(args.device)
    if "WORLD_SIZE" not in os.environ and data == 1:
        return None, device
    mesh = make_mesh(data=data, ensemble=max(size // data, 1))
    if mesh.size != size:
        raise SystemExit(f"--mesh-data {data} does not divide the world of {size} ranks")
    if n == 1 and mesh.ensemble > 1:
        raise SystemExit(f"one model over {size} ranks with --mesh-data {data}: launch {data} "
                         "processes, or train an ensemble (--ensemble E)")
    return mesh, device


def cmd_train(args) -> int:
    from pinns_tpu_torch.train.trainer import Trainer

    exp = _build_exp(args)
    n = exp.mesh.ensemble if args.ensemble is None else args.ensemble
    if n < 1:
        raise SystemExit(f"--ensemble takes a member count of at least 1, got {n}")
    data = exp.mesh.data_parallel if args.mesh_data is None else args.mesh_data
    if data < 1:
        raise SystemExit(f"--mesh-data takes a rank count of at least 1, got {data}")
    mesh, device = _mesh(args, n, data)
    trainer = Trainer(exp, device=device, dataset=args.data)
    if n == 1:
        if args.select:
            raise SystemExit("--select picks a member of an ensemble: pass --ensemble E > 1")
        state = trainer.load_checkpoint(args.resume) if args.resume else None
        if mesh is not None:
            from pinns_tpu_torch.parallel.sharding import place_state, shard_trainer

            shard_trainer(trainer, mesh)
            if state is not None:  # the whole checkpoint, cut to this rank's rows
                state = place_state(state, mesh)
        _, summary = trainer.train(state)
        print(json.dumps(summary), flush=True)
        return 0
    return _train_ensemble(args, exp, trainer, n, mesh)


def _train_ensemble(args, exp, trainer, n: int, mesh=None) -> int:
    """``train --ensemble n``: members of seeds train.seed + i, each one's
    summary line, then the pick of ``--select``. Over a mesh each ensemble
    coordinate trains its members (``parallel.ensemble.mesh_members``) and
    rank 0 prints every member's line."""
    from pinns_tpu_torch.parallel.ensemble import (
        mesh_members,
        run_ensemble,
        select_member,
        selection_scores,
        stack_states,
    )

    if args.select and mesh is not None and mesh.ensemble > 1:
        raise SystemExit("--select scores every member on one card; members spread over "
                         f"{mesh.ensemble} ensemble coordinates are not gathered for it yet "
                         "(slice 6b, ROADMAP queue 2): run --select on one card or on "
                         "--mesh-data alone")
    seeds = [exp.train.seed + i for i in range(n)]
    stacked = None
    ids = mesh_members(n, mesh)
    if args.resume and ids:
        members = []
        for i in ids:
            path = f"{args.resume}_m{i}.ckpt"
            if not os.path.exists(path):
                raise SystemExit(f"ensemble resume: missing member checkpoint {path} "
                                 "(--resume takes the prefix of the _m<i>.ckpt set)")
            members.append(trainer.load_checkpoint(path))
        stacked = stack_states(members)
    if mesh is None:
        stacked, summaries = run_ensemble(trainer, seeds, stacked=stacked)
    else:
        stacked, summaries = run_ensemble(trainer, seeds, stacked=stacked, mesh=mesh)
        if mesh.rank != 0:
            return 0
    for seed, summary in zip(seeds, summaries):
        print(json.dumps(dict(summary, seed=seed)), flush=True)
    if args.select:
        scores = selection_scores(trainer, stacked, n)
        pick = select_member(scores)
        print(json.dumps({"selected_member": pick, "seed": seeds[pick],
                          "checkpoint": f"{exp.name}_final_m{pick}.ckpt",
                          "scores": scores}), flush=True)
    return 0


def _split_top_level(text: str):
    """Split on commas outside (), [] and {}: tuple values such as
    model.layers=(2,8,1),(2,16,1) stay whole."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p for p in parts if p]


def cmd_sweep(args) -> int:
    from pinns_tpu_torch.parallel.sweep import cartesian_grid, run_sweep

    exp = _build_exp(args)
    lists = {}
    for spec in args.grid:
        if "=" not in spec:
            raise SystemExit(f"--grid expects KEY=V1,V2,..., got {spec!r}")
        key, values = spec.split("=", 1)
        lists[key] = [_parse_value(v) for v in _split_top_level(values)]
    grid = cartesian_grid(lists)
    results = run_sweep(exp, grid, retries=args.retries, out_path=args.out, epochs=args.epochs,
                        concurrent=False if args.serial else None, device=args.device,
                        dataset=args.data)
    ok = sum(1 for r in results if r.status == "ok")
    print(f"{ok}/{len(results)} configurations succeeded", flush=True)
    for r in results:
        line = {"overrides": r.overrides, "status": r.status}
        if r.summary:
            line.update({k: v for k, v in r.summary.items() if k.startswith("rel_l2")})
        if r.error:
            line["error"] = r.error.strip().splitlines()[-1]
        print(json.dumps(line), flush=True)
    return 0 if ok == len(results) else 1


def cmd_export(args) -> int:
    from pinns_tpu_torch.serve import export_predict

    if args.params:
        from pinns_tpu_torch.interop import load_params_npz

        if args.checkpoint or args.preset or args.select or args.calibrate:
            raise SystemExit("export takes --params, or --preset with --checkpoint")
        loaded = load_params_npz(args.params)
        path = export_predict(
            loaded["spec"], loaded["params"], args.out,
            lambda1=loaded["lambda1"], lambda2=loaded["lambda2"],
            experiment=loaded["experiment"], pde=loaded["pde"], gamma=loaded["gamma"],
        )
        print(path)
        return 0
    if not (args.preset and args.checkpoint):
        raise SystemExit("export needs --params, or --preset with --checkpoint")
    # JAX's refusals, before anything is loaded
    if args.select and args.calibrate:
        raise SystemExit("--select exports a single member (no ensemble spread to "
                         "calibrate); use a plain ensemble export for calibrated bands")
    if args.select and len(args.checkpoint) < 2:
        raise SystemExit("--select needs >= 2 member checkpoints to rank")
    if args.calibrate and len(args.checkpoint) < 2:
        raise SystemExit("--calibrate needs an ensemble: pass every member checkpoint "
                         "(calibration is the conformal factor over member spread)")
    from pinns_tpu_torch.train.trainer import Trainer

    exp = _build_exp(args)
    trainer = Trainer(exp, device=args.device, dataset=args.data)
    if args.select:
        return _export_selected(args, trainer)
    states = [trainer.load_checkpoint(c) for c in args.checkpoint]
    if len(states) == 1:
        path = _export_member(trainer, states[0], args.out)
    else:
        path = _export_ensemble(args, trainer, states)
    print(path)
    return 0


def _coeffs(problem, params):
    """The effective Burgers coefficients of a member as floats."""
    lam1, lam2 = problem.effective_coeffs(params)
    return float(lam1.reshape(-1)[0]), float(lam2.reshape(-1)[0])


def _export_member(trainer, state, out: str) -> str:
    from pinns_tpu_torch.serve import export_predict

    problem, exp = trainer.problem, trainer.exp
    lam1, lam2 = _coeffs(problem, state.params)
    return export_predict(problem.spec, state.params["net"], out, lambda1=lam1, lambda2=lam2,
                          experiment=exp.name, pde=exp.pde.kind, gamma=exp.pde.gamma)


def _stacked(states):
    """The members' params as a stacked state (prediction, calibration and
    selection read nothing else)."""
    from pinns_tpu_torch.parallel.ensemble import stack_params

    return states[0]._replace(params=stack_params([s.params for s in states]))


def _export_ensemble(args, trainer, states) -> str:
    """An ensemble artifact of the member checkpoints; with --calibrate the
    band factors on the preset's grid, one printed row a field."""
    from pinns_tpu_torch.parallel.ensemble import uq_calibration
    from pinns_tpu_torch.serve import export_ensemble

    problem, exp = trainer.problem, trainer.exp
    cal = None
    if args.calibrate:
        cal = uq_calibration(trainer, _stacked(states), mond_feature=args.mond_feature)
        for field, row in cal.items():
            print(json.dumps({"field": field, **{
                k: ([round(float(x), 4) for x in v] if isinstance(v, list)
                    else v if isinstance(v, str) else round(float(v), 4))
                for k, v in row.items()}}), flush=True)
    coeffs = [_coeffs(problem, s.params) for s in states]
    return export_ensemble(problem.spec, [s.params["net"] for s in states], args.out,
                           [c[0] for c in coeffs], [c[1] for c in coeffs], experiment=exp.name,
                           pde=exp.pde.kind, gamma=exp.pde.gamma, calibration=cal)


def _export_selected(args, trainer) -> int:
    """``export --select``: score the member checkpoints without ground truth
    and export the pick as a point artifact, the scores and the pick in its
    meta (JAX's ``_export_selected``)."""
    import os

    from pinns_tpu_torch.parallel.ensemble import select_member, selection_scores

    states = [trainer.load_checkpoint(c) for c in args.checkpoint]
    stacked = _stacked(states)
    anchor_params = None
    if args.select in ("consensus", "rank"):
        anchor_params = (_stacked([trainer.load_checkpoint(c) for c in args.anchor]).params
                         if args.anchor else stacked.params)
    scores = selection_scores(trainer, stacked, len(states), seed=trainer.exp.train.seed + 777,
                              anchor_params=anchor_params)
    sel = select_member(scores, by=args.select)
    print(json.dumps({"selected": sel, "by": args.select, "scores": scores}), flush=True)
    path = _export_member(trainer, states[sel], args.out)
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["selection"] = {"by": args.select, "selected": sel,
                         "checkpoints": list(args.checkpoint),
                         "anchor": list(args.anchor) if args.anchor else None,
                         "scores": scores}
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    print(path)
    return 0


def cmd_eval(args) -> int:
    if args.artifact:
        return _eval_artifact(args)
    if not (args.checkpoint and args.preset):
        raise SystemExit("eval needs --artifact, or --preset with --checkpoint")
    from pinns_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_build_exp(args), device=args.device, dataset=args.data)
    state = trainer.load_checkpoint(args.checkpoint)
    print(json.dumps(trainer.evaluate(state)), flush=True)
    return 0


def _eval_artifact(args) -> int:
    """Grade a serving artifact against its dataset's exact grid: the rel-L2
    of each served field there (the preset defaults to the artifact's own
    experiment) and, for an ensemble, the coverage of its band: ``band_k_*``
    (the global factor), ``band_cov_*`` (|mean - exact| <= k std) and, for a
    Mondrian calibration, ``band_cov_mond_*`` (``ServedModel.band_ks``)."""
    from pinns_tpu_torch.serve import load_exported
    from pinns_tpu_torch.train.evaluate import relative_l2
    from pinns_tpu_torch.train.trainer import build_problem

    served = load_exported(args.artifact, device=args.device)
    if not args.preset:
        args.preset = served.meta.get("experiment")
        if not args.preset:
            raise SystemExit("the artifact names no experiment: pass --preset")
    exp = _build_exp(args)
    ds = build_problem(exp, args.device, args.data).dataset
    preds = served.predict(ds.X_star)
    out = {"artifact": args.artifact, "experiment": exp.name,
           "truth": getattr(ds, "provenance", "unknown")}
    for name in sorted(ds.star):
        if name not in preds:
            continue
        exact = np.asarray(ds.star[name])
        out[f"rel_l2_{name}"] = relative_l2(preds[name], exact)
        std = preds.get(f"{name}_std")
        if std is not None:
            k = served.band_k(name)
            err = np.abs(np.asarray(preds[name]) - exact)
            out[f"band_k_{name}"] = round(float(k), 4)
            out[f"band_cov_{name}"] = float(np.mean(err <= k * np.asarray(std)))
            if ((served.meta.get("calibration") or {}).get(name) or {}).get("mond_k"):
                kpt = served.band_ks(name, std, feature=preds.get(f"{name}_dx"))
                out[f"band_cov_mond_{name}"] = float(np.mean(err <= kpt * np.asarray(std)))
    print(json.dumps(out), flush=True)
    return 0


def cmd_polish(args) -> int:
    """JAX's ``polish`` (``pinns_tpu/cli.py:486-557``) on ``--device``."""
    from pinns_tpu_torch.config import override
    from pinns_tpu_torch.train import checkpoint as ckpt_io
    from pinns_tpu_torch.train.polish import polish
    from pinns_tpu_torch.train.trainer import Trainer

    exp = override(_build_exp(args), {"model.dtype": "float64"})
    trainer = Trainer(exp, device=args.device, dataset=args.data)
    state = trainer.load_checkpoint(args.checkpoint)
    state, res = polish(trainer.problem, state, max_iters=args.max_iters)
    print(f"f64 L-BFGS: {int(res.n_iters)} iters, loss {float(res.f):.3e}, "
          f"converged={bool(res.converged)}", flush=True)
    print(json.dumps(trainer.evaluate(state)), flush=True)
    out = args.out or (args.checkpoint + ".polished.ckpt")
    ckpt_io.save_checkpoint(out, state, meta={"polished": True})
    print(out)
    return 0


def cmd_serve(args) -> int:
    from pinns_tpu_torch.serve import make_http_server

    server = make_http_server(args.artifact, host=args.host, port=args.port,
                              device=args.device)
    host, port = server.server_address[:2]
    print(f"serving {args.artifact} on {args.device} at http://{host}:{port} "
          f"(GET /meta, POST /predict)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def _read_points(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return np.asarray(z["x"])
    with open(path) as f:
        first = f.readline()
    return np.loadtxt(
        path, delimiter="," if "," in first else None,
        skiprows=1 if any(c.isalpha() for c in first) else 0,
    )


def cmd_predict(args) -> int:
    from pinns_tpu_torch.serve import load_exported

    served = load_exported(args.artifact, device=args.device)
    x = np.atleast_2d(np.asarray(_read_points(args.points), np.float32))
    out = served.predict(x)
    if args.bands:
        if not served.meta.get("calibration"):  # the HTTP policy: no silent 2 std band
            raise SystemExit("artifact carries no calibration metadata; export with "
                             "--calibrate to emit bands")
        out = served.add_bands(out)
    if args.out.endswith(".npz"):
        np.savez(args.out, x=x, **{k: np.asarray(v, np.float32) for k, v in out.items()})
    else:
        names = sorted(out)
        cols = [x[:, 0], x[:, 1]] + [np.asarray(out[k], np.float32).ravel() for k in names]
        np.savetxt(args.out, np.column_stack(cols), delimiter=",",
                   header="x,t," + ",".join(names), comments="")
    print(args.out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pinns_tpu_torch",
                                 description="PyTorch port of pinns_tpu")
    sub = ap.add_subparsers(dest="command", required=True)

    def add_common(p, preset_required=True):
        p.add_argument("--preset", required=preset_required)
        p.add_argument("--set", action="append", metavar="KEY=VALUE",
                       help="override a config field, e.g. sampling.n_f=4000 (repeatable)")
        p.add_argument("--data", help="grid .mat/.npz in place of the preset's dataset")
        p.add_argument("--device", default="cuda")

    p = sub.add_parser("train", help="train a preset")
    add_common(p)
    p.add_argument("--epochs", type=int)
    p.add_argument("--chunk", type=int, help="epochs per chunk (metrics stay on the device)")
    p.add_argument("--out-dir", help="metrics JSONL and checkpoints go here")
    p.add_argument("--seed", type=int)
    p.add_argument("--resume", metavar="CKPT",
                   help="continue this checkpoint from its epoch to the schedule's end; "
                        "with --ensemble, the PREFIX of the <prefix>_m<i>.ckpt set")
    p.add_argument("--mesh-data", type=int, default=None, metavar="D",
                   help="train each model data-parallel over D ranks (launch one process a "
                        "card with python -m torch.distributed.run; default: "
                        "mesh.data_parallel)")
    p.add_argument("--ensemble", type=int, default=None, metavar="E",
                   help="train E members, seeds train.seed .. train.seed + E - 1 "
                        "(default: mesh.ensemble)")
    p.add_argument("--select", action="store_true",
                   help="after an --ensemble run, score the members without ground truth "
                        "(training-data misfit + fresh-batch residual) and print the pick")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("sweep", help="hyperparameter sweep over a cartesian grid")
    add_common(p)
    p.add_argument("--grid", action="append", required=True, metavar="KEY=V1,V2,...")
    p.add_argument("--epochs", type=int)
    p.add_argument("--retries", type=int, default=1)
    p.add_argument("--out", default=None, help="JSONL results path")
    p.add_argument("--serial", action="store_true",
                   help="run the units in turn (the only way on one card)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("export", help="write a serving artifact from a params file or a "
                                      "checkpoint")
    add_common(p, preset_required=False)
    p.add_argument("--params", help="params .npz (interop format)")
    p.add_argument("--checkpoint", nargs="+",
                   help="a checkpoint of the preset's training, or every member checkpoint "
                        "(train --ensemble writes <name>_final_m<i>.ckpt) for an ensemble")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--calibrate", action="store_true",
                   help="bake split-conformal and Mondrian band factors, measured on the "
                        "preset's grid, into the ensemble artifact's meta.json")
    p.add_argument("--mond-feature", choices=("std", "dx"), default="dx",
                   help="the Mondrian binning feature: the predicted |d(field)/dx| (default; "
                        "the artifact then serves {field}_dx) or the predicted std")
    p.add_argument("--select", choices=("score", "consensus", "rank"),
                   help="export the one member picked without ground truth: 'score' the "
                        "lowest data misfit + residual mean square, 'consensus' the nearest "
                        "to the anchor ensemble's mean, 'rank' the rank sum of both")
    p.add_argument("--anchor", nargs="+", default=None,
                   help="anchor ensemble checkpoints of --select consensus/rank (default: "
                        "the --checkpoint members)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("eval", help="evaluate a checkpoint, or grade a serving artifact")
    add_common(p, preset_required=False)
    p.add_argument("--checkpoint")
    p.add_argument("--artifact", help="artifact directory (from export); the preset "
                                      "defaults to its experiment")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("polish", help="float64 L-BFGS polish of a checkpoint (on the card "
                                      "unless --device cpu)")
    add_common(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--max-iters", type=int, default=20_000)
    p.add_argument("--out", default=None, help="default: <checkpoint>.polished.ckpt")
    p.set_defaults(fn=cmd_polish)

    p = sub.add_parser("serve", help="HTTP prediction server over an artifact")
    p.add_argument("--artifact", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("predict", help="batch inference from an artifact")
    p.add_argument("--artifact", required=True)
    p.add_argument("--points", required=True, help=".npz with key 'x', or a 2-column csv")
    p.add_argument("--out", required=True, help=".npz or .csv")
    p.add_argument("--bands", action="store_true",
                   help="add the calibrated half-width {field}_band of a calibrated ensemble")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_predict)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
