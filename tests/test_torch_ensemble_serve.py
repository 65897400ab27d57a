"""Port parity for serving an ensemble: the numpy cores of the calibration,
the ensemble prediction, the calibration on a grid, the ensemble artifact and
its served bands (ServedModel, HTTP, ``predict --bands``, ``eval
--artifact``) and ``export --select``, each against the JAX package live on
the CPU, on the same numpy inputs.

Sizes: Burgers 8x20 (abgrall_admm on the committed TwoSin grid) and the
euler_weak_fast trunk cut to 2x16 with its two shock paths, three members
each: a base net and two perturbed copies (members that agree to a few
percent, as trained ones do), each Burgers member with its own coefficients.

Tolerances (float32, members summed in another order): mean and dx rtol 1e-5
/ atol 1e-5 max|JAX| (1e-4 max|f| for the residuals f, f1..f3); the std, a
difference, at atol 1e-5 (1e-4 for residuals) max|mean| of its field. The
calibration rows from the port's predictions: k_conf95, k95 and mond_k rtol
1e-3 (``method='higher'`` picks one score, and may pick a neighbour),
coverages within 2/n, mond_edges rtol 1e-4, and the Mondrian bin of every
point equal except within that tolerance of an edge (under 0.1% of the
points). On identical numpy inputs calibration_stats and mond_band_factors
equal JAX's exactly.
"""

import io
import json
import os
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinns_tpu import cli as jcli
from pinns_tpu import serve as jserve
from pinns_tpu.config import override as joverride
from pinns_tpu.data import datasets as jds
from pinns_tpu.data.sampling import uniform_box as juniform_box
from pinns_tpu.experiments.presets import PRESETS as JPRESETS
from pinns_tpu.models.mlp import MLPSpec as JSpec
from pinns_tpu.parallel import ensemble as jens
from pinns_tpu.train import trainer as jtrainer
from pinns_tpu_torch import cli
from pinns_tpu_torch.config import override
from pinns_tpu_torch.experiments import get_preset
from pinns_tpu_torch.interop import params_from_jax
from pinns_tpu_torch.parallel import ensemble as tens
from pinns_tpu_torch.serve import ServedModel, export_ensemble, make_http_server
from pinns_tpu_torch.train import trainer as ttrainer
from torch_port_util import NARROW, numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(REPO, "tests", "fixtures", "torch_port", "twosin_burgers_shock.npz")
COMMITTED = os.path.join(REPO, "benchmarks", "results", "r4_artifacts", "euler_ens8_dx",
                         "meta.json")
CPU = torch.device("cpu")
E = 3
UPDATES = {
    "abgrall_admm": {"model.layers": NARROW, "sampling.n_f": 64, "data.n_u": 16},
    "euler_weak_fast": {"model.layers": (2, 16, 16, 3), "sampling.n_f": 32, "data.n_u": 64},
}
RESIDUALS = ("f", "f1", "f2", "f3")


def _atol_rel(name):
    return 1e-4 if name in RESIDUALS else 1e-5


# -- the members, both packages ----------------------------------------------------

def _jax_trainer(preset):
    exp = joverride(JPRESETS[preset], UPDATES[preset])
    if preset != "abgrall_admm":
        return jtrainer.Trainer(exp, problem=jtrainer.build_problem(exp))
    with np.load(GRID) as z:
        ds = jds.GridDataset(x=z["x"], t=z["t"], fields={"u": z["usol"].T},
                             provenance=str(z["provenance"]))
    x_data, targets = jds.build_ic_bc_training_set(ds, exp.data.n_u, seed=exp.data.seed)
    spec = JSpec(layers=exp.model.layers, lb=tuple(float(v) for v in ds.lb),
                 ub=tuple(float(v) for v in ds.ub))
    problem = jtrainer.Problem(exp=exp, dataset=ds, spec=spec, x_data=jnp.asarray(x_data),
                               targets={k: jnp.asarray(v) for k, v in targets.items()})
    return jtrainer.Trainer(exp, problem=problem)


def _port_trainer(preset):
    exp = override(get_preset(preset), UPDATES[preset])
    return ttrainer.Trainer(exp, device="cpu", dataset=GRID if preset == "abgrall_admm" else None)


def _members(preset, spec):
    """E JAX-layout member trees {'net', 'coeffs'}: a base net and perturbed
    copies; path nets carry moved paths; Burgers members own coefficients."""
    rng = np.random.default_rng(11)
    exp = get_preset(preset)
    base = numpy_params(spec.widths, seed=5)
    if spec.n_paths:
        c = (0.3 * rng.standard_normal((spec.n_paths, spec.path_degree + 1))).astype(np.float32)
        c[:, 0] = np.linspace(-0.5, 0.5, spec.n_paths)
        base[0]["path_c"] = c
        base[0]["path_a"] = np.full(spec.n_paths, spec.path_sharpness, np.float32)
    out = []
    for i in range(E):
        net = [{k: (v * (1.0 + 0.03 * i * rng.standard_normal(v.shape))).astype(np.float32)
                for k, v in layer.items()} for layer in base]
        lam1 = exp.pde.lambda1 + 0.1 * i if exp.pde.kind == "burgers" else exp.pde.lambda1
        lam2 = exp.pde.lambda2 + 0.002 * i if exp.pde.kind == "burgers" else exp.pde.lambda2
        out.append({"net": net, "coeffs": {"lambda1": np.full((1,), lam1, np.float32),
                                           "lambda2": np.full((1,), lam2, np.float32)}})
    return out


def _jax_stacked(members):
    tree = jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs)), *members)
    return types.SimpleNamespace(params=tree)


def _port_stacked(members):
    trees = [{"net": params_from_jax(m["net"], CPU),
              "coeffs": {k: torch.from_numpy(v) for k, v in m["coeffs"].items()}}
             for m in members]
    return types.SimpleNamespace(params=tens.stack_params(trees))


_CACHE = {}


def _ensemble(preset):
    """Both packages' trainers and the members of ``preset``, built once."""
    if preset not in _CACHE:
        jtr, ttr = _jax_trainer(preset), _port_trainer(preset)
        members = _members(preset, ttr.problem.spec)
        _CACHE[preset] = types.SimpleNamespace(
            preset=preset, jtr=jtr, ttr=ttr, members=members, jst=_jax_stacked(members),
            tst=_port_stacked(members))
    return _CACHE[preset]


PRESETS = ("abgrall_admm", "euler_weak_fast")


def _points(ttr, n, seed):
    rng = np.random.default_rng(seed)
    p = ttr.problem
    return np.stack([rng.uniform(p.lb[i], p.ub[i], n) for i in range(2)], 1).astype(np.float32)


def _close(name, got, want, scale=None, what=""):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-5,
                               atol=_atol_rel(name) * float(scale), err_msg=f"{name} {what}")


# -- the numpy cores, exactly ----------------------------------------------------

def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    exact = rng.standard_normal((n, 1))
    mean = exact + 0.05 * rng.standard_normal((n, 1))
    std = np.abs(0.02 * rng.standard_normal((n, 1))) + 1e-4
    return exact, mean, std, np.abs(rng.standard_normal((n, 1))), np.abs(rng.standard_normal(n))


CORE_CASES = {
    "grad_mag": dict(n=5000, grad=True),
    "no_grad_mag": dict(n=5000, grad=False),
    "bin_feature_dx": dict(n=5000, grad=True, dx=True),
    "tiny_n": dict(n=37, grad=True),
    "one_bin": dict(n=3000, grad=True, n_bins=1),
}


@pytest.mark.parametrize("case", sorted(CORE_CASES) + ["factors_std", "factors_dx",
                                                       "factors_dx_without_feature",
                                                       "factors_no_bins"])
def test_numpy_cores_equal_jax(case):
    """calibration_stats and mond_band_factors on identical numpy inputs give
    JAX's rows and factors exactly (points placed on the bin edges too)."""
    if case in CORE_CASES:
        c = CORE_CASES[case]
        exact, mean, std, gm, dx = _arrays(c["n"], seed=len(case))
        kw = dict(grad_mag=gm if c["grad"] else None, n_bins=c.get("n_bins", 4), seed=3)
        if c.get("dx"):
            kw.update(bin_feature=dx, feature_name="dx")
        assert tens.calibration_stats(exact, mean, std, **kw) == \
            jens.calibration_stats(exact, mean, std, **kw)
        return
    exact, mean, std, gm, dx = _arrays(4000, seed=9)
    dx_row = case != "factors_std"
    row = jens.calibration_stats(exact, mean, std, grad_mag=gm, bin_feature=dx if dx_row
                                 else None, feature_name="dx" if dx_row else "std")
    if case == "factors_no_bins":
        row = {k: v for k, v in row.items() if k not in ("mond_edges", "mond_k")}
    feat = None if case == "factors_dx_without_feature" else dx.reshape(-1, 1).copy()
    probe = std.copy()
    if "mond_edges" in row:  # points exactly on the edges: side='right'
        (feat if dx_row and feat is not None else probe)[:3, 0] = row["mond_edges"]
    got = tens.mond_band_factors(row, probe, feature=feat)
    want = jens.mond_band_factors(row, probe, feature=feat)
    np.testing.assert_array_equal(got, want)
    assert got.shape == probe.shape


# -- the ensemble prediction and the calibration ------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("want_dx", [False, True], ids=["plain", "dx"])
def test_ensemble_predict_matches_jax(preset, want_dx):
    """mean, std, members and dx per field against JAX's ensemble_predict."""
    ensemble = _ensemble(preset)
    x = _points(ensemble.ttr, 700, seed=21)
    want = jens.ensemble_predict(ensemble.jtr, ensemble.jst, x, want_dx=want_dx)
    got = tens.ensemble_predict(ensemble.ttr, ensemble.tst, x, want_dx=want_dx)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert sorted(g) == sorted(w), name
        assert g["members"].shape == (E, 700, 1) and g["mean"].shape == (700, 1)
        scale = np.abs(w["mean"]).max()
        _close(name, g["mean"], w["mean"], what="mean")
        _close(name, g["std"], w["std"], scale=scale, what="std")
        _close(name, g["members"], w["members"], what="members")
        if "dx" in w:
            _close(name, g["dx"], w["dx"], what="dx")


def _assert_rows_close(got, want, n, feature_port, feature_jax):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k == "mond_feature":
            assert g == w
        elif k.startswith("cov"):
            assert abs(g - w) <= 2.0 / n, (k, g, w)
        elif k == "mond_edges":
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
        elif k in ("k_conf95", "k95", "mond_k"):
            np.testing.assert_allclose(g, w, rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
    edges = np.asarray(want["mond_edges"])
    fp, fj = np.ravel(feature_port), np.ravel(feature_jax)
    moved = np.searchsorted(edges, fp, side="right") != np.searchsorted(edges, fj, side="right")
    near = np.min(np.abs(fj[:, None] - edges[None, :]), axis=1) <= 1e-4 * np.abs(edges).max() \
        + 1e-5 * np.abs(fj).max()
    assert not np.any(moved & ~near), "a point far from every edge changed its bin"
    assert moved.sum() <= 1e-3 * fj.size, f"{moved.sum()} of {fj.size} points changed bin"


@pytest.mark.parametrize("mond_feature", ["std", "dx"])
def test_uq_calibration_matches_jax(mond_feature):
    """uq_calibration on the TwoSin grid against JAX's (Burgers 8x20)."""
    ensemble = _ensemble("abgrall_admm")
    want = jens.uq_calibration(ensemble.jtr, ensemble.jst, mond_feature=mond_feature)
    got = tens.uq_calibration(ensemble.ttr, ensemble.tst, mond_feature=mond_feature)
    assert sorted(got) == sorted(want) == ["u"]
    n = ensemble.ttr.problem.dataset.n_points
    key = "dx" if mond_feature == "dx" else "std"
    x = ensemble.ttr.problem.dataset.X_star
    fp = tens.ensemble_predict(ensemble.ttr, ensemble.tst, x, want_dx=True)["u"][key]
    fj = jens.ensemble_predict(ensemble.jtr, ensemble.jst, x, want_dx=True)["u"][key]
    _assert_rows_close(got["u"], want["u"], n, fp, fj)


# -- the artifact, its bands, HTTP and the CLI ---------------------------------------

def _committed_calibration():
    with open(COMMITTED) as f:
        return json.load(f)["calibration"]


_ARTIFACTS = {}


def _artifacts(preset, tmp_path_factory):
    """(JAX artifact, port artifact) of the preset's members, built once:
    Burgers calibrated by JAX's uq_calibration binned on std, Euler with the
    committed euler_ens8_dx calibration (dx rows: the {name}_dx outputs)."""
    if preset not in _ARTIFACTS:
        ens = _ensemble(preset)
        cal = (jens.uq_calibration(ens.jtr, ens.jst, mond_feature="std")
               if preset == "abgrall_admm" else _committed_calibration())
        root = tmp_path_factory.mktemp(preset)
        jart = jserve.export_ensemble(ens.jtr, ens.jst.params, str(root / "jax"), calibration=cal)
        exp = ens.ttr.exp
        tart = export_ensemble(
            ens.ttr.problem.spec, [m["net"] for m in ens.members], str(root / "port"),
            [float(m["coeffs"]["lambda1"][0]) for m in ens.members],
            [float(m["coeffs"]["lambda2"][0]) for m in ens.members], experiment=exp.name,
            pde=exp.pde.kind, gamma=exp.pde.gamma, calibration=cal)
        _ARTIFACTS[preset] = (jart, tart)
    return _ARTIFACTS[preset]


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _close_outputs(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        name = k.rsplit("_", 1)[0] if k.endswith(("_std", "_dx", "_band")) else k
        scale = np.abs(want[name]).max() if k.endswith(("_std", "_band")) else None
        _close(name, got[k], w, scale=scale, what=k)


@pytest.mark.parametrize("preset", PRESETS)
def test_ensemble_artifact_matches_jax(preset, tmp_path_factory):
    """export_ensemble -> ServedModel(device='cpu').predict against JAX's
    exported function at ragged points, padded to a bucket or not; meta.json with JAX's keys, fields,
    member count and calibration block."""
    jart, tart = _artifacts(preset, tmp_path_factory)
    jm, tm = _meta(jart), _meta(tart)
    assert sorted(tm) == sorted(jm)
    for key in ("fields", "ensemble_members", "experiment", "pde", "calibration", "input"):
        assert tm[key] == jm[key], key
    x = _points(_ensemble(preset).ttr, 517, seed=23)
    want = jserve.ServedModel(jart).predict(x)
    served = ServedModel(tart, device="cpu")
    _close_outputs(served.predict(x), want)
    _close_outputs(served.predict(x, pad_to_bucket=True), want)


@pytest.mark.parametrize("name", ["rho", "u", "E"])
@pytest.mark.parametrize("feature", [True, False], ids=["dx", "no-feature"])
def test_band_ks_on_the_committed_calibration(name, feature, tmp_path_factory):
    """band_k and band_ks on euler_ens8_dx's calibration against JAX's
    ServedModel, on seeded std and dx with points on the bin edges."""
    jart, tart = _artifacts("euler_weak_fast", tmp_path_factory)
    served, jserved = ServedModel(tart, device="cpu"), jserve.ServedModel(jart)
    rng = np.random.default_rng(41)
    std = np.abs(rng.standard_normal((2000, 1))).astype(np.float32)
    dx = np.abs(3.0 * rng.standard_normal((2000, 1))).astype(np.float32)
    edges = served.meta["calibration"][name]["mond_edges"]
    dx[:len(edges), 0] = edges
    kw = {"feature": dx} if feature else {}
    assert served.band_k(name) == jserved.band_k(name)
    np.testing.assert_array_equal(served.band_ks(name, std, **kw), jserved.band_ks(name, std, **kw))


def _http(url, body=None, ctype="application/json"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("encoding", ["json", "npy", "uncalibrated"])
def test_http_bands(encoding, tmp_path_factory, tmp_path):
    """Bands over HTTP: {name}_band per calibrated field, by JSON and by npy,
    equal to ServedModel.add_bands of the served predict; an ensemble
    without calibration answers a 400."""
    _, tart = _artifacts("abgrall_admm", tmp_path_factory)
    if encoding == "uncalibrated":
        ens = _ensemble("abgrall_admm")
        tart = export_ensemble(ens.ttr.problem.spec, [m["net"] for m in ens.members],
                               str(tmp_path / "raw"), [1.0] * E, [0.0] * E,
                               experiment="abgrall_admm")
    srv = make_http_server(tart, port=0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = "http://127.0.0.1:%d" % srv.server_address[1]
        x = _points(_ensemble("abgrall_admm").ttr, 40, seed=43)
        if encoding == "npy":
            buf = io.BytesIO()
            np.save(buf, x)
            code, ctype, body = _http(base + "/predict?bands=1", buf.getvalue(),
                                      "application/x-npy")
        else:
            code, ctype, body = _http(base + "/predict",
                                      json.dumps({"x": x.tolist(), "bands": True}).encode())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    if encoding == "uncalibrated":
        assert code == 400 and "calibration" in json.loads(body)["error"]
        return
    served = ServedModel(tart, device="cpu")
    want = served.add_bands(served.predict(x, pad_to_bucket=True))
    assert "u_band" in want and "f_band" not in want
    if encoding == "npy":
        assert code == 200 and ctype == "application/x-npz"
        with np.load(io.BytesIO(body)) as z:
            got = {k: z[k] for k in z.files}
    else:
        assert code == 200
        got = {k: np.asarray(v, np.float32) for k, v in json.loads(body).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)


def _sets(preset):
    return [a for k, v in UPDATES[preset].items() for a in ("--set", f"{k}={v}")]


def _json_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_predict_bands_and_eval_artifact_match_jax(preset, tmp_path_factory, tmp_path,
                                                       capsys):
    """predict --bands and eval --artifact of the port's artifact against the
    JAX CLI on JAX's: the same keys, the values within the tolerances; bands
    on an artifact without calibration refused by both."""
    jart, tart = _artifacts(preset, tmp_path_factory)
    pts = str(tmp_path / "pts.npz")
    np.savez(pts, x=_points(_ensemble(preset).ttr, 300, seed=47))
    jout, tout = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jcli.main(["predict", "--artifact", jart, "--points", pts, "--out", jout,
                      "--bands"]) == 0
    assert cli.main(["predict", "--artifact", tart, "--points", pts, "--out", tout,
                     "--bands", "--device", "cpu"]) == 0
    with np.load(jout) as j, np.load(tout) as t:
        np.testing.assert_array_equal(t["x"], j["x"])
        _close_outputs({k: t[k] for k in t.files if k != "x"},
                       {k: j[k] for k in j.files if k != "x"})
    capsys.readouterr()
    assert jcli.main(["eval", "--artifact", jart, "--preset", preset, *_sets(preset)]) == 0
    want = _json_lines(capsys)[-1]
    assert cli.main(["eval", "--artifact", tart, *_sets(preset), "--device", "cpu"]) == 0
    got = _json_lines(capsys)[-1]
    assert sorted(got) == sorted(want)
    assert any(k.startswith("band_cov_mond_") for k in got)
    n = _ensemble(preset).ttr.problem.dataset.n_points
    for k, w in want.items():
        if k.startswith("rel_l2_"):
            assert got[k] == pytest.approx(w, rel=1e-5), k
        elif k.startswith("band_cov"):
            assert abs(got[k] - w) <= 2.0 / n, k
        elif k != "artifact":
            assert got[k] == w, k
    point = str(tmp_path / "point")
    ens = _ensemble(preset)
    from pinns_tpu_torch.serve import export_predict

    export_predict(ens.ttr.problem.spec, ens.members[0]["net"], point, 1.0, 0.0,
                   experiment=ens.ttr.exp.name, pde=ens.ttr.exp.pde.kind)
    with pytest.raises(SystemExit, match="calibration"):
        cli.main(["predict", "--artifact", point, "--points", pts, "--out", tout, "--bands",
                  "--device", "cpu"])


def test_export_select_matches_jax(tmp_path, capsys):
    """export --select rank over member checkpoints: the printed scores and
    pick, and meta['selection'] with JAX's keys; the scores at JAX's own
    points (seed train.seed + 777) against JAX's selection_scores, and the
    picks of score, consensus and rank equal."""
    from pinns_tpu_torch.train import checkpoint as ckpt_io

    ens = _ensemble("abgrall_admm")
    ttr, seed = ens.ttr, ens.ttr.exp.train.seed + 777
    ckpts = []
    for i, tree in enumerate(tens.member_params(ens.tst.params, i) for i in range(E)):
        path = str(tmp_path / f"m{i}.ckpt")
        ckpt_io.save_checkpoint(path, ttr.init_state(seed=1234 + i)._replace(params=tree))
        ckpts.append(path)
    out = str(tmp_path / "sel")
    assert cli.main(["export", "--preset", "abgrall_admm", *_sets("abgrall_admm"), "--data",
                     GRID, "--checkpoint", *ckpts, "--select", "rank", "--out", out,
                     "--device", "cpu"]) == 0
    printed = _json_lines(capsys)[-1]
    assert printed["by"] == "rank"
    assert printed["selected"] == tens.select_member(printed["scores"], "rank")
    meta = _meta(out)
    assert sorted(meta["selection"]) == ["anchor", "by", "checkpoints", "scores", "selected"]
    assert meta["selection"]["selected"] == printed["selected"]
    assert meta["selection"]["checkpoints"] == ckpts and meta["selection"]["anchor"] is None
    assert ServedModel(out, device="cpu").members is None  # a point artifact

    want = jens.selection_scores(ens.jtr, ens.jst, E, seed=seed, anchor_params=ens.jst.params)
    spec = ens.jtr.problem.spec
    pts = np.array(juniform_box(jax.random.PRNGKey(seed), 4096,
                                jnp.asarray(ens.jtr.problem.lb, spec.dtype),
                                jnp.asarray(ens.jtr.problem.ub, spec.dtype), spec.dtype))
    got = tens.scores_at(ttr, ens.tst, torch.from_numpy(pts), anchor_params=ens.tst.params)
    for t, j in zip(got, want, strict=True):
        for key in ("data_term", "resid_ms", "score", "consensus"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-5, err_msg=key)
    for by in ("score", "consensus", "rank"):
        assert tens.select_member(got, by) == jens.select_member(want, by)
