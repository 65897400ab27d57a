"""The port's serving slice as a whole: the JAX-trained fixture through
export -> ServedModel -> predict, the HTTP server and the CLI."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pinns_tpu_torch.interop import load_params_npz
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.serve import ServedModel, export_predict, load_exported, make_http_server
from pinns_tpu_torch.train.evaluate import relative_l2
from torch_port_util import FIXTURE, TOL, assert_close, numpy_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def thread_fp_state():
    """What each intra-op thread's floating-point control state does, one row
    a thread: at::parallel_for splits an elementwise op into
    torch.get_num_threads() equal shares, share k on OpenMP thread k (0 the
    calling thread), so each share's results show its thread's MXCSR:
    rounding up or down (1 + 2^-25 and -1 - 2^-25, ties that round to +-1
    to nearest), DAZ (a denormal input read as 0) and FTZ (a denormal result
    written as 0)."""
    t = torch.get_num_threads()
    n = t * (1 << 16)
    one, tie = torch.ones(n), torch.full((n,), 2.0 ** -25)
    up, down = one + tie, -one - tie
    daz = torch.full((n,), 1e-39) * 1.0
    ftz = torch.full((n,), 1e-20) * torch.full((n,), 1e-19)
    share = -(-n // t)
    return [{"thread": k, "round_up": bool((up[s] != 1).any()),
             "round_down": bool((down[s] != -1).any()), "daz": bool((daz[s] == 0).any()),
             "ftz": bool((ftz[s] == 0).any())}
            for k, s in ((k, slice(k * share, (k + 1) * share)) for k in range(t))]


def layer_departures(spec, params, x, rows=4096):
    """The plain recurrence's streams, layer by layer, on the padded batch
    ``x`` in float32 against float64: per layer the largest error (relative
    to each stream's max) of the ``rows`` rows (P1's rows: the first
    ``rows`` of them for an int, else a boolean mask, e.g. the CLI leg's
    failing block) and of the others, and the float32 streams of those
    rows; a layer whose P1 rows err far more than the rest is where P1's
    product departs."""
    from pinns_tpu_torch.models.mlp import embed_streams, normalize_inputs
    from pinns_tpu_torch.ops.taylor import _StreamPolicy, taylor2_layer

    out, saved = [], {}
    runs = {}
    head = (np.arange(len(x)) < rows) if np.isscalar(rows) else np.asarray(rows, bool)
    for dtype in (torch.float32, torch.float64):
        sp = spec if dtype == torch.float32 else dataclasses.replace(spec, dtype=dtype)
        net = [{k: v.to(dtype) for k, v in layer.items()} for layer in params]
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
        n = xt.shape[0]
        h = normalize_inputs(sp, xt)
        streams = embed_streams(sp, h, net[0])
        streams = (h, streams[1].expand(n, -1), streams[2].expand(n, -1), None)
        layers = []
        with torch.inference_mode():
            for i, layer in enumerate(net[:-1]):
                _, _, streams = taylor2_layer(_StreamPolicy(sp), streams, layer["W"],
                                              layer["b"], i == 0)
                layers.append([s.numpy().astype(np.float64) for s in streams])
        runs[dtype] = layers
    for i, (a, b) in enumerate(zip(runs[torch.float32], runs[torch.float64])):
        err = [np.abs(u - v).max(axis=1) / max(float(np.abs(v).max()), 1e-30)
               for u, v in zip(a, b)]
        part = lambda m: max((float(e[m].max()) for e in err if m.any()), default=0.0)  # noqa: E731
        out.append({"layer": i, "head_err": part(head), "rest_err": part(~head)})
        saved[f"layer{i}"] = np.stack([s[head] for s in a]).astype(np.float32)
    return out, saved


def report_bad_rows(name, got, want, bad, served=None, x=None):
    """Print, before a comparison fails, which rows failed it (ROADMAP P1: an
    order-dependent CPU mismatch seen in full xdist runs): their count, first
    and last index, whether they form one contiguous block, this process's
    intra-op threading and each intra-op thread's floating-point state
    (:func:`thread_fp_state`); and save both arrays and the mask to a
    temporary .npz, whose path it prints, so that an occurrence shows which
    side moved. With the ``served`` model and its padded batch ``x``, the
    plain recurrence is run again layer by layer (:func:`layer_departures`)
    and its layers' errors printed and its streams saved too. ``bad`` is
    the (N,) mask of failing rows of ``got`` against ``want``."""
    rows = np.flatnonzero(bad)
    if rows.size == 0:
        return
    fd, path = tempfile.mkstemp(prefix="p1_rows_", suffix=".npz")
    os.close(fd)
    layers, saved = ([], {}) if served is None else layer_departures(
        served.spec, served.params, x, rows=4096 if len(x) > 4096 else np.asarray(bad, bool))
    np.savez(path, got=np.asarray(got), want=np.asarray(want), bad=np.asarray(bad), **saved)
    print(f"P1 diagnostic, {name}: {rows.size} of {bad.size} rows differ, first {rows[0]}, "
          f"last {rows[-1]}, contiguous block {bool(rows[-1] - rows[0] + 1 == rows.size)}; "
          f"torch.get_num_threads() {torch.get_num_threads()}\n"
          f"{torch.__config__.parallel_info()}\nthreads' floating-point state "
          f"{thread_fp_state()}\nlayers (plain float32 against float64) {layers}\n"
          f"arrays saved to {path}")


@pytest.fixture(scope="module")
def fixture_npz():
    with np.load(FIXTURE, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    loaded = load_params_npz(FIXTURE)
    return export_predict(
        loaded["spec"], loaded["params"], str(tmp_path_factory.mktemp("art") / "m"),
        lambda1=loaded["lambda1"], lambda2=loaded["lambda2"],
        experiment=loaded["experiment"],
    )


def test_artifact_meta(artifact):
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    assert {"experiment", "fields", "input", "pde", "provenance"} <= set(meta)
    assert meta["experiment"] == "burgers_forward" and meta["pde"] == "burgers"
    assert meta["fields"] == ["f", "u"]
    assert meta["provenance"]["config"]["layers"] == [2] + [20] * 8 + [1]


def test_fixture_slice_matches_jax(artifact, fixture_npz):
    served = load_exported(artifact, device="cpu")
    before = k_taylor2.LAUNCHES
    out = served.predict(fixture_npz["X_star"], pad_to_bucket=True)
    for k in ("u", "f"):
        assert out[k].shape == (25_600, 1)
        want = fixture_npz[f"{k}_jax"]
        rtol, atol_rel = TOL[k]
        bad = np.abs(out[k] - want) > atol_rel * float(np.abs(want).max()) + rtol * np.abs(want)
        x = fixture_npz["X_star"]
        padded = np.concatenate([x, np.repeat(x[-1:], served.bucket_size(len(x)) - len(x), 0)])
        report_bad_rows(f"served {k} vs JAX", out[k], want, bad.any(axis=1), served, padded)
        assert_close(k, out[k], want)
    rel = relative_l2(out["u"], fixture_npz["u_star"])
    assert abs(rel - float(fixture_npz["rel_l2_jax"])) <= 1e-5
    assert k_taylor2.LAUNCHES == before  # CPU tensors take the plain path


def test_thread_fp_probe_sees_each_threads_state():
    """The P1 probe reads what every intra-op thread's floating-point state
    does: to nearest with denormals kept in this process, and flushing
    (FTZ and DAZ) on every thread under torch.set_flush_denormal."""
    rows = thread_fp_state()
    assert len(rows) == torch.get_num_threads()
    assert not any(r["round_up"] or r["round_down"] or r["daz"] or r["ftz"] for r in rows)
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush denormals")
    try:
        rows = thread_fp_state()
    finally:
        torch.set_flush_denormal(False)
    assert all(r["daz"] and r["ftz"] and not r["round_up"] for r in rows)


def test_layer_departures_on_the_served_batch(artifact, fixture_npz):
    """The P1 layer report on the served fixture: every layer's float32
    streams within 1e-4 of float64 (relative to each stream's max), the
    first rows no worse than 10x the rest (no departure in a healthy
    process)."""
    served = load_exported(artifact, device="cpu")
    x = fixture_npz["X_star"]
    padded = np.concatenate([x, np.repeat(x[-1:], served.bucket_size(len(x)) - len(x), 0)])
    layers, saved = layer_departures(served.spec, served.params, padded)
    assert len(layers) == len(served.spec.layers) - 2 == len(saved)
    for row in layers:
        assert row["rest_err"] < 1e-4 and row["head_err"] <= 10 * row["rest_err"] + 1e-7, row


def test_bucket_padding_is_exact(artifact):
    served = ServedModel(artifact, device="cpu")
    assert [served.bucket_size(n) for n in (1, 64, 65, 100, 128, 129)] == [
        64, 64, 128, 128, 128, 256]
    x = numpy_points(100, seed=31)
    padded = served.predict(x, pad_to_bucket=True)
    by_hand = served.predict(np.concatenate([x, np.repeat(x[-1:], 28, axis=0)]))
    plain = served.predict(x)
    for k in ("u", "f"):
        assert padded[k].shape == (100, 1)
        # the real rows of the 128-row bucket, bit for bit
        np.testing.assert_array_equal(padded[k], by_hand[k][:100])
        # and the unpadded batch up to the matmul's blocking by batch size
        np.testing.assert_allclose(padded[k], plain[k], rtol=1e-6, atol=1e-7)


def test_empty_and_malformed_batches_raise(artifact):
    served = ServedModel(artifact, device="cpu")
    with pytest.raises(ValueError, match="empty batch"):
        served.predict(np.zeros((0, 2), np.float32), pad_to_bucket=True)
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        served.predict(np.zeros((4, 3), np.float32))


def _http(url, body=None, ctype="application/json"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.fixture(scope="module")
def server(artifact):
    srv = make_http_server(artifact, port=0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield "http://127.0.0.1:%d" % srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_http_json_and_npy_roundtrips(server, artifact):
    served = ServedModel(artifact, device="cpu")
    code, _, body = _http(server + "/meta")
    assert code == 200 and json.loads(body) == served.meta

    x = numpy_points(8, seed=32)
    code, _, body = _http(server + "/predict", json.dumps({"x": x.tolist()}).encode())
    assert code == 200
    want = served.predict(x, pad_to_bucket=True)
    got = json.loads(body)
    for k in ("u", "f"):
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), want[k])

    x = numpy_points(3000, seed=33)
    buf = io.BytesIO()
    np.save(buf, x)
    code, ctype, body = _http(server + "/predict", buf.getvalue(), "application/x-npy")
    assert code == 200 and ctype == "application/x-npz"
    want = served.predict(x, pad_to_bucket=True)
    with np.load(io.BytesIO(body)) as z:
        for k in ("u", "f"):
            np.testing.assert_array_equal(z[k], want[k])


@pytest.mark.parametrize("path,body,ctype", [
    ("/predict", b"{not json", "application/json"),
    ("/predict", json.dumps({"x": [[0.1, 0.2, 0.3]]}).encode(), "application/json"),
    ("/predict", json.dumps({"x": [[0.1, 0.2]], "bands": True}).encode(), "application/json"),
    ("/predict?bands=1", None, "application/x-npy"),
], ids=["malformed", "bad-shape", "bands-json", "bands-npy"])
def test_http_bad_requests_get_400(server, path, body, ctype):
    if body is None:
        buf = io.BytesIO()
        np.save(buf, numpy_points(4, seed=34))
        body = buf.getvalue()
    code, ctype_out, out = _http(server + path, body, ctype)
    assert code == 400 and ctype_out == "application/json"
    assert "error" in json.loads(out)


# a fresh process's view of P1: the CLI's own imports and load, then each
# intra-op thread's floating-point state and its predict's rows (printed as
# JSON), as the CLI predict computes them
CLI_PROBE = """
import json, sys
import numpy as np
sys.path.insert(0, {tests!r})
from pinns_tpu_torch.serve import load_exported
from test_torch_serve import thread_fp_state
served = load_exported({art!r}, device="cpu")
with np.load({points!r}) as z:
    x = np.atleast_2d(np.asarray(z["x"], np.float32))
before = thread_fp_state()
out = served.predict(x)
np.savez({out!r}, **{{k: np.asarray(v, np.float32) for k, v in out.items()}})
print(json.dumps({{"before": before, "after": thread_fp_state()}}))
"""


def cli_p1_probe(art: str, points: str, want: dict, env: dict, tmp_path) -> None:
    """On a mismatch of the CLI's predict (ROADMAP P1), cover the process
    that moved: run the same CLI command a second time and a fresh process
    that loads the artifact as the CLI does and prints its threads'
    floating-point state before and after its predict (:func:`thread_fp_state`);
    print which of the reruns moved, on which rows, and save their outputs."""
    runs = {}
    again = str(tmp_path / "pred_again.npz")
    subprocess.run([sys.executable, "-m", "pinns_tpu_torch", "predict", "--artifact", art,
                    "--points", points, "--out", again, "--device", "cpu"],
                   check=True, env=env, cwd=REPO, timeout=120)
    probe_out = str(tmp_path / "pred_probe.npz")
    code = CLI_PROBE.format(tests=os.path.dirname(os.path.abspath(__file__)), art=art,
                            points=points, out=probe_out)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    for name, path in (("cli_again", again), ("probe", probe_out)):
        if os.path.exists(path):
            with np.load(path) as z:
                runs[name] = {k: z[k] for k in ("u", "f")}
    for name, got in runs.items():
        for k in ("u", "f"):
            bad = np.flatnonzero((got[k] != want[k]).any(axis=1))
            print(f"P1 diagnostic, {name} {k}: {bad.size} rows differ"
                  + (f", first {bad[0]}, last {bad[-1]}" if bad.size else ""))
    print(f"P1 diagnostic, fresh-process probe: rc {proc.returncode} "
          f"{proc.stdout.strip()[-2000:]} {proc.stderr.strip()[-1000:]}\n"
          f"reruns saved to {again} and {probe_out}")


def test_cli_export_and_predict(tmp_path, artifact, fixture_npz):
    env = {**os.environ, "PYTHONPATH": REPO}
    art = str(tmp_path / "cli_art")
    subprocess.run([sys.executable, "-m", "pinns_tpu_torch", "export", "--params", FIXTURE,
                    "--out", art], check=True, env=env, cwd=REPO, timeout=120)
    points = str(tmp_path / "pts.npz")
    x = fixture_npz["X_star"][::37]
    np.savez(points, x=x)
    out = str(tmp_path / "pred.npz")
    subprocess.run([sys.executable, "-m", "pinns_tpu_torch", "predict", "--artifact", art,
                    "--points", points, "--out", out, "--device", "cpu"],
                   check=True, env=env, cwd=REPO, timeout=120)
    served = ServedModel(artifact, device="cpu")
    want = served.predict(x)
    with np.load(out) as z:
        got = {k: z[k] for k in ("u", "f")}
        np.testing.assert_array_equal(z["x"], x)
    if any((got[k] != want[k]).any() for k in got):
        cli_p1_probe(art, points, want, env, tmp_path)
    for k in ("u", "f"):
        # the CLI leg's layers too: the plain recurrence on the CLI's batch
        report_bad_rows(f"CLI {k} vs in-process predict", got[k], want[k],
                        (got[k] != want[k]).any(axis=1), served=served, x=x)
        np.testing.assert_array_equal(got[k], want[k])
