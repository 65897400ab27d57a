"""The port's serving slice as a whole: the JAX-trained fixture through
export -> ServedModel -> predict, the HTTP server and the CLI."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from pinns_tpu_torch.interop import load_params_npz
from pinns_tpu_torch.ops.kernels import taylor2 as k_taylor2
from pinns_tpu_torch.serve import ServedModel, export_predict, load_exported, make_http_server
from pinns_tpu_torch.train.evaluate import relative_l2
from torch_port_util import FIXTURE, assert_close, numpy_points

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        assert_close(k, out[k], fixture_npz[f"{k}_jax"])
    rel = relative_l2(out["u"], fixture_npz["u_star"])
    assert abs(rel - float(fixture_npz["rel_l2_jax"])) <= 1e-5
    assert k_taylor2.LAUNCHES == before  # CPU tensors take the plain path


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
    want = ServedModel(artifact, device="cpu").predict(x)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["x"], x)
        for k in ("u", "f"):
            np.testing.assert_array_equal(z[k], want[k])
