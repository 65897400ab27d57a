"""The port's data generators (``pinns_tpu_torch.data.generators``) against
the JAX package's on the CPU, ``generate-data``, and K12's plain path and
scope (``ops.kernels.fv_solve``).

Tolerances:
- the float64 numpy oracles (Cole-Hopf, HLLC, WENO5, the ICs) are copies:
  within 1e-12 of max|JAX| (they agree to the last bit on this CPU);
- the float32 FV solvers follow JAX's arithmetic op by op but neither the
  float32 grid points (one formula here, XLA's there) nor XLA's CPU
  rounding: the same ``steps_per_snap`` and pre-steps, and
  max|port - JAX| within F64_FACTOR times the larger of the two float32
  errors against the port's float64 run of the same solve.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from pinns_tpu import cli as jcli
from pinns_tpu.data import generators as jgen
from pinns_tpu_torch import cli as tcli
from pinns_tpu_torch.data import generators as tgen
from pinns_tpu_torch.ops.kernels import fv_solve

ORACLE_RTOL = 1e-12
F64_FACTOR = 4.0
H100_SMEM = 232_448  # the opt-in shared memory of an H100 block


def assert_oracle(port: dict, jax: dict):
    assert sorted(port) == sorted(jax)
    for k in jax:
        want = np.asarray(jax[k], np.float64)
        got = np.asarray(port[k], np.float64)
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ORACLE_RTOL * float(np.abs(want).max()), err_msg=k)


def assert_f64_criterion(port, jax, port64, name=""):
    """max|port - JAX| <= F64_FACTOR x the larger float32 error against the
    port's float64 run."""
    port, jax, port64 = (np.asarray(a, np.float64) for a in (port, jax, port64))
    assert port.shape == jax.shape == port64.shape
    diff = float(np.abs(port - jax).max())
    err = max(float(np.abs(port - port64).max()), float(np.abs(jax - port64).max()))
    assert diff <= F64_FACTOR * err, f"{name}: |port - JAX| {diff} vs float32 error {err}"


def jax_burgers_steps(ic, nx, nt, t_final=1.0, nu=0.0, xlim=(-1.0, 1.0), cfl=0.4,
                      periodic=False, t_offset=0.0):
    """JAX's burgers_fv step count and pre-steps (pinns_tpu/data/generators.py:224-239),
    from JAX's own float32 grid and IC."""
    x = jnp.linspace(xlim[0], xlim[1], nx, dtype=jnp.float32)
    dx = float(x[1] - x[0])
    u0 = jnp.asarray(ic(np.asarray(x)), jnp.float32).reshape(-1)
    if periodic:
        u0 = u0[:-1]
    dt = cfl * dx / ((float(jnp.max(jnp.abs(u0))) + 1e-6) * 1.6)
    if nu > 0:
        dt = min(dt, 0.4 * dx * dx / (2 * nu))
    steps = max(1, int(np.ceil(t_final / (nt - 1) / dt)))
    dt = t_final / (nt - 1) / steps
    return steps, max(0, int(round(t_offset / dt)))


def jax_euler_steps(nx, t_final, n_snapshots, gamma=1.4, cfl=0.4):
    """JAX's euler_solve step count (pinns_tpu/data/generators.py:157-167)."""
    x = jnp.linspace(0.0, 1.0, nx + 1, dtype=jnp.float32)
    q0 = jgen.euler_ic_sod_lax_blend(0.5 * (x[:-1] + x[1:]), gamma=gamma)
    dt = cfl * (1.0 / nx) / (float(jnp.max(jgen._euler_max_speed(q0, gamma))) * 1.5)
    return max(1, int(np.ceil(t_final / (n_snapshots - 1) / dt)))


def test_cole_hopf_grid_matches_jax():
    assert_oracle(tgen.make_burgers_shock_grid(nx=64, nt=20),
                  jgen.make_burgers_shock_grid(nx=64, nt=20))
    x, t = np.linspace(-1, 1, 33), np.linspace(0, 0.5, 5)
    assert_oracle({"u": tgen.burgers_cole_hopf(x, t, nu=0.02, n_quad=64)},
                  {"u": jgen.burgers_cole_hopf(x, t, nu=0.02, n_quad=64)})


def test_hllc_oracle_matches_jax():
    """Includes the float32 rounding of the default IC, which JAX builds
    through jnp before widening it."""
    kw = dict(nx=160, t_final=0.05, n_snapshots=6)
    assert_oracle(tgen.euler_solve_hllc(**kw), jgen.euler_solve_hllc(**kw))


@pytest.mark.parametrize("periodic,nu", [(True, 1e-3), (False, 0.0)])
def test_weno_oracle_matches_jax(periodic, nu):
    kw = dict(nx=128, nt=5, t_final=0.05, nu=nu, periodic=periodic)
    assert_oracle(tgen.burgers_weno(tgen.two_sin_ic, **kw),
                  jgen.burgers_weno(jgen.two_sin_ic, **kw))


def test_ics_and_constants_match_jax():
    x = np.linspace(-1.0, np.pi, 301)
    for xs in (x, x.astype(np.float32)):
        np.testing.assert_array_equal(tgen.two_sin_ic(xs), jgen.two_sin_ic(xs))
        np.testing.assert_array_equal(tgen.abgrall_burgers_ic(xs), jgen.abgrall_burgers_ic(xs))
    for name in ("TWOSIN_NU", "TWOSIN_AMP", "TWOSIN_TAU", "ABGRALL_LAM1", "ABGRALL_NU",
                 "ABGRALL_TAU0", "ABGRALL_IC_A", "ABGRALL_IC_B", "EULER_T0", "EULER_DT"):
        assert getattr(tgen, name) == getattr(jgen, name), name
    # the float32 Sod-Lax blend bit for bit
    xc = np.linspace(0.0, 1.0, 1501)
    xc = (0.5 * (xc[:-1] + xc[1:])).astype(np.float32)
    np.testing.assert_array_equal(
        tgen.euler_ic_sod_lax_blend(torch.from_numpy(xc)).numpy(),
        np.asarray(jgen.euler_ic_sod_lax_blend(jnp.asarray(xc))))


BURGERS_CASES = {
    "periodic_viscous": dict(nx=257, nt=21, t_final=0.05, nu=1.9e-3, periodic=True),
    "outflow_inviscid": dict(nx=257, nt=21, t_final=0.3, nu=0.0, periodic=False),
    "t_offset": dict(nx=257, nt=21, t_final=0.2, nu=1.9e-3, periodic=True, t_offset=0.01),
}


@pytest.mark.parametrize("case", sorted(BURGERS_CASES))
def test_burgers_fv_matches_jax(case):
    kw = BURGERS_CASES[case]
    plan = tgen.burgers_plan(tgen.two_sin_ic, device="cpu", **kw)
    assert (plan.steps_per_snap, plan.offset_steps) == jax_burgers_steps(jgen.two_sin_ic, **kw)
    assert plan.offset_steps > 0 or "t_offset" not in kw
    before = fv_solve.BURGERS_LAUNCHES
    port = tgen.burgers_fv(tgen.two_sin_ic, device="cpu", **kw)
    assert fv_solve.BURGERS_LAUNCHES == before  # the CPU runs the plain version
    port64 = tgen.burgers_fv(tgen.two_sin_ic, device="cpu", dtype=torch.float64, **kw)
    jax = jgen.burgers_fv(jgen.two_sin_ic, **kw)
    assert port["usol"].dtype == np.float32 and port["usol"].shape == (kw["nx"], kw["nt"])
    np.testing.assert_array_equal(port["t"], jax["t"])
    np.testing.assert_allclose(port["x"], jax["x"], rtol=0, atol=2.4e-7)
    assert_f64_criterion(port["usol"], jax["usol"], port64["usol"], case)


def test_euler_solve_matches_jax():
    kw = dict(nx=300, t_final=0.1, n_snapshots=11)
    plan = tgen.euler_plan(device="cpu", **kw)
    assert plan.steps_per_snap == jax_euler_steps(**kw)
    port = tgen.euler_solve(device="cpu", **kw)
    port64 = tgen.euler_solve(device="cpu", dtype=torch.float64, **kw)
    jax = jgen.euler_solve(**kw)
    assert sorted(port) == sorted(jax)
    for k in ("rhosol", "usol", "Enersol"):
        assert port[k].shape == (300, 11)
        assert_f64_criterion(port[k], jax[k], port64[k], k)


# (kind, extra arguments): the native sizes, the Euler solve cut to 200 cells
GENERATE_KINDS = {
    "burgers_shock": [], "burgers_twosin": [], "twosin_dataset": [], "abgrall_dataset": [],
    "euler_dataset": [], "euler": ["--nx", "200", "--nt", "11", "--t-final", "0.1"],
}


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("kind", sorted(GENERATE_KINDS))
def test_generate_data_writes_every_kind(kind, tmp_path):
    """``generate-data --device cpu`` writes JAX's keys and shapes; the numpy
    kinds JAX's values, the FV kinds values within the FV solvers' float32
    spread (their float64 criterion is held above and in
    tests/test_torch_generator_grids.py)."""
    extra = GENERATE_KINDS[kind]
    port_path, jax_path = str(tmp_path / "port.mat"), str(tmp_path / "jax.mat")
    out = _run_cli(tcli.main, ["generate-data", "--kind", kind, "--out", port_path,
                               "--device", "cpu", *extra])
    assert out.strip() == port_path
    _run_cli(jcli.main, ["generate-data", "--kind", kind, "--out", jax_path, *extra])
    port, jax = scipy.io.loadmat(port_path), scipy.io.loadmat(jax_path)
    keys = sorted(k for k in jax if not k.startswith("__"))
    assert sorted(k for k in port if not k.startswith("__")) == keys
    numpy_kind = kind in ("burgers_shock", "euler_dataset")
    for k in keys:
        assert port[k].shape == jax[k].shape, k
        assert np.isfinite(port[k]).all(), k
        atol = (ORACLE_RTOL if numpy_kind else 1e-3) * float(np.abs(jax[k]).max())
        np.testing.assert_allclose(port[k], jax[k], rtol=0, atol=atol, err_msg=k)


def test_k12_scope_refusal_names_the_cpu_path():
    for euler in (False, True):
        n = fv_solve.max_cells(H100_SMEM, euler)
        assert fv_solve.smem_bytes(n, euler) <= H100_SMEM < fv_solve.smem_bytes(n + 1, euler)
        fv_solve.check_scope(n, euler, torch.float32, H100_SMEM)
        with pytest.raises(NotImplementedError, match="--device cpu") as e:
            fv_solve.check_scope(n + 1, euler, torch.float32, H100_SMEM)
        assert "cluster design" in str(e.value)
        with pytest.raises(NotImplementedError, match="--device cpu"):
            fv_solve.check_scope(16, euler, torch.float64, H100_SMEM)
    # the presets' solves fit: twosin's 2,048 cells, abgrall's 1,024, euler's 1,500
    assert fv_solve.max_cells(H100_SMEM, False) >= 2048
    assert fv_solve.max_cells(H100_SMEM, True) >= 1500


def test_k12_wrappers_on_cpu_run_the_plain_version():
    plan = tgen.burgers_plan(tgen.two_sin_ic, nx=65, nt=4, t_final=0.05, nu=1e-3,
                             periodic=True, t_offset=0.01, device="cpu")
    counts = (fv_solve.BURGERS_LAUNCHES, fv_solve.EULER_LAUNCHES)
    got = fv_solve.burgers_trajectory(plan.q0, plan.dx, plan.dt, plan.steps_per_snap, 4, 1e-3,
                                      True, plan.offset_steps)
    want = fv_solve.burgers_trajectory_reference(plan.q0, plan.dx, plan.dt,
                                                 plan.steps_per_snap, 4, 1e-3, True,
                                                 plan.offset_steps)
    assert plan.offset_steps == 2 and got.shape == (4, 64) and torch.equal(got, want)
    assert not torch.equal(got[0], plan.q0)  # the pre-steps ran
    eplan = tgen.euler_plan(nx=40, t_final=0.01, n_snapshots=3, device="cpu")
    got = fv_solve.euler_trajectory(eplan.q0, eplan.dx, eplan.dt, eplan.steps_per_snap, 3)
    assert got.shape == (3, 40, 3) and torch.equal(got[0], eplan.q0)
    assert (fv_solve.BURGERS_LAUNCHES, fv_solve.EULER_LAUNCHES) == counts
    with pytest.raises(ValueError, match="state"):
        fv_solve.burgers_trajectory(eplan.q0, 0.1, 0.01, 1, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        fv_solve.burgers_trajectory(torch.zeros(8, device="meta"), 0.1, 0.01, 1, 2)

