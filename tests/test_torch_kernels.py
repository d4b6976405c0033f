"""The port's fused U-pass kernels on the CPU: the wrappers take their plain
PyTorch versions for CPU tensors, held against the JAX Pallas kernels run
in interpret mode (pycmf_tpu/ops/pallas/mu_fused.py, newton_fused.py), with
the same NumPy inputs. The CUDA kernels themselves run only on a card; they
are checked against these plain versions by chip_smoke.py.

Tolerances:
- float64: rtol 1e-10, the reference's own bar for its kernels against
  their unfused math (tests/test_pallas.py).
- bf16 X with f32 factors: both round V and U_new to bf16 at the same
  points and accumulate in f32, in different orders: rtol 1e-5 on U_new,
  1e-4 on numV (a sum over n rows of bf16-rounded U_new).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycmf_tpu.ops.pallas.mu_fused import fused_mu_u_pass as j_mu
from pycmf_tpu.ops.pallas.newton_fused import \
    fused_newton_linear_u_pass as j_newton
from pycmf_tpu_torch.ops.kernels import _build, mu_fused, newton_fused, policy


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _operands(rng, n, m, k, pert=0.21, l2=0.01):
    X = np.abs(rng.randn(n, m))
    U = np.abs(rng.randn(n, k))
    V = np.abs(rng.randn(m, k))
    BtB = V.T @ V
    Hinv = np.linalg.inv(BtB + (l2 + pert) * np.eye(k))
    return X, U, V, BtB, Hinv


@pytest.mark.parametrize("n,n_valid", [(60, None), (61, None), (61, 50)])
def test_mu_pass_f64_matches_pallas(rng, n, n_valid):
    """61 rows with row_tile=16: the Pallas grid's edge tile is ragged."""
    X, U, V, VtV, _ = _operands(rng, n, 40, 4)
    l1, l2, eps = 0.2, 0.5, 1e-10
    want = j_mu(jnp.asarray(X), jnp.asarray(U), jnp.asarray(V),
                jnp.asarray(VtV), l1, l2, eps, row_tile=16, n_valid=n_valid)
    got = mu_fused.fused_mu_u_pass(_t(X), _t(U), _t(V), _t(VtV), l1, l2, eps,
                                   n_valid=n_valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [60, 61])
def test_mu_pass_bf16_matches_pallas(rng, n):
    X, U, V, _, _ = _operands(rng, n, 40, 4)
    VtV = (V.astype(np.float32).T @ V.astype(np.float32))
    args = (0.01, 0.02, 1e-10)
    want = j_mu(jnp.asarray(X, jnp.bfloat16), jnp.asarray(U, jnp.float32),
                jnp.asarray(V, jnp.float32), jnp.asarray(VtV), *args,
                row_tile=16)
    got = mu_fused.fused_mu_u_pass(
        _t(X, torch.bfloat16), _t(U, torch.float32), _t(V, torch.float32),
        _t(VtV, torch.float32), *args)
    assert all(g.dtype == torch.float32 for g in got)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4)
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-5)


@pytest.mark.parametrize("n", [60, 61])
@pytest.mark.parametrize("trials,non_negative", [(8, True), (1, True),
                                                 (0, True), (3, False)])
def test_newton_pass_f64_matches_pallas(rng, n, trials, non_negative):
    X, U, V, BtB, Hinv = _operands(rng, n, 40, 4)
    row_sq = (X ** 2).sum(axis=1)
    l1, l2 = 0.0, 0.01
    want = j_newton(jnp.asarray(X), jnp.asarray(U), jnp.asarray(V),
                    jnp.asarray(BtB), jnp.asarray(Hinv), jnp.asarray(row_sq),
                    l1, l2, trials=trials, non_negative=non_negative,
                    row_tile=16)
    got = newton_fused.fused_newton_linear_u_pass(
        _t(X), _t(U), _t(V), _t(BtB), _t(Hinv), _t(row_sq), l1, l2,
        trials=trials, non_negative=non_negative)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [60, 61])
def test_newton_pass_bf16_matches_pallas(rng, n):
    X, U, V, _, _ = _operands(rng, n, 40, 4)
    V32 = V.astype(np.float32)
    BtB = V32.T @ V32
    Hinv = np.linalg.inv(BtB + 0.21 * np.eye(4)).astype(np.float32)
    row_sq = (X.astype(np.float32) ** 2).sum(axis=1)
    l1, l2 = 0.001, 0.01
    want = j_newton(jnp.asarray(X, jnp.bfloat16), jnp.asarray(U, jnp.float32),
                    jnp.asarray(V32), jnp.asarray(BtB), jnp.asarray(Hinv),
                    jnp.asarray(row_sq), l1, l2, trials=8, non_negative=True,
                    row_tile=16)
    got = newton_fused.fused_newton_linear_u_pass(
        _t(X, torch.bfloat16), _t(U, torch.float32), _t(V32, torch.float32),
        _t(BtB, torch.float32), _t(Hinv, torch.float32),
        _t(row_sq, torch.float32), l1, l2, trials=8, non_negative=True)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4)


def test_cpu_wrappers_take_plain_versions_without_launching(rng):
    """CPU tensors: the wrapper returns the plain version's result exactly,
    and no kernel launch is counted."""
    X, U, V, BtB, Hinv = _operands(rng, 61, 40, 4)
    rs = _t((X ** 2).sum(axis=1))
    policy.reset_launch_counts()
    a = mu_fused.fused_mu_u_pass(_t(X), _t(U), _t(V), _t(BtB), 0.1, 0.2,
                                 1e-10)
    b = mu_fused.fused_mu_u_pass_ref(_t(X), _t(U), _t(V), _t(BtB), 0.1, 0.2,
                                     1e-10)
    c = newton_fused.fused_newton_linear_u_pass(
        _t(X), _t(U), _t(V), _t(BtB), _t(Hinv), rs, 0.0, 0.01, trials=8,
        non_negative=True)
    d = newton_fused.fused_newton_linear_u_pass_ref(
        _t(X), _t(U), _t(V), _t(BtB), _t(Hinv), rs, 0.0, 0.01, trials=8,
        non_negative=True)
    for x, y in list(zip(a, b)) + list(zip(c, d)):
        assert torch.equal(x, y)
    assert policy.launch_counts()["fused_mu_u_pass"] == 0
    assert policy.launch_counts()["fused_newton_linear_u_pass"] == 0


def test_fp8_data_raises_in_both_wrappers(rng):
    X, U, V, BtB, Hinv = _operands(rng, 8, 6, 2)
    X8 = _t(X, torch.float32).to(torch.float8_e4m3fn)
    f = lambda a: _t(a, torch.float32)  # noqa: E731
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        mu_fused.fused_mu_u_pass(X8, f(U), f(V), f(BtB), 0.0, 0.0, 1e-10)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        newton_fused.fused_newton_linear_u_pass(
            X8, f(U), f(V), f(BtB), f(Hinv), f(np.ones(8)), 0.0, 0.0,
            trials=2, non_negative=True)


def test_mixed_devices_raise(rng):
    X, U, V, BtB, _ = _operands(rng, 8, 6, 2)
    with pytest.raises(ValueError, match="one CUDA device or all"):
        policy.on_card(_t(X), _t(U).to("meta"))


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    """Here (no CUDA toolkit) a kernel build fails with a message naming
    what is missing; it never falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_sources_name_the_kernels_they_replace():
    for name, ref in (("mu_fused", "mu_fused.py:fused_mu_u_pass"),
                      ("newton_fused",
                       "newton_fused.py:fused_newton_linear_u_pass")):
        head = (_build.CSRC / f"{name}.cu").read_text()[:2000]
        assert f"pycmf_tpu/ops/pallas/{ref}" in head
        assert "Bound:" in head and "Design:" in head
