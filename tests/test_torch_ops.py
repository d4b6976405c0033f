"""Parity of the PyTorch port's ops (pycmf_tpu_torch/ops) with the JAX
reference (pycmf_tpu/ops) on the CPU: the same NumPy inputs through both.

Tolerances: float64 paths agree to rtol 1e-12 (the two frameworks sum in
different orders, nothing else differs). Mixed-precision matmuls (bf16
data, f32 factors) agree to rtol 1e-6: both round the operands to bf16
and accumulate in float32, in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycmf_tpu.ops import linesearch as jls
from pycmf_tpu.ops import links as jlinks
from pycmf_tpu.ops import losses as jlosses
from pycmf_tpu.ops.matmul import gram as jgram
from pycmf_tpu.ops.matmul import matmul as jmatmul
from pycmf_tpu_torch.ops import linesearch as tls
from pycmf_tpu_torch.ops import links as tlinks
from pycmf_tpu_torch.ops import losses as tlosses
from pycmf_tpu_torch.ops.matmul import gram as tgram
from pycmf_tpu_torch.ops.matmul import matmul as tmatmul
from tests.conftest import make_problem


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


@pytest.mark.parametrize("link", ["linear", "sigmoid"])
def test_links_match_reference(rng, link):
    t = rng.randn(7, 5) * 3
    np.testing.assert_allclose(_np(tlinks.apply_link(link, _t(t))),
                               _np(jlinks.apply_link(link, jnp.asarray(t))),
                               rtol=1e-12)
    tp, tg = tlinks.link_and_grad(link, _t(t))
    jp, jg = jlinks.link_and_grad(link, jnp.asarray(t))
    np.testing.assert_allclose(_np(tp), _np(jp), rtol=1e-12)
    assert (tg is None) == (jg is None)
    if tg is not None:
        np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-12)
    p = 1.0 / (1.0 + np.exp(-t))
    np.testing.assert_allclose(
        _np(tlinks.link_second_deriv(link, _t(p))),
        _np(jlinks.link_second_deriv(link, jnp.asarray(p))), rtol=1e-12,
        atol=1e-15)


def test_check_link_rejects_unknown():
    with pytest.raises(ValueError):
        tlinks.check_link("relu")


@pytest.mark.parametrize("shape", [(6, 9, 4), (61, 40, 4)])
def test_matmul_and_gram_f64(rng, shape):
    p, q, k = shape
    a, b = rng.randn(p, q), rng.randn(q, k)
    np.testing.assert_allclose(_np(tmatmul(_t(a), _t(b))),
                               _np(jmatmul(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-12)
    np.testing.assert_allclose(_np(tgram(_t(b))), _np(jgram(jnp.asarray(b))),
                               rtol=1e-12)


def test_matmul_bf16_accumulates_in_f32(rng):
    """bf16 data × f32 factor: f32 result from bf16-rounded operands (not
    the bf16 output torch.matmul gives for two bf16 tensors)."""
    a, b = np.abs(rng.randn(61, 300)), rng.randn(300, 4)
    tout = tmatmul(_t(a, torch.bfloat16), _t(b, torch.float32))
    jout = jmatmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.float32))
    assert tout.dtype == torch.float32
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-6, atol=1e-5)
    exact = (_np(_t(a, torch.bfloat16)) @ _np(_t(b, torch.bfloat16)))
    np.testing.assert_allclose(_np(tout), exact, rtol=1e-5, atol=1e-4)


def test_matmul_promotes_mixed_float_dtypes(rng):
    a, b = rng.randn(5, 3), rng.randn(3, 2)
    out = tmatmul(_t(a, torch.float32), _t(b, torch.float64))
    assert out.dtype == torch.float64


@pytest.mark.parametrize("alpha,l1_ratio", [(0.0, 0.0), (0.5, 0.3),
                                            (1.0, 1.0)])
def test_penalty(rng, alpha, l1_ratio):
    M = rng.randn(9, 4)
    np.testing.assert_allclose(
        float(tlosses.penalty(_t(M), alpha, l1_ratio)),
        float(jlosses.penalty(jnp.asarray(M), alpha, l1_ratio)), rtol=1e-12)


@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("precomputed", [True, False])
def test_total_loss_f64(rng, with_y, precomputed):
    X, Y = make_problem(rng)
    U, V, Z = (np.abs(rng.randn(60, 4)), np.abs(rng.randn(40, 4)),
               np.abs(rng.randn(10, 4)))
    xa = float((X ** 2).sum()) if precomputed else None
    ya = float((Y ** 2).sum()) if precomputed else None
    Yj = jnp.asarray(Y) if with_y else None
    Yt = _t(Y) if with_y else None
    want = jlosses.total_loss(jnp.asarray(X), Yj, jnp.asarray(U),
                              jnp.asarray(V), jnp.asarray(Z), "linear",
                              "linear", 0.3, 0.4, x_a_sq=xa, y_a_sq=ya)
    got = tlosses.total_loss(_t(X), Yt, _t(U), _t(V), _t(Z), "linear",
                             "linear", 0.3, 0.4,
                             x_a_sq=None if xa is None else _t(xa),
                             y_a_sq=None if ya is None else _t(ya))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("n", [60, 3000])
def test_linear_term_mixed_precision(rng, n):
    """bf16 data, f32 factors: small problems take the direct residual,
    large ones the factored identity, in both packages (n=3000, m=1500 is
    past the 2**22-element switch). rtol 1e-5: f32 sums in two orders."""
    m = 40 if n == 60 else 1500
    A = np.abs(rng.randn(n, m))
    M, B = np.abs(rng.randn(n, 4)), np.abs(rng.randn(m, 4))
    a_sq = float((A ** 2).sum())
    want = jlosses.reconstruction_term(
        jnp.asarray(A, jnp.bfloat16), jnp.asarray(M, jnp.float32),
        jnp.asarray(B, jnp.float32), "linear", a_sq=jnp.float32(a_sq))
    got = tlosses.reconstruction_term(
        _t(A, torch.bfloat16), _t(M, torch.float32), _t(B, torch.float32),
        "linear", a_sq=torch.tensor(a_sq, dtype=torch.float32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_sigmoid_term(rng, monkeypatch, streamed, dtype):
    """Dense ½‖A − σ(M Bᵀ)‖², in one block and streamed over row blocks
    (_BLOCK_ELEMS cut small in both packages, 61 rows in blocks of 7).
    f64 rtol 1e-12; bf16 data with f32 factors rtol 1e-6 (f32 sums in two
    orders)."""
    A = (rng.rand(61, 40) < 0.3).astype(np.float64)
    M, B = rng.randn(61, 4), rng.randn(40, 4)
    if streamed:
        monkeypatch.setattr(tlosses, "_BLOCK_ELEMS", 7 * 40)
        monkeypatch.setattr(jlosses, "_BLOCK_ELEMS", 7 * 40)
    if dtype == "float64":
        args_t, args_j, rtol = (_t(A), _t(M), _t(B)), \
            (jnp.asarray(A), jnp.asarray(M), jnp.asarray(B)), 1e-12
    else:
        args_t = (_t(A, torch.bfloat16), _t(M, torch.float32),
                  _t(B, torch.float32))
        args_j = (jnp.asarray(A, jnp.bfloat16), jnp.asarray(M, jnp.float32),
                  jnp.asarray(B, jnp.float32))
        rtol = 1e-6
    got = tlosses.reconstruction_term(*args_t, "sigmoid")
    want = jlosses.reconstruction_term(*args_j, "sigmoid")
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


@pytest.mark.parametrize("x_link,y_link", [("linear", "sigmoid"),
                                           ("sigmoid", "linear"),
                                           ("sigmoid", "sigmoid")])
def test_total_loss_sigmoid_links_f64(rng, x_link, y_link):
    X, Y = make_problem(rng, binary_y=True)
    U, V, Z = rng.randn(60, 4), rng.randn(40, 4), rng.randn(10, 4)
    if x_link == "sigmoid":
        X = (X > np.median(X)).astype(float)
    want = jlosses.total_loss(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(U),
                              jnp.asarray(V), jnp.asarray(Z), x_link, y_link,
                              0.3, 0.4)
    got = tlosses.total_loss(_t(X), _t(Y), _t(U), _t(V), _t(Z), x_link,
                             y_link, 0.3, 0.4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def _phi_parts(rng, p=23, k=4):
    M = rng.randn(p, k)
    d = rng.randn(p, k)
    W = rng.randn(k, k)
    S = W @ W.T + np.eye(k)
    c = rng.randn(p, k)
    return M, d, S, c


@pytest.mark.parametrize("trials", [0, 1, 4, 8])
@pytest.mark.parametrize("non_negative", [True, False])
def test_backtracking_select(rng, trials, non_negative):
    """Same accept rule: first strictly-lower candidate, else keep the row;
    trials=0 is the plain projected step. The selected rows are identical
    in f64; φ at them agrees to rtol 1e-12 (matmul summation order)."""
    M, d, S, c = _phi_parts(rng)

    def make(lib, arr):
        St, ct = arr(S), arr(c)

        def phi(x):
            return ((x @ St) * x).sum(-1) - 2.0 * (ct * x).sum(-1)

        if lib is torch:
            proj = (lambda x: torch.clamp_min(x, 0.0)) if non_negative \
                else (lambda x: x)
        else:
            proj = (lambda x: jnp.maximum(x, 0.0)) if non_negative \
                else (lambda x: x)
        return phi, proj

    tphi, tproj = make(torch, _t)
    jphi, jproj = make(jnp, jnp.asarray)
    got = tls.backtracking_select(tphi, tproj, _t(M), _t(d), trials)
    want = jls.backtracking_select(jphi, jproj, jnp.asarray(M),
                                   jnp.asarray(d), trials)
    np.testing.assert_array_equal(_np(got), _np(want))
    if trials > 0:
        got, gphi = tls.backtracking_select(tphi, tproj, _t(M), _t(d), trials,
                                            return_phi=True)
        want, wphi = jls.backtracking_select(jphi, jproj, jnp.asarray(M),
                                             jnp.asarray(d), trials,
                                             return_phi=True)
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_allclose(_np(gphi), _np(wphi), rtol=1e-12)


@pytest.mark.parametrize("non_negative", [True, False])
def test_backtracking_select_table(rng, non_negative):
    M, d, _, _ = _phi_parts(rng, p=31)
    phis = rng.randn(31, 6)
    phis[::4, 1:] = phis[::4, :1] + 1.0    # rows with no accepted step
    tproj = (lambda x: torch.clamp_min(x, 0.0)) if non_negative \
        else (lambda x: x)
    jproj = (lambda x: jnp.maximum(x, 0.0)) if non_negative else (lambda x: x)
    got, gphi = tls.backtracking_select_table(_t(phis), tproj, _t(M), _t(d),
                                              return_phi=True)
    want, wphi = jls.backtracking_select_table(jnp.asarray(phis), jproj,
                                               jnp.asarray(M), jnp.asarray(d),
                                               return_phi=True)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(gphi), _np(wphi))
