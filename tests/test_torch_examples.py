"""Smoke tests of ``examples/*.py`` on the port: each example's calls, made on
``pycmf_tpu_torch`` at a small size on the CPU (the examples themselves
drive the reference and import its compile cache, which the port does not
have). The sharded example runs its rows, cols and grid fits in 2 gloo
ranks (``tests/_torch_dist.py``).

Bars: float32 fits, so agreement between two layouts of one fit is held to
1e-4 relative on the final loss (1e-2 for a bf16-stored X against the
float32 chunked layout), and every fit to a decreasing loss.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.utils.datasets import block_sparse_matrix, synthetic_20ng
from pycmf_tpu_torch.utils.validation import as_coupled
from tests._torch_dist import run_cases, spawn


def _decreased(est):
    return est.reconstruction_err_ < est.loss_history_[0] \
        and np.isfinite(est.reconstruction_err_)


def test_supervised_topics_20ng(capsys):
    """examples/supervised_topics_20ng.py: MU on the term×document X with
    document labels, verbose, the topic terms of U, each topic's strongest
    label, and a fold-in."""
    X, Y = synthetic_20ng(n_docs=150, n_terms=300, random_state=0)
    model = CMF(n_components=6, solver="mu", alpha=0.01, tol=1e-4,
                max_iter=40, random_state=0, verbose=1, device="cpu")
    U, V, Z = model.fit_transform(X, Y)
    assert U.shape == (300, 6) and V.shape == (150, 6) and Z.shape == (20, 6)
    assert _decreased(model)
    vocab = [f"term{i}" for i in range(X.shape[0])]
    s = model.print_topic_terms(vocabulary=vocab, factor="U", n_top_words=8)
    out = capsys.readouterr().out
    assert "[pycmf_tpu_torch] iter" in out and s in out
    lines = s.splitlines()
    assert len(lines) == 6 and all(len(ln.split()) == 10 for ln in lines)
    top_label = np.asarray(Z).argmax(axis=0)
    assert top_label.shape == (6,) and top_label.max() < 20
    U_new = model.transform(X[:50])
    assert U_new.shape == (50, 6) and np.all(np.isfinite(U_new))


def test_beyond_threshold_streaming():
    """examples/beyond_threshold_streaming.py: a sparse X densified at bf16
    storage, then streamed through the chunked layout; the two fits agree,
    and transform runs on the chunked model."""
    rng = np.random.RandomState(0)
    n, m, k = 400, 300, 6
    nnz = int(n * m * 0.03)
    X = sp.coo_matrix(
        (rng.rand(nnz), (rng.randint(0, n, nnz), rng.randint(0, m, nnz))),
        shape=(n, m)).tocsr()
    Y = np.abs(rng.randn(m, 12))
    common = dict(n_components=k, solver="mu", max_iter=30, tol=1e-5,
                  random_state=0, device="cpu")
    model = CMF(data_dtype="bfloat16", sparse_mode="auto", **common)
    model.fit_transform(X, Y)
    model_c = CMF(sparse_mode="chunked", **common)
    model_c.fit_transform(X, Y)
    assert _decreased(model) and _decreased(model_c)
    gap = abs(model.reconstruction_err_ - model_c.reconstruction_err_) \
        / model.reconstruction_err_
    assert gap < 1e-2
    U_new = model_c.transform(X[:40])
    assert U_new.shape == (40, k) and np.all(np.isfinite(U_new))


def test_binary_labels_newton():
    """examples/binary_labels_newton.py: Newton with a sigmoid Y link
    (config #2), then sampled Newton on a tall X (config #4)."""
    rng = np.random.RandomState(0)
    n, m, r, k = 120, 60, 8, 4
    Ut, Vt, Zt = (rng.randn(p, k) * 0.6 for p in (n, m, r))
    X = Ut @ Vt.T + 0.05 * rng.randn(n, m)
    Y = (1 / (1 + np.exp(-(Vt @ Zt.T))) > 0.5).astype(np.float32)
    model = CMF(n_components=k, solver="newton", x_link="linear",
                y_link="sigmoid", U_non_negative=False,
                V_non_negative=False, Z_non_negative=False,
                hessian_pertubation=0.2, line_search_trials=8, tol=1e-6,
                max_iter=20, random_state=0, device="cpu")
    U, V, Z = model.fit_transform(X, Y)
    assert _decreased(model)
    P = 1 / (1 + np.exp(-(V @ Z.T)))
    assert ((P > 0.5) == (Y > 0.5)).mean() > 0.8
    tall = CMF(n_components=k, solver="newton", sg_sample_ratio=0.3,
               U_non_negative=False, V_non_negative=False,
               Z_non_negative=False, max_iter=10, random_state=0,
               device="cpu")
    Xtall = np.vstack([X, Ut @ Vt.T + 0.05 * rng.randn(n, m)])
    tall.fit(Xtall, Y)
    assert tall.U_.shape == (2 * n, k) and _decreased(tall)


def test_block_sparse_bell():
    """examples/block_sparse_bell.py: a block-structured X through the
    BlockEll layout (sparse_mode='csr', use_pallas), against the dense
    path."""
    rng = np.random.RandomState(0)
    X = block_sparse_matrix(512, 384, block_frac=0.5, rng=rng)
    Y = np.abs(rng.randn(384, 12))
    assert as_coupled(X, torch.float32, "cpu", use_pallas=True,
                      sparse_mode="csr").A_bell is not None
    model = CMF(n_components=8, solver="mu", sparse_mode="csr",
                use_pallas=True, max_iter=40, tol=1e-4, random_state=0,
                device="cpu")
    model.fit_transform(X, Y)
    dense = CMF(n_components=8, solver="mu", sparse_mode="dense",
                max_iter=40, tol=1e-4, random_state=0, device="cpu")
    dense.fit(X, Y)
    assert _decreased(model)
    gap = abs(dense.reconstruction_err_ - model.reconstruction_err_) \
        / dense.reconstruction_err_
    assert gap < 1e-4


def test_pod_scale_sharded(tmp_path):
    """examples/pod_scale_sharded.py in 2 gloo ranks: the rows, cols and
    grid ((2, 1)) layouts against the single-device fit, and the sharded
    fold-in."""
    rng = np.random.RandomState(0)
    n, m, r, k = 256, 96, 16, 4
    X = np.abs(rng.randn(n, m)).astype(np.float32)
    Y = np.abs(rng.randn(m, r)).astype(np.float32)
    kw = dict(n_components=k, solver="mu", random_state=0, max_iter=20,
              tol=0.0)
    shards = {"rows": 2, "cols": 2, "grid": (2, 1)}
    cases = {layout: dict(kind="fit", kw=dict(kw, n_shards=ns,
                                              shard_layout=layout),
                          X=X, Y=Y, Xn=X[:32])
             for layout, ns in shards.items()}
    ranks = spawn(run_cases, 2, tmp_path, cases)
    try:
        single = CMF(**kw, device="cpu").fit(X, Y)
    finally:
        ports = ranks.join()
    for layout in shards:
        got = ports[0][layout]
        assert got["n_iter"] == 20
        gap = abs(got["losses"][-1] - single.reconstruction_err_) \
            / single.reconstruction_err_
        assert gap < 1e-4
        assert got["transform"].shape == (32, k)
        assert got["losses"] == ports[1][layout]["losses"]


@pytest.mark.parametrize("name", ["supervised_topics_20ng",
                                  "beyond_threshold_streaming",
                                  "binary_labels_newton", "block_sparse_bell",
                                  "pod_scale_sharded"])
def test_every_example_has_its_smoke_test(name):
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    examples = sorted(p.stem for p in (root / "examples").glob("*.py"))
    assert name in examples and len(examples) == 5
    assert f"test_{name}" in globals()
