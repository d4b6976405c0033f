"""The port's estimator surface and utilities against the reference's, on the
CPU: topic-term analysis, ``components_``, ``inverse_transform``,
``get_feature_names_out``, ``print_topic_terms``, sklearn's ``clone`` and
``Pipeline``, checkpoints in both directions, profiling, and the packages'
exports.

Tolerances: strings equal character for character; float64 surfaces at
rtol 1e-12 on factors carried over by ``CMF.from_reference``; a transform
after a checkpoint's round trip at rtol 1e-9.
"""
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pycmf_tpu
import pycmf_tpu.utils as j_utils
import pycmf_tpu_torch
import pycmf_tpu_torch.utils as t_utils
from pycmf_tpu import CMF as JCMF
from pycmf_tpu.utils import analysis as j_analysis
from pycmf_tpu.utils import checkpoint as j_checkpoint
from pycmf_tpu_torch import CMF
from pycmf_tpu_torch.utils import analysis as t_analysis
from pycmf_tpu_torch.utils import checkpoint as t_checkpoint
from pycmf_tpu_torch.utils import profiling
from tests.conftest import make_problem

KW = dict(n_components=3, random_state=0, max_iter=15, eval_every=5,
          dtype="float64")


# -- analysis ------------------------------------------------------------------

class _OutNames:
    def get_feature_names_out(self):
        return np.asarray([f"out{i}" for i in range(12)], dtype=object)


class _OldNames:
    def get_feature_names(self):
        return [f"old{i}" for i in range(12)]


class _VocabOnly:
    vocabulary_ = {f"v{i}": 11 - i for i in range(12)}


def _factors():
    rng = np.random.RandomState(5)
    ties = rng.randint(0, 3, size=(12, 4)).astype(float)  # many equal values
    return {"seeded": rng.randn(12, 4), "ties": ties,
            "ties_negative": -ties}


@pytest.mark.parametrize("factor", list(_factors()))
@pytest.mark.parametrize("vocab", ["none", "list", "dict", "out", "old",
                                   "vocabulary_"])
def test_topic_terms_string_equals_reference(factor, vocab):
    M = _factors()[factor]
    kw = {"none": {}, "list": dict(vocabulary=[f"w{i}" for i in range(12)]),
          "dict": dict(vocabulary={f"d{i}": (5 * i) % 12 for i in range(12)}),
          "out": dict(vectorizer=_OutNames()),
          "old": dict(vectorizer=_OldNames()),
          "vocabulary_": dict(vectorizer=_VocabOnly())}[vocab]
    for n_top in (1, 4, 12):
        assert t_analysis.topic_terms_string(M, n_top_words=n_top, **kw) \
            == j_analysis.topic_terms_string(M, n_top_words=n_top, **kw)


@pytest.mark.parametrize("factor", list(_factors()))
def test_top_terms_and_samples_equal_reference(factor):
    M = _factors()[factor]
    for n_top in (1, 3, 12):
        np.testing.assert_array_equal(
            t_analysis.top_terms_per_component(M, n_top),
            j_analysis.top_terms_per_component(M, n_top))
        np.testing.assert_array_equal(
            t_analysis.top_component_samples(M, n_top),
            j_analysis.top_component_samples(M, n_top))


def test_print_topic_terms_after_a_port_fit_equals_reference():
    """The port fits; the reference prints the same factors (set on a
    reference estimator) to the same string and the same output."""
    X, Y = make_problem(np.random.RandomState(0), n=30, m=20)
    t = CMF(device="cpu", **KW).fit(X, Y)
    j = JCMF(**KW)
    j.U_, j.V_, j.Z_ = t.U_, t.V_, t.Z_
    vocab = [f"word{i}" for i in range(X.shape[0])]
    for factor in ("U", "V", "Z"):
        out_t, out_j = io.StringIO(), io.StringIO()
        s_t = t.print_topic_terms(vocabulary=vocab if factor == "U" else None,
                                  factor=factor, n_top_words=4, file=out_t)
        s_j = j.print_topic_terms(vocabulary=vocab if factor == "U" else None,
                                  factor=factor, n_top_words=4, file=out_j)
        assert s_t == s_j and out_t.getvalue() == out_j.getvalue()
        assert len(s_t.splitlines()) == 3
    with pytest.raises(RuntimeError, match="not fitted"):
        CMF(device="cpu").print_topic_terms()


# -- the estimator's surface -----------------------------------------------------

@pytest.mark.parametrize("x_link", ["linear", "sigmoid"])
def test_surface_equals_reference_on_carried_factors(x_link):
    X, Y = make_problem(np.random.RandomState(1), n=25, m=18,
                        non_negative=x_link == "linear")
    kw = dict(KW, max_iter=4)
    if x_link == "sigmoid":
        X = (X > np.median(X)).astype(float)
        kw.update(solver="newton", x_link="sigmoid", U_non_negative=False,
                  V_non_negative=False, Z_non_negative=False)
    j = JCMF(**kw).fit(X, Y)
    t = CMF.from_reference(j, device="cpu")
    np.testing.assert_allclose(t.components_, j.components_, rtol=1e-12)
    assert t.components_.shape == (3, X.shape[1])
    U = np.random.RandomState(2).randn(7, 3)
    np.testing.assert_allclose(t.inverse_transform(U),
                               j.inverse_transform(U), rtol=1e-12)
    names = t.get_feature_names_out()
    np.testing.assert_array_equal(names, j.get_feature_names_out())
    assert names.dtype == object and list(names) == ["cmf0", "cmf1", "cmf2"]


def test_surface_before_fit_raises_as_the_reference():
    for est in (CMF(device="cpu"), JCMF()):
        with pytest.raises(AttributeError, match="after fit"):
            est.get_feature_names_out()
        with pytest.raises(AttributeError, match="after fit"):
            est.components_
        with pytest.raises(RuntimeError, match="before fit"):
            est.inverse_transform(np.ones((2, 3)))


def test_sklearn_clone_and_pipeline():
    """clone, and a Pipeline's fit_transform then transform, as the
    reference's test_pipeline_usage; the tags equal the reference's."""
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    from sklearn.pipeline import Pipeline
    from sklearn.utils import get_tags

    est = CMF(n_components=3, random_state=0, max_iter=30, device="cpu")
    c = clone(est)
    assert c is not est and c.get_params() == est.get_params()
    X = np.abs(np.random.RandomState(3).randn(40, 25))
    pipe = Pipeline([("cmf", CMF(n_components=3, random_state=0,
                                 max_iter=30, device="cpu"))])
    U = pipe.fit_transform(X)
    assert U[0].shape == (40, 3)
    assert pipe.transform(X).shape == (40, 3)
    assert get_tags(est) == get_tags(JCMF())


# -- checkpoints ---------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted():
    X, Y = make_problem(np.random.RandomState(4), n=30, m=20)
    j = JCMF(**KW).fit(X, Y)
    t = CMF(device="cpu", **KW).fit(X, Y)
    return X, Y, j, t


def test_reference_checkpoint_loads_in_the_port(fitted, tmp_path):
    X, _, j, _ = fitted
    path = str(tmp_path / "ref.npz")
    j_checkpoint.save_model(path, j)
    t = t_checkpoint.load_model(path, device="cpu")
    assert t.get_params() == dict(j.get_params(), device="cpu")
    for name in ("U_", "V_", "Z_"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.n_iter_ == j.n_iter_ and t.n_components_ == 3
    assert t.loss_history_ == j.loss_history_
    assert t.reconstruction_err_ == j.loss_history_[-1]
    assert t.loss_iters_ == [] and t.step_times_ == []
    np.testing.assert_allclose(t.transform(X[:9]), j.transform(X[:9]),
                               rtol=1e-9, atol=1e-12)


def test_port_checkpoint_loads_in_the_reference(fitted, tmp_path):
    X, _, _, t = fitted
    path = str(tmp_path / "port.npz")
    t_checkpoint.save_model(path, t)
    with np.load(path) as f:
        assert sorted(f.files) == ["U", "V", "Z", "loss_history", "n_iter",
                                   "params_json"]
        params = json.loads(str(f["params_json"]))
    assert "device" not in params
    j = j_checkpoint.load_model(path)
    for name in ("U_", "V_", "Z_"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
    assert j.n_iter_ == t.n_iter_ and j.loss_history_ == t.loss_history_
    back = t_checkpoint.load_model(path, device="cpu")
    np.testing.assert_allclose(back.transform(X[:9]), j.transform(X[:9]),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("with_z", [True, False])
def test_load_checkpoint_round_trips(tmp_path, with_z):
    rng = np.random.RandomState(6)
    U, V, Z = rng.randn(5, 2), rng.randn(4, 2), rng.randn(3, 2)
    path = str(tmp_path / "ck.npz")
    params = {"n_components": 2, "solver": "newton", "alpha": 0.5}
    t_checkpoint.save_checkpoint(path, U, V, Z if with_z else None,
                                 n_iter=7, loss_history=[3.0, 2.5, 2.25],
                                 params=params)
    ck = t_checkpoint.load_checkpoint(path)
    np.testing.assert_array_equal(ck["U"], U)
    np.testing.assert_array_equal(ck["V"], V)
    if with_z:
        np.testing.assert_array_equal(ck["Z"], Z)
    else:
        assert ck["Z"] is None
    assert ck["n_iter"] == 7 and ck["loss_history"] == [3.0, 2.5, 2.25]
    assert ck["params"] == params
    ref = j_checkpoint.load_checkpoint(path)
    assert ref["params"] == params and ref["n_iter"] == 7


def test_saving_an_unfitted_model_raises(tmp_path):
    with pytest.raises(RuntimeError, match="unfitted"):
        t_checkpoint.save_model(str(tmp_path / "x.npz"), CMF(device="cpu"))


# -- profiling -----------------------------------------------------------------

def test_trace_writes_the_annotated_region(tmp_path):
    X, Y = make_problem(np.random.RandomState(7), n=20, m=15)
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("cmf_fit_region"):
            CMF(device="cpu", **dict(KW, max_iter=2)).fit(X, Y)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    text = files[0].read_text()
    assert "cmf_fit_region" in text
    json.loads(text)


def test_step_timer():
    timer = profiling.StepTimer()
    for name in ("a", "b", "a"):
        with timer.measure(name):
            pass
    assert [n for n, _ in timer.events] == ["a", "b", "a"]
    assert timer.total("a") <= timer.total() and timer.total() >= 0


# -- exports -------------------------------------------------------------------

def test_exports_match_the_reference():
    assert pycmf_tpu_torch.__all__ == pycmf_tpu.__all__
    assert t_utils.__all__ == j_utils.__all__
    for name in t_utils.__all__:
        assert callable(getattr(t_utils, name))
    assert pycmf_tpu_torch.__version__ == pycmf_tpu.__version__
    from pycmf_tpu_torch.ops.sparse import CsrMatrix
    from pycmf_tpu_torch.solvers.common import SolverConfig, make_hyper
    assert pycmf_tpu_torch.CsrMatrix is CsrMatrix
    assert pycmf_tpu_torch.SolverConfig is SolverConfig
    assert pycmf_tpu_torch.make_hyper is make_hyper


def test_import_pulls_in_neither_sklearn_nor_jax():
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, pycmf_tpu_torch, pycmf_tpu_torch.utils, "
            "pycmf_tpu_torch.ops, pycmf_tpu_torch.solvers, pycmf_torch; "
            "print('sklearn' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "False"]
