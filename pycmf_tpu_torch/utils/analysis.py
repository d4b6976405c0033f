"""Topic and factor inspection helpers.

Counterpart of ``pycmf_tpu/utils/analysis.py``: the top-weighted terms per
component of a fitted factor, named through a vectorizer's vocabulary.
Host NumPy on the fitted (NumPy) factors, with the reference's
``np.argsort(-M, axis=0)`` tie order, so the strings equal the reference's
character for character.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _resolve_vocab(vectorizer=None, vocabulary=None, size: int = 0):
    """The index → term list: a {term: index} dict inverted, a sequence as
    given, a vectorizer's ``get_feature_names_out``, ``get_feature_names``
    or ``vocabulary_``; else ``feat_0 .. feat_{size-1}``."""
    if vocabulary is not None:
        if isinstance(vocabulary, dict):
            inv = [None] * (max(vocabulary.values()) + 1)
            for tok, idx in vocabulary.items():
                inv[idx] = tok
            return inv
        return list(vocabulary)
    if vectorizer is not None:
        if hasattr(vectorizer, "get_feature_names_out"):
            return list(vectorizer.get_feature_names_out())
        if hasattr(vectorizer, "get_feature_names"):
            return list(vectorizer.get_feature_names())
        if hasattr(vectorizer, "vocabulary_"):
            return _resolve_vocab(vocabulary=vectorizer.vocabulary_)
    return [f"feat_{i}" for i in range(size)]


def top_terms_per_component(M: np.ndarray, n_top: int = 10) -> np.ndarray:
    """(k, n_top) indices of the n_top largest-weight rows of each column
    of M (n_features, k), largest first."""
    M = np.asarray(M)
    order = np.argsort(-M, axis=0)
    return order[:n_top].T


def topic_terms_string(M: np.ndarray, vectorizer=None, vocabulary=None,
                       n_top_words: int = 10) -> str:
    """One line 'Topic #j: w1 w2 ...' per column of M."""
    M = np.asarray(M)
    vocab = _resolve_vocab(vectorizer, vocabulary, size=M.shape[0])
    idx = top_terms_per_component(M, n_top_words)
    lines: List[str] = []
    for j, row in enumerate(idx):
        terms = " ".join(str(vocab[i]) for i in row)
        lines.append(f"Topic #{j}: {terms}")
    return "\n".join(lines)


def top_component_samples(M: np.ndarray, n_top: int = 5) -> np.ndarray:
    """(k, n_top) indices of the rows (documents, say) most associated
    with each component: top_terms_per_component on a sample factor."""
    return top_terms_per_component(M, n_top)
