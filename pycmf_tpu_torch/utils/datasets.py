"""Datasets for benchmarks and examples.

Counterpart of ``pycmf_tpu/utils/datasets.py``; ``synthetic_20ng`` is kept
line for line, so both packages draw the same surrogate from one seed.
The real 20 Newsgroups corpus needs a download; ``load_20ng`` uses
scikit-learn's on-disk copy when both exist and otherwise falls back to
``synthetic_20ng``, never downloading — a corpus-shaped
surrogate matching 20NG's documented statistics (11314 train docs, ~30k
vocab at max_features, Zipfian term frequencies, ~0.1-0.3% density,
20 balanced-ish labels). Benchmarks label which one they used.

Orientation: the CMF contract couples X's columns with Y's rows through the
shared V (X ≈ f(UVᵀ), Y ≈ f(VZᵀ); SURVEY.md §0). For supervised topics the
shared dimension must be documents, so X is TERM×DOCUMENT and Y is
DOCUMENT×LABEL one-hot; U then holds term-topic weights (what
print_topic_terms reads) and V holds document-topic weights.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def synthetic_20ng(n_docs: int = 11314, n_terms: int = 30000,
                   n_labels: int = 20, n_topics: int = 40,
                   avg_doc_len: int = 120, random_state: int = 0,
                   dtype=np.float32):
    """20NG-shaped synthetic bag-of-words: (X term×doc CSR, Y doc×label)."""
    rng = np.random.RandomState(random_state)
    # Zipfian term distribution per topic
    base = 1.0 / np.arange(1, n_terms + 1) ** 1.1
    topic_term = np.stack([
        base[rng.permutation(n_terms)] for _ in range(n_topics)])
    topic_term /= topic_term.sum(axis=1, keepdims=True)
    doc_topic = rng.dirichlet(np.full(n_topics, 0.1), size=n_docs)
    labels = doc_topic.argmax(axis=1) % n_labels

    rows, cols, vals = [], [], []
    doc_lens = rng.poisson(avg_doc_len, size=n_docs).clip(10)
    for d in range(n_docs):
        # mixture sampling of terms for one document
        t = rng.choice(n_topics, p=doc_topic[d])
        terms = rng.choice(n_terms, size=doc_lens[d], p=topic_term[t])
        uterms, counts = np.unique(terms, return_counts=True)
        rows.append(uterms)
        cols.append(np.full(uterms.shape, d, dtype=np.int64))
        vals.append(counts.astype(dtype))
    X = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_terms, n_docs), dtype=dtype)
    Y = np.zeros((n_docs, n_labels), dtype=dtype)
    Y[np.arange(n_docs), labels] = 1.0
    return X, Y


def load_20ng(max_features: int = 30000, random_state: int = 0,
              dtype=np.float32) -> Tuple[sp.csr_matrix, np.ndarray, str]:
    """(X term×doc CSR, Y doc×label one-hot, source).

    Uses scikit-learn's on-disk 20NG cache when scikit-learn is installed
    and its cache file exists ($SCIKIT_LEARN_DATA, default
    ~/scikit_learn_data); otherwise returns the synthetic surrogate, with
    the reason in the source string. Never downloads, and writes nothing.
    """
    import os

    home = os.path.expanduser(os.environ.get(
        "SCIKIT_LEARN_DATA", os.path.join("~", "scikit_learn_data")))
    if not os.path.exists(os.path.join(home, "20news-bydate.pkz")):
        reason = "no cached copy"
    else:
        try:
            from sklearn.datasets import fetch_20newsgroups
            from sklearn.feature_extraction.text import CountVectorizer
        except ImportError:
            reason = "scikit-learn not installed"
        else:
            data = fetch_20newsgroups(
                data_home=home, subset="train", download_if_missing=False,
                remove=("headers", "footers", "quotes"))
            vec = CountVectorizer(max_features=max_features,
                                  dtype=np.float64)
            X = sp.csr_matrix(vec.fit_transform(data.data).T, dtype=dtype)
            n_labels = int(np.max(data.target)) + 1
            Y = np.zeros((X.shape[1], n_labels), dtype=dtype)
            Y[np.arange(X.shape[1]), data.target] = 1.0
            return X, Y, "20newsgroups (sklearn cache)"
    X, Y = synthetic_20ng(random_state=random_state, dtype=dtype)
    return X, Y, f"synthetic 20NG-shaped surrogate ({reason})"


def synthetic_rcv1(n_terms: int = 47236, n_docs: int = 804414,
                   doc_len: float = 95.0, zipf: float = 1.0,
                   random_state: int = 0, dtype=np.float32) -> sp.csr_matrix:
    """RCV1-v2-shaped synthetic bag-of-words X (term×document CSR).

    The shape of RCV1-v2 (Lewis et al. 2004, JMLR 5; 47 236 terms ×
    804 414 documents, ``sklearn.datasets.fetch_rcv1``) at ~0.16% density,
    ~60M nonzeros: Poisson(doc_len) tokens per document drawn from a Zipf
    law over the terms (in a random order), counts of repeated terms as
    values. Row lengths are Zipfian: the most frequent term occurs in
    nearly every document. Vectorised: tens of seconds on one core."""
    rng = np.random.default_rng(random_state)
    w = 1.0 / np.arange(1, n_terms + 1) ** zipf
    cdf = np.cumsum(w / w.sum())
    rank_to_term = rng.permutation(n_terms).astype(np.int64)
    lens = rng.poisson(doc_len, size=n_docs)
    doc = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    rank = np.searchsorted(cdf, rng.random(doc.size, dtype=np.float32))
    keys = doc * n_terms + rank_to_term[np.minimum(rank, n_terms - 1)]
    del doc, rank
    keys, counts = np.unique(keys, return_counts=True)
    indptr = np.zeros(n_docs + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys // n_terms, minlength=n_docs), out=indptr[1:])
    cols = (keys % n_terms).astype(np.int32)
    Xt = sp.csr_matrix((counts.astype(dtype), cols, indptr),
                       shape=(n_docs, n_terms))
    return Xt.T.tocsr()


def block_sparse_matrix(p: int, q: int, block_frac: float,
                        rng) -> sp.csr_matrix:
    """Random block-structured sparse matrix: each 128-aligned 128×128 block
    position is dense (uniform values) with probability ``block_frac``, else
    empty. The reference's ``examples/block_sparse_bell.py`` generator."""
    rows, cols, vals = [], [], []
    base = np.arange(128)
    for i in range(-(-p // 128)):
        for j in range(-(-q // 128)):
            if rng.rand() > block_frac:
                continue
            r0, c0 = i * 128, j * 128
            h, w = min(128, p - r0), min(128, q - c0)
            rows.append(np.repeat(base[:h] + r0, w))
            cols.append(np.tile(base[:w] + c0, h))
            vals.append(rng.rand(h * w))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(p, q))
