"""Text preprocessing tools: tf-idf vocabulary selection and LDA topic
init (counterpart of ``topk_rec_tpu/tools/text.py``, a copy so that the
port stands alone).

The reference's legacy pipeline selects a top-N vocabulary by count·idf and
emits per-item tf-idf features (``old/tools/parseText.py:52-83``), and fits
LDA for ``init.theta``/``init.beta`` topic initializations
(``old/tools/genLdaFiles.py``). NumPy and scikit-learn; scikit-learn is
imported only by :func:`lda_topics`, so importing this module needs only
NumPy. The outputs are dense float32 matrices for
``Recommender.set_features``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[A-Za-z]+")


def tfidf_features(
    documents: Sequence[str],
    vocab_size: int = 8000,
    lowercase: bool = True,
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Per-document tf-idf features over a count·idf-selected vocabulary.

    Mirrors reference parseText.py semantics: tokenize, rank terms by
    total count × idf, keep the top ``vocab_size``, emit tf·idf rows.
    Returns (features [n_docs, V] float32, vocab term->column).
    """
    n_docs = len(documents)
    tokenized: List[List[str]] = []
    counts: Dict[str, int] = {}
    doc_freq: Dict[str, int] = {}
    for doc in documents:
        toks = _TOKEN_RE.findall(doc.lower() if lowercase else doc)
        tokenized.append(toks)
        seen = set()
        for t in toks:
            counts[t] = counts.get(t, 0) + 1
            if t not in seen:
                seen.add(t)
                doc_freq[t] = doc_freq.get(t, 0) + 1
    idf = {
        t: np.log(n_docs / (1.0 + doc_freq[t])) for t in counts
    }
    score = {t: counts[t] * idf[t] for t in counts}
    chosen = sorted(score, key=lambda t: -score[t])[:vocab_size]
    vocab = {t: i for i, t in enumerate(chosen)}
    feat = np.zeros((n_docs, len(vocab)), dtype=np.float32)
    for row, toks in enumerate(tokenized):
        for t in toks:
            col = vocab.get(t)
            if col is not None:
                feat[row, col] += 1.0
    for t, col in vocab.items():
        feat[:, col] *= idf[t]
    return feat, vocab


def lda_topics(
    term_counts: np.ndarray,
    n_topics: int = 50,
    max_iter: int = 50,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """LDA topic decomposition: (theta [n_docs, K], beta [K, V]).

    The reference fits 50-topic LDA for 1500 iterations to initialize
    CTR's theta (genLdaFiles.py:12-31); this uses sklearn's online LDA.
    ``theta`` rows are normalized doc-topic mixtures, ``beta`` rows are
    topic-term distributions.
    """
    from sklearn.decomposition import LatentDirichletAllocation

    lda = LatentDirichletAllocation(
        n_components=n_topics,
        max_iter=max_iter,
        random_state=seed,
        learning_method="batch",
    )
    doc_topic = lda.fit_transform(np.asarray(term_counts))
    theta = doc_topic / doc_topic.sum(axis=1, keepdims=True)
    beta = lda.components_ / lda.components_.sum(axis=1, keepdims=True)
    return theta.astype(np.float32), beta.astype(np.float32)
