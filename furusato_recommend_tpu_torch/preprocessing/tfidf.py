"""TF-IDF vectors as scikit-learn's ``TfidfVectorizer`` (1.9) computes them
with its defaults and ``max_df`` / ``min_df`` / ``max_features``, on numpy and
scipy alone (the card's machine has no scikit-learn):

- tokens: ``(?u)\\b\\w\\w+\\b`` over the lowercased document, so a token of one
  character is dropped;
- the vocabulary sorted; a term in more than ``max_df`` of the documents (a
  fraction, or a count when an int) or fewer than ``min_df`` dropped; above
  ``max_features`` terms, the most frequent over the corpus kept, through the
  same ``argsort`` of the negated counts, so ties at the cut fall as numpy
  orders them;
- idf = ln((1 + n) / (1 + df)) + 1 in float64; each row's counts times idf,
  divided by the row's l2 norm (rows of no term stay empty);
- the same ``ValueError`` s where no term is found or none survives.

The rows' l2 norms are summed by numpy, not by scikit-learn's Cython loop, so
a value may differ from scikit-learn's in its last bits.
"""

from __future__ import annotations

import re
from numbers import Integral
from typing import Dict, Iterable, List, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = ["TfidfVectorizer"]

_TOKEN = re.compile(r"(?u)\b\w\w+\b")


class TfidfVectorizer:
    def __init__(self, max_df=1.0, min_df=1, max_features=None):
        self.max_df = max_df
        self.min_df = min_df
        self.max_features = max_features
        self.vocabulary_: Dict[str, int] = {}
        self.idf_ = np.empty(0)

    @staticmethod
    def _tokens(docs: Iterable[str]) -> Tuple[List[List[str]], int]:
        rows = [_TOKEN.findall(doc.lower()) for doc in docs]
        return rows, len(rows)

    @staticmethod
    def _counts(rows: List[List[str]], vocab: Dict[str, int]) -> sp.csr_matrix:
        """[docs, |vocab|] float64 counts of the in-vocabulary tokens, each
        row's columns ascending."""
        n_vocab = len(vocab)
        lengths = [len(r) for r in rows]
        ids = np.fromiter((vocab.get(t, -1) for r in rows for t in r), dtype=np.int64, count=sum(lengths))
        doc = np.repeat(np.arange(len(rows), dtype=np.int64), lengths)
        ok = ids >= 0
        keys, counts = np.unique(doc[ok] * max(n_vocab, 1) + ids[ok], return_counts=True)
        mat = sp.csr_matrix(
            (counts.astype(np.float64), (keys // max(n_vocab, 1), keys % max(n_vocab, 1))),
            shape=(len(rows), n_vocab),
        )
        mat.sort_indices()
        return mat

    def fit(self, docs: Iterable[str]) -> "TfidfVectorizer":
        rows, n_doc = self._tokens(docs)
        terms = sorted({t for r in rows for t in r})
        if not terms:
            raise ValueError("empty vocabulary; perhaps the documents only contain stop words")
        high = self.max_df if isinstance(self.max_df, Integral) else self.max_df * n_doc
        low = self.min_df if isinstance(self.min_df, Integral) else self.min_df * n_doc
        if high < low:
            raise ValueError("max_df corresponds to < documents than min_df")
        x = self._counts(rows, {t: i for i, t in enumerate(terms)})
        dfs = np.bincount(x.indices, minlength=len(terms))
        mask = (dfs <= high) & (dfs >= low)
        limit = self.max_features
        if limit is not None and mask.sum() > limit:
            tfs = np.bincount(x.indices, weights=x.data, minlength=len(terms))
            mask_inds = (-tfs[mask]).argsort()[:limit]
            new_mask = np.zeros(len(dfs), dtype=bool)
            new_mask[np.where(mask)[0][mask_inds]] = True
            mask = new_mask
        kept = np.where(mask)[0]
        if len(kept) == 0:
            raise ValueError("After pruning, no terms remain. Try a lower min_df or a higher max_df.")
        self.vocabulary_ = {terms[j]: i for i, j in enumerate(kept)}
        df = dfs[kept].astype(np.float64) + 1.0
        idf = np.full_like(df, fill_value=n_doc + 1, dtype=np.float64)
        idf /= df
        np.log(idf, out=idf)
        idf += 1.0
        self.idf_ = idf
        return self

    def transform(self, docs: Iterable[str]) -> sp.csr_matrix:
        rows, _ = self._tokens(docs)
        x = self._counts(rows, self.vocabulary_)
        x.data *= self.idf_[x.indices]
        sq = x.data * x.data
        nnz = np.diff(x.indptr)
        norms = np.zeros(x.shape[0])
        has = nnz > 0
        if has.any():
            norms[has] = np.sqrt(np.add.reduceat(sq, x.indptr[:-1][has]))
        x.data /= np.repeat(np.where(has, norms, 1.0), nnz)
        return x

