"""Text features with the initialize / update protocol (port of the JAX
package's ``preprocessing/text.py``): tokens, TF-IDF vectors of the three
text fields (``name``, ``main_comment``, ``main_list_comment``) over a
vocabulary fit on their concatenation, sentence embeddings, and the review
feature (per product counts and rates, the reviews' tokens as one document,
its TF-IDF thresholded at 0.1 to a binary vector).

Deviations: the tokenizer is the JAX package's no-Janome fallback (NFKC, the
punctuation stripped, Latin words, CJK character bigrams, the NG-word
stoplist) and the sentence embedding its no-sentence-transformers fallback (a
hashed bag of tokens through Python's ``hash``, salted per process, so equal
to the JAX package's only inside one process). Janome and
sentence-transformers, which need packages and a model that neither machine
has, are not copied. The TF-IDF is ``tfidf.TfidfVectorizer``, scikit-learn's
computation on numpy and scipy.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from .frame import Frame, _is_nan, isna
from .tfidf import TfidfVectorizer

__all__ = ["join_nouns", "ProductTextFeature", "ProductReviewFeature"]

NG_WORDS = {
    "あう", "する", "れる", "さ", "ある", "よう", "等", "など", "いる", "ため",
    "こと", "ござる", "くださる", "おる", "あり", "なる", "の", "ん", "そう",
    "くる", "いう", "もの", "ない", "ろ", "それ", "うえ", "さん", "せる", "おり",
    "こ", "す", "め", "ば", "ゅ", "ら", "てる",
}

_PUNCT = re.compile(r"[#!:;<.*?>{}・`,()\-=$/_'\"\[\]\|~]+")
_CJK = re.compile(r"[぀-ヿ一-鿿]+")
_RUNS = re.compile(r"[a-z0-9]+|[぀-ヿ一-鿿]+")


def _fallback_tokenize(text: str) -> List[str]:
    """NFKC, lowercase, punctuation to spaces; Latin words whole, CJK runs as
    character bigrams (a run of one character as itself)."""
    text = unicodedata.normalize("NFKC", text).lower()
    text = _PUNCT.sub(" ", text)
    tokens: List[str] = []
    for run in _RUNS.findall(text):
        if _CJK.fullmatch(run):
            if len(run) == 1:
                tokens.append(run)
            else:
                tokens.extend(run[i : i + 2] for i in range(len(run) - 1))
        else:
            tokens.append(run)
    return tokens


def join_nouns(text) -> Optional[str]:
    """The tokens of ``text`` less the NG words, joined by spaces; None when
    missing."""
    if _is_nan(text):
        return None
    return " ".join(t for t in _fallback_tokenize(text) if t not in NG_WORDS)


def _sentence_embed(texts: List[str], dim: int = 768) -> np.ndarray:
    """[N, dim] float32: each token adds +-1 at ``hash(token) % dim``, the row
    l2-normalised (the JAX package's fallback)."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, t in enumerate(texts):
        for tok in (t or "").split():
            h = hash(tok) % (2 * dim)
            out[i, h % dim] += 1.0 if h < dim else -1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-6)


def _filled(col: np.ndarray) -> List[str]:
    """``fillna("")`` of a text column."""
    return ["" if m else v for v, m in zip(col.tolist(), isna(col))]


def _tokenized(texts: List[str]) -> List[str]:
    return [join_nouns(t) or "" for t in texts]


class ProductTextFeature:
    TEXT_COLS = ["name", "main_comment", "main_list_comment"]

    def __init__(self, product_unique_df: Frame, max_features: int = 50000):
        fields, alls = self._fields(product_unique_df)
        self._tfidf_vec = TfidfVectorizer(max_df=0.5, min_df=1, max_features=max_features)
        self._tfidf_vec.fit(_tokenized(alls))
        self._tokenized = {c: _tokenized(fields[c]) for c in self.TEXT_COLS}
        self._vecs = {c: self._tfidf_vec.transform(self._tokenized[c]) for c in self.TEXT_COLS}
        self._sentence_embedding = _sentence_embed(alls)

    @classmethod
    def _fields(cls, df: Frame):
        fields = {c: _filled(df[c]) for c in cls.TEXT_COLS}
        alls = [a + b + c for a, b, c in zip(*(fields[c] for c in cls.TEXT_COLS))]
        return fields, alls

    @property
    def name_vec(self) -> sp.csr_matrix:
        return self._vecs["name"]

    @property
    def main_comment_vec(self) -> sp.csr_matrix:
        return self._vecs["main_comment"]

    @property
    def main_list_comment_vec(self) -> sp.csr_matrix:
        return self._vecs["main_list_comment"]

    @property
    def sentence_embedding(self) -> np.ndarray:
        return self._sentence_embedding

    @property
    def tfidf_vectorizer(self) -> TfidfVectorizer:
        return self._tfidf_vec

    def update(self, new_product_unique_df: Frame) -> None:
        """The new rows vectorised with the frozen vocabulary and stacked."""
        fields, alls = self._fields(new_product_unique_df)
        for c in self.TEXT_COLS:
            tok = _tokenized(fields[c])
            self._vecs[c] = sp.vstack([self._vecs[c], self._tfidf_vec.transform(tok)]).tocsr()
            self._tokenized[c].extend(tok)
        self._sentence_embedding = np.concatenate([self._sentence_embedding, _sentence_embed(alls)], axis=0)


class ProductReviewFeature:
    TFIDF_THRESHOLD = 0.1

    def __init__(self, product_unique_df: Frame, review_info: Frame, tfidf_vec: TfidfVectorizer):
        self._n_product = len(product_unique_df)
        self._tfidf_vec = tfidf_vec
        self._review_cnt = np.zeros(self._n_product, np.int64)
        self._review_rate_total = np.zeros(self._n_product, np.float64)
        self._texts = ["" for _ in range(self._n_product)]
        self._tokenized = ["" for _ in range(self._n_product)]
        self.count_review(review_info)

    def update_info(self, n_product: int) -> None:
        if n_product > self._n_product:
            grow = n_product - self._n_product
            self._review_cnt = np.concatenate([self._review_cnt, np.zeros(grow, np.int64)])
            self._review_rate_total = np.concatenate([self._review_rate_total, np.zeros(grow)])
            self._texts.extend("" for _ in range(grow))
            self._tokenized.extend("" for _ in range(grow))
            self._n_product = n_product

    def update_feature(self, new_review_info: Frame) -> None:
        self.count_review(new_review_info)

    def count_review(self, review_df: Frame) -> None:
        comments = review_df["comment"].tolist()
        tokenized = _tokenized(comments)
        for cf_product, rate, comment, tok in zip(
            review_df["cf_product"].tolist(), review_df["recommend_level"].tolist(), comments, tokenized
        ):
            if _is_nan(cf_product):
                continue
            i = int(cf_product)
            self._review_cnt[i] += 1
            self._review_rate_total[i] += rate
            self._texts[i] += str(comment)
            self._tokenized[i] += " " + str(tok)

    def get_tfidf_vec(self) -> sp.csr_matrix:
        vec = self._tfidf_vec.transform(self._tokenized)
        vec.data = (vec.data >= self.TFIDF_THRESHOLD).astype(vec.data.dtype)
        vec.eliminate_zeros()
        return vec

    @property
    def review_cnt(self) -> np.ndarray:
        return self._review_cnt

    @property
    def review_rate_mean(self) -> np.ndarray:
        return self._review_rate_total / np.maximum(self._review_cnt, 1)
