"""The incremental feature-engineering pipeline on the host (port of the JAX
package's ``preprocessing/``), on numpy and scipy alone: ``frame.Frame``
stands in for pandas, ``tfidf.TfidfVectorizer`` for scikit-learn's, and the
host C++ (``csrc/host/furusato_host.cpp``, ``native.py``) carries the
Levenshtein ratio, the adjacency parser and the cuckoo build. Every class
keeps the reference's initialize-then-update protocol."""

from .artifacts import write_artifacts
from .pipeline import run_preprocessing
from .filtering import five_core, k_core, read_recbole, ten_core, write_recbole
from .categorical import (
    CategoricalFeature,
    CustomerCategoricalFeature,
    OrdinalEncoder,
    ProductCategoricalFeature,
)
from .category import CategoryInfo, ProductCategoryInfo, padded_categories
from .ids import CustomerIDInfo, ProductIDInfo, TimeProcessing, TransactionInfo, birth_year
from .numeric import CustomerNumericFeature, FeatureCounter, ProductNumericFeature
from .partner import PartnerMerge
from .text import ProductReviewFeature, ProductTextFeature, join_nouns

__all__ = [
    "write_artifacts",
    "run_preprocessing",
    "k_core",
    "five_core",
    "ten_core",
    "write_recbole",
    "read_recbole",
    "OrdinalEncoder",
    "CategoricalFeature",
    "ProductCategoricalFeature",
    "CustomerCategoricalFeature",
    "CategoryInfo",
    "ProductCategoryInfo",
    "padded_categories",
    "ProductIDInfo",
    "CustomerIDInfo",
    "TransactionInfo",
    "TimeProcessing",
    "birth_year",
    "FeatureCounter",
    "CustomerNumericFeature",
    "ProductNumericFeature",
    "PartnerMerge",
    "ProductTextFeature",
    "ProductReviewFeature",
    "join_nouns",
]
