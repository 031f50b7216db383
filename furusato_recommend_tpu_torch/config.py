"""Typed configuration: the port's own copy of ``furusato_recommend_tpu.config``.

Same fields, defaults, validation and JSON form as the JAX package's ``Config``,
so a config JSON written by either package reads in both; ``ddp_flagship_config``
is its flagship recipe. Fields that only the JAX package's XLA or mesh code
reads (``pipeline_dispatch``, ``compile_cache``, ``donate_params``, ``mesh``
beyond one device, ...) are kept for that round trip.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Sequence

__all__ = ["Config", "MeshConfig", "ddp_flagship_config"]

USER_FEATURE_ALPHABET = "ncwtbs"
ITEM_FEATURE_ALPHABET = "ncwtsrb"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: ``data`` shards the training batch, ``model``
    row-shards the embedding tables."""

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class Config:
    # --- model selection ---
    model: str = "lgn"
    dataset: str = "furusato"

    # --- core hyperparameters ---
    bpr_batch_size: int = 2048
    latent_dim: int = 64
    n_layers: int = 2
    lr: float = 1e-4
    decay: float = 1e-7
    dropout: bool = False
    keep_prob: float = 0.6
    num_neighbors: int = 5
    topks: Sequence[int] = (10, 20)
    epochs: int = 1000
    test_span: int = 10
    seed: int = 2020
    pretrain: bool = False
    r: float = 0.5  # rAdjGCN asymmetric-normalization exponent
    conv: str = "gcn"
    multi_relational: str = "add"
    inference: str = "all"
    train_emb: bool = False
    sample_pow: float = 0.0
    factorization: bool = False

    # --- dataset slicing flags ---
    test_mode: bool = False  # stop reading at uid == 100
    cold_start: bool = False  # uid < 10000 keep uid // 2000 train items
    for_lgbm: bool = False  # hold out lgbm_ratio / 0.7 of each user's items
    lgbm_ratio: float = 0.1
    suffix: str = ""  # dataset variant key

    # --- feature DSL ---
    user_feature: str = "ntw"
    item_feature: str = "ntw"

    # --- paths / logging ---
    path: str = "./checkpoints"
    data_path: str = "./data"
    wandb: str = ""
    tensorboard: bool = False
    comment: str = "lgn"
    load: bool = False

    # --- distributed-recipe constants ---
    negative_pow: float = 0.2
    positive_num_limit: int = 3000
    train_iterative: int = 3
    test_count: int = 100

    # --- accelerator knobs ---
    mesh: MeshConfig = field(default_factory=MeshConfig)
    ckpt_backend: str = "npz"
    param_dtype: str = "float32"
    #: SpMM operand precision: x and the edge weights are rounded to this type,
    #: the sums accumulate in float32
    compute_dtype: str = "bfloat16"
    neg_candidates: int = 4
    sample_infer_chunk: int = 512
    eval_user_batch: int = 1024
    donate_params: bool = True
    compute_auc: bool = False
    loss_fn: str = "bpr"
    infonce_temperature: float = 0.1
    feature_update_every: int = 1
    relin_every: int = 1
    pipeline_dispatch: bool = True
    compile_cache: str = ""

    def __post_init__(self):
        for f in self.user_feature:
            if f not in USER_FEATURE_ALPHABET:
                raise ValueError(
                    f"user_feature flag {f!r} not in {USER_FEATURE_ALPHABET!r}"
                )
        for f in self.item_feature:
            if f not in ITEM_FEATURE_ALPHABET:
                raise ValueError(
                    f"item_feature flag {f!r} not in {ITEM_FEATURE_ALPHABET!r}"
                )
        if self.inference not in ("all", "sample"):
            raise ValueError(f"inference must be 'all' or 'sample', got {self.inference!r}")
        if self.multi_relational not in ("add", "sum", "prod"):
            raise ValueError(f"bad multi_relational {self.multi_relational!r}")
        if self.conv not in ("gcn", "sage", "gat", "transformer", "ggnn", "mean", "light"):
            raise ValueError(f"bad conv {self.conv!r}")
        if not self.topks:
            raise ValueError("topks must be non-empty")
        if self.loss_fn not in ("bpr", "infonce"):
            raise ValueError(f"loss_fn must be 'bpr' or 'infonce', got {self.loss_fn!r}")
        if self.ckpt_backend not in ("npz", "orbax"):
            raise ValueError(f"ckpt_backend must be 'npz' or 'orbax', got {self.ckpt_backend!r}")

    @property
    def max_topk(self) -> int:
        return max(self.topks)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["topks"] = list(self.topks)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        d["topks"] = tuple(d["topks"])
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = MeshConfig(**d["mesh"])
        # ignore fields this version does not know
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        return cls(**d)


def ddp_flagship_config() -> Config:
    """The reference's DDP flagship recipe: TextSAGE, d = 32, 2 layers,
    fanout 5, batch 5000, lr 1e-3, decay 1e-6, features n / w / t, 200 epochs,
    3 x the dataset's size in samples an epoch (train with
    ``Trainer(..., ddp_recipe=True)``)."""
    return Config(
        model="textsage",
        latent_dim=32,
        n_layers=2,
        num_neighbors=5,
        bpr_batch_size=5000,
        lr=1e-3,
        decay=1e-6,
        user_feature="nwt",
        item_feature="nwt",
        epochs=200,
        train_iterative=3,
        positive_num_limit=3000,
        negative_pow=0.2,
    )
