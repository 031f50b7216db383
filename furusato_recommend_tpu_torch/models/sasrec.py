"""SASRec, the sequence model (port of ``models/sasrec.py``).

- Items: each item's initial (feature) embedding, assembled per id through
  the SAGE feature machinery (``_initial_side_emb``), then the item tower:
  (L - 1) relu linears and a last linear.
- Users: a user is its item sequence (``data/sequence.py``), never its own
  features. The sequence's initial item rows, zeroed beyond its length, go
  through L pre-norm blocks: causal multi-head self-attention (``N_HEADS``)
  with a residual and relu, then a single-linear feed-forward with a
  residual, with dropout ``DROPOUT`` after the attention's output projection
  and after the feed-forward. The user's embedding is the mean of the valid
  positions. The attention masks only causally: pad positions are zero rows
  that later positions still attend to, as in the JAX package.
- Loss: BPR through ``main_loss`` plus decay x 0.5 sum of squares of the
  top-level embedding tables (parameter names with ``emb`` and no list
  index), over the number of valid rows.

The SAGE parameters it inherits (the conv layers included) stay, unused, so
the parameter trees match the JAX package's. The sequence rows and the
positive and negative items are one ``table_gather`` of the item table a
step, so its gradient is one ``scatter_add_rows`` launch; a pad slot reads
item 0 and adds an exact zero to it. The item table's text bags take one
more: their word rows' gather (``SAGE._text_bags``). On the card its
fresh-cadence training step is captured as a CUDA graph and replayed
(``train/graphed.py``): the dropout draws from the trainer's generator, the
causal attention and the gathers have static shapes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import Config
from ..data.features import FeatureStore
from ..data.graph import BipartiteGraph
from ..data.sequence import UserSequences
from ..ops.scatter import table_gather
from ..sampling.bpr import BatchShard
from .base import param_norm, row_norm
from .sage import SAGE, dropout
from .sage_convs import xavier

__all__ = ["SASRec", "N_HEADS", "DROPOUT"]

N_HEADS = 8
#: dropout after each block's attention output and feed-forward; read at
#: call time
DROPOUT = 0.2
#: users a chunk of the full propagation encodes
PROPAGATE_CHUNK = 1024


class SASRec(SAGE):
    name = "sasrec"

    def __init__(self, config: Config, graph: BipartiteGraph, features: FeatureStore,
                 sequences: UserSequences, **kw):
        super().__init__(config, graph, features, conv="sage_cat", **kw)
        self.sequences = sequences

    def _init_values(self, g: torch.Generator) -> dict:
        p = super()._init_values(g)
        d = self.dim
        p["blocks"] = [
            {"wq": xavier(g, (d, d)), "wk": xavier(g, (d, d)), "wv": xavier(g, (d, d)), "wo": xavier(g, (d, d)),
             "ln1_scale": torch.ones(d), "ln1_bias": torch.zeros(d), "ffn_w": xavier(g, (d, d)),
             "ffn_b": torch.zeros(d), "ln2_scale": torch.ones(d), "ln2_bias": torch.zeros(d)}
            for _ in range(self.n_layers)
        ]
        p["item_tower"] = [{"w": xavier(g, (d, d)), "b": torch.zeros(d)} for _ in range(max(self.n_layers - 1, 0))]
        p["item_last_w"] = xavier(g, (d, d))
        p["item_last_b"] = torch.zeros(d)
        return p

    def to(self, *args, **kwargs) -> "SASRec":
        super().to(*args, **kwargs)
        self.sequences = self.sequences.to(next(self.parameters()).device)
        return self

    # ---- the blocks ----
    @staticmethod
    def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Over the last axis, biased variance, eps 1e-5."""
        return F.layer_norm(x, x.shape[-1:], scale, bias, eps=1e-5)

    def _block(self, bp, x: torch.Tensor, generator: Optional[torch.Generator], train: bool,
               shard: Optional[BatchShard] = None) -> torch.Tensor:
        """One pre-norm block on x [B, T, d]; ``shard``: the users' share of
        a batch, for the dropout's draws."""
        b, t, d = x.shape
        drop = (generator, DROPOUT) if shard is None else (generator, DROPOUT, shard)
        h = self._layer_norm(x, bp["ln1_scale"], bp["ln1_bias"])
        q, k, v = ((h @ bp[w]).reshape(b, t, N_HEADS, d // N_HEADS).transpose(1, 2) for w in ("wq", "wk", "wv"))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)  # [B, H, T, dh]
        out = out.transpose(1, 2).reshape(b, t, d) @ bp["wo"]
        if train:
            out = dropout(out, *drop)
        x = torch.relu(x + out)
        h = self._layer_norm(x, bp["ln2_scale"], bp["ln2_bias"]) @ bp["ffn_w"] + bp["ffn_b"]
        if train:
            h = dropout(h, *drop)
        return x + h

    def _encode_sequences(self, rows: torch.Tensor, lengths: torch.Tensor,
                          generator: Optional[torch.Generator], train: bool,
                          shard: Optional[BatchShard] = None) -> torch.Tensor:
        """[B, T, d] initial rows of the users' sequences -> [B, d]: the rows
        beyond each length zeroed, the blocks, the mean of the valid
        positions."""
        valid = (torch.arange(rows.shape[1], device=rows.device)[None, :] < lengths[:, None])[..., None]
        x = torch.where(valid, rows, 0.0)
        for bp in self.blocks:
            x = self._block(bp, x, generator, train, shard)
        m = valid.to(x.dtype)
        return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)

    def forward_user(self, item_initial: torch.Tensor, users: torch.Tensor,
                     generator: Optional[torch.Generator] = None, train: bool = False) -> torch.Tensor:
        """[B] user ids -> [B, d] over their item sequences, read from the
        initial item table ``item_initial``."""
        users = users.long()
        seq = self.sequences.items[users]
        rows = table_gather(item_initial, seq.reshape(-1)).reshape(seq.shape + (-1,))
        return self._encode_sequences(rows, self.sequences.lengths[users], generator, train)

    def forward_item(self, x: torch.Tensor) -> torch.Tensor:
        for tp in self.item_tower:
            x = torch.relu(x @ tp["w"] + tp["b"])
        return x @ self.item_last_w + self.item_last_b

    def _item_initial(self) -> torch.Tensor:
        return self._initial_side_emb(torch.arange(self.m_items, device=self.item_last_w.device), "item")

    # ---- serving and evaluation ----
    def propagate(self, graph: BipartiteGraph, generator: Optional[torch.Generator] = None):
        """(user_emb [N, d], item_emb [M, d]); the users in chunks of
        ``PROPAGATE_CHUNK``. The graph is not read."""
        item_initial = self._item_initial()
        users = torch.arange(self.n_users, device=item_initial.device)
        user_emb = torch.cat([self.forward_user(item_initial, users[s : s + PROPAGATE_CHUNK])
                              for s in range(0, self.n_users, PROPAGATE_CHUNK)])
        return user_emb, self.forward_item(item_initial)

    # ---- training ----
    def loss(self, graph: BipartiteGraph, batch, generator: Optional[torch.Generator] = None):
        """BPR on (user, pos, neg) plus decay x the embedding tables' L2 over
        the number of valid rows; ``generator`` draws the dropout. The
        sequences' rows and the positives' and negatives' come through one
        ``table_gather`` of the initial item table."""
        item_initial = self._item_initial()
        users = batch.user.long()
        seq = self.sequences.items[users]
        b, t = seq.shape
        rows = table_gather(item_initial, torch.cat([seq.reshape(-1), batch.pos.long(), batch.neg.long()]))
        u = self._encode_sequences(rows[: b * t].reshape(b, t, -1), self.sequences.lengths[users], generator,
                                   train=True, shard=batch.shard)
        p = self.forward_item(rows[b * t : b * t + b])
        n = self.forward_item(rows[b * t + b :])
        bpr = self.main_loss(u, p, n, batch.valid, row_norm(batch), batch.shard)
        reg = 0.5 * sum(torch.sum(torch.square(v)) for k, v in self.named_parameters() if "emb" in k and "." not in k)
        reg = reg / param_norm(batch)
        return bpr + self.config.decay * reg, {"bpr": bpr, "reg": reg}
