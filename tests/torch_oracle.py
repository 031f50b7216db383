"""Clean-room torch reference oracles.

Torch implementations of the reference's *math*, re-derived from reading the
reference sources (no code copied), used as quality anchors:

- MF / LightGCN: embedding tables + BPR softplus + ego-L2
  (`/root/reference/model/MF.py:35-112`), sym-normalized propagation + layer
  mean (`/root/reference/model/MF.py:178-217`).
- TextSAGE: the DDP flagship's n/w/t feature projections, mean-aggregation
  conv W[cat(self, aggr)], BPR + whole-param L2, fanout-tree training +
  full-graph mean inference (`/root/reference/ddp.py:355-560,628-671`).
- DDP epoch sampler distribution: capped weighted positives + pop^NEGATIVE_POW
  rejection negatives (`/root/reference/ddp.py:674-706`).

Consumers: tests/test_parity_torch.py (mid-scale parity) and
benchmarks/anchor20k.py (20k x 10k flagship-scale anchor, round-4 verdict #1).
"""

from __future__ import annotations

import numpy as np
import torch


def np_feats(feats):
    return {
        "numeric": np.asarray(feats.numeric, np.float32),
        "w2v": np.asarray(feats.word2vec, np.float32),
        "text": np.asarray(feats.text),  # [N, 3, W] -1-padded word ids
    }


class TorchTextSAGE(torch.nn.Module):
    def __init__(self, uf, itf, dim, vocab, seed):
        super().__init__()
        torch.manual_seed(seed)
        self.dim, self.wd = dim, dim // 2
        self.word_emb = torch.nn.Embedding(vocab, self.wd)
        torch.nn.init.xavier_uniform_(self.word_emb.weight)
        in_u = dim + 3 * self.wd + uf["w2v"].shape[1]
        in_i = dim + 3 * self.wd + itf["w2v"].shape[1]
        self.un = torch.nn.Linear(uf["numeric"].shape[1], dim)
        self.itn = torch.nn.Linear(itf["numeric"].shape[1], dim)
        self.uproj = torch.nn.Linear(in_u, dim)
        self.iproj = torch.nn.Linear(in_i, dim)
        self.ws = torch.nn.ModuleList(
            [torch.nn.Linear(2 * dim, dim) for _ in range(2)]
        )
        gain = torch.nn.init.calculate_gain("relu")
        for lin in [self.un, self.itn, self.uproj, self.iproj]:
            torch.nn.init.xavier_uniform_(lin.weight)
            torch.nn.init.zeros_(lin.bias)
        for i, w in enumerate(self.ws):
            torch.nn.init.xavier_uniform_(w.weight, gain=1.0 if i == 1 else gain)
            torch.nn.init.zeros_(w.bias)
        self.uf, self.itf = uf, itf

    def _text(self, feats, ids):
        t = torch.from_numpy(feats["text"][ids])  # [B, 3, W]
        mask = (t >= 0).float().unsqueeze(-1)
        emb = self.word_emb(t.clamp(min=0).long()) * mask
        bags = emb.sum(-2) / mask.sum(-2).clamp(min=1.0)  # [B, 3, wd]
        return bags.reshape(len(ids), -1)

    def initial(self, side, ids):
        f = self.uf if side == "user" else self.itf
        lin = self.un if side == "user" else self.itn
        proj = self.uproj if side == "user" else self.iproj
        parts = [
            lin(torch.from_numpy(f["numeric"][ids])),
            self._text(f, ids),
            torch.from_numpy(f["w2v"][ids]),
        ]
        return proj(torch.cat(parts, dim=1))


def make_encoder(model, rng, up_ptr, up_idx, ip_ptr, ip_idx, F, L, dropout=0.0):
    """Fanout-tree encoder (the reference DDP's neighbor-sampled train-time
    forward, `/root/reference/ddp.py:470-560`): uniform fanout-F trees of depth
    L, mean aggregation, relu on all but the last conv.

    dropout: the reference applies Dropout(0.2) to source messages
    (`/root/reference/ddp.py:195,544`); default 0.0 here (the historical
    oracle behavior — it descends faster per epoch but reaches the same
    loss->recall frontier, see PERF.md "anchor" section; pass 0.2 for the
    exact reference recipe)."""

    def fanout(ptr, idx, nodes):
        deg = ptr[nodes + 1] - ptr[nodes]
        r = rng.integers(0, 1 << 30, (len(nodes), F)) % np.maximum(deg, 1)[:, None]
        out = idx[np.clip(ptr[nodes][:, None] + r, 0, len(idx) - 1)]
        return out, deg > 0

    def encode(seeds, side):
        sides = [side]
        for _ in range(L):
            sides.append("item" if sides[-1] == "user" else "user")
        levels, valids = [seeds], [None]
        for lvl in range(L):
            ptr, idx = (up_ptr, up_idx) if sides[lvl] == "user" else (ip_ptr, ip_idx)
            flat = levels[-1].reshape(-1)
            nbr, has = fanout(ptr, idx, flat)
            levels.append(nbr.reshape(levels[-1].shape + (F,)))
            valids.append(has.reshape(levels[-2].shape))
        xs = [model.initial(sides[i], lvl.reshape(-1)).reshape(lvl.shape + (-1,))
              for i, lvl in enumerate(levels)]
        for i in range(L):
            new_xs = []
            for lvl in range(L - i):
                nbr_x = xs[lvl + 1]
                if dropout > 0.0:
                    keep = torch.from_numpy(
                        (rng.random(nbr_x.shape) >= dropout).astype(np.float32)
                    )
                    nbr_x = nbr_x * keep / (1.0 - dropout)
                aggr = nbr_x.mean(dim=-2)
                aggr = aggr * torch.from_numpy(valids[lvl + 1]).float().reshape(
                    aggr.shape[:-1] + (1,)
                )
                h = model.ws[i](torch.cat([xs[lvl], aggr], dim=-1))
                if i != L - 1:
                    h = h.relu()
                new_xs.append(h)
            xs = new_xs
        return xs[0]

    return encode


def textsage_full_embeddings(model, up_ptr, up_idx, ip_ptr, ip_idx, n, m, L):
    """Full-graph mean inference (reference getUsersRating shape,
    `/root/reference/ddp.py:628-671`). Returns (user_emb, item_emb) tensors."""
    with torch.no_grad():
        ux = model.initial("user", np.arange(n))
        ix = model.initial("item", np.arange(m))
        deg_u = np.maximum(up_ptr[1:] - up_ptr[:-1], 1)
        deg_i = np.maximum(ip_ptr[1:] - ip_ptr[:-1], 1)
        u_rows = torch.from_numpy(np.repeat(np.arange(n), up_ptr[1:] - up_ptr[:-1]))
        i_rows = torch.from_numpy(np.repeat(np.arange(m), ip_ptr[1:] - ip_ptr[:-1]))
        for i in range(L):
            ua = torch.zeros_like(ux).index_add_(0, u_rows, ix[up_idx]) / (
                torch.from_numpy(deg_u).float().unsqueeze(1)
            )
            ia = torch.zeros_like(ix).index_add_(0, i_rows, ux[ip_idx]) / (
                torch.from_numpy(deg_i).float().unsqueeze(1)
            )
            nu = model.ws[i](torch.cat([ux, ua], dim=1))
            ni = model.ws[i](torch.cat([ix, ia], dim=1))
            if i != L - 1:
                nu, ni = nu.relu(), ni.relu()
            ux, ix = nu, ni
    return ux, ix


def eval_full(score_chunk_fn, ds, ks=(10,), chunk=2048):
    """Mean recall@k / ndcg@k over test users — the reference metric formulas
    (`/root/reference/metric.py:60-72,84-103`: recall = hits/|test_u|, binary
    NDCG with ideal DCG over min(k, |test_u|)), computed host-side in chunks so
    the [n_users, m_items] score matrix never materializes whole."""
    ap, td = ds.all_pos(), ds.test_dict()
    users = np.array(sorted(td.keys()))
    kmax = max(ks)
    disc = 1.0 / np.log2(np.arange(2, kmax + 2))
    cum = np.concatenate([[0.0], np.cumsum(disc)])
    out = {f"recall@{k}": 0.0 for k in ks}
    out.update({f"ndcg@{k}": 0.0 for k in ks})
    for lo in range(0, len(users), chunk):
        uu = users[lo : lo + chunk]
        S = np.asarray(score_chunk_fn(uu), np.float32).copy()
        for r, u in enumerate(uu):
            S[r, ap[u]] = -np.inf
        top = np.argpartition(-S, kmax, axis=1)[:, :kmax]
        order = np.argsort(-np.take_along_axis(S, top, 1), axis=1, kind="stable")
        top = np.take_along_axis(top, order, 1)
        for r, u in enumerate(uu):
            ts = set(td[u].tolist())
            hits = np.fromiter((1.0 if t in ts else 0.0 for t in top[r]), float, kmax)
            for k in ks:
                out[f"recall@{k}"] += hits[:k].sum() / len(ts)
                idcg = cum[min(len(ts), k)]
                out[f"ndcg@{k}"] += (hits[:k] * disc[:k]).sum() / (idcg or 1.0)
    return {key: v / len(users) for key, v in out.items()}


class DDPSamplerNp:
    """Numpy realization of the reference DDP epoch sampler's distribution
    (`/root/reference/ddp.py:674-706`): positives from the per-item-capped
    weighted edge distribution (POSITIVE_NUM_LIMIT), negatives from
    pop^NEGATIVE_POW with full rejection against the user's positives."""

    def __init__(self, ds, samples_per_epoch, positive_num_limit, negative_pow):
        from furusato_recommend_tpu.sampling.weights import (
            capped_positive_edge_weights,
            popularity_negative_weights,
        )

        order = np.lexsort((ds.train_item, ds.train_user))
        self.eu = ds.train_user[order].astype(np.int64)
        self.ei = ds.train_item[order].astype(np.int64)
        w = capped_positive_edge_weights(ds, samples_per_epoch, positive_num_limit)
        self.pe = w / w.sum()
        nw = popularity_negative_weights(ds, negative_pow)
        self.pn = nw / nw.sum()
        self.m = ds.m_items
        self.key_sorted = self.eu * self.m + self.ei  # ascending (CSR order)
        self.S = samples_per_epoch

    def sample(self, rng):
        e = rng.choice(len(self.pe), size=self.S, p=self.pe)
        u, p = self.eu[e], self.ei[e]
        neg = rng.choice(self.m, size=self.S, p=self.pn)
        for _ in range(64):
            q = u * self.m + neg
            j = np.minimum(np.searchsorted(self.key_sorted, q), len(self.key_sorted) - 1)
            bad = self.key_sorted[j] == q
            if not bad.any():
                break
            neg[bad] = rng.choice(self.m, size=int(bad.sum()), p=self.pn)
        return u, p, neg


def run_textsage(
    ds,
    fu,
    fi,
    vocab,
    *,
    epochs,
    dim,
    lr,
    seed=0,
    decay=1e-6,
    bs=128,
    F=3,
    L=2,
    sampler: DDPSamplerNp | None = None,
    ks=(10,),
    eval_every=None,
    record=None,
    accum_chunk=None,
    dropout=0.0,
):
    """Train the clean-room torch TextSAGE; returns final eval metrics.

    sampler=None draws uniform BPR triplets via the native CPU sampler (the
    single-GPU recipe); a DDPSamplerNp runs the flagship's weighted recipe.
    ``record(epoch, metrics, loss)`` fires every ``eval_every`` epochs.
    ``accum_chunk`` bounds tree memory: each optimizer step's batch gradient is
    accumulated over sub-chunks (mathematically identical — the BPR loss is a
    mean over the batch and the L2 term is batch-independent).
    """
    rng = np.random.default_rng(seed)
    model = TorchTextSAGE(fu, fi, dim, vocab, seed)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    g = ds.graph
    up_ptr = np.asarray(g.user_pos.indptr, np.int64)
    up_idx = np.asarray(g.user_pos.indices, np.int64)
    ip_ptr = np.asarray(g.item_pos.indptr, np.int64)
    ip_idx = np.asarray(g.item_pos.indices, np.int64)
    n, m = ds.n_users, ds.m_items
    encode = make_encoder(model, rng, up_ptr, up_idx, ip_ptr, ip_idx, F, L, dropout=dropout)

    def evaluate():
        ux, ix = textsage_full_embeddings(model, up_ptr, up_idx, ip_ptr, ip_idx, n, m, L)
        ixT = ix.numpy().T

        def score(uu):
            return ux.numpy()[uu] @ ixT

        return eval_full(score, ds, ks=ks)

    metrics = None
    for ep in range(epochs):
        if sampler is None:
            from furusato_recommend_tpu.preprocessing.native import bpr_sample_cpu

            u, p, ng = bpr_sample_cpu(
                up_ptr, up_idx, n, m, ds.train_size, seed=seed * 997 + ep
            )
        else:
            u, p, ng = sampler.sample(rng)
        last_loss = 0.0
        for lo in range(0, len(u), bs):
            B = len(u[lo : lo + bs])
            ch = accum_chunk or B
            opt.zero_grad()
            total = 0.0
            for clo in range(lo, lo + B, ch):
                chi = min(clo + ch, lo + B)
                ue = encode(u[clo:chi], "user")
                pe = encode(p[clo:chi], "item")
                ne = encode(ng[clo:chi], "item")
                part = (
                    torch.nn.functional.softplus(
                        (ue * ne).sum(1) - (ue * pe).sum(1)
                    ).sum()
                    / B
                )
                part.backward()
                total += float(part.detach())
            reg = decay * sum(0.5 * (q**2).sum() for q in model.parameters()) / B
            reg.backward()
            opt.step()
            last_loss = total + float(reg.detach())
        if eval_every and ((ep + 1) % eval_every == 0 or ep + 1 == epochs):
            metrics = evaluate()
            if record is not None:
                record(ep + 1, metrics, last_loss)
    if metrics is None or not eval_every:
        metrics = evaluate()
    return metrics


class TorchSASRec(torch.nn.Module):
    """Clean-room SASRec (`/root/reference/model/sasrec.py:55-500`): item
    representations from the n/w/t feature encoder, pre-norm causal MHA blocks
    with residual+relu and single-linear FFN (oneblock, :385-397), user repr =
    mean over valid positions (:399-413), item tower (L-1) relu linears + proj
    (:415-421), L2 over 'emb'-named params only (:428-432)."""

    def __init__(self, itf, dim, vocab, n_layers, seed, dropout=0.2):
        super().__init__()
        torch.manual_seed(seed)
        self.dim, self.wd, self.L, self.p = dim, dim // 2, n_layers, dropout
        self.word_emb = torch.nn.Embedding(vocab, self.wd)
        torch.nn.init.xavier_uniform_(self.word_emb.weight)
        self.itn = torch.nn.Linear(itf["numeric"].shape[1], dim)
        self.iproj = torch.nn.Linear(dim + 3 * self.wd + itf["w2v"].shape[1], dim)
        for lin in (self.itn, self.iproj):
            torch.nn.init.xavier_uniform_(lin.weight)
            torch.nn.init.zeros_(lin.bias)
        self.attn_norms = torch.nn.ModuleList(
            [torch.nn.LayerNorm(dim) for _ in range(n_layers)]
        )
        self.attns = torch.nn.ModuleList(
            [torch.nn.MultiheadAttention(dim, 8, batch_first=True) for _ in range(n_layers)]
        )
        self.ffn_norms = torch.nn.ModuleList(
            [torch.nn.LayerNorm(dim) for _ in range(n_layers)]
        )
        self.ffns = torch.nn.ModuleList(
            [torch.nn.Linear(dim, dim) for _ in range(n_layers)]
        )
        self.item_tower = torch.nn.ModuleList(
            [torch.nn.Linear(dim, dim) for _ in range(max(n_layers - 1, 0))]
        )
        self.item_last = torch.nn.Linear(dim, dim)
        self.itf = itf

    def initial_item(self, ids):
        t = torch.from_numpy(self.itf["text"][ids])
        mask = (t >= 0).float().unsqueeze(-1)
        emb = self.word_emb(t.clamp(min=0).long()) * mask
        bags = emb.sum(-2) / mask.sum(-2).clamp(min=1.0)
        parts = [
            self.itn(torch.from_numpy(self.itf["numeric"][ids])),
            bags.reshape(len(ids), -1),
            torch.from_numpy(self.itf["w2v"][ids]),
        ]
        return self.iproj(torch.cat(parts, dim=1))

    def forward_user(self, item_initial, seq, lengths):
        B, T = seq.shape
        x = item_initial[torch.from_numpy(seq).long()]  # [B, T, d]
        valid = torch.arange(T)[None, :] < torch.from_numpy(lengths)[:, None]
        x = x * valid[..., None].float()
        attn_mask = torch.triu(torch.full((T, T), float("-inf")), diagonal=1)
        for i in range(self.L):
            init_x = x
            h = self.attn_norms[i](x)
            a, _ = self.attns[i](h, h, h, attn_mask=attn_mask, need_weights=False)
            a = torch.nn.functional.dropout(a, self.p, self.training)
            x = (init_x + a).relu()
            init_x = x
            h = self.ffns[i](self.ffn_norms[i](x))
            x = init_x + torch.nn.functional.dropout(h, self.p, self.training)
        m = valid[..., None].float()
        return (x * m).sum(1) / m.sum(1).clamp(min=1.0)

    def forward_item(self, x):
        for lin in self.item_tower:
            x = lin(x).relu()
        return self.item_last(x)


def run_sasrec(
    ds,
    fi,
    vocab,
    seq_items,
    seq_lengths,
    *,
    epochs,
    dim,
    lr,
    seed=0,
    decay=1e-6,
    bs=128,
    L=2,
    ks=(10,),
    eval_every=0,
    record=None,
):
    """Train the clean-room torch SASRec; returns final eval metrics.
    eval_every/record mirror run_textsage: evaluate every N epochs and call
    record(epoch, metrics, last_loss) (the 20k anchor's curve hook)."""
    from furusato_recommend_tpu.preprocessing.native import bpr_sample_cpu

    model = TorchSASRec(fi, dim, vocab, L, seed)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    g = ds.graph
    up_ptr = np.asarray(g.user_pos.indptr, np.int64)
    up_idx = np.asarray(g.user_pos.indices, np.int64)
    n, m = ds.n_users, ds.m_items

    def evaluate():
        model.eval()
        with torch.no_grad():
            item_initial = model.initial_item(np.arange(m))
            ix = model.forward_item(item_initial).numpy()
            ux = np.zeros((n, dim), np.float32)
            for lo in range(0, n, 512):
                hi = min(lo + 512, n)
                ux[lo:hi] = model.forward_user(
                    item_initial, seq_items[lo:hi], seq_lengths[lo:hi]
                ).numpy()
        model.train()

        def score(uu):
            return ux[uu] @ ix.T

        return eval_full(score, ds, ks=ks)

    metrics, last_loss = None, 0.0
    model.train()
    for ep in range(epochs):
        u, p, ng = bpr_sample_cpu(up_ptr, up_idx, n, m, ds.train_size, seed=seed * 991 + ep)
        for lo in range(0, len(u), bs):
            uu, pp, nn_ = u[lo : lo + bs], p[lo : lo + bs], ng[lo : lo + bs]
            item_initial = model.initial_item(np.arange(m))
            ue = model.forward_user(item_initial, seq_items[uu], seq_lengths[uu])
            pe = model.forward_item(item_initial[torch.from_numpy(pp).long()])
            ne = model.forward_item(item_initial[torch.from_numpy(nn_).long()])
            loss = torch.nn.functional.softplus(
                (ue * ne).sum(1) - (ue * pe).sum(1)
            ).mean()
            reg = sum(
                0.5 * (v**2).sum()
                for k_, v in model.named_parameters()
                if "emb" in k_
            ) / len(uu)
            loss = loss + decay * reg
            opt.zero_grad()
            loss.backward()
            opt.step()
            last_loss = float(loss.detach())
        if eval_every and ((ep + 1) % eval_every == 0 or ep + 1 == epochs):
            metrics = evaluate()
            if record is not None:
                record(ep + 1, metrics, last_loss)
    if metrics is None or not eval_every:
        metrics = evaluate()
    return metrics


def run_mf_lgn(
    ds,
    model_name,
    *,
    epochs,
    dim,
    lr,
    seed=0,
    decay=1e-7,
    bs=256,
    ks=(10,),
    eval_every=None,
    record=None,
):
    """Train the clean-room torch MF / LightGCN; returns final eval metrics."""
    from furusato_recommend_tpu.preprocessing.native import bpr_sample_cpu

    torch.manual_seed(seed)
    n, m = ds.n_users, ds.m_items
    user_emb = torch.nn.Embedding(n, dim)
    item_emb = torch.nn.Embedding(m, dim)
    # match each model's init: MF uses torch Embedding's default N(0,1)
    # (reference MF.py), LightGCN uses normal(std=0.1) (reference MF.py:131-135)
    std = 1.0 if model_name == "mf" else 0.1
    torch.nn.init.normal_(user_emb.weight, std=std)
    torch.nn.init.normal_(item_emb.weight, std=std)
    opt = torch.optim.Adam(list(user_emb.parameters()) + list(item_emb.parameters()), lr=lr)

    g = ds.graph
    indptr = np.asarray(g.user_pos.indptr, np.int64)
    indices = np.asarray(g.user_pos.indices, np.int64)

    if model_name == "lgn":
        src = np.asarray(g.norm_edges.src)
        dst = np.asarray(g.norm_edges.dst)
        w = np.asarray(g.norm_edges.weight)
        A = torch.sparse_coo_tensor(
            torch.tensor(np.stack([dst, src])), torch.tensor(w), (n + m, n + m)
        ).coalesce()

    def embeddings():
        if model_name == "mf":
            return user_emb.weight, item_emb.weight
        x = torch.cat([user_emb.weight, item_emb.weight], 0)
        acc, h = x, x
        for _ in range(2):
            h = torch.sparse.mm(A, h)
            acc = acc + h
        out = acc / 3
        return out[:n], out[n:]

    def evaluate():
        with torch.no_grad():
            U, I = embeddings()
            Un, InT = U.numpy(), I.numpy().T

        def score(uu):
            return Un[uu] @ InT

        return eval_full(score, ds, ks=ks)

    metrics = None
    for ep in range(epochs):
        u, p, ng = bpr_sample_cpu(indptr, indices, n, m, ds.train_size, seed=seed * 1000 + ep)
        last_loss = 0.0
        for lo in range(0, len(u), bs):
            uu = torch.tensor(u[lo : lo + bs])
            pp = torch.tensor(p[lo : lo + bs])
            nn_ = torch.tensor(ng[lo : lo + bs])
            U, I = embeddings()
            ue, pe, ne = U[uu], I[pp], I[nn_]
            loss = torch.nn.functional.softplus(
                (ue * ne).sum(1) - (ue * pe).sum(1)
            ).mean()
            u0, p0, n0 = user_emb(uu), item_emb(pp), item_emb(nn_)
            reg = 0.5 * (u0.norm() ** 2 + p0.norm() ** 2 + n0.norm() ** 2) / len(uu)
            loss = loss + decay * reg
            opt.zero_grad()
            loss.backward()
            opt.step()
            last_loss = float(loss)
        if eval_every and ((ep + 1) % eval_every == 0 or ep + 1 == epochs):
            metrics = evaluate()
            if record is not None:
                record(ep + 1, metrics, last_loss)
    if metrics is None or not eval_every:
        metrics = evaluate()
    return metrics


class OptaxAdam:
    """``optax.adam(lr)``'s update rule (``scale_by_adam``, then -lr) in
    float64 numpy, one ``step(grads)`` at a time over a list of parameter
    arrays: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, and
    p -= lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps).
    Consumers: tests/test_torch_graphed.py holds it against optax,
    tests/test_torch_kernels.py holds the card's Adam against it."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params = [np.array(p, np.float64) for p in params]
        self.mu = [np.zeros_like(p) for p in self.params]
        self.nu = [np.zeros_like(p) for p in self.params]
        self.count = 0
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def step(self, grads) -> None:
        self.count += 1
        c1, c2 = 1.0 - self.b1**self.count, 1.0 - self.b2**self.count
        for i, g in enumerate(grads):
            g = np.asarray(g, np.float64)
            self.mu[i] = self.b1 * self.mu[i] + (1.0 - self.b1) * g
            self.nu[i] = self.b2 * self.nu[i] + (1.0 - self.b2) * g * g
            self.params[i] = self.params[i] - self.lr * (self.mu[i] / c1) / (np.sqrt(self.nu[i] / c2) + self.eps)
