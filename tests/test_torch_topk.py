"""The fused masked top-k: its plain version (what ``masked_topk`` runs for CPU
tensors) against the JAX package's Pallas ``streaming_topk`` in interpret
mode, ``lax.top_k``'s tie order, and the masked / sigmoid scores of the JAX
``Recommender``. The CUDA kernel itself is held against the plain version in
``test_torch_kernels.py``, on a card.

Tolerances: untied Gaussian scores agree to rtol 1e-5 (float32 sums in another
order); inputs that are small multiples of 1/8 give exact dot products, so
there values and ids must be equal, tie order included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from furusato_recommend_tpu.ops.pallas_topk import streaming_topk
from furusato_recommend_tpu_torch.ops import streaming_topk as st
from furusato_recommend_tpu_torch.ops.streaming_topk import (
    MASK_SENTINEL,
    masked_topk,
)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize(
    "b,m,d,k,tile,b_tile,sign",
    [
        (16, 1000, 32, 8, 256, 256, 1.0),  # argsort match
        (8, 130, 16, 5, 64, 256, -1.0),  # M not a tile multiple
        (19, 257, 16, 4, 64, 8, 1.0),  # B > b_tile, not a multiple
    ],
)
def test_matches_pallas_streaming_topk(b, m, d, k, tile, b_tile, sign):
    rng = np.random.default_rng(b + m)
    u = (sign * rng.standard_normal((b, d))).astype(np.float32)
    i = rng.standard_normal((m, d)).astype(np.float32)
    jv, ji = streaming_topk(jnp.asarray(u), jnp.asarray(i), k=k, tile=tile, b_tile=b_tile, interpret=True)
    before = st.launches
    tv, ti = masked_topk(_t(u), _t(i), torch.arange(b), k)
    assert st.launches == before  # CPU tensors never launch the kernel
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64
    assert tuple(ti.shape) == (b, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def _tied_inputs(seed, n=12, m=300, d=8):
    """Embeddings in multiples of 1/8 with duplicated item rows: exact dot
    products and many ties."""
    rng = np.random.default_rng(seed)
    u = (rng.integers(-3, 4, size=(n, d)) / 8).astype(np.float32)
    i = (rng.integers(-2, 3, size=(m, d)) / 8).astype(np.float32)
    i[1::3] = i[0::3][: len(i[1::3])]
    return u, i


@pytest.mark.parametrize("k", [1, 7, 40, 300])
def test_tie_order_matches_lax_top_k(k):
    u, i = _tied_inputs(k)
    s = u @ i.T  # exact
    jv, ji = jax.lax.top_k(jnp.asarray(s), k)
    tv, ti = masked_topk(_t(u), _t(i), torch.arange(u.shape[0]), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def jax_recommenders():
    from furusato_recommend_tpu.config import Config as JConfig
    from furusato_recommend_tpu.data import synthetic_dataset
    from furusato_recommend_tpu.models.registry import build_model
    from furusato_recommend_tpu.serve import Recommender

    ds = synthetic_dataset(n_users=40, m_items=60, avg_degree=8, seed=2)
    out = {}
    for name in ("mf", "lgn"):
        cfg = JConfig(model=name, latent_dim=8, n_layers=1)
        model = build_model(name, cfg, ds.graph)
        params = model.init(jax.random.PRNGKey(1))
        out[name] = (ds, Recommender(model, ds, cfg, params, use_inference_edges=False))
    return out


@pytest.mark.parametrize("name,k", [("mf", 10), ("mf", 60), ("lgn", 25)])
def test_matches_jax_recommender_topk(jax_recommenders, name, k):
    ds, rec = jax_recommenders[name]
    users = np.array([0, 3, 3, 17, 39], dtype=np.int32)
    jv, ji = rec._topk(jnp.asarray(users), rec._user_emb, rec._item_emb, rec._mask_graph, k)
    g = ds.graph
    tv, ti = masked_topk(
        _t(np.asarray(rec._user_emb)),
        _t(np.asarray(rec._item_emb)),
        _t(users),
        k,
        _t(np.asarray(g.user_pos.indptr)),
        _t(np.asarray(g.user_pos.indices)),
        sigmoid=rec.model.score_sigmoid,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    if k == 60:  # the whole catalog: train positives rank last, at exactly -1024
        deg = np.diff(np.asarray(g.user_pos.indptr))[users]
        for row, n_pos in zip(tv.numpy(), deg):
            assert (row[k - n_pos :] == MASK_SENTINEL).all()
            assert (row[: k - n_pos] > MASK_SENTINEL).all()


def test_rejects_bad_arguments():
    u, i = _tied_inputs(0, m=20)
    users = torch.arange(3)
    with pytest.raises(ValueError, match="k="):
        masked_topk(_t(u), _t(i), users, 21)  # k > M, as lax.top_k
    with pytest.raises(ValueError, match="k="):
        masked_topk(_t(u), _t(i), users, 0)
    with pytest.raises(ValueError, match="both"):
        masked_topk(_t(u), _t(i), users, 3, mask_indptr=torch.zeros(13, dtype=torch.int32))
    with pytest.raises(ValueError, match="N \\+ 1"):
        masked_topk(
            _t(u), _t(i), users, 3,
            torch.zeros(5, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
        )
    with pytest.raises(ValueError):
        masked_topk(_t(u), _t(i[:, :4]), users, 3)
