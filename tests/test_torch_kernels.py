"""The port's CUDA kernel against its plain PyTorch version, on a card; and the
kernel's launch plan, which runs anywhere.

This file imports neither JAX nor the JAX package, so on a machine with a card
and no JAX it runs on its own:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py

Tolerances: inputs that are small multiples of 1/8 give exact dot products in
any summation order, so there ids and values must be equal; Gaussian inputs
give values within rtol 1e-5 / atol 1e-6 and equal ids wherever the plain
version's neighbouring values differ by more than 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from furusato_recommend_tpu_torch.ops.streaming_topk import (
    masked_topk,
    masked_topk_reference,
    plan_segments,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("b", [1, 8, 64, 512, 5000])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_plan_segments_cover_the_catalog(b, k):
    m, sms = 20000, 132
    n_seg, seg_len = plan_segments(b, m, k, sms)
    assert 1 <= n_seg <= 65535
    assert n_seg * seg_len >= m > (n_seg - 1) * seg_len  # no empty segment
    assert seg_len >= min(m, max(256, 4 * k))
    if b >= 2 * sms:  # enough rows to fill the card: one segment each
        assert n_seg == 1


def _cases():
    rng = np.random.default_rng(5)
    n, m, d = 300, 20000, 64
    exact = (
        (rng.integers(-4, 5, size=(n, d)) / 8).astype(np.float32),
        (rng.integers(-2, 3, size=(m, d)) / 8).astype(np.float32),
    )
    exact[1][1::2] = exact[1][0::2]  # every item has a twin: ties
    gauss = (  # scaled so that the sigmoid does not saturate
        (0.3 * rng.standard_normal((n, d))).astype(np.float32),
        (0.3 * rng.standard_normal((m, d))).astype(np.float32),
    )
    rows = []
    for u in range(n):
        # row 7 leaves 50 items unmasked, so -1024 entries rank at k > 50
        deg = m - 50 if u == 7 else int(rng.integers(0, 60))
        rows.append(np.sort(rng.choice(m, size=deg, replace=False)))
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    return exact, gauss, indptr, np.concatenate(rows).astype(np.int32)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    exact, gauss, indptr, indices = _cases()
    dev = torch.device("cuda")
    ip, ix = torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev)
    for kind, (u, i) in (("exact", exact), ("gauss", gauss)):
        U, I = torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev)
        for b in (1, 8, 64, 512):
            users = torch.arange(b, device=dev) % U.shape[0]
            users[0] = 7  # the densely masked row
            for k in (10, 20, 128):
                for masked in (False, True):
                    for sig in (False, True):
                        mk = (ip, ix) if masked else (None, None)
                        kv, ki = masked_topk(U, I, users, k, *mk, sigmoid=sig)
                        rv, ri = masked_topk_reference(U, I, users, k, *mk, sigmoid=sig)
                        torch.cuda.synchronize()
                        kv, ki, rv, ri = (x.cpu().numpy() for x in (kv, ki, rv, ri))
                        if kind == "exact":
                            np.testing.assert_array_equal(ki, ri)
                            np.testing.assert_array_equal(kv, rv)
                        else:
                            np.testing.assert_allclose(kv, rv, rtol=1e-5, atol=1e-6)
                            gap = np.abs(np.diff(rv, axis=1)) > 1e-5 * np.abs(rv[:, 1:])
                            sep = np.ones_like(ki, dtype=bool)
                            sep[:, 1:] &= gap
                            sep[:, :-1] &= gap
                            np.testing.assert_array_equal(ki[sep], ri[sep])
                        if masked and not sig and k == 128:
                            assert (kv[0, 50:] == -1024.0).all()
