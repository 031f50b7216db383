"""Port vs JAX package: ``tools preprocess`` on the same raw files, and the
port's own chain on the CPU: raw tables -> ``tools preprocess`` -> the CLI
trains TextSAGE -> ``tools evaluate``.

Tolerances: the artifact directories as in ``test_torch_preprocessing.py``
(``.npy`` equal, pickled matrices of equal pattern within rtol 1e-12, the
``cf`` text files byte-equal); the printed summaries equal.
"""

import glob
import json

import numpy as np
import pandas as pd
import pytest
import torch

from furusato_recommend_tpu import tools as jtools
from furusato_recommend_tpu.preprocessing.ids import ProductIDInfo as JProductIDInfo
from furusato_recommend_tpu_torch import tools as ttools
from furusato_recommend_tpu_torch.cli import main as cli_main
from furusato_recommend_tpu_torch.preprocessing import frame as fr
from furusato_recommend_tpu_torch.preprocessing.ids import ProductIDInfo
from furusato_recommend_tpu_torch.preprocessing.pipeline import _split
from furusato_recommend_tpu_torch.preprocessing.synthetic import synthetic_raw_tables
from test_torch_preprocessing import assert_artifacts_equal

torch.set_num_threads(1)


def _raw(tmp_path, seed=5):
    raw = synthetic_raw_tables(seed=seed, n_customers=120, n_products=80, n_unique=66, n_partners=12,
                               n_categories=7, n_reviews=100)
    paths = raw.write_csv(tmp_path / "raw")
    pkl = str(tmp_path / "raw" / "products.pkl")
    pd.read_csv(paths["products"]).to_pickle(pkl)  # the JAX chain's products come pickled
    return raw, {**paths, "products_pkl": pkl}


def _preprocess_argv(p, out, products):
    return ["preprocess", "--products", products, "--customers", p["customers"],
            "--transactions", p["transactions"], "--product_category", p["category"],
            "--partner", p["partner"], "--reviews", p["reviews"], "--out", out, "--test_holdout", "2"]


@pytest.mark.parametrize("products", ["products", "products_pkl"])
def test_tools_preprocess_matches_jax(tmp_path, capsys, products):
    raw, p = _raw(tmp_path)
    printed = {}
    for name, main in (("port", ttools.main), ("jax", jtools.main)):
        main(_preprocess_argv(p, str(tmp_path / name), p[products]))
        printed[name] = json.loads(capsys.readouterr().out)
    assert printed["port"].pop("out_dir") == str(tmp_path / "port")
    printed["jax"].pop("out_dir")
    assert printed["port"] == printed["jax"]
    assert printed["port"]["n_product"] == raw.n_unique_products
    assert printed["port"]["incremental_updates"] == 1
    assert_artifacts_equal(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.2])
def test_planted_duplicates_dedup_to_the_planted_count(frac):
    raw = synthetic_raw_tables(seed=9, n_customers=40, n_products=600, n_unique=500, n_partners=5,
                               n_categories=4, n_reviews=10)
    products = fr.Frame(raw.tables["products"])
    orig, new = _split(products, frac)
    info = ProductIDInfo(orig)
    df = pd.DataFrame(raw.tables["products"])
    jinfo = JProductIDInfo(df.iloc[: len(orig)])
    if new is not None:
        info.update(new)
        jinfo.update(df.iloc[len(orig):])
    np.testing.assert_array_equal(info._remapped_ids, jinfo._remapped_ids)
    assert info.n_product == raw.n_unique_products == 500
    names = raw.tables["products"]["name"]
    near = np.array([n.endswith("★") for n in names])
    same = np.array([n in set(names[~near][:i]) for i, n in enumerate(names)])
    assert near.any() and same.any() and "再販" in " ".join(names)


def test_chain_preprocess_train_evaluate_on_cpu(tmp_path, capsys):
    raw, p = _raw(tmp_path, seed=6)
    data = str(tmp_path / "data")
    out = ttools.main(_preprocess_argv(p, data, p["products"]))
    assert set(out["seconds"]) == {"read", "dedup", "categorical", "numeric", "text", "reviews", "categories",
                                   "write", "split"}
    ckpt_dir = tmp_path / "ckpt"
    cli_main(["--model", "textsage", "--ddp_recipe", "--recdim", "16", "--layer", "2", "--num_neighbors", "3",
              "--bpr_batch", "128", "--lr", "0.01", "--epochs", "1", "--test_span", "1", "--topks", "[5,10]",
              "--testbatch", "32", "--user_feature", "nct", "--item_feature", "nctsr", "--data_path", data,
              "--path", str(ckpt_dir), "--device", "cpu"])
    ckpts = glob.glob(str(ckpt_dir / "textsage" / "*.ckpt"))
    assert ckpts, "training left no checkpoint"
    capsys.readouterr()
    res = ttools.main(["evaluate", "--ckpt", ckpts[0], "--data_path", data, "--device", "cpu"])
    assert res["topk"].shape[0] > 0
    assert all(np.isfinite(v) for v in res["results"].values())
    assert 0.0 <= res["results"]["recall@5"] <= 1.0
