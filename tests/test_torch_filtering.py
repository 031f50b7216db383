"""Port vs JAX package: k-core filtering, the RecBole export and ``tools
convert-recbole`` on the CPU, on the frames of ``tests/test_filtering.py``.

Tolerances: the rows k-core keeps equal (the same positions); the atomic
files and the tool's outputs byte-equal; what ``read_recbole`` reads back
equal, types included.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from furusato_recommend_tpu import tools as jtools
from furusato_recommend_tpu.preprocessing import filtering as jfl
from furusato_recommend_tpu_torch import tools as ttools
from furusato_recommend_tpu_torch.preprocessing import filtering as tfl
from furusato_recommend_tpu_torch.preprocessing import frame as fr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _interactions(rng, n_users=40, n_items=25, n=600):
    return {
        "customer_id": rng.integers(0, n_users, n),
        "remap_id": rng.integers(0, n_items, n) ** 2 % n_items,  # skewed
    }


def _string_ids(rng, n=500):
    """Customer ids as strings with blanks: value_counts drops a missing id."""
    users = np.array([np.nan if r < 0.05 else f"c{int(r * 30)}" for r in rng.random(n)], dtype=object)
    return {"customer_id": users, "remap_id": rng.integers(0, 20, n), "rating": rng.random(n)}


def _rows(frame: fr.Frame, df: pd.DataFrame):
    """The port keeps rows by position: match them against the JAX index."""
    assert len(frame) == len(df)
    for c in df.columns:
        g, w = frame[c], df[c].to_numpy()
        assert [None if fr._is_nan(v) else v for v in g.tolist()] == \
            [None if (isinstance(v, float) and v != v) else v for v in w.tolist()], c


@pytest.mark.parametrize("case", ["five", "ten", "k4_iterate", "k1", "strings_iterate"])
def test_k_core_matches_jax(case):
    rng = np.random.default_rng({"five": 0, "ten": 1, "k4_iterate": 2, "k1": 3, "strings_iterate": 4}[case])
    cols = _string_ids(rng) if case == "strings_iterate" else _interactions(rng, n=1200 if case == "ten" else 600)
    frame, df = fr.Frame(cols), pd.DataFrame(cols)
    if case == "five":
        got, want = tfl.five_core(frame), jfl.five_core(df)
    elif case == "ten":
        got, want = tfl.ten_core(frame), jfl.ten_core(df)
    elif case == "k1":
        got, want = tfl.k_core(frame, 1), jfl.k_core(df, 1)
    else:
        got, want = tfl.k_core(frame, 4, iterate=True), jfl.k_core(df, 4, iterate=True)
        assert len(tfl.k_core(got, 4, iterate=True)) == len(got)  # a fixpoint
    _rows(got, want)


def _toy():
    inter = {"customer_id": np.array([0, 1, 1, 2]), "remap_id": np.array([5, 5, 6, 7]),
             "rating": np.array([1.0, 0.5, 1.0, 1.0]), "note": np.array(["a", "b\tc", np.nan, "d"], dtype=object)}
    users = {"customer_id": np.array([0, 1, 2]), "age": np.array([30.0, np.nan, 25.0])}
    tags = np.empty(3, dtype=object)
    tags[:] = [["x", "y"], ["y"], []]
    items = {"remap_id": np.array([5, 6, 7]), "name": np.array(["a", "b", "c"], dtype=object), "tags": tags}
    return inter, users, items


@pytest.mark.parametrize("types", [None, {"inter.rating": "float", "user.age": "token", "note": "token"}])
def test_write_recbole_bytes_match_jax(tmp_path, types):
    inter, users, items = _toy()
    kw = dict(extra_inter_cols=("rating", "note"), types=types)
    got = tfl.write_recbole(str(tmp_path / "port"), "toy", fr.Frame(inter), fr.Frame(users), fr.Frame(items), **kw)
    want = jfl.write_recbole(str(tmp_path / "jax"), "toy", pd.DataFrame(inter), pd.DataFrame(users),
                             pd.DataFrame(items), **kw)
    assert set(got) == set(want) == {"inter", "user", "item"}
    for key in want:
        with open(got[key], "rb") as g, open(want[key], "rb") as w:
            assert g.read() == w.read(), key
        back, jback = tfl.read_recbole(got[key]), jfl.read_recbole(want[key])
        assert back.attrs["recbole_types"] == jback.attrs["recbole_types"]
        _rows(back, jback)
    assert tfl.read_recbole(got["item"])["tags"].tolist() == ["x y", "y", ""]


def test_write_recbole_needs_the_id_column(tmp_path):
    inter, users, _ = _toy()
    with pytest.raises(ValueError, match="'customer_id' or 'user_id'"):
        tfl.write_recbole(str(tmp_path), "t", fr.Frame(inter), users=fr.Frame({"uid": users["customer_id"]}))


@pytest.mark.parametrize("argv", [
    ["--k_core", "5"],
    ["--k_core", "5", "--iterate", "--name", "it"],
    ["--extra_inter_cols", "rating", "--types", "rating=float", "--name", "xc"],
])
def test_convert_recbole_tool_matches_jax(tmp_path, capsys, argv):
    rng = np.random.default_rng(7)
    cols = {**_interactions(rng, n=800), "rating": rng.random(800).round(3),
            "note": np.array([f"n{i % 9}" for i in range(800)], dtype=object)}
    src = tmp_path / "inter.csv"
    pd.DataFrame(cols).to_csv(src, index=False)
    users = tmp_path / "users.csv"
    pd.DataFrame({"customer_id": np.arange(40), "age": np.arange(40) * 1.5}).to_csv(users, index=False)
    outs = {}
    for name, main in (("port", ttools.main), ("jax", jtools.main)):
        main(["convert-recbole", "--interactions", str(src), "--users", str(users),
              "--out", str(tmp_path / name), *argv])
        outs[name] = capsys.readouterr().out.replace(str(tmp_path / name), "OUT")
    assert outs["port"] == outs["jax"]
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_tools_run_without_pandas_or_sklearn(tmp_path):
    """The port's tools preprocess and convert-recbole run on CSV input to the
    end with pandas and scikit-learn unimportable, as on the card's machine."""
    from furusato_recommend_tpu_torch.preprocessing.synthetic import synthetic_raw_tables

    raw = synthetic_raw_tables(seed=2, n_customers=80, n_products=50, n_unique=40, n_partners=8,
                               n_categories=5, n_reviews=60)
    p = raw.write_csv(tmp_path / "raw")
    code = (
        "import sys; sys.modules['pandas'] = None; sys.modules['sklearn'] = None\n"
        "from furusato_recommend_tpu_torch import tools\n"
        f"p = {p!r}\n"
        "out = tools.main(['preprocess', '--products', p['products'], '--customers', p['customers'],"
        " '--transactions', p['transactions'], '--product_category', p['category'], '--partner', p['partner'],"
        f" '--reviews', p['reviews'], '--out', {str(tmp_path / 'data')!r}])\n"
        "tools.main(['convert-recbole', '--interactions', p['transactions'], '--user_col', 'customer_id',"
        f" '--item_col', 'product_id', '--k_core', '5', '--iterate', '--out', {str(tmp_path / 'rb')!r}])\n"
        "assert 'pandas' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('N_PRODUCT', out['summary']['n_product'])\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"N_PRODUCT {raw.n_unique_products}" in res.stdout
    got = tfl.read_recbole(str(tmp_path / "rb" / "furusato.inter"))
    for col in ("user_id", "item_id"):
        _, counts = np.unique(got[col].astype(str), return_counts=True)
        assert counts.min() >= 5
    assert (tmp_path / "data" / "cf" / "train.txt").exists()
    json.dumps(got.attrs["recbole_types"])
