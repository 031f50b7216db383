"""Interaction filtering and the RecBole export (port of the JAX package's
``preprocessing/filtering.py``).

- ``five_core`` / ``ten_core``: the reference README's snippets, one pass that
  keeps the items with >= k interactions, then the users with >= k over the
  item-filtered rows. ``k_core(..., iterate=True)`` repeats until no row
  drops (the JAX package's opt-in Deviation).
- RecBole atomic files: tab-separated with ``name:type`` headers (token,
  float, token_seq), ``{name}.inter`` and the optional ``.user`` / ``.item``.
  A column's type follows its kind (float -> float, int -> token, lists ->
  token_seq, else token) unless ``types`` names it; floats are written as
  ``DataFrame.to_csv`` writes them (``30.0``, NaN as an empty field).
  ``read_recbole`` reads a file back (types under ``attrs["recbole_types"]``),
  an empty token_seq field as ``""``.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np

from .frame import Frame, factorize, isna, read_csv, write_csv

__all__ = ["k_core", "five_core", "ten_core", "write_recbole", "read_recbole"]

ITEM_COL = "remap_id"
USER_COL = "customer_id"


def _keep_by_count(df: Frame, col: str, k: int) -> Frame:
    codes, uniques = factorize(df[col])
    counts = np.bincount(codes[codes >= 0], minlength=len(uniques))
    keep = codes >= 0
    keep[keep] = counts[codes[keep]] >= k
    return df.iloc(keep)


def k_core(df: Frame, k: int, *, item_col: str = ITEM_COL, user_col: str = USER_COL,
           iterate: bool = False) -> Frame:
    """The items with >= k rows, then the users with >= k of what is left;
    with ``iterate`` again until no row drops."""
    if k <= 1:
        return df
    while True:
        n = len(df)
        df = _keep_by_count(df, item_col, k)
        df = _keep_by_count(df, user_col, k)
        if not iterate or len(df) == n:
            return df


def five_core(df: Frame) -> Frame:
    return k_core(df, 5)


def ten_core(df: Frame) -> Frame:
    return k_core(df, 10)


def _recbole_type(col: np.ndarray) -> str:
    if col.dtype.kind == "f":
        return "float"
    if col.dtype.kind in "iu":
        return "token"  # ids are tokens; a numeric int column needs a types= override
    if col.dtype.kind == "O" and any(isinstance(v, (list, tuple, np.ndarray)) for v in col):
        return "token_seq"
    return "token"


def _write_atomic(df: Frame, path: str, types: Optional[Mapping[str, str]] = None) -> None:
    types = dict(types or {})
    kinds = {c: types.get(c) or _recbole_type(df[c]) for c in df.columns}
    out = df.copy()
    for c, kind in kinds.items():
        if kind == "token_seq":
            col = np.empty(len(out), dtype=object)
            col[:] = [" ".join(str(x) for x in v) if isinstance(v, (list, tuple, np.ndarray)) else str(v)
                      for v in df[c]]
            out[c] = col
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write("\t".join(f"{c}:{kinds[c]}" for c in df.columns) + "\n")
        write_csv(out, f, sep="\t", header=False)


def _table_types(types: Optional[Mapping[str, str]], table: str) -> dict:
    """A types mapping for one table: plain keys apply to every table,
    ``"table.col"`` keys to that table only."""
    out = {}
    for k, v in (types or {}).items():
        tbl, _, col = k.partition(".")
        if col:
            if tbl == table:
                out[col] = v
        else:
            out[k] = v
    return out


def write_recbole(
    out_dir: str,
    name: str,
    interactions: Frame,
    users: Optional[Frame] = None,
    items: Optional[Frame] = None,
    *,
    item_col: str = ITEM_COL,
    user_col: str = USER_COL,
    extra_inter_cols: Sequence[str] = (),
    types: Optional[Mapping[str, str]] = None,
) -> dict:
    """``{name}.inter`` (user, item and ``extra_inter_cols``), and ``.user`` /
    ``.item`` when their tables are given; returns {suffix: path}."""
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    inter = interactions[[user_col, item_col, *extra_inter_cols]].rename(
        {user_col: "user_id", item_col: "item_id"}
    )
    path = os.path.join(out_dir, f"{name}.inter")
    _write_atomic(inter, path, {"user_id": "token", "item_id": "token", **_table_types(types, "inter")})
    written["inter"] = path
    if users is not None:
        udf = users.rename({user_col: "user_id"})
        if "user_id" not in udf:
            raise ValueError(f"users frame needs a '{user_col}' or 'user_id' column")
        upath = os.path.join(out_dir, f"{name}.user")
        _write_atomic(udf, upath, {"user_id": "token", **_table_types(types, "user")})
        written["user"] = upath
    if items is not None:
        idf = items.rename({item_col: "item_id"})
        if "item_id" not in idf:
            raise ValueError(f"items frame needs a '{item_col}' or 'item_id' column")
        ipath = os.path.join(out_dir, f"{name}.item")
        _write_atomic(idf, ipath, {"item_id": "token", **_table_types(types, "item")})
        written["item"] = ipath
    return written


def read_recbole(path: str) -> Frame:
    """One atomic file, its header types under ``attrs["recbole_types"]``."""
    df = read_csv(path, sep="\t")
    types, renames = {}, {}
    for col in df.columns:
        base, _, typ = col.partition(":")
        renames[col] = base
        types[base] = typ or "token"
    df = df.rename(renames)
    for col, typ in types.items():
        if typ == "token_seq" and isna(df[col]).any():
            filled = np.empty(len(df), dtype=object)
            filled[:] = ["" if isinstance(v, float) and v != v else v for v in df[col].tolist()]
            df[col] = filled
    df.attrs["recbole_types"] = types
    return df
