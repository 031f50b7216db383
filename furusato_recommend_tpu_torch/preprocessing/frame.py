"""A small column table in place of pandas, which the card's machine lacks.

``Frame`` is an ordered dict of equally long 1-D numpy columns of three kinds,
the ones ``pd.read_csv`` gives for the tables this pipeline reads:

- int64;
- float64, NaN for a missing value;
- object holding ``str`` (or other Python values), NaN for a missing value.

It carries only the operations the preprocessing modules use, each with the
pandas semantics the JAX package relies on: row slicing (``iloc``),
``concat``, ``map_values`` through a dict (NaN for a miss), ``dropna``,
``unique`` in order of first appearance, ``factorize`` (``value_counts`` and
``isin`` are built on it), ``drop_duplicates`` (keep the last), ``reindex``
onto ``arange(n)`` (missing ids become all-NaN rows) and a left join that
keeps the left rows' order (``merge_left``).

``read_csv`` infers each column's kind as ``pd.read_csv`` does on these files:
integers with no blank -> int64; numbers with a blank (or a non-integer)
-> float64; an all-blank column -> float64; ``True`` / ``False`` -> bool;
otherwise strings, with pandas' default missing-value words (a blank among
them) as NaN. ``write_csv`` writes as ``DataFrame.to_csv(index=False)``:
floats by ``repr``, NaN as an empty field, through the same ``csv`` module.
``read_table`` also reads a pickled DataFrame (``.pkl``), which needs pandas:
it is imported in that branch only, and its absence raises.
"""

from __future__ import annotations

import csv
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np

__all__ = ["Frame", "isna", "unique", "factorize", "map_values", "read_csv", "write_csv", "read_table"]

# pandas' default words for a missing value (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*", re.IGNORECASE)
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


def _is_nan(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def isna(col: np.ndarray) -> np.ndarray:
    """Elementwise missing-value mask (NaN, or None in an object column)."""
    col = np.asarray(col)
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.fromiter((_is_nan(v) for v in col), dtype=bool, count=len(col))
    return np.zeros(len(col), dtype=bool)


def factorize(col: np.ndarray):
    """(codes, uniques): codes[i] indexes ``uniques`` (-1 where missing);
    ``uniques`` in order of first appearance, missing values left out."""
    col = np.asarray(col)
    if col.dtype.kind == "O":
        index: Dict = {}
        codes = np.empty(len(col), dtype=np.int64)
        for i, v in enumerate(col):
            codes[i] = -1 if _is_nan(v) else index.setdefault(v, len(index))
        return codes, np.array(list(index), dtype=object)
    ok = ~isna(col)
    codes = np.full(len(col), -1, dtype=np.int64)
    if not ok.any():
        return codes, col[:0]
    vals, first, inv = np.unique(col[ok], return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")  # sorted uniques -> first-appearance order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    codes[ok] = rank[inv.reshape(-1)]
    return codes, vals[order]


def unique(col: np.ndarray) -> list:
    """The values of ``col`` in order of first appearance, missing values left
    out (``pd.unique`` less its NaN), as Python scalars of the column's kind."""
    return list(factorize(col)[1])


def map_values(col: np.ndarray, mapping: Mapping) -> np.ndarray:
    """``Series.map(dict)`` for a dict of numbers: each value's image, NaN
    where the dict has none; int64 when every value maps to an int, else
    float64."""
    out = [mapping.get(v, np.nan) if not _is_nan(v) else np.nan for v in np.asarray(col)]
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in out):
        return np.array(out, dtype=np.int64)
    return np.array(out, dtype=np.float64)


def _as_column(values, n: Optional[int]) -> np.ndarray:
    if np.isscalar(values) or values is None:
        if n is None:
            raise ValueError("a scalar column needs a frame with rows")
        col = np.empty(n, dtype=object) if isinstance(values, str) or values is None else None
        if col is None:
            return np.full(n, values)
        col[:] = values
        return col
    col = np.asarray(values)
    if col.dtype.kind in "US":  # numpy strings become Python str in an object column
        col = col.astype(object)
    if col.ndim != 1:
        raise ValueError(f"a column must be 1-D, got shape {col.shape}")
    return col


def _with_missing(col: np.ndarray, missing: np.ndarray) -> np.ndarray:
    """``col`` with the rows of ``missing`` set to NaN, upcast as pandas does:
    ints to float64, bools to object."""
    if not missing.any():
        return col
    if col.dtype.kind in "iu":
        col = col.astype(np.float64)
    elif col.dtype.kind != "f":
        col = col.astype(object)
    else:
        col = col.copy()
    col[missing] = np.nan
    return col


def _concat_columns(cols: List[np.ndarray]) -> np.ndarray:
    kinds = {c.dtype.kind for c in cols}
    if kinds <= {"i", "u"}:
        return np.concatenate(cols).astype(np.int64)
    if kinds <= {"i", "u", "f"}:
        return np.concatenate([c.astype(np.float64) for c in cols])
    if kinds == {"b"}:
        return np.concatenate(cols)
    return np.concatenate([c.astype(object) for c in cols])


class Frame:
    """An ordered dict of equally long 1-D numpy columns (see the module)."""

    def __init__(self, columns: Optional[Mapping[str, Iterable]] = None, attrs: Optional[dict] = None):
        self._cols: Dict[str, np.ndarray] = {}
        self._n: Optional[int] = None
        for name, col in (columns or {}).items():
            self[name] = col
        self.attrs = dict(attrs or {})

    # -- shape and columns --
    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n or 0

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, key: Union[str, Sequence[str]]):
        if isinstance(key, str):
            return self._cols[key]
        return Frame({k: self._cols[k] for k in key}, self.attrs)

    def __setitem__(self, name: str, values) -> None:
        col = _as_column(values, self._n)
        if self._n is not None and len(col) != self._n:
            raise ValueError(f"column {name!r} has {len(col)} rows, the frame {self._n}")
        self._n = len(col)
        self._cols[name] = col

    def copy(self) -> "Frame":
        return Frame({k: v.copy() for k, v in self._cols.items()}, self.attrs)

    def rename(self, mapping: Mapping[str, str]) -> "Frame":
        return Frame({mapping.get(k, k): v for k, v in self._cols.items()}, self.attrs)

    # -- rows --
    def iloc(self, rows) -> "Frame":
        """Rows by position: a slice, an int array or a bool mask."""
        return Frame({k: v[rows] for k, v in self._cols.items()}, self.attrs)

    @staticmethod
    def concat(frames: Sequence["Frame"]) -> "Frame":
        """Rows of every frame in turn; a column a frame lacks is NaN there."""
        names: List[str] = []
        for f in frames:
            names.extend(c for c in f.columns if c not in names)
        out = {}
        for name in names:
            parts = [
                f[name] if name in f else np.full(len(f), np.nan) for f in frames
            ]
            out[name] = _concat_columns(parts)
        return Frame(out)

    def dropna(self, subset: Sequence[str]) -> "Frame":
        keep = np.ones(len(self), dtype=bool)
        for c in subset:
            keep &= ~isna(self._cols[c])
        return self.iloc(keep)

    def drop_duplicates(self, subset: str) -> "Frame":
        """``drop_duplicates(subset=subset, keep="last")``: the rows whose
        ``subset`` value does not recur later, in row order."""
        codes, _ = factorize(self._cols[subset])
        _, last = np.unique(codes[::-1], return_index=True)
        keep = np.zeros(len(self), dtype=bool)
        keep[len(codes) - 1 - last] = True
        return self.iloc(keep)

    def reindex(self, key: str, n: int) -> "Frame":
        """Row i is the row whose ``key`` is i, for i in [0, n); where none is,
        every column is NaN (ints become float64, as pandas upcasts)."""
        ids = np.asarray(self._cols[key])
        if len(np.unique(ids)) != len(ids):
            raise ValueError(f"cannot reindex on {key!r}: it has duplicate values")
        pos = np.full(n, -1, dtype=np.int64)
        inside = (ids >= 0) & (ids < n)
        pos[ids[inside].astype(np.int64)] = np.nonzero(inside)[0]
        missing = pos < 0
        take = np.where(missing, 0, pos)
        out = {}
        for k, v in self._cols.items():
            col = v[take] if len(v) else np.full(n, np.nan)
            out[k] = _with_missing(col, missing)
        return Frame(out, self.attrs)

    def merge_left(self, right: "Frame", on: str) -> "Frame":
        """``pd.merge(self, right, on=on, how="left")`` for a ``right`` whose
        ``on`` values are unique: the left rows in order, the right's other
        columns after the left's (NaN where a row finds no match); a name in
        both sides takes pandas' suffixes ``_x`` and ``_y``."""
        rkeys = right[on]
        index: Dict = {}
        for j, v in enumerate(rkeys):
            if v in index:
                raise ValueError(f"merge_left: {on!r} value {v!r} is not unique on the right")
            index[v] = j
        pos = np.array([index.get(v, -1) if not _is_nan(v) else -1 for v in self._cols[on]], dtype=np.int64)
        missing = pos < 0
        take = np.where(missing, 0, pos)
        both = (set(self.columns) & set(right.columns)) - {on}
        out = {(k + "_x" if k in both else k): v for k, v in self._cols.items()}
        for k in right.columns:
            if k == on:
                continue
            col = right[k][take] if len(right) else np.full(len(self), np.nan)
            out[k + "_y" if k in both else k] = _with_missing(col, missing)
        return Frame(out)


# -- CSV -----------------------------------------------------------------------


def _infer(values: Sequence[str]) -> np.ndarray:
    na = np.fromiter((v in NA_VALUES for v in values), dtype=bool, count=len(values))
    present = [v for v, m in zip(values, na) if not m]
    if not len(values):
        return np.empty(0, dtype=object)
    if not present:
        return np.full(len(values), np.nan)
    if all(_INT.fullmatch(v) for v in present):
        if not na.any():
            return np.array([int(v) for v in values], dtype=np.int64)
        return np.array([np.nan if m else float(int(v)) for v, m in zip(values, na)], dtype=np.float64)
    if all(_FLOAT.fullmatch(v) for v in present):
        return np.array([np.nan if m else float(v) for v, m in zip(values, na)], dtype=np.float64)
    if all(v in _BOOL for v in present):
        if not na.any():
            return np.array([_BOOL[v] for v in values], dtype=bool)
        return np.array([np.nan if m else _BOOL[v] for v, m in zip(values, na)], dtype=object)
    out = np.empty(len(values), dtype=object)
    out[:] = [np.nan if m else v for v, m in zip(values, na)]
    return out


def read_csv(path, sep: str = ",") -> Frame:
    """A CSV file with a header line, each column's kind inferred as
    ``pd.read_csv`` infers it (see the module); blank lines are skipped and a
    short row is padded with missing values."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if not rows:
        raise ValueError(f"{path}: no header line")
    header, body = rows[0], rows[1:]
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: duplicate column names in {header}")
    width = len(header)
    for i, r in enumerate(body):
        if len(r) > width:
            raise ValueError(f"{path}: line {i + 2} has {len(r)} fields, the header {width}")
        if len(r) < width:
            body[i] = r + [""] * (width - len(r))
    cols = list(zip(*body)) if body else [() for _ in header]
    return Frame({name: _infer(col) for name, col in zip(header, cols)})


def _cell(v) -> str:
    if _is_nan(v):
        return ""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return v if isinstance(v, str) else str(v)


def _column_cells(col: np.ndarray) -> list:
    if col.dtype.kind in "iu":
        return [str(v) for v in col.tolist()]
    if col.dtype.kind == "f":
        return ["" if v != v else repr(v) for v in col.tolist()]
    return [_cell(v) for v in col]


def write_csv(frame: Frame, path_or_file, sep: str = ",", header: bool = True) -> None:
    """``frame.to_csv(path, sep=sep, header=header, index=False)``'s bytes."""
    cols = [_column_cells(frame[c]) for c in frame.columns]

    def write(f):
        w = csv.writer(f, delimiter=sep, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        if header:
            w.writerow(frame.columns)
        w.writerows(zip(*cols))

    if hasattr(path_or_file, "write"):
        write(path_or_file)
    else:
        with open(path_or_file, "w", newline="", encoding="utf-8") as f:
            write(f)


def read_table(path) -> Optional[Frame]:
    """A table from a ``.pkl`` (a pickled DataFrame; needs pandas) or a CSV
    file; None for no path."""
    if path is None:
        return None
    if str(path).endswith(".pkl"):
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError(
                f"{path}: reading a pickled DataFrame needs pandas, which is not installed; "
                "pass the table as a CSV file"
            ) from e
        df = pd.read_pickle(path)
        return Frame({str(c): df[c].to_numpy() for c in df.columns})
    return read_csv(path)
