"""Whitespace-separated tables with the standard library and numpy.

The CLI's text formats (variant lists, sumstats, annotations, LD .var
files, the .estimates.tsv / .simgwas.tsv outputs) are plain tables. This
module reads them as the subset of pandas' `read_csv(sep=r'\\s+')` the
loaders rely on, and writes them byte-for-byte as `DataFrame.to_csv(
sep='\\t', index=False)` did.
"""
import csv

import numpy as np

# pandas' default missing-value tokens
NA_TOKENS = frozenset([
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'])


class Table:
    """Named numpy columns of equal length (the DataFrame surface the
    loaders use: `t['ID']`, `t.ID`, `t.columns`, `t.shape`, `len(t)`)."""

    def __init__(self, columns):
        object.__setattr__(self, '_cols', dict(columns))

    @property
    def columns(self):
        return list(self._cols)

    @property
    def shape(self):
        return (len(self), len(self._cols))

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name):
        return name in self._cols

    def __getitem__(self, name):
        return self._cols[name]

    def __setitem__(self, name, values):
        self._cols[name] = np.asarray(values)

    def __getattr__(self, name):
        try:
            return self._cols[name]
        except KeyError:
            raise AttributeError(name) from None

    def take(self, rows):
        """A new Table of the given rows (index array or boolean mask)."""
        return Table({k: v[rows] for k, v in self._cols.items()})

    def items(self):
        return self._cols.items()


def _column(tokens, as_str):
    """Tokens -> int64, float64 (NA tokens -> nan) or str array, as
    pandas infers them."""
    if not as_str:
        try:
            return np.array(tokens, dtype=np.int64)
        except (ValueError, OverflowError):
            pass
        try:
            return np.array([np.nan if t in NA_TOKENS else t
                             for t in tokens], dtype=np.float64)
        except ValueError:
            pass
        return np.array([np.nan if t in NA_TOKENS else t
                         for t in tokens], dtype=object)
    return np.array(tokens, dtype=object)


def read_table(path, names=None, usecols=None, nrows=None,
               str_cols=('ID', 'A1', 'A2', 'REF', 'ALT')):
    """Read a whitespace-separated table.

    names: column names for a file without a header row; otherwise the
    first row names the columns. usecols: keep only these columns (each
    must exist). nrows: read at most this many data rows. str_cols are
    kept as strings (identifiers and alleles); other columns become int
    or float where every token parses.
    """
    with open(path, 'r') as fh:
        rows = (line.split() for line in fh)
        rows = [r for r in rows if r] if nrows is None else _head(
            rows, nrows + (names is None))
    if names is None:
        if not rows:
            raise ValueError(f'{path}: empty table')
        names, rows = rows[0], rows[1:]
    width = len(names)
    for r in rows:
        if len(r) != width:
            raise ValueError(f'{path}: expected {width} fields, saw '
                             f'{len(r)}')
    keep = list(names) if usecols is None else list(usecols)
    missing = [c for c in keep if c not in names]
    if missing:
        raise ValueError(f'{path}: missing columns {missing}')
    pos = {n: i for i, n in enumerate(names)}
    return Table({c: _column([r[pos[c]] for r in rows], c in str_cols)
                  for c in keep})


def _head(rows, n):
    out = []
    for r in rows:
        if r:
            out.append(r)
            if len(out) >= n:
                break
    return out


def header(path):
    """Column names of a table's header row."""
    with open(path, 'r') as fh:
        for line in fh:
            if line.split():
                return line.split()
    return []


def _cell(value):
    if isinstance(value, (float, np.floating)):
        return '' if np.isnan(value) else str(value)
    return str(value)


def write_tsv(path, columns):
    """Write {name: column} (or a Table) tab-separated with a header row,
    formatted as pandas' to_csv formats it: shortest round-trip floats,
    NaN as an empty cell, True/False booleans."""
    items = list(columns.items())
    names = [k for k, _ in items]
    cols = [np.asarray(v) for _, v in items]
    with open(path, 'w', newline='') as fh:
        out = csv.writer(fh, delimiter='\t', lineterminator='\n')
        out.writerow(names)
        for row in zip(*cols):
            out.writerow([_cell(v) for v in row])
