"""Plain-text tables without pandas (io/table.py) and the loaders on
them: written as pandas' to_csv wrote them, read as the loaders' old
pandas calls read them. pandas is used here only as the yardstick."""
import os

import numpy as np
import pandas as pd
import pytest

from vilma_tpu.io import load, table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, 'example_out')


def test_estimates_round_trip_is_byte_identical(tmp_path):
    """Reading the committed example .estimates.tsv and writing it back
    reproduces every byte (float repr, True/False, header)."""
    path = os.path.join(EXAMPLE, 'example_vilma_run.estimates.tsv')
    est = table.read_table(path)
    out = tmp_path / 'e.tsv'
    table.write_tsv(str(out), est)
    with open(path) as a, open(out) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_writer_matches_pandas(tmp_path, dtype):
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal(500) * 10.0 ** rng.integers(-12, 9, 500))
    vals = np.concatenate([vals, [0.0, -0.0, 1e16, 1e-5, np.nan, np.inf]])
    cols = {'ID': np.array([f'rs{i}' for i in range(vals.size)],
                           dtype=object),
            'x': vals.astype(dtype), 'flag': vals > 0}
    table.write_tsv(str(tmp_path / 'mine.tsv'), cols)
    pd.DataFrame(cols).to_csv(tmp_path / 'pandas.tsv', sep='\t',
                              index=False)
    assert ((tmp_path / 'mine.tsv').read_text()
            == (tmp_path / 'pandas.tsv').read_text())


def test_reader_types_and_na(tmp_path):
    path = tmp_path / 't.tsv'
    path.write_text('ID A1 n x s\nrs1 A 1 0.5 a\nrs2 C 2 NA b\n'
                    'rs3 G 3 1e-3 NA\n')
    t = table.read_table(str(path))
    assert t.columns == ['ID', 'A1', 'n', 'x', 's']
    assert t.shape == (3, 5) and len(t) == 3
    assert t.n.dtype == np.int64 and t.x.dtype == np.float64
    assert np.isnan(t.x[1]) and t.ID[2] == 'rs3'
    assert isinstance(t.s[2], float) and np.isnan(t.s[2])
    assert table.read_table(str(path), usecols=['x', 'ID']).columns == [
        'x', 'ID']
    with pytest.raises(ValueError, match='missing columns'):
        table.read_table(str(path), usecols=['BETA'])


def test_schema_entries_on_example_panel():
    """The committed example schema matches its own variants in genome
    order with no flips."""
    est = table.read_table(os.path.join(
        EXAMPLE, 'example_vilma_run.estimates.tsv'))
    variants = table.Table({c: est[c] for c in load.VARIANT_COLUMNS})
    entries = list(load.matched_schema_entries(
        os.path.join(EXAMPLE, 'ld_mat', 'example_schema.schema'),
        variants, []))
    idx = np.concatenate([e['idx'] for e in entries])
    assert np.array_equal(np.sort(idx), np.arange(len(idx)))
    assert all(e['num_flipped'] == 0 for e in entries)
