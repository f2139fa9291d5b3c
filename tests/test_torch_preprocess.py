"""The port's numpy preprocess against the JAX package's pandas one: the
same raw file through both gives the same files, byte for byte (the id
mappings, the triplets, the sequences, ``train_set_sequences+``, ``stats``
and both READMEs). Three inputs, each made from a seed with numpy: integer
ids and ratings with ``::`` (``scripts/baseline_run.sh``'s format),
whitespace with no rating column, and text ids with decimal ratings and
ISO-8601 dates; rows are shuffled and timestamps tied, so the stable time
sort matters. Also a split given as fractions, ``main`` with ``--yes``,
every text timestamp format the port reads (ISO dates and times with and
without fractions, ``Z`` or an offset; slashes year first and month
first; month names; Amazon's ``03 1, 2001``) against ``pd.to_datetime``,
equal instants written differently kept in file order, the same
``ValueError`` wherever pandas refuses a column (a row that does not match
the format of the first, mixed offsets), and the refusal of a date the
port does not read.
"""

import datetime
import os

import numpy as np
import pytest

from seqrec_tpu.data import preprocess as jax_preprocess
from seqrec_tpu_torch.data import preprocess as torch_preprocess
from seqrec_tpu_torch.data.synthetic import generate_interactions

FILES = [
    "data/user_id_mapping", "data/item_id_mapping",
    "data/train_set_triplets", "data/val_set_triplets", "data/test_set_triplets",
    "data/train_set_sequences", "data/val_set_sequences", "data/test_set_sequences",
    "data/train_set_sequences+", "data/stats", "data/README", "results/README",
]


def _rows(seed):
    """(user, item, rating, time) rows, shuffled, with sparse original ids,
    timestamps tied in threes and 8 users of one row each."""
    rows = generate_interactions(n_users=90, n_items=50, min_len=2, max_len=16, seed=seed)
    rng = np.random.default_rng(seed)
    single = np.stack([np.arange(90, 98), rows[rng.integers(0, len(rows), 8), 1],
                       np.full(8, 3), rng.integers(0, rows[-1, 3], 8)], axis=1)
    rows = np.concatenate([rows, single])
    rows[:, 0] = rows[:, 0] * 7 + 1000
    rows[:, 1] = rows[:, 1] * 13 + 5
    rows[:, 3] //= 3
    return rows[rng.permutation(len(rows))]


def _write_int_colons(path, seed):
    np.savetxt(path, _rows(seed), fmt="%d", delimiter="::")


def _write_whitespace_uit(path, seed):
    rows = _rows(seed)
    rng = np.random.default_rng(seed + 1)
    gaps = [" ", "  ", "\t", " \t "]
    with open(path, "w") as f:
        for u, i, _, t in rows:
            g = [gaps[j] for j in rng.integers(0, len(gaps), 3)]
            f.write(f"{u}{g[0]}{i}{g[1]}{t}{g[2]}extra\n")


def _write_text_ids(path, seed):
    """Text ids whose code-point order is not their numeric order, ratings
    like 3.5 and 4.0, ISO-8601 dates with ties, a comma separator."""
    rows = _rows(seed)
    rng = np.random.default_rng(seed + 2)
    ratings = rng.integers(2, 11, len(rows)) / 2
    days = np.datetime64("2001-03-01T00:00:00") + rows[:, 3].astype("timedelta64[h]")
    with open(path, "w") as f:
        for (u, i, _, _), r, t in zip(rows, ratings, days):
            f.write(f"u{u % 97},it{i},{r},{str(t).replace('T', ' ')}\n")


INPUTS = {
    "int_colons_uirt": (_write_int_colons, dict(columns="uirt", sep="::")),
    "whitespace_uit": (_write_whitespace_uit, dict(columns="uit")),
    "text_ids_decimal_ratings": (_write_text_ids, dict(columns="uirt", sep=",")),
}

# text timestamps: (render a datetime, the step between two of _rows' time units); from late
# 2000, so the rows span a new year and month names, and ``_rows`` ties them in threes
TIME_TEXT = {
    "iso_date": (lambda t: t.strftime("%Y-%m-%d"), datetime.timedelta(days=1)),
    "iso_space_minutes": (lambda t: t.strftime("%Y-%m-%d %H:%M"), datetime.timedelta(hours=29, minutes=7)),
    "iso_space_seconds": (lambda t: t.strftime("%Y-%m-%d %H:%M:%S"), datetime.timedelta(hours=29, seconds=7)),
    "iso_t_seconds": (lambda t: t.strftime("%Y-%m-%dT%H:%M:%S"), datetime.timedelta(hours=29, seconds=7)),
    "iso_t_fraction": (lambda t: t.strftime("%Y-%m-%dT%H:%M:%S.%f"), datetime.timedelta(hours=1, microseconds=250)),
    "iso_t_z": (lambda t: t.strftime("%Y-%m-%dT%H:%M:%SZ"), datetime.timedelta(hours=29, seconds=7)),
    "iso_t_fraction_z": (lambda t: t.strftime("%Y-%m-%dT%H:%M:%S.%fZ"), datetime.timedelta(minutes=97, microseconds=5)),
    "iso_t_offset": (lambda t: t.strftime("%Y-%m-%dT%H:%M:%S+05:30"), datetime.timedelta(hours=29, seconds=7)),
    "year_slash": (lambda t: t.strftime("%Y/%m/%d"), datetime.timedelta(days=1)),
    "month_slash": (lambda t: t.strftime("%m/%d/%Y"), datetime.timedelta(days=1)),
    "month_slash_minutes": (lambda t: t.strftime("%m/%d/%Y %H:%M"), datetime.timedelta(hours=29, minutes=7)),
    "month_slash_seconds": (lambda t: t.strftime("%m/%d/%Y %H:%M:%S"), datetime.timedelta(hours=29, seconds=7)),
    "day_abbrev_year": (lambda t: t.strftime("%d-%b-%Y"), datetime.timedelta(days=1)),
    "abbrev_day_comma_year": (lambda t: t.strftime("%b %d, %Y"), datetime.timedelta(days=1)),
    "day_abbrev_space_year": (lambda t: t.strftime("%d %b %Y"), datetime.timedelta(days=1)),
    "amazon_review_time": (lambda t: f"{t.month:02d} {t.day}, {t.year}", datetime.timedelta(days=1)),
}


def _write_text_times(path, seed, fmt):
    """Text ids and times in the TIME_TEXT format ``fmt``, tab-separated."""
    render, step = TIME_TEXT[fmt]
    start = datetime.datetime(2000, 10, 17, 6, 30)
    with open(path, "w") as f:
        for u, i, r, t in _rows(seed):
            f.write(f"u{u}\tit{i}\t{r}\t{render(start + int(t) * step)}\n")


def _run_both(tmp_path, name, data_seed, **kwargs):
    write, flags = INPUTS[name]
    dirs = []
    for pkg, module in (("jax", jax_preprocess), ("port", torch_preprocess)):
        d = tmp_path / pkg
        d.mkdir()
        write(d / "ratings.dat", data_seed)
        dirs.append(module.preprocess(str(d / "ratings.dat"), dirname=str(d) + "/", **flags, **kwargs))
    return dirs


def _assert_same_files(want_dir, got_dir):
    for name in FILES:
        with open(os.path.join(want_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(got_dir, name), "rb") as f:
            got = f.read()
        assert got == want, name


@pytest.mark.parametrize(
    "name, kwargs",
    [
        ("int_colons_uirt", dict(min_item_pop=3, val_size=10, test_size=10)),
        ("int_colons_uirt", dict(min_user_activity=1, min_item_pop=2, val_size=10, test_size=12, seed=4)),
        ("whitespace_uit", dict(min_item_pop=4, val_size=8, test_size=9, seed=2)),
        ("text_ids_decimal_ratings", dict(min_item_pop=3, val_size=10, test_size=10, seed=3)),
        ("int_colons_uirt", dict(min_item_pop=3, val_size=0.1, test_size=0.15)),
    ],
    ids=["int_colons", "one_item_users", "whitespace_uit", "text_ids", "fraction_split"],
)
def test_files_equal_jax_byte_for_byte(tmp_path, name, kwargs):
    _assert_same_files(*_run_both(tmp_path, name, data_seed=11, **kwargs))


def test_one_item_users_reach_the_quirk(tmp_path):
    """min_user_activity=1 keeps users with one item: the sequences drop
    them except for the last user, as the JAX package does."""
    _, got = _run_both(tmp_path, "int_colons_uirt", data_seed=11, min_user_activity=1, min_item_pop=2,
                       val_size=10, test_size=12)
    triplets = np.loadtxt(os.path.join(got, "data", "train_set_triplets"), dtype=np.int64)
    users, counts = np.unique(triplets[:, 0], return_counts=True)
    with open(os.path.join(got, "data", "train_set_sequences")) as f:
        written = [int(line.split()[0]) for line in f]
    single = set(users[counts == 1].tolist())
    assert single and not (single - {users.max()}) & set(written)


def test_main_with_yes_matches_jax(tmp_path, capsys):
    argv_tail = ["--columns", "uirt", "--sep", "::", "--min_item_pop", "3", "--val_size", "10",
                 "--test_size", "10", "--yes"]
    for pkg, module in (("jax", jax_preprocess), ("port", torch_preprocess)):
        (tmp_path / pkg).mkdir()
        _write_int_colons(tmp_path / pkg / "ratings.dat", 5)
        module.main(["-f", str(tmp_path / pkg / "ratings.dat"), *argv_tail])
        assert capsys.readouterr().out.strip() == "Data ready!"
    _assert_same_files(str(tmp_path / "jax") + "/", str(tmp_path / "port") + "/")


@pytest.mark.parametrize("fmt", sorted(TIME_TEXT))
def test_time_formats_equal_jax_byte_for_byte(tmp_path, fmt):
    """Each text timestamp format through both preprocesses: pandas' one
    guessed format and the port's order the shuffled, tied rows alike (the
    month-first and month-name formats sort apart from their text)."""
    dirs = []
    for pkg, module in (("jax", jax_preprocess), ("port", torch_preprocess)):
        d = tmp_path / pkg
        d.mkdir()
        _write_text_times(d / "ratings.dat", 13, fmt)
        dirs.append(module.preprocess(str(d / "ratings.dat"), columns="uirt", sep="\t", min_item_pop=3,
                                      val_size=10, test_size=10, dirname=str(d) + "/"))
    _assert_same_files(*dirs)


@pytest.mark.parametrize(
    "times",
    [
        ["2001-03-01", "2000-12-31 10:00:00"],
        ["03/01/2001", "13/01/2001"],
        ["Mar 1, 2001", "March 2, 2001"],
        ["2001-03-01T10:00:00Z", "2001-03-01T23:59:59.5Z"],
        ["2001-03-01T10:00:00.5Z", "2001-03-01T23:59:59Z"],
        ["2001-03-01T10:00:00+02:00", "2001-03-01T10:00:00+03:00"],
        ["2001-03-01T10:00:00Z", "2001-03-01T10:00:00+00:00", "2001-03-01T09:00:00-01:00"],
    ],
    ids=["date_then_time", "day_past_12", "abbrev_then_full", "z_then_fraction", "fraction_then_none",
         "mixed_offsets", "utc_then_offset"],
)
def test_time_columns_pandas_refuses_raise_value_error(tmp_path, times):
    path = tmp_path / "ratings.tsv"
    path.write_text("".join(f"{u}\t{u + 5}\t1\t{t}\n" for u, t in enumerate(times)))
    with pytest.raises(ValueError):
        jax_preprocess.load_data(str(path), "uirt", "\t")
    with pytest.raises(ValueError):
        torch_preprocess.load_data(str(path), "uirt", "\t")


def test_equal_instants_in_other_text_keep_the_file_order(tmp_path):
    """"Z", "+00:00" and "+0000" name one instant: pandas' stable sort keeps
    such rows in file order, whatever their text's order."""
    times = ["2001-03-01T10:00:00+00:00", "2001-03-01T09:00:00Z", "2001-03-01T10:00:00Z",
             "2001-03-01T10:00:00+0000", "2001-03-01T08:59:59.5+00:00", "2001-03-01T10:00:00Z"]
    times = [t if "." in t else t.replace(":00Z", ":00.0Z").replace(":00+", ":00.0+") for t in times]
    path = tmp_path / "ratings.tsv"
    path.write_text("".join(f"{u}\t{u + 5}\t1\t{t}\n" for u, t in enumerate(times)))
    want = jax_preprocess.load_data(str(path), "uirt", "\t")["u"].tolist()
    assert torch_preprocess.load_data(str(path), "uirt", "\t")["u"].tolist() == want == [4, 1, 0, 2, 3, 5]


def test_unknown_date_format_raises(tmp_path):
    """A two-digit year, which pandas reads through dateutil and no format
    of the port reads: the refusal names the value and the formats."""
    path = tmp_path / "ratings.csv"
    path.write_text("1,2,3,03/01/01\n")
    with pytest.raises(NotImplementedError, match=r"'03/01/01'.*%Y-%m-%d, "):
        torch_preprocess.load_data(str(path), "uirt", ",")


@pytest.mark.parametrize(
    "fmt, times",
    [
        ("%Y-%m-%d", ["2001-03-01", "1999-12-31", "2001-03-01"]),
        ("%Y-%m-%d %H:%M:%S", ["2001-03-01 10:00:07", "1970-01-01 00:00:00", "2259-12-31 23:59:59"]),
        ("%Y-%m-%dT%H:%M:%S.%f", ["2001-03-01T10:00:07.5", "2001-03-01T10:00:07.123456789"]),
        ("%Y-%m-%dT%H:%M:%S%z", ["2001-03-01T10:00:07Z", "2001-03-01T09:00:00Z"]),
        ("%Y-%m-%dT%H:%M:%S%z", ["2001-03-01T10:00:07-05", "2001-03-01T09:00:00-05"]),
        ("%Y-%m-%dT%H:%M:%S.%f%z", ["2001-03-01T10:00:07.25+05:30", "2001-03-01T09:00:00.5+05:30"]),
    ],
)
def test_iso_column_at_once_equals_row_by_row(fmt, times):
    """The ISO column read at once through np.datetime64 gives each row the
    nanoseconds the row-by-row parser gives it."""
    rx = torch_preprocess._TIME_REGEXES[fmt]
    got = torch_preprocess._iso_instants(np.array(times), fmt, rx.fullmatch(times[0]))
    assert got.tolist() == [torch_preprocess._instant(rx.fullmatch(t))[0] for t in times]


@pytest.mark.parametrize(
    "fmt, times",
    [
        ("%Y-%m-%d", ["2001-03-01", "2300-01-01"]),  # past int64 nanoseconds in numpy
        ("%Y-%m-%d %H:%M", ["2001-03-01 10:00", "2001-03-01 9:00"]),  # an hour without its zero
        ("%Y-%m-%dT%H:%M:%S%z", ["2001-03-01T10:00:07Z", "2001-03-01T09:00:00+00:00"]),  # other offset text
    ],
)
def test_iso_column_numpy_cannot_read_goes_row_by_row(fmt, times):
    rx = torch_preprocess._TIME_REGEXES[fmt]
    assert torch_preprocess._iso_instants(np.array(times), fmt, rx.fullmatch(times[0])) is None
    order = np.argsort(torch_preprocess._time_order(np.array(times)), kind="stable")
    want = np.argsort([torch_preprocess._instant(rx.fullmatch(t))[0] for t in times], kind="stable")
    assert order.tolist() == want.tolist()
