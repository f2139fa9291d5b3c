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
import tempfile

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

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


# --- raw files as pandas' reader types them (column types, NA fields, its number grammar) ---

SEPARATORS = {"comma": ",", "whitespace": r"\s+", "colons": "::"}
ALL_SEPARATORS = tuple(SEPARATORS.values())


def _line(cells, sep):
    return {",": ",", r"\s+": " \t", "::": "::"}[sep].join(cells) + "\n"


def _fullwidth(n):
    return "".join(chr(0xFF10 + int(c)) for c in str(n))


# each fault as (the cells of a row of _rows, the separators it can occur under); rng is the row's
# numpy generator, k the row's index in the file
FAULTS = {
    # float unix seconds with a fraction: pandas reads whole nanoseconds, so a second's rows tie
    "float_times_unix": (lambda u, i, r, t, k, rng: [u, i, r, f"{978300760 + (t - 40) / 7:.1f}"], ALL_SEPARATORS),
    # fractions either side of zero truncate to 0 alike
    "float_times_around_zero": (lambda u, i, r, t, k, rng: [u, i, r, f"{(t - 40) / 9:.2f}"], ALL_SEPARATORS),
    # "100_5" and "1005" are two users, full-width digits two items
    "underscore_and_fullwidth_ids": (
        lambda u, i, r, t, k, rng: [f"{u // 10}_{u % 10}" if k % 2 else str(u),
                                    _fullwidth(i) if i % 3 == 0 else str(i), r, t], ALL_SEPARATORS),
    # 2**63 and up: uint64, 1000 apart (float64's spacing there is 2048)
    "ids_past_int64": (lambda u, i, r, t, k, rng: [str(2**63 + u * 1000), i, r, t], ALL_SEPARATORS),
    # 2**64 and up: Python ints
    "ids_past_uint64": (lambda u, i, r, t, k, rng: [str(2**64 + u), i, r, t], ALL_SEPARATORS),
    # missing ratings: float64 with NaN (an empty field where the separator allows one)
    "missing_ratings": (
        lambda u, i, r, t, k, rng: [u, i, ["", "NA", "null", "nan", r, r, r][k % 7], t], (",", "::")),
    "missing_ratings_no_empty": (
        lambda u, i, r, t, k, rng: [u, i, ["NA", "null", "nan", "N/A", r, r, r][k % 7], t], ALL_SEPARATORS),
    # boolean item ids and ratings in pandas' spellings
    "bool_items_and_ratings": (
        lambda u, i, r, t, k, rng: [u, ["true", "FALSE", "True", "false", "TRUE", "False"][(i + k) % 6],
                                    ["True", "false"][k % 2], t], ALL_SEPARATORS),
    # missing times, the first row's among them: pandas guesses from the first present value, NaT last
    "missing_times": (
        lambda u, i, r, t, k, rng: [u, i, r, "NA" if k % 9 == 0 else
                                    (datetime.datetime(2001, 3, 1) + int(t) * datetime.timedelta(hours=7)).isoformat()],
        ALL_SEPARATORS),
    "missing_times_empty": (
        lambda u, i, r, t, k, rng: [u, i, r, ["", "nan", "NaT"][k % 3] if k % 7 == 0 else
                                    (datetime.datetime(2001, 3, 1) + int(t) * datetime.timedelta(hours=7)).isoformat()],
        (",", "::")),
}


def _fault_text(fault, sep, seed=17):
    render, _ = FAULTS[fault]
    rng = np.random.default_rng(seed)
    return "".join(_line([str(c) for c in render(u, i, r, t, k, rng)], sep)
                   for k, (u, i, r, t) in enumerate(_rows(seed).tolist()))


def _same_files(tmp_path, text, columns, sep, **kwargs):
    dirs = []
    for pkg, module in (("jax", jax_preprocess), ("port", torch_preprocess)):
        d = tmp_path / pkg
        d.mkdir()
        (d / "ratings.dat").write_text(text)
        dirs.append(module.preprocess(str(d / "ratings.dat"), columns=columns, sep=sep, dirname=str(d) + "/",
                                      **kwargs))
    _assert_same_files(*dirs)


FAULT_CASES = [(f, s) for f, (_, seps) in FAULTS.items() for s in SEPARATORS.values() if s in seps]


@pytest.mark.parametrize("fault, sep", FAULT_CASES,
                         ids=[f"{f}-{n}" for f, s in FAULT_CASES for n, v in SEPARATORS.items() if v == s])
def test_raw_fields_equal_jax_byte_for_byte(tmp_path, fault, sep):
    """Each way the reader once differed from pandas (float times, ids
    Python's int() reads and pandas does not, ids of 2**63 and up, NA
    fields, bools, missing times), under each separator kind where it can
    occur: the ten data files and both READMEs, byte for byte."""
    _same_files(tmp_path, _fault_text(fault, sep), "uirt", sep, min_item_pop=1, val_size=10, test_size=10)


def test_float_times_sort_by_whole_nanoseconds(tmp_path):
    """pd.to_datetime reads floats as nanoseconds truncated toward zero:
    978300760.7 and 978300760.2 tie, as do -0.5, 0.5 and -0.2."""
    for times, want in (([978300760.7, 978300760.2, 978300759.9], [2, 0, 1]), ([-0.5, 0.5, -0.2], [0, 1, 2])):
        path = tmp_path / "ratings.csv"
        path.write_text("".join(f"{u},{u + 5},1,{t}\n" for u, t in enumerate(times)))
        assert jax_preprocess.load_data(str(path), "uirt", ",")["u"].tolist() == want
        assert torch_preprocess.load_data(str(path), "uirt", ",")["u"].tolist() == want


# the seven text formats pandas reads and the port once refused, as (render, step): "%b %d %Y", points
# year first and month first, a blank before the offset, the 12-hour clock (pandas guesses it for some
# first values and reads each value alone for others), year and month, a zone name
NEW_TIME_TEXT = {
    "abbrev_day_year": (lambda t: f"{t:%b} {t.day} {t.year}", datetime.timedelta(days=1)),
    "year_point": (lambda t: t.strftime("%Y.%m.%d"), datetime.timedelta(days=1)),
    "month_point": (lambda t: t.strftime("%m.%d.%Y"), datetime.timedelta(days=1)),
    "space_offset": (lambda t: t.strftime("%Y-%m-%d %H:%M:%S +0530"), datetime.timedelta(hours=29, seconds=7)),
    "twelve_hour": (lambda t: t.strftime("%m/%d/%Y %I:%M %p"), datetime.timedelta(hours=29, minutes=7)),
    "year_month": (lambda t: f"{t.year}-{t.month:02d}", datetime.timedelta(days=3)),
    "utc_name": (lambda t: t.strftime("%Y-%m-%d %H:%M:%S UTC"), datetime.timedelta(hours=29, seconds=7)),
}
TIME_TEXT.update(NEW_TIME_TEXT)
NEW_TIME_CASES = [(f, n) for f in NEW_TIME_TEXT for n, s in SEPARATORS.items()
                  if s != r"\s+" or " " not in NEW_TIME_TEXT[f][0](datetime.datetime(2001, 3, 1))]


@pytest.mark.parametrize("fmt, sep_name", NEW_TIME_CASES, ids=[f"{f}-{n}" for f, n in NEW_TIME_CASES])
def test_new_time_formats_equal_jax_under_each_separator(tmp_path, fmt, sep_name):
    render, step = NEW_TIME_TEXT[fmt]
    start, sep = datetime.datetime(2000, 10, 17, 6, 30), SEPARATORS[sep_name]
    text = "".join(_line([f"u{u}", f"it{i}", str(r), render(start + int(t) * step)], sep)
                   for u, i, r, t in _rows(13).tolist())
    _same_files(tmp_path, text, "uirt", sep, min_item_pop=3, val_size=10, test_size=10)


@pytest.mark.parametrize(
    "times",
    [
        ["Mar 1 2001", "March 2 2001"],
        ["2001.03.01", "2001-03-02"],
        ["01.03.2001", "13.03.2001"],
        ["2001-03-01 10:00:00 +0000", "2001-03-01 09:00:00+0000"],
        ["2001-03-01 10:00:00 +0000", "2001-03-01 09:00:00 +0100"],
        ["2001-03", "2001-03-05"],
        ["2001-03-01 10:00:00 UTC", "2001-03-01 09:00:00 EST"],
        ["2001-03-01 10:00:00 UTC", "2001-03-01 09:00:00"],
        ["2001-03-01 10:00:00 GMT", "2001-03-01 09:00:00 UTC"],
        ["03/01/2001 02:00 AM", "03/01/2001 14:00"],
        ["03/01/2001 02:00 am", "03/01/2001 10:00 pm"],
        ["03/01/2001 10:00 PM", "2001-03-01T10:00:00Z"],
        ["", "2001-03-01", "03/01/2001"],
    ],
    ids=["abbrev_then_full", "point_then_dash", "month_point_day_past_12", "offset_without_blank", "two_offsets",
         "year_month_then_day", "utc_then_est", "utc_then_none", "gmt_then_utc", "twelve_hour_then_24",
         "literal_am_then_pm", "per_value_mixed_zones", "missing_first_then_off_format"],
)
def test_new_time_formats_pandas_refuses_raise_value_error(tmp_path, times):
    """Where pd.to_datetime refuses a column (a row off the guessed format,
    a zone other than UTC or GMT after a UTC row, mixed zones), both
    packages raise ValueError."""
    path = tmp_path / "ratings.tsv"
    path.write_text("".join(f"{u}\t{u + 5}\t1\t{t}\n" for u, t in enumerate(times)))
    with pytest.raises(ValueError):
        jax_preprocess.load_data(str(path), "uirt", "\t")
    with pytest.raises(ValueError):
        torch_preprocess.load_data(str(path), "uirt", "\t")


@pytest.mark.parametrize("zone", ["EST", "CET", "Europe/Paris", "utc"])
def test_a_first_zone_other_than_utc_or_gmt_is_refused(tmp_path, zone):
    """pandas refuses a first value with another zone name (ValueError);
    the port reads UTC and GMT only and says so (NotImplementedError)."""
    path = tmp_path / "ratings.tsv"
    path.write_text("".join(f"{u}\t{u + 5}\t1\t2001-03-0{u + 1} 10:00:00 {zone}\n" for u in range(2)))
    with pytest.raises(ValueError):
        jax_preprocess.load_data(str(path), "uirt", "\t")
    with pytest.raises(NotImplementedError, match=zone):
        torch_preprocess.load_data(str(path), "uirt", "\t")


@pytest.mark.parametrize("times, error", [(["true", "False"], TypeError), (["9223372036854775808", "1"], ValueError),
                                          (["18446744073709551616", "1"], ValueError)],
                         ids=["bool", "uint64", "past_uint64"])
def test_time_columns_pandas_cannot_convert_raise_as_pandas(tmp_path, times, error):
    path = tmp_path / "ratings.csv"
    path.write_text("".join(f"{u},{u + 5},1,{t}\n" for u, t in enumerate(times)))
    with pytest.raises(error):
        jax_preprocess.load_data(str(path), "uirt", ",")
    with pytest.raises(error):
        torch_preprocess.load_data(str(path), "uirt", ",")


def test_missing_ids_are_refused(tmp_path):
    """A missing user or item: pandas gives it category code -1, which the
    port does not write; it refuses the file instead."""
    path = tmp_path / "ratings.csv"
    path.write_text("1,5,1\nNA,6,1\n")
    with pytest.raises(NotImplementedError, match="missing u"):
        torch_preprocess.load_data(str(path), "uir", ",")


def test_na_strings_are_pandas_defaults():
    """The port's own copy of pandas' default NA strings (the one place a
    test holds the port to pandas itself)."""
    from pandas._libs.parsers import STR_NA_VALUES

    assert torch_preprocess.NA_VALUES == STR_NA_VALUES


# --- property: cells from a small grammar, typed and put in time order as pandas does ---

_EDGES = [2**63 - 1, 2**63, -(2**63), -(2**63) - 1, 2**64 - 1, 2**64]
_CELLS = st.one_of(
    st.integers(-30, 30).map(str),
    st.sampled_from(_EDGES).map(str),
    st.builds(lambda m, f, e: f"{m}.{f}e{e}", st.integers(-99, 99), st.integers(0, 99), st.integers(-5, 5)),
    st.builds(lambda m, f: f"{m}.{f}", st.integers(-99, 99), st.integers(0, 99)),
    st.sampled_from(["1_0", "2_5.5", "1e_2", "3E+1", "-0", ".5", "1.", "inf", "-Infinity"]),
    st.sampled_from(sorted(torch_preprocess.NA_VALUES)),
    st.sampled_from(["true", "False", "TRUE", "tRUE"]),
    st.sampled_from(["x", "u1", "１", "NaT"]),
)
_TIME_CELLS = st.one_of(_CELLS, st.integers(1, 28).map(lambda d: f"2001-03-{d:02d}"),
                        st.integers(1, 28).map(lambda d: f"Mar {d} 2001"))


def _column(draw_cells, sep):
    cells = st.lists(draw_cells, min_size=2, max_size=6)
    return cells.filter(lambda c: "" not in c) if sep == r"\s+" else cells


def _typed_as(col):
    """(dtype kind, each value's type and repr): text as "O", whatever its dtype."""
    kind = col.dtype.kind
    return "O" if kind in "OUT" else kind, [(type(v).__name__, repr(v)) for v in col.tolist()]


def _load_both(text, columns, sep):
    out = []
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ratings.dat")
        with open(path, "w") as f:
            f.write(text)
        for module in (jax_preprocess, torch_preprocess):
            try:
                out.append(module.load_data(path, columns, sep))
            except Exception as err:  # noqa: BLE001 -- the class is what is compared
                out.append(err)
    return out


@pytest.mark.parametrize("sep_name", list(SEPARATORS))
def test_columns_typed_as_pandas_property(sep_name):
    """A 2-6-row column drawn from ints, +-2**63 and 2**64 edges, floats
    (with exponents, with "_"), the NA strings, bools and text, as the
    first field of a row (where the python reader strips the line) and as
    a middle one: the same dtype and the same values as pandas' reader
    gives, or (a missing id) the port's refusal."""
    sep = SEPARATORS[sep_name]

    @settings(max_examples=200, derandomize=True, deadline=None)
    @given(_column(_CELLS, sep), st.sampled_from(["u", "r"]))
    @example(["-9223372036854775808", "NA", "1"], "r")  # the C reader: -2**63 beside NA is NaN
    @example(["tRUE", "false", "NA"], "r")  # bools in any case in the C reader only
    @example(["9223372036854775808", "1.5"], "r")  # 19 digits, rounded as pandas' parser rounds
    @example(["0.1234567890123456789", "99999999999999999999.5"], "r")  # its 17 digits
    @example(["18446744073709551616", "1_0", "NA"], "r")  # past uint64: Python ints
    @example(["18446744073709551616", "NA", "x"], "r")  # ... else text, "NA" as it is
    @example(["9223372036854775808", "NA"], "r")  # past int64 beside NA: text
    @example(["-0", "9223372036854775808"], "r")  # "-0" is negative to the C reader only
    @example(["1e400", "-1e-700", "-Infinity"], "r")
    @example(["NA", "7"], "u")
    def check(cells, name):
        rows = [[c, str(k + 5), "7"] if name == "u" else [str(k), str(k + 5), c] for k, c in enumerate(cells)]
        want, got = _load_both("".join(_line(r, sep) for r in rows), "uir", sep)
        if isinstance(got, NotImplementedError):
            assert name == "u" and any(v != v for v in want["u"].tolist() if isinstance(v, float))
        else:
            assert _typed_as(got[name]) == _typed_as(want[name])

    check()


@pytest.mark.parametrize("sep_name", list(SEPARATORS))
def test_time_columns_ordered_as_pandas_property(sep_name):
    """A 2-6-row time column from the same grammar and ISO and month-name
    dates: the same stable order as the JAX package's, the same exception
    class where it refuses the column, or the port's NotImplementedError
    (text it does not read), never an order pandas does not give."""
    sep = SEPARATORS[sep_name]

    @settings(max_examples=200, derandomize=True, deadline=None)
    @given(_column(_TIME_CELLS, sep))
    def check(cells):
        text = "".join(_line([str(k), str(k + 5), "1", c], sep) for k, c in enumerate(cells))
        want, got = _load_both(text, "uirt", sep)
        if isinstance(got, NotImplementedError):
            return
        if isinstance(want, Exception):
            kind = next(k for k in (ValueError, TypeError, Exception) if isinstance(want, k))
            assert isinstance(got, kind), (want, got)
        else:
            assert not isinstance(got, Exception), (want, got)
            assert got["u"].tolist() == want["u"].tolist()

    check()
