"""CSV → canonical dataset directory, with numpy only (no pandas).

    python -m seqrec_tpu_torch.data.preprocess -f DIR/ratings.dat --columns uirt --sep :: --yes

Counterpart of ``seqrec_tpu/data/preprocess.py``, with the same flags, the
same ``preprocess()`` and ``main()``, and the same files, byte for byte:
``data/{user,item}_id_mapping``, ``data/{train,val,test}_set_triplets``,
``data/{train,val,test}_set_sequences``, ``data/train_set_sequences+``,
``data/stats``, ``data/README`` and ``results/README``. What the JAX
package leaves to pandas is done here as pandas does it:

- the first ``len(columns)`` columns are read (``\\s+``: whitespace; one
  character: a CSV field separator with quotes; longer: a regular
  expression); a column of integers stays integers, one of numbers
  floats, any other text; rating 1 where there is no ``r``;
- rows are put in time order by a stable sort of ``t``: numbers as they
  are (pandas reads integers as unix seconds and floats as nanoseconds,
  which keeps their order); text as ``pd.to_datetime`` reads it: one
  format of ``TIME_FORMATS`` guessed from the first value, month first
  (``dayfirst=False``: a day-first format only where the month-first one
  cannot read it; a full month name before an abbreviated one), every row
  parsed with it and sorted by its instant; a row the format does not
  read, or offsets from UTC that differ between rows, raise
  ``ValueError``; a first value no format reads raises
  ``NotImplementedError``;
- users, then items, then users again with too few rows are removed;
- ids become their rank among the sorted distinct ids (numeric order for
  numbers, code-point order for text), as pandas' category codes;
- the test users, then the validation users are drawn with
  ``Generator.choice(..., replace=False)`` from the users in order of
  first appearance (pandas' ``unique()``), from one
  ``np.random.default_rng(seed)``;
- numbers are written as ``to_csv`` writes them: ``4`` for an integer
  column, the shortest round-trip text (``4.5``, ``4.0``) for a float one.
"""

from __future__ import annotations

import argparse
import csv
import datetime
import os
import re
import sys
from shutil import copyfile

import numpy as np


def command_parser(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-f", dest="filename", help="Input file", required=True, type=str)
    parser.add_argument(
        "--columns",
        help='Order of the columns in the file (eg: "uirt"), u=user, i=item, '
        "t=timestamp, r=rating. Missing r ⇒ rating 1; missing t ⇒ input order is "
        "chronological. Extra columns ignored. Default: uit",
        default="uit",
        type=str,
    )
    parser.add_argument(
        "--sep",
        help="Column separator (a regular expression when longer than one character).",
        default=r"\s+",
        type=str,
    )
    parser.add_argument(
        "--min_user_activity",
        help="Users with fewer interactions are removed. Default: 2",
        default=2,
        type=int,
    )
    parser.add_argument(
        "--min_item_pop",
        help="Items with fewer interactions are removed. Default: 5",
        default=5,
        type=int,
    )
    parser.add_argument(
        "--val_size",
        help="Users in the validation set; (0,1) means a fraction. Default: 0.1",
        default=0.1,
        type=float,
    )
    parser.add_argument(
        "--test_size",
        help="Users in the test set; (0,1) means a fraction. Default: 0.1",
        default=0.1,
        type=float,
    )
    parser.add_argument("--seed", help="Seed for the random split", default=1, type=int)
    parser.add_argument(
        "--yes", help="Do not ask for confirmation.", action="store_true"
    )
    args = parser.parse_args(argv)
    args.dirname = os.path.dirname(os.path.abspath(args.filename)) + "/"
    return args


def create_dirs(dirname: str) -> None:
    for sub in ("data", "models", "results"):
        os.makedirs(os.path.join(dirname, sub), exist_ok=True)


def _take(data: dict, rows) -> dict:
    """The rows ``rows`` (a boolean mask or indices) of every column."""
    return {name: col[rows] for name, col in data.items()}


def _typed(values) -> np.ndarray:
    """A column of text as pandas' reader types it: int64, else float64,
    else text."""
    for parse, dtype in ((int, np.int64), (float, np.float64)):
        try:
            return np.fromiter(map(parse, values), dtype=dtype, count=len(values))
        except (ValueError, OverflowError):
            continue
    return np.asarray(values, dtype=str)


def _text(col: np.ndarray) -> list:
    """Each value as ``to_csv`` writes it."""
    return col.astype(str).tolist()


def _fields(lines, separator: str):
    if separator == r"\s+":
        return (line.split() for line in lines if line.strip())
    if len(separator) == 1:
        return (row for row in csv.reader(lines, delimiter=separator) if row)
    rx = re.compile(separator)
    return (rx.split(line) for line in lines if line)


def _iso_formats() -> list:
    """ISO-8601 dates: the date alone, or with ``T`` or a space before the
    time (minutes, seconds or a fraction), each without and with ``%z``."""
    out = ["%Y-%m-%d"]
    for sep in (" ", "T"):
        for clock in ("%H:%M", "%H:%M:%S", "%H:%M:%S.%f"):
            out += [f"%Y-%m-%d{sep}{clock}", f"%Y-%m-%d{sep}{clock}%z"]
    return out


# the text timestamps read, in the order a column's first value tries them (the one format
# pandas' guess gives it): ISO dates, year first and month first with slashes (day first only
# where the month does not read), month names (a full name before an abbreviation, as "May" is
# both), and Amazon's reviewTime ("03 1, 2001")
TIME_FORMATS = tuple(_iso_formats() + [
    "%Y/%m/%d", "%Y/%m/%d %H:%M", "%Y/%m/%d %H:%M:%S",
    "%m/%d/%Y", "%m/%d/%Y %H:%M", "%m/%d/%Y %H:%M:%S",
    "%d/%m/%Y", "%d/%m/%Y %H:%M", "%d/%m/%Y %H:%M:%S",
    "%d-%B-%Y", "%d-%b-%Y", "%B %d, %Y", "%b %d, %Y", "%d %B %Y", "%d %b %Y", "%m %d, %Y",
])
_MONTHS = ("January", "February", "March", "April", "May", "June", "July", "August", "September", "October",
           "November", "December")
# each directive as strptime's regular expression (a space: one or more blanks), with pandas'
# widening of %f to any digits (nanoseconds kept) and of %z to a bare hour
_DIRECTIVES = {
    "Y": r"(?P<Y>\d\d\d\d)",
    "m": r"(?P<m>1[0-2]|0[1-9]|[1-9])",
    "d": r"(?P<d>3[01]|[12]\d|0[1-9]|[1-9]| [1-9])",
    "H": r"(?P<H>2[0-3]|[01]\d|\d)",
    "M": r"(?P<M>[0-5]\d|\d)",
    "S": r"(?P<S>6[01]|[0-5]\d|\d)",
    "f": r"(?P<f>\d+)",
    "z": r"(?P<z>(?-i:Z)|[+-]\d\d(?::?[0-5]\d)?)",
    "B": "(?P<B>" + "|".join(_MONTHS) + ")",
    "b": "(?P<b>" + "|".join(m[:3] for m in _MONTHS) + ")",
}


def _format_regex(fmt: str):
    parts = re.split(r"%(\w)", fmt)
    rx = "".join(_DIRECTIVES[p] if i % 2 else re.sub(r"\\\s+|\\ ", r"\\s+", re.escape(p))
                 for i, p in enumerate(parts))
    return re.compile(rx, re.IGNORECASE)


_TIME_REGEXES = {fmt: _format_regex(fmt) for fmt in TIME_FORMATS}


def _instant(match) -> tuple:
    """(nanoseconds since the epoch in UTC, the offset in minutes or None)
    of a matched timestamp; a date or time out of range raises
    ``ValueError``."""
    g = match.groupdict()
    name = g.get("B") or g.get("b")
    month = int(g["m"]) if g.get("m") else [m[:3].lower() for m in _MONTHS].index(name[:3].lower()) + 1
    t = datetime.datetime(int(g["Y"]), month, int(g["d"]), int(g.get("H") or 0), int(g.get("M") or 0),
                          int(g.get("S") or 0))
    ns = ((t.toordinal() - 719163) * 86400 + t.hour * 3600 + t.minute * 60 + t.second) * 10**9
    ns += int((g.get("f") or "0")[:9].ljust(9, "0"))  # pandas keeps 9 digits
    offset = None
    if g.get("z"):
        z = g["z"].replace(":", "")
        offset = 0 if z.upper() == "Z" else (1 if z[0] == "+" else -1) * (int(z[1:3]) * 60 + int(z[3:5] or 0))
        ns -= offset * 60 * 10**9
    return ns, offset


# each directive in the zero-padded ISO form np.datetime64 reads, at years whose nanoseconds fit in
# int64 (numpy wraps the others round silently)
_ISO_DIRECTIVES = {
    "Y": r"(?:1[7-9]\d\d|2[01]\d\d|22[0-5]\d)",
    "m": r"(?:0[1-9]|1[0-2])",
    "d": r"(?:0[1-9]|[12]\d|3[01])",
    "H": r"(?:[01]\d|2[0-3])",
    "M": r"[0-5]\d",
    "S": r"[0-5]\d",
    "f": r"\d{1,9}",
}


def _iso_instants(t: np.ndarray, fmt: str, first) -> np.ndarray | None:
    """Nanoseconds since the epoch in UTC of every row of an ISO column in
    ``fmt``, all through ``np.datetime64`` at once, where every row is in
    the form numpy reads and ends in the first row's offset text (``first``
    the first row's match); else None, for the row-by-row path to read the
    column or raise."""
    line = re.sub(r"%(\w)", lambda m: _ISO_DIRECTIVES[m.group(1)], re.escape(fmt.removesuffix("%z")))
    zone = first.group("z") if fmt.endswith("%z") else ""
    text = "\n".join(t.tolist()) + "\n"
    if not re.fullmatch(f"(?:{line}{re.escape(zone)}\n)+", text):
        return None
    if zone:
        t = np.array(text.replace(zone + "\n", "\n").split("\n")[:-1])
    offset_ns = (_instant(first)[1] or 0) * 60 * 10**9
    return t.astype("datetime64[ns]").astype(np.int64) - offset_ns


def _time_order(t: np.ndarray) -> np.ndarray:
    """Sort keys of a text time column (equal instants, equal keys), read
    as ``pd.to_datetime`` reads it (module docstring): an ISO column in the
    form numpy reads as its nanoseconds (_iso_instants), any other as the
    ranks of its distinct values' instants."""
    first = str(t[0])
    fmt, misread = None, None
    for candidate, rx in _TIME_REGEXES.items():
        match = rx.fullmatch(first)
        if match:
            try:
                _instant(match)
            except ValueError as err:
                misread = misread or err
                continue
            fmt = candidate
            break
    if fmt is None:
        if misread is not None:
            raise ValueError(f"timestamp {first!r}: {misread}")
        raise NotImplementedError(f"timestamps such as {first!r}: this preprocess reads numbers and the text "
                                  f"formats {', '.join(TIME_FORMATS)}")
    if fmt.startswith("%Y-%m-%d"):
        instants = _iso_instants(t, fmt, match)
        if instants is not None:
            return instants
    rx = _TIME_REGEXES[fmt]
    values, inverse = np.unique(t, return_inverse=True)
    keys, offsets = [], set()
    for value in values.tolist():
        match = rx.fullmatch(value)
        if match is None:
            raise ValueError(f"time data {value!r} does not match the format {fmt!r} of the first row ({first!r})")
        ns, offset = _instant(match)
        keys.append(ns)
        offsets.add(offset)
    if len(offsets) > 1:
        raise ValueError(f"mixed offsets from UTC in the time column ({first!r} ...)")
    # Python ints: nanoseconds past 2262 overflow int64; equal instants in other text share a rank
    rank = np.unique(np.array(keys, dtype=object), return_inverse=True)[1]
    return rank[inverse.reshape(-1)]


def load_data(filename: str, columns: str, separator: str) -> dict:
    """The first ``len(columns)`` columns of the file, typed, with r = 1
    where the file has none, in time order when it has t (a stable sort)."""
    n = len(columns)
    with open(filename, newline="") as f:
        lines = f.read().splitlines()
    rows = [fields[:n] for fields in _fields(lines, separator)]
    if any(len(fields) < n for fields in rows):
        raise ValueError(f"{filename}: a row has fewer than {n} columns")
    cols = list(zip(*rows)) if rows else [()] * n
    data = {name: _typed(col) for name, col in zip(columns, cols)}
    if "r" not in columns:
        data["r"] = np.ones(len(rows), dtype=np.int64)
    if "t" in columns:
        t = data["t"]
        if t.dtype.kind not in "iuf" and len(t):
            t = _time_order(t)
        data = _take(data, np.argsort(t, kind="stable"))
    return data


def _counts_at_least(col: np.ndarray, least: int) -> np.ndarray:
    _, inv, counts = np.unique(col, return_inverse=True, return_counts=True)
    return counts[inv] >= least


def remove_rare_elements(data: dict, min_user_activity: int, min_item_popularity: int) -> dict:
    """Alternating removal of inactive users and rare items (users, items,
    users again); the item bound may end up loosely satisfied."""
    data = _take(data, _counts_at_least(data["u"], min_user_activity))
    data = _take(data, _counts_at_least(data["i"], min_item_popularity))
    return _take(data, _counts_at_least(data["u"], min_user_activity))


def save_index_mapping(data: dict, dirname: str) -> dict:
    """Remap ids to their rank among the sorted distinct ids and write the
    mapping TSVs (``original_id\\tnew_id``, in original-id order)."""
    data = dict(data)
    for col, fname in (("u", "user_id_mapping"), ("i", "item_id_mapping")):
        original, data[col] = np.unique(data[col], return_inverse=True)
        with open(os.path.join(dirname, "data", fname), "w") as f:
            f.write("original_id\tnew_id\n")
            f.writelines(f"{o}\t{j}\n" for j, o in enumerate(_text(original)))
    return data


def _write_triplets(filename: str, data: dict) -> None:
    with open(filename, "w") as f:
        f.writelines(
            f"{u}\t{i}\t{r}\n" for u, i, r in zip(data["u"].tolist(), data["i"].tolist(), _text(data["r"]))
        )


def split_data(data: dict, nb_val_users: float, nb_test_users: float, dirname: str, rng: np.random.Generator):
    """By-user random split into train/val/test; each user lands in exactly
    one set. Sampling is without replacement."""
    nb_users = len(np.unique(data["u"]))
    if nb_val_users < 1:
        nb_val_users = round(nb_val_users * nb_users)
    if nb_test_users < 1:
        nb_test_users = round(nb_test_users * nb_users)
    nb_val_users, nb_test_users = int(nb_val_users), int(nb_test_users)

    if nb_users <= nb_val_users + nb_test_users:
        raise ValueError(
            "Not enough users in the dataset: choose less users for validation and test splits"
        )

    def extract_n_users(part, n):
        _, first = np.unique(part["u"], return_index=True)
        users_ids = rng.choice(part["u"][np.sort(first)], n, replace=False)
        chosen = np.isin(part["u"], users_ids)
        return _take(part, chosen), _take(part, ~chosen)

    test_set, tmp_set = extract_n_users(data, nb_test_users)
    val_set, train_set = extract_n_users(tmp_set, nb_val_users)

    for part, name in (
        (train_set, "train_set_triplets"),
        (val_set, "val_set_triplets"),
        (test_set, "test_set_triplets"),
    ):
        _write_triplets(os.path.join(dirname, "data", name), part)
    return train_set, val_set, test_set


def gen_sequences(data: dict, half: bool = False):
    """Yield ``[user, i1, r1, i2, r2, ...]`` rows in user order, each in time
    order; ``half=True`` keeps the first ``1 + 2 * int((len - 1) / 4)``
    entries. As in the JAX package (and the reference), a sequence of 3
    entries or fewer (one item) is dropped unless it is the last user's,
    which is always yielded (``[]`` when there are no rows)."""
    order = np.argsort(data["u"], kind="stable")
    users, items, ratings = data["u"][order].tolist(), data["i"][order].tolist(), _text(data["r"][order])
    starts = [j for j in range(len(users)) if j == 0 or users[j] != users[j - 1]]
    if not starts:
        yield []
        return
    ends = starts[1:] + [len(users)]
    for k, (lo, hi) in enumerate(zip(starts, ends)):
        seq = [users[lo]]
        for item, rating in zip(items[lo:hi], ratings[lo:hi]):
            seq += [item, rating]
        if len(seq) > 3 or k == len(starts) - 1:
            if half:
                seq = seq[: 1 + 2 * int((len(seq) - 1) / 4)]
            yield seq


def make_sequence_format(train_set, val_set, test_set, dirname) -> None:
    """Write the sequence-format splits and the extended training set."""
    for part, name in (
        (train_set, "train_set_sequences"),
        (val_set, "val_set_sequences"),
        (test_set, "test_set_sequences"),
    ):
        with open(os.path.join(dirname, "data", name), "w") as f:
            for s in gen_sequences(part):
                f.write(" ".join(map(str, s)) + "\n")

    plus = os.path.join(dirname, "data", "train_set_sequences+")
    copyfile(os.path.join(dirname, "data", "train_set_sequences"), plus)
    with open(plus, "a") as f:
        for part in (val_set, test_set):
            for s in gen_sequences(part, half=True):
                f.write(" ".join(map(str, s)) + "\n")


def _stats(part: dict) -> str:
    users, counts = np.unique(part["u"], return_counts=True)
    longest = counts.max() if len(counts) else "nan"
    return "\t".join(map(str, [len(users), len(np.unique(part["i"])), len(part["u"]), longest]))


def save_data_stats(data, train_set, val_set, test_set, dirname) -> None:
    """Write ``data/stats``."""
    with open(os.path.join(dirname, "data", "stats"), "w") as f:
        f.write("set\tn_users\tn_items\tn_interactions\tlongest_sequence\n")
        f.write("Full\t" + _stats(data) + "\n")
        f.write("Train\t" + _stats(train_set) + "\n")
        f.write("Val\t" + _stats(val_set) + "\n")
        f.write("Test\t" + _stats(test_set) + "\n")


def make_readme(dirname, val_set, test_set) -> None:
    data_readme = (
        "Files generated by seqrec_tpu preprocess (reference-compatible layout):\n"
        "  user_id_mapping / item_id_mapping: original ↔ new id TSVs\n"
        "  train_set_triplets: (user, item, rating) per line, chronological\n"
        "  {train,val,test}_set_sequences: user i1 r1 i2 r2 ... per line\n"
        "  train_set_sequences+: training set plus first halves of val/test users\n"
        "  stats: per-split counts\n"
        "The validation set contains %s users, the test set %s users.\n"
        % (len(np.unique(val_set["u"])), len(np.unique(test_set["u"])))
    )
    results_readme = (
        "Each line of a results file corresponds to one model: the epoch count\n"
        "followed by tab-separated metric values (all @10 unless -k is set).\n"
    )
    with open(os.path.join(dirname, "data", "README"), "w") as f:
        f.write(data_readme)
    with open(os.path.join(dirname, "results", "README"), "w") as f:
        f.write(results_readme)


def preprocess(
    filename: str,
    columns: str = "uit",
    sep: str = r"\s+",
    min_user_activity: int = 2,
    min_item_pop: int = 5,
    val_size: float = 0.1,
    test_size: float = 0.1,
    seed: int = 1,
    dirname: str | None = None,
) -> str:
    """Programmatic entry point; returns the dataset directory."""
    if dirname is None:
        dirname = os.path.dirname(os.path.abspath(filename)) + "/"
    rng = np.random.default_rng(seed)
    create_dirs(dirname)
    data = load_data(filename, columns, sep)
    data = remove_rare_elements(data, min_user_activity, min_item_pop)
    data = save_index_mapping(data, dirname)
    train_set, val_set, test_set = split_data(data, val_size, test_size, dirname, rng)
    make_sequence_format(train_set, val_set, test_set, dirname)
    save_data_stats(data, train_set, val_set, test_set, dirname)
    make_readme(dirname, val_set, test_set)
    return dirname


def main(argv=None) -> None:
    args = command_parser(argv)
    if not args.yes:
        print(
            "This program will create a lot of files and directories in "
            + args.dirname
        )
        answer = input("Are you sure that you want to do that ? [y/n]")
        if answer != "y":
            sys.exit(0)
    preprocess(
        args.filename,
        columns=args.columns,
        sep=args.sep,
        min_user_activity=args.min_user_activity,
        min_item_pop=args.min_item_pop,
        val_size=args.val_size,
        test_size=args.test_size,
        seed=args.seed,
        dirname=args.dirname,
    )
    print("Data ready!")


if __name__ == "__main__":
    main()
