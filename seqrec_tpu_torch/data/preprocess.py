"""CSV → canonical dataset directory, with numpy only (no pandas).

    python -m seqrec_tpu_torch.data.preprocess -f DIR/ratings.dat --columns uirt --sep :: --yes

Counterpart of ``seqrec_tpu/data/preprocess.py``, with the same flags, the
same ``preprocess()`` and ``main()``, and the same files, byte for byte:
``data/{user,item}_id_mapping``, ``data/{train,val,test}_set_triplets``,
``data/{train,val,test}_set_sequences``, ``data/train_set_sequences+``,
``data/stats``, ``data/README`` and ``results/README``. What the JAX
package leaves to pandas is done here as pandas does it:

- the first ``len(columns)`` columns are read (``\\s+``: whitespace; one
  character: a CSV field separator with quotes, pandas' C reader; longer:
  a regular expression, pandas' python reader, which strips each line);
  rating 1 where there is no ``r``;
- each column is typed as that reader types it (``_typed``): a field equal
  to one of pandas' 19 default NA strings (``NA_VALUES``) is missing; then
  int64; uint64 for values from 2**63 to 2**64-1; Python ints past those;
  float64 in pandas' number grammar (ASCII digits, a sign, a point, an
  exponent, the inf spellings; ``1_0`` and full-width digits are text),
  rounded as pandas' parser rounds, with NaN for a missing field; bool;
  else text. The corners follow each reader: a value past int64 beside a
  negative or a missing field leaves every field text, missing ones
  included; the C reader reads -2**63 beside a missing field as NaN and
  spells bools in any case, the python reader only True/TRUE/true;
- rows are put in time order by a stable sort of ``pd.to_datetime`` of
  ``t``, NaT last: int64 as unix seconds; float64 as nanoseconds truncated
  toward zero (so 978300760.7 and 978300760.2 tie; NaN, inf and values past
  +-2**63 are NaT); uint64 and Python ints raise ``ValueError``, bools
  ``TypeError``; text as ``pd.to_datetime`` reads it: NaN and the NaT
  strings are missing, one format of ``TIME_FORMATS`` is guessed from the
  first present value, month first (``dayfirst=False``: a day-first format
  only where the month-first one cannot read it; a full month name before
  an abbreviated one), every row parsed with it and sorted by its instant;
  a 12-hour clock pandas guesses only for some first values and otherwise
  reads each value on its own, here in the first format that reads it; a
  row the format does not read, or offsets from UTC that differ between
  rows, raise ``ValueError``; a first value no format reads (another zone
  name than UTC or GMT among them), "now" and "today" raise
  ``NotImplementedError``, as does a missing user or item (pandas' code
  -1);
- users, then items, then users again with too few rows are removed;
- ids become their rank among the sorted distinct ids (numeric order for
  numbers, code-point order for text), as pandas' category codes;
- the test users, then the validation users are drawn with
  ``Generator.choice(..., replace=False)`` from the users in order of
  first appearance (pandas' ``unique()``), from one
  ``np.random.default_rng(seed)``;
- values are written as ``to_csv`` writes them: ``4`` for an integer
  column, the shortest round-trip text (``4.5``, ``4.0``) for a float one,
  ``True``, an empty field for NaN, text with a tab or a quote quoted; the
  sequences as ``str`` writes them (``nan``).
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


# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES): a field equal to one is missing
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
    "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT64_MIN, _INT64_MAX, _UINT64_MAX = -(2**63), 2**63 - 1, 2**64 - 1
_SPACE = " \t\n\v\f\r"  # what pandas' C parsers skip around a number (isspace_ascii)
_OVERFLOW = object()
_C_INT = re.compile(r"[ \t\n\v\f\r]*([+-]?)([0-9]+)[ \t\n\v\f\r]*")
_NUMBER = re.compile(r"[ \t\n\v\f\r]*([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE][ \t\n\v\f\r]*([+-]?[0-9]+))?"
                     r"[ \t\n\v\f\r]*")
_INF = {"inf": np.inf, "+inf": np.inf, "-inf": -np.inf, "infinity": np.inf, "+infinity": np.inf,
        "-infinity": -np.inf}
_POWERS = [float(f"1e{k}") for k in range(309)]
_C_BOOLS = {"true": True, "false": False}  # the C reader's, compared without case
_PYTHON_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


def _number(v: str):
    """(value, is an integer literal) of a field as pandas' number parser
    reads it (``precise_xstrtod``: at most 17 digits kept, then scaled by a
    power of ten, so long numbers round as pandas rounds them; or one of the
    inf spellings), or None where it does not read the whole field."""
    m = _NUMBER.fullmatch(v)
    if m is None or not (m.group(2) or m.group(3)):
        return (_INF[v.lower()], False) if v.isascii() and v.lower() in _INF else None
    sign, whole, frac, exp = m.groups()
    number, exponent, kept = 0.0, 0, 0
    for d in whole:
        if kept < 17:
            number, kept = number * 10.0 + (ord(d) - 48), kept + 1
        else:
            exponent += 1
    for d in (frac or "")[: max(0, 17 - kept)]:
        number, kept, exponent = number * 10.0 + (ord(d) - 48), kept + 1, exponent - 1
    if sign == "-":
        number = -number
    exponent += int(exp or 0)
    if exponent > 308:
        number = number * np.inf if number else number
    elif exponent > 0:
        number *= _POWERS[exponent]
    elif exponent < -616:
        number = 0.0
    elif exponent < -308:
        number = number / _POWERS[-308 - exponent] / _POWERS[308]
    else:
        number /= _POWERS[-exponent]
    return number, frac is None and exp is None


def _c_int(v: str, unsigned: bool = False):
    """The C reader's integer parse of a field (``str_to_int64``, or
    ``str_to_uint64`` when ``unsigned``): its value, ``_OVERFLOW`` where it
    is an integer past the range that ends the field (followed by blanks it
    is not read), else None."""
    m = _C_INT.fullmatch(v)
    if m is None:
        return None
    x = -int(m.group(2)) if m.group(1) == "-" else int(m.group(2))
    if (0 if unsigned else _INT64_MIN) <= x <= (_UINT64_MAX if unsigned else _INT64_MAX):
        return x
    return _OVERFLOW if m.end(2) == len(v) else None


def _text_column(values, na) -> np.ndarray:
    """Text, with NaN for the fields ``na`` marks missing (None: none)."""
    if na is None or not any(na):
        return np.asarray(values, dtype=str)
    return np.array([np.nan if m else v for v, m in zip(values, na)], dtype=object)


def _bool_column(values, na, spellings: dict, fold: bool):
    """Booleans (object, NaN where missing), or None where a present field
    is not one of ``spellings`` (compared without case when ``fold``)."""
    out = []
    for v, m in zip(values, na):
        key = v.lower() if fold and v.isascii() else v
        if not m and key not in spellings:
            return None
        out.append(np.nan if m else spellings[key])
    return np.array(out, dtype=object if any(na) else bool)


def _c_past_int64(values, na):
    """The C reader's column after an int64 overflow: uint64; text, missing
    fields included, where a negative or a missing field joins a value past
    int64; past uint64 (or below int64), Python ints where every present
    field is one, else the same text; None where a field is no integer (the
    float64 attempt follows)."""
    uints, sint = [], False
    for v, m in zip(values, na):
        if m or v.lstrip(_SPACE).startswith("-"):
            sint |= not m
            continue
        x = _c_int(v, unsigned=True)
        if x is None:
            return None
        if x is _OVERFLOW:
            break
        uints.append(x)
    else:
        if any(x > _INT64_MAX for x in uints) and (sint or any(na)):
            return np.asarray(values, dtype=str)
        if not sint:
            return np.array(uints, dtype=np.uint64)
    try:
        return np.array([np.nan if m else int(v.encode()) for v, m in zip(values, na)], dtype=object)
    except ValueError:
        return np.asarray(values, dtype=str)


def _c_reader_column(values) -> np.ndarray:
    """A column as pandas' C reader types it: int64 (float64 with NaN where
    a field is missing, -2**63 among them), else _c_past_int64 after an
    int64 overflow, else float64, else bool, else text."""
    na = [v in NA_VALUES for v in values]
    ints = []
    for v, m in zip(values, na):
        x = None if m else _c_int(v)
        if not m and (x is None or x is _OVERFLOW):
            break
        ints.append(x)
    else:
        if not any(na):
            return np.array(ints, dtype=np.int64)
        return np.array([np.nan if x is None or x == _INT64_MIN else float(x) for x in ints])
    if x is _OVERFLOW and (col := _c_past_int64(values, na)) is not None:
        return col
    floats = [np.nan if m else _number(v) for v, m in zip(values, na)]
    if all(x is not None for x in floats):
        return np.array([x if m else x[0] for x, m in zip(floats, na)], dtype=np.float64)
    col = _bool_column(values, na, _C_BOOLS, fold=True)
    return _text_column(values, na) if col is None else col


def _python_reader_column(values) -> np.ndarray:
    """A column as pandas' python reader (a separator of more than one
    character) types it: numbers when every present field is one, as
    ``lib.maybe_convert_numeric`` does (text, missing fields included, where
    a value past int64 meets a negative or a missing field; float64 where a
    field is missing or not an integer; Python ints past uint64; uint64;
    int64), else bool (its own spellings), else text."""
    na = [v in NA_VALUES for v in values]
    nums = [None if m else _number(v) for v, m in zip(values, na)]
    if all(m or x is not None for x, m in zip(nums, na)):
        ints = [int(v) for v, x in zip(values, nums) if x is not None and x[1]]
        missing, floats = any(na), len(ints) < len(values) - sum(na)
        uint = any(_INT64_MAX < x <= _UINT64_MAX for x in ints)
        if uint and (missing or any(_INT64_MIN <= x < 0 for x in ints)):
            return np.asarray(values, dtype=str)
        if missing or floats:
            return np.array([np.nan if x is None else x[0] for x in nums], dtype=np.float64)
        if any(x < _INT64_MIN or x > _UINT64_MAX for x in ints):
            return np.array(ints, dtype=object)
        return np.array(ints, dtype=np.uint64 if uint else np.int64)
    col = _bool_column(values, na, _PYTHON_BOOLS, fold=False)
    return _text_column(values, na) if col is None else col


def _plain(values, also: str = "") -> bool:
    """No field holds anything Python's int()/float() read and pandas does
    not: no underscore, non-ASCII digit or space, or \\x1c-\\x1f (nor the
    characters ``also``)."""
    text = "".join(values)
    return text.isascii() and not any(c in text for c in "_\x1c\x1d\x1e\x1f" + also)


def _typed(values, python_engine: bool = False, plain: bool = False) -> np.ndarray:
    """A column of fields as pandas' reader types it (the C reader, or the
    python one for a regular-expression separator; ``plain``: the file is
    _plain). Integers, short decimals and text whose first field is text
    take fast paths; any other column goes field by field through the
    reader's own rules."""
    n = len(values)
    try:
        col = np.fromiter(map(int, values), dtype=np.int64, count=n)
    except (ValueError, OverflowError):
        col = None
    if col is not None and (plain or _plain(values)):
        return col
    # decimals of at most 15 characters and no exponent: pandas' parser rounds them exactly
    try:
        col = np.fromiter(map(float, values), dtype=np.float64, count=n)
    except ValueError:
        col = None
    if col is not None and _plain(values, "eEnN") and max(map(len, values)) <= 15:
        return col
    first = values[0]
    if (first not in NA_VALUES and _number(first) is None and _c_int(first) is None
            and not (first.isascii() and first.lower() in _C_BOOLS)):
        # every reader stops at the first field: text (no NA string is longer than 8 characters)
        missing = min(map(len, values)) <= 8 and not NA_VALUES.isdisjoint(values)
        return _text_column(values, [v in NA_VALUES for v in values] if missing else None)
    return (_python_reader_column if python_engine else _c_reader_column)(values)


def _has_missing(col: np.ndarray) -> bool:
    if col.dtype.kind == "f":
        return bool(np.isnan(col).any())
    return col.dtype == object and any(isinstance(v, float) and v != v for v in col.tolist())


_QUOTED = re.compile(r'[\t"\n\r]')


def _text(col: np.ndarray, na: str = "") -> list:
    """Each value as ``to_csv`` writes it with a tab separator (NaN as
    ``na``; text with a tab, a quote or a line break quoted), or with
    ``na="nan"`` as ``str`` writes it (``gen_sequences``)."""
    if col.dtype == object:
        text = [na if isinstance(v, float) and v != v else str(v) for v in col.tolist()]
    else:
        text = col.astype(str)
        if col.dtype.kind == "f" and na != "nan":
            text[np.isnan(col)] = na
        text = text.tolist()
    if na != "nan" and col.dtype.kind in "UO" and _QUOTED.search("".join(text)):
        return ['"' + v.replace('"', '""') + '"' if _QUOTED.search(v) else v for v in text]
    return text


def _fields(lines, separator: str):
    if separator == r"\s+":
        return (line.split() for line in lines if line.strip())
    if len(separator) == 1:
        return (row for row in csv.reader(lines, delimiter=separator) if row)
    rx = re.compile(separator)  # pandas' python reader: each line stripped, blank lines skipped
    return (rx.split(line) for line in map(str.strip, lines) if line)


def _iso_formats() -> list:
    """ISO-8601 dates: the date alone, or with ``T`` or a space before the
    time (minutes, seconds or a fraction), each without and with ``%z``."""
    out = ["%Y-%m-%d"]
    for sep in (" ", "T"):
        for clock in ("%H:%M", "%H:%M:%S", "%H:%M:%S.%f"):
            out += [f"%Y-%m-%d{sep}{clock}", f"%Y-%m-%d{sep}{clock}%z"]
    return out


def _zoned_formats() -> list:
    """ISO dates and times with a blank before the zone: an offset, ``GMT``
    (pandas' guess keeps it as text, so the times stay without a zone) or
    ``%Z`` (``UTC``; later rows ``UTC`` or ``GMT``)."""
    return [f"%Y-%m-%d{sep}{clock} {zone}" for zone in ("%z", "GMT", "%Z") for sep in (" ", "T")
            for clock in ("%H:%M", "%H:%M:%S", "%H:%M:%S.%f")]


def _with_clocks(date: str) -> list:
    return [date, f"{date} %H:%M", f"{date} %H:%M:%S"]


# the 12-hour clock after a date: pandas guesses it only where the hour as written is the hour of
# the day (1-11 AM, 12 PM), and then with "AM"/"PM" as %p but "am", "pm" or "Am" as literal text
# after a 24-hour %H; for any other first value it reads each value on its own (_time_order)
_TWELVE_HOUR = tuple(f"{date} %I:%M{sec} %p" for date in ("%Y-%m-%d", "%Y/%m/%d", "%m/%d/%Y", "%d/%m/%Y")
                     for sec in ("", ":%S"))
# the text timestamps read, in the order a column's first value tries them (the one format
# pandas' guess gives it): ISO dates (and year-month), year first and month first with slashes or
# points (day first only where the month does not read), month names (a full name before an
# abbreviation, as "May" is both), Amazon's reviewTime ("03 1, 2001"), and the 12-hour clock
_ISO_FORMATS = tuple(_iso_formats())
TIME_FORMATS = tuple(list(_ISO_FORMATS) + _zoned_formats() + ["%Y-%m"] + [
    f for date in ("%Y/%m/%d", "%m/%d/%Y", "%d/%m/%Y", "%Y.%m.%d", "%m.%d.%Y", "%d.%m.%Y") for f in _with_clocks(date)
] + [
    "%d-%B-%Y", "%d-%b-%Y", "%B %d, %Y", "%b %d, %Y", "%B %d %Y", "%b %d %Y", "%d %B %Y", "%d %b %Y", "%m %d, %Y",
] + list(_TWELVE_HOUR))
_MONTHS = ("January", "February", "March", "April", "May", "June", "July", "August", "September", "October",
           "November", "December")
# each directive as strptime's regular expression (a space: one or more blanks), with pandas'
# widening of %f to any digits (nanoseconds kept) and of %z to a bare hour; %Z only UTC and GMT
_DIRECTIVES = {
    "Y": r"(?P<Y>\d\d\d\d)",
    "m": r"(?P<m>1[0-2]|0[1-9]|[1-9])",
    "d": r"(?P<d>3[01]|[12]\d|0[1-9]|[1-9]| [1-9])",
    "H": r"(?P<H>2[0-3]|[01]\d|\d)",
    "I": r"(?P<I>1[0-2]|0[1-9]|[1-9])",
    "M": r"(?P<M>[0-5]\d|\d)",
    "S": r"(?P<S>6[01]|[0-5]\d|\d)",
    "f": r"(?P<f>\d+)",
    "p": r"(?P<p>AM|PM)",
    "z": r"(?P<z>(?-i:Z)|[+-]\d\d(?::?[0-5]\d)?)",
    "Z": r"(?P<Z>(?-i:UTC|GMT))",
    "B": "(?P<B>" + "|".join(_MONTHS) + ")",
    "b": "(?P<b>" + "|".join(m[:3] for m in _MONTHS) + ")",
}


def _format_regex(fmt: str):
    parts = re.split(r"%(\w)", fmt)
    rx = "".join(_DIRECTIVES[p] if i % 2 else re.sub(r"\\\s+|\\ ", r"\\s+", re.escape(p))
                 for i, p in enumerate(parts))
    return re.compile(rx, re.IGNORECASE)


_TIME_REGEXES = {fmt: _format_regex(fmt) for fmt in TIME_FORMATS}


def _guess(fmt: str, match) -> str | None:
    """The format pandas guesses from a first value that ``fmt`` reads
    (``match``), or None where it has no guess (the 12-hour clock,
    _TWELVE_HOUR)."""
    if fmt not in _TWELVE_HOUR:
        return fmt
    hour, noon = int(match.group("I")), match.group("p")
    if (hour == 12) != (noon.upper() == "PM"):
        return None
    return fmt if noon in ("AM", "PM") else fmt.replace("%I", "%H").replace("%p", noon)


def _instant(match) -> tuple:
    """(nanoseconds since the epoch in UTC, the offset in minutes or None)
    of a matched timestamp; a date or time out of range raises
    ``ValueError``."""
    g = match.groupdict()
    name = g.get("B") or g.get("b")
    month = int(g["m"]) if g.get("m") else [m[:3].lower() for m in _MONTHS].index(name[:3].lower()) + 1
    hour = int(g["I"]) % 12 + 12 * (g["p"].upper() == "PM") if g.get("I") else int(g.get("H") or 0)
    t = datetime.datetime(int(g["Y"]), month, int(g.get("d") or 1), hour, int(g.get("M") or 0),
                          int(g.get("S") or 0))
    ns = ((t.toordinal() - 719163) * 86400 + t.hour * 3600 + t.minute * 60 + t.second) * 10**9
    ns += int((g.get("f") or "0")[:9].ljust(9, "0"))  # pandas keeps 9 digits
    offset = 0 if g.get("Z") else None
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


def _read_instant(value: str, formats) -> tuple:
    """(the format, its instant, the match) of the first of ``formats`` that
    reads ``value``: a value one matches but whose date does not exist raises
    ``ValueError`` where no later format reads it, a value none matches
    ``NotImplementedError``."""
    misread = None
    for fmt in formats:
        match = _TIME_REGEXES[fmt].fullmatch(value)
        if match:
            try:
                return fmt, _instant(match), match
            except ValueError as err:
                misread = misread or err
    if misread is not None:
        raise ValueError(f"timestamp {value!r}: {misread}")
    raise NotImplementedError(f"timestamps such as {value!r}: this preprocess reads numbers and the text "
                              f"formats {', '.join(TIME_FORMATS)}")


def _time_order(t: np.ndarray) -> np.ndarray:
    """Sort keys of a text time column with no missing value (equal
    instants, equal keys), read as ``pd.to_datetime`` reads it (module
    docstring): an ISO column in the form numpy reads as its nanoseconds
    (_iso_instants), any other as the ranks of its distinct values'
    instants."""
    first = str(t[0])
    fmt = _guess(*_read_instant(first, TIME_FORMATS)[::2])
    rx = _TIME_REGEXES[fmt] if fmt in _TIME_REGEXES else _format_regex(fmt) if fmt else None
    if fmt in _ISO_FORMATS:
        match = rx.fullmatch(first)
        instants = _iso_instants(t, fmt, match)
        if instants is not None:
            return instants
    values, inverse = np.unique(t, return_inverse=True)
    keys, offsets = [], set()
    for value in values.tolist():
        if fmt is None:  # no guess: each value in the first format that reads it (a zone name: UTC)
            ns, offset = _read_instant(value, [f for f in TIME_FORMATS if not f.endswith(" GMT")])[1]
        else:
            match = rx.fullmatch(value)
            if match is None:
                raise ValueError(f"time data {value!r} does not match the format {fmt!r} of the first row "
                                 f"({first!r})")
            ns, offset = _instant(match)
        keys.append(ns)
        offsets.add(offset)
    if len(offsets) > 1:
        raise ValueError(f"mixed offsets from UTC in the time column ({first!r} ...)")
    # Python ints: nanoseconds past 2262 overflow int64; equal instants in other text share a rank
    rank = np.unique(np.array(keys, dtype=object), return_inverse=True)[1]
    return rank[inverse.reshape(-1)]


# text pd.to_datetime reads as NaT, and text it reads as the time of the call
_NAT_TEXT = frozenset({"", "NaT", "nat", "NAT", "nan", "NaN", "NAN"})
_NOW_TEXT = frozenset({"now", "today"})


def _time_permutation(t: np.ndarray) -> np.ndarray:
    """The rows in the order of pandas' stable sort of ``pd.to_datetime`` of
    the time column, missing times (NaT) last: int64 as it is (unix
    seconds); float64 as whole nanoseconds, truncated toward zero (NaN, inf
    and values past +-2**63 are NaT); text as ``_time_order`` reads it, NaN
    and ``_NAT_TEXT`` missing. Columns pandas refuses raise as it does: bool
    ``TypeError``, integers past int64 (uint64, Python ints) ``ValueError``."""
    if t.dtype.kind == "i":
        return np.argsort(t, kind="stable")
    if t.dtype.kind == "f":
        whole = np.trunc(t)
        return np.argsort(np.where(np.abs(whole) < 2.0**63, whole, np.inf), kind="stable")
    if t.dtype.kind == "U" and len(t) == 0:
        return np.arange(0)
    if t.dtype.kind == "U":  # at once; no time format reads NaT text or "now", so it raises where they are
        try:
            return np.argsort(_time_order(t), kind="stable")
        except (ValueError, NotImplementedError):
            if (_NAT_TEXT | _NOW_TEXT).isdisjoint(t.tolist()):
                raise
    values = t.tolist()
    types = set(map(type, values))
    if bool in types:
        raise TypeError("a bool time column cannot be converted to datetime64")
    if int in types:  # uint64 or Python ints
        raise ValueError("time values past int64 overflow datetime64[ns]")
    if not _NOW_TEXT.isdisjoint(values):
        raise NotImplementedError("timestamps 'now' and 'today': pandas reads them as the time of the call")
    missing = np.array([not isinstance(v, str) or v in _NAT_TEXT for v in values], dtype=bool)
    present = np.flatnonzero(~missing)
    if len(present):
        present = present[np.argsort(_time_order(np.array([values[j] for j in present], dtype=str)),
                                     kind="stable")]
    return np.concatenate([present, np.flatnonzero(missing)])


def load_data(filename: str, columns: str, separator: str) -> dict:
    """The first ``len(columns)`` columns of the file, typed as pandas'
    reader types them, with r = 1 where the file has none, in time order
    when it has t (a stable sort; module docstring)."""
    n = len(columns)
    with open(filename, newline="") as f:
        text = f.read()
    rows = [fields[:n] for fields in _fields(text.splitlines(), separator)]
    if any(len(fields) < n for fields in rows):
        raise ValueError(f"{filename}: a row has fewer than {n} columns")
    cols = list(zip(*rows)) if rows else [()] * n
    python_engine, plain = len(separator) > 1 and separator != r"\s+", _plain([text])
    data = {name: _typed(col, python_engine, plain) for name, col in zip(columns, cols)}
    for name in "ui":
        if name in data and _has_missing(data[name]):
            raise NotImplementedError(f"a missing {name} field: pandas gives it category code -1, which this "
                                      "preprocess does not write")
    if "r" not in columns:
        data["r"] = np.ones(len(rows), dtype=np.int64)
    if "t" in columns:
        data = _take(data, _time_permutation(data["t"]))
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
        ids = data[col]
        original, data[col] = np.unique(ids, return_inverse=True)
        if ids.dtype.kind == "f" and (original == 0).any():  # 0.0 and -0.0: the first one's sign, as pandas
            original[original == 0] = ids[np.argmax(ids == 0)]
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
    users, items, ratings = data["u"][order].tolist(), data["i"][order].tolist(), _text(data["r"][order], "nan")
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
