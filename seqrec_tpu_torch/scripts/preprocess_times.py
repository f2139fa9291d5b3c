#!/usr/bin/env python3
"""Seconds of the preprocess's ``load_data`` on the CPU, for integer columns and text time columns:

    python3 PATH/TO/preprocess_times.py [--rows N] [--reps R] [--files NAME ...]

run from the root of the checkout to measure (its package is imported from
there, so one copy of this script measures another checkout too). Writes,
once, files of N rows (2,000,000 by default) under
``build/preprocess_times/``, their times N distinct seconds from 2001 in a
shuffled order: ``int_colons`` (``user::item::rating::unix seconds``, all
integers, ML-1M's ``ratings.dat`` layout) and, as ``user,item,time``,
``iso_space`` (``2001-01-01 00:00:00``), ``iso_offset``
(``2001-01-01T00:00:00+05:30``) and ``month_slash`` (``01/01/2001
00:00:00``, a format read row by row). Prints one JSON line a file (or
only for the files named) with the seconds of each of R calls (3 by
default).
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def write_files(directory: str, rows: int) -> dict:
    rng = np.random.default_rng(0)
    seconds = rng.permutation(rows).astype(np.int64) + 978_307_200
    iso = seconds.astype("datetime64[s]").astype(str)
    texts = {
        "iso_space": np.char.replace(iso, "T", " "),
        "iso_offset": np.char.add(iso, "+05:30"),
        "month_slash": np.array([f"{t[5:7]}/{t[8:10]}/{t[:4]} {t[11:]}" for t in iso.tolist()]),
    }
    users, items = rng.integers(0, 50_000, rows), rng.integers(0, 20_000, rows)
    paths = {"int_colons": (os.path.join(directory, f"int_colons_{rows}.dat"), "uirt", "::")}
    if not os.path.exists(paths["int_colons"][0]):
        ratings = rng.integers(1, 6, rows)
        with open(paths["int_colons"][0], "w") as f:
            f.writelines(f"{u}::{i}::{r}::{t}\n" for u, i, r, t in zip(users.tolist(), items.tolist(),
                                                                       ratings.tolist(), seconds.tolist()))
    for name, text in texts.items():
        paths[name] = (os.path.join(directory, f"{name}_{rows}.csv"), "uit", ",")
        if not os.path.exists(paths[name][0]):
            with open(paths[name][0], "w") as f:
                f.writelines(f"{u},{i},{t}\n" for u, i, t in zip(users.tolist(), items.tolist(), text.tolist()))
    return paths


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=2_000_000)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--files", nargs="*", help="time only these files (default: all)")
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    from seqrec_tpu_torch.data.preprocess import load_data

    directory = os.path.join(os.getcwd(), "build", "preprocess_times")
    os.makedirs(directory, exist_ok=True)
    for name, (path, columns, separator) in write_files(directory, args.rows).items():
        if args.files and name not in args.files:
            continue
        seconds = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            try:
                load_data(path, columns, separator)
            except NotImplementedError:
                seconds = "NotImplementedError: the format is not read"
                break
            seconds.append(time.perf_counter() - t0)
        print(json.dumps({"checkout": os.getcwd(), "file": name, "rows": args.rows, "load_data_s": seconds}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
