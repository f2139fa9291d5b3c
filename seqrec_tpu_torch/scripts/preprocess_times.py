#!/usr/bin/env python3
"""Seconds of the preprocess's ``load_data`` on a text time column, on the CPU:

    python3 PATH/TO/preprocess_times.py [--rows N] [--reps R]

run from the root of the checkout to measure (its package is imported from
there, so one copy of this script measures another checkout too). Writes,
once, files of N rows (2,000,000 by default) of ``user,item,time`` under
``build/preprocess_times/``, their times N distinct seconds from 2001 in a
shuffled order: ``iso_space`` (``2001-01-01 00:00:00``), ``iso_offset``
(``2001-01-01T00:00:00+05:30``) and ``month_slash`` (``01/01/2001
00:00:00``, a format read row by row). Prints one JSON line a file with
the seconds of each of R calls (3 by default).
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
    paths = {}
    for name, text in texts.items():
        paths[name] = os.path.join(directory, f"{name}_{rows}.csv")
        if not os.path.exists(paths[name]):
            with open(paths[name], "w") as f:
                f.writelines(f"{u},{i},{t}\n" for u, i, t in zip(users.tolist(), items.tolist(), text.tolist()))
    return paths


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=2_000_000)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    from seqrec_tpu_torch.data.preprocess import load_data

    directory = os.path.join(os.getcwd(), "build", "preprocess_times")
    os.makedirs(directory, exist_ok=True)
    for name, path in write_files(directory, args.rows).items():
        seconds = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            try:
                load_data(path, "uit", ",")
            except NotImplementedError:
                seconds = "NotImplementedError: the format is not read"
                break
            seconds.append(time.perf_counter() - t0)
        print(json.dumps({"checkout": os.getcwd(), "file": name, "rows": args.rows, "load_data_s": seconds}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
