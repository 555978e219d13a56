"""Hold the port's experiment-matrix cells to the JAX artifact.

    python tools/matrix_bounds.py PORT_MATRIX.csv [...] \
        [--ref docs/artifacts/matrix/matrix.csv] [--episodes 50]

Reads the ``matrix.csv`` files that ``python -m
img_env_tpu_torch.eval.experiment_matrix`` wrote (one part a file, or
all parts in one) and, for every cell (part, crowd, method, beep), prints
the port's and the reference's arrive rate, their difference and the
two-sample bound 3 * sqrt(p(1 - p) * 2 / n) at the pooled rate p, as one
JSON line per cell, then a summary line with the cells outside the
bound.  The port's episodes are its own (a JAX bank's keys load as
seeds), so the cells are compared as two samples of the same protocol.
Needs only the standard library.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs", "artifacts", "matrix", "matrix.csv")
KEY = ("part", "crowd", "method", "beep")


def read_cells(path: str) -> dict:
    with open(path, newline="") as f:
        return {tuple(r[k] for k in KEY): r for r in csv.DictReader(f)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port", nargs="+")
    ap.add_argument("--ref", default=REF)
    ap.add_argument("--episodes", type=int, default=50)
    args = ap.parse_args()
    ref = read_cells(args.ref)
    port = {}
    for path in args.port:
        port.update(read_cells(path))
    outside = []
    for key, row in ref.items():
        if key not in port:
            continue
        p_port = float(port[key]["arrive_rate"])
        p_ref = float(row["arrive_rate"])
        pooled = (p_port + p_ref) / 2
        bound = 3 * math.sqrt(pooled * (1 - pooled) * 2 / args.episodes)
        delta = p_port - p_ref
        cell = dict(zip(KEY, key), port=p_port, ref=p_ref,
                    delta=round(delta, 4), bound=round(bound, 4),
                    inside=abs(delta) <= bound + 1e-12,
                    port_ped_coll=float(port[key]["ped_coll_rate"]),
                    ref_ped_coll=float(row["ped_coll_rate"]),
                    port_wall_s=float(port[key]["wall_s"]))
        if not cell["inside"]:
            outside.append(key)
        print(json.dumps(cell))
    print(json.dumps({"cells": sum(k in port for k in ref),
                      "outside": [list(k) for k in outside]}))


if __name__ == "__main__":
    main()
