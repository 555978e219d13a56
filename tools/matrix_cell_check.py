"""Experiment-matrix cells of the port on the JAX package's own scenario
layouts.

    JAX_PLATFORMS=cpu python tools/matrix_cell_check.py compare \
        --part B --crowd rvoscene [--episodes 8] [--steps 60] [--seed 5]
    JAX_PLATFORMS=cpu python tools/matrix_cell_check.py layouts \
        --part B --out LAYOUTS.npz [--bank docs/.../bank50.npz]
    python tools/matrix_cell_check.py cells --bank LAYOUTS.npz \
        --cells B:rvoscene:ckpt_baseline,B:rvoscene:ckpt_ervo [--episodes 50]

``compare`` (CPU, imports JAX) runs one cell through both drivers
(``run_cell`` of ``img_env_tpu_torch.eval.experiment_matrix`` and of
``examples/experiment_matrix.py``) on the same episodes: the layouts are
drawn from a JAX bank of keys (``--seed``) by the JAX sampler, vmapped as
its batch reset draws them, and injected into the port as a
``ScenarioBank`` of samples.  The config is cut to 3 m views at 0.05 m
and 32 beams, as ``tests/test_torch_drivers.py`` cuts it, with
``time_max`` ``--steps``; the ERVO scenario answers every beep
(``ped_ca_p`` 1.0).  Part A: the baseline config and stage-5 policy; B:
the ERVO scenario with ``--crowd`` at action width 2 and the stage-5
policy; C: the ERVO scenario and policy (``--beep-off``).

``layouts`` (CPU, imports JAX) writes the JAX layouts of a key bank (the
matrix's bank50 by default) for part A's or parts B/C's scenario as a
port bank of samples: the episodes the JAX artifact
``docs/artifacts/matrix/matrix.csv`` ran.  ``cells`` (the port alone, on
the card unless ``--device cpu``) runs named cells (part:crowd:method
[:off]) at full width over such a bank, the protocol's 101 steps, and
prints each row beside the artifact's.

Each mode prints one JSON line (``--out FILE`` writes it too).
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
BANK50 = os.path.join(REPO, "docs/artifacts/baseline_curriculum/bank50.npz")
MATRIX = os.path.join(REPO, "docs/artifacts/matrix/matrix.csv")
ORBAX = {"stage5": os.path.join(REPO, "docs/artifacts/baseline_curriculum/"
                                      "stage5_ckpt"),
         "ervo": os.path.join(REPO, "docs/artifacts/ervo/ckpt")}


def scenario(part: str) -> dict:
    from img_env_tpu_torch.config import read_config
    from img_env_tpu_torch.eval import experiment_matrix as em

    return read_config(em.BASELINE_CFG if part == "A" else em.ERVO_CFG)


def jax_layouts(raw: dict, keys):
    """The JAX batch reset's scenario of each key, as the port's
    ``ScenarioSample``s (the sampler depends on the map, the objects and
    the agents only, not on the views or beams)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from img_env_tpu.config import EnvConfig as JaxEnvConfig
    from img_env_tpu.env.sampler import SamplerSpec, sample_scenario_retry
    from img_env_tpu_torch.env.sampler import ScenarioSample

    with jax.enable_x64(False):
        spec = SamplerSpec.from_config(JaxEnvConfig.from_dict(raw))
        draw = jax.jit(jax.vmap(lambda k: sample_scenario_retry(
            jax.random.split(k)[0], spec)))
        out = draw(jnp.asarray(keys))
    return [ScenarioSample(*(torch.as_tensor(np.array(x[k])) for x in out))
            for k in range(np.asarray(keys).shape[0])]


def compare(args) -> dict:
    import jax

    from img_env_tpu.eval.recorder import ScenarioBank as JaxScenarioBank
    from img_env_tpu_torch.eval import experiment_matrix as em
    from img_env_tpu_torch.eval.recorder import ScenarioBank

    raw = scenario(args.part)
    raw.update(view_map={"resolution": 0.05, "width": 3.0, "height": 3.0},
               range_total=32, time_max=args.steps)
    if args.part != "A":
        raw["ped_ca_p"] = 1.0
    if args.part == "B":
        raw = em.crowd_variant(raw, args.crowd, 2)
    npz, orbax = ((em.ERVO, ORBAX["ervo"]) if args.part == "C"
                  else (em.STAGE5, ORBAX["stage5"]))
    spec = importlib.util.spec_from_file_location(
        "jax_experiment_matrix", os.path.join(REPO, "examples",
                                              "experiment_matrix.py"))
    jmatrix = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmatrix)

    jbank = JaxScenarioBank.generate(args.seed, args.episodes)
    tbank = ScenarioBank(samples=jax_layouts(raw, jbank.keys))
    t0 = time.perf_counter()
    got = em.run_cell(raw, "ckpt", tbank, args.episodes, ckpt=npz,
                      force_beep_off=args.beep_off, device="cpu")
    t_port = time.perf_counter() - t0
    t0 = time.perf_counter()
    with jax.enable_x64(False):
        want = jmatrix.run_cell(raw, "ckpt", jbank, args.episodes,
                                ckpt=orbax, force_beep_off=args.beep_off)
    t_jax = time.perf_counter() - t0
    rows = {}
    for name, res in (("port", got), ("jax", want)):
        rows[name] = em.matrix_row(args.part, "cell", args.crowd, "ckpt",
                                   "off" if args.beep_off else "n/a", res[0])
        rows[name].pop("wall_s")
    dones = {"port": [int(x) for x in got[1].reshape(-1)],
             "jax": [int(x) for x in want[1].reshape(-1)]}
    return {"mode": "compare", "part": args.part, "crowd": args.crowd,
            "episodes": args.episodes, "steps": args.steps,
            "seed": args.seed, "rows": rows, "dones": dones,
            "dones_equal": dones["port"] == dones["jax"],
            "rows_equal": rows["port"] == rows["jax"],
            "ped_min_dist_delta": rows["port"]["ped_min_dist_mean"]
            - rows["jax"]["ped_min_dist_mean"],
            "seconds": {"port": t_port, "jax": t_jax}}


def layouts(args) -> dict:
    import numpy as np

    from img_env_tpu_torch.eval.recorder import ScenarioBank

    with np.load(args.bank) as z:
        keys = z["keys"]
    ScenarioBank(samples=jax_layouts(scenario(args.part), keys)).save(
        args.out)
    return {"mode": "layouts", "part": args.part, "bank": args.bank,
            "episodes": int(keys.shape[0]), "out": args.out}


def cells(args) -> dict:
    from img_env_tpu_torch.eval import experiment_matrix as em
    from img_env_tpu_torch.eval.recorder import ScenarioBank

    bank = ScenarioBank.load(args.bank)
    with open(MATRIX, newline="") as f:
        ref = {(r["part"], r["crowd"], r["method"], r["beep"]): r
               for r in csv.DictReader(f)}
    out = []
    for name in args.cells.split(","):
        part, crowd, method, *off = name.split(":")
        ervo = method == "ckpt_ervo"
        raw = scenario(part)
        if part == "B":
            raw = em.crowd_variant(raw, crowd, 3 if ervo else 2)
        beep = ("off" if off else "on") if part == "C" else (
            "policy" if ervo else "n/a")
        summary = em.run_cell(raw, "ckpt", bank, args.episodes,
                              ckpt=em.ERVO if ervo else em.STAGE5,
                              force_beep_off=bool(off),
                              device=args.device)[0]
        row = em.matrix_row(part, "ervo_crowd", crowd, method, beep,
                            summary)
        want = ref.get((part, crowd, method, beep), {})
        out.append({"cell": name, "port": row,
                    "jax_artifact": {k: want.get(k) for k in (
                        "arrive_rate", "ped_coll_rate", "static_coll_rate",
                        "stuck_rate")}})
        print(json.dumps(out[-1]), flush=True)
    return {"mode": "cells", "bank": args.bank, "episodes": args.episodes,
            "device": args.device, "cells": out}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("compare", "layouts", "cells"))
    ap.add_argument("--part", choices=("A", "B", "C"), default="B")
    ap.add_argument("--crowd", default="rvoscene")
    ap.add_argument("--episodes", type=int, default=None)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--beep-off", action="store_true")
    ap.add_argument("--bank", default=BANK50)
    ap.add_argument("--cells", default="B:rvoscene:ckpt_baseline")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    torch.set_num_threads(args.threads)
    if args.episodes is None:
        args.episodes = 8 if args.mode == "compare" else 50
    line = json.dumps({"compare": compare, "layouts": layouts,
                       "cells": cells}[args.mode](args))
    print(line)
    if args.out and args.mode != "layouts":
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
