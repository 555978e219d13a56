"""Paper-scale experiment matrix over shared 50-episode scenario banks
(port of examples/experiment_matrix.py).

Reproduces both papers' evaluation protocols (reference README.md:159-186)
through the trusted scene-batched evaluator (eval/batched_eval.py, the
same outcomes as the sequential wrapper stack):

  A. Sensors-20 A/B — {ckpt, mpc, random} on baseline_10obs_5ped, one
     shared bank (the committed bank50 by default), with the BagReader-
     style time/distance/extra-time comparison CSV + figures
     (eval/plots.compare_methods).
  B. IROS-21 crowd matrix — {baseline ckpt, ervo ckpt, mpc} x crowd
     strategy {pedscene, rvoscene, ervoscene} on the ervo_crowd scenario,
     all cells on the same bank, reporting ped_min_dist and the
     InfoLogWrapper 1 m close-to-human rate alongside the outcome rates.
  C. Beep ablation — the act_dim-3 ERVO checkpoint on ervoscene with the
     beep channel live vs forced OFF (the IROS-21 causal claim: beeping
     makes crowd passage safer, ervoscene.h:13-22 + img_env.cpp:323-342).

    python -m img_env_tpu_torch.eval.experiment_matrix --episodes 50 \
        --parts A --no-figures --out matrix_out

The configs are the JSON the committed checkpoints were trained with
(``artifacts/stage5_policy_env.json`` = baseline_10obs_5ped.yaml,
``ervo_policy_env.json`` = ervo_crowd.yaml; a yaml path needs PyYAML) and
the checkpoints the port's npz.  The episodes are the port's own: a JAX
bank file's keys load as seeds (F4).  Writes OUT/matrix.csv (one row per
cell) and, for part A, OUT/compare/ (the indicator csv, each method's
EpisodeRecorder npz and, unless ``--no-figures``, the figures; ``--draw``
draws them later from the saved recorders where matplotlib exists).
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os


PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(PKG, "artifacts")
BASELINE_CFG = os.path.join(ARTIFACTS, "stage5_policy_env.json")
ERVO_CFG = os.path.join(ARTIFACTS, "ervo_policy_env.json")
BANK50 = os.path.join(os.path.dirname(PKG),
                      "docs/artifacts/baseline_curriculum/bank50.npz")
STAGE5 = os.path.join(ARTIFACTS, "stage5_policy.npz")
ERVO = os.path.join(ARTIFACTS, "ervo_policy.npz")
CROWDS = ("pedscene", "rvoscene", "ervoscene")
METHODS_A = ("ckpt", "mpc", "random")

COLS = ["part", "config", "crowd", "method", "beep", "episodes",
        "arrive_rate", "static_coll_rate", "ped_coll_rate",
        "other_coll_rate", "stuck_rate", "avg_arrive_steps",
        "ped_min_dist_mean", "close_to_human_rate", "wall_s"]


def crowd_variant(ervo: dict, crowd: str, act_dim: int) -> dict:
    """Part B's config of one crowd strategy and action width."""
    d = dict(ervo)
    d["ped_sim"] = dict(ervo["ped_sim"], type=crowd)
    d["act_dim"] = act_dim
    return d


def run_cell(cfg_dict, method, bank, episodes, *, ckpt=None,
             force_beep_off=False, record=False, mpc_cfg=None,
             max_steps=None, device="cuda"):
    """One cell: ``evaluate_batched`` of 'mpc' (MPPI H=8, K=64), 'random'
    or a checkpoint's mean action over the bank's first ``episodes``, for
    at most ``max_steps`` control steps (default: the protocol's
    ``time_max + 1``)."""
    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.eval.batched_eval import evaluate_batched
    from img_env_tpu_torch.eval.evaluate import random_policy

    cfg = EnvConfig.from_dict(dict(cfg_dict))
    kw = dict(episodes=episodes, max_steps=max_steps, bank=bank,
              record=record, force_beep_off=force_beep_off, device=device)
    if method == "mpc":
        from img_env_tpu_torch.mpc import MppiConfig

        return evaluate_batched(cfg, None, mpc=mpc_cfg or MppiConfig(
            horizon=8, samples=64), **kw)
    if method == "random":
        return evaluate_batched(cfg, random_policy(cfg), **kw)
    from img_env_tpu_torch.models.policy import load_ckpt_policy

    return evaluate_batched(cfg, load_ckpt_policy(cfg, ckpt, device)[0],
                            **kw)


def matrix_row(part, config, crowd, method, beep, summary) -> dict:
    """One ``matrix.csv`` row of a cell's summary."""
    return {
        "part": part, "config": config, "crowd": crowd,
        "method": method, "beep": beep,
        "episodes": summary.get("episodes", 0),
        "arrive_rate": summary.get("arrive_rate", 0.0),
        "static_coll_rate": summary.get("static_coll_rate", 0.0),
        "ped_coll_rate": summary.get("ped_coll_rate", 0.0),
        "other_coll_rate": summary.get("other_coll_rate", 0.0),
        "stuck_rate": summary.get("stuck_rate", 0.0),
        "avg_arrive_steps": summary.get("avg_arrive_steps", 0.0),
        "ped_min_dist_mean": summary.get("ped_min_dist_mean", float("nan")),
        "close_to_human_rate": summary.get("close_to_human_rate",
                                           float("nan")),
        "wall_s": summary.get("wall_s", 0.0),
    }


def write_matrix(path: str, rows) -> None:
    with open(path, "w") as f:
        f.write(",".join(COLS) + "\n")
        for r in rows:
            f.write(",".join(
                f"{r[c]:.4f}" if isinstance(r[c], float) else str(r[c])
                for c in COLS) + "\n")


def draw_part_a(compare_dir: str, cfg_dict: dict, device="cpu") -> dict:
    """Part A's figures and table from the recorders a ``--no-figures``
    run saved in ``compare_dir`` (matplotlib)."""
    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.env.nav_env import NavEnv
    from img_env_tpu_torch.eval.plots import compare_methods
    from img_env_tpu_torch.eval.recorder import EpisodeRecorder

    recorders = {m: EpisodeRecorder.load(
        os.path.join(compare_dir, f"recorder_{m}.npz")) for m in METHODS_A}
    statics = NavEnv(EnvConfig.from_dict(cfg_dict), device).statics
    return compare_methods(recorders, compare_dir, statics=statics)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=50)
    ap.add_argument("--bank", default=BANK50)
    ap.add_argument("--out", default="matrix_out")
    ap.add_argument("--baseline-cfg", default=BASELINE_CFG)
    ap.add_argument("--ervo-cfg", default=ERVO_CFG)
    ap.add_argument("--baseline-ckpt", default=STAGE5)
    ap.add_argument("--ervo-ckpt", default=ERVO)
    ap.add_argument("--parts", default="A,B,C")
    ap.add_argument("--no-figures", action="store_true",
                    help="part A writes its table and recorders, no "
                         "figures (no matplotlib needed)")
    ap.add_argument("--draw", action="store_true",
                    help="only draw part A's figures from the recorders "
                         "under OUT/compare")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from img_env_tpu_torch.config import read_config
    from img_env_tpu_torch.eval.recorder import ScenarioBank

    compare_dir = os.path.join(args.out, "compare")
    if args.draw:
        draw_part_a(compare_dir, read_config(args.baseline_cfg), args.device)
        print(f"wrote figures under {compare_dir}/")
        return
    os.makedirs(args.out, exist_ok=True)
    bank = (ScenarioBank.load(args.bank) if os.path.exists(args.bank)
            else ScenarioBank.generate(0, args.episodes))
    parts = set(args.parts.split(","))
    rows = []

    def add_row(part, config, crowd, method, beep, summary):
        rows.append(matrix_row(part, config, crowd, method, beep, summary))
        print(f"[{part}] {config}/{crowd}/{method}"
              f"{' beep-off' if beep == 'off' else ''}: "
              f"arrive {summary.get('arrive_rate', 0):.2f} "
              f"static {summary.get('static_coll_rate', 0):.2f} "
              f"ped {summary.get('ped_coll_rate', 0):.2f} "
              f"stuck {summary.get('stuck_rate', 0):.2f} "
              f"({summary.get('wall_s', 0):.0f}s)", flush=True)

    # ---------------- Part A: Sensors-20 A/B --------------------------
    if "A" in parts:
        from img_env_tpu_torch.eval.plots import compare_methods

        base = read_config(args.baseline_cfg)
        recorders = {}
        for method in METHODS_A:
            summary, dones, rec = run_cell(
                base, method, bank, args.episodes, ckpt=args.baseline_ckpt,
                record=True, device=args.device)
            add_row("A", "baseline_10obs_5ped", "pedscene", method, "n/a",
                    summary)
            recorders[method] = rec
        os.makedirs(compare_dir, exist_ok=True)
        for method, rec in recorders.items():
            rec.save(os.path.join(compare_dir, f"recorder_{method}.npz"))
        if args.no_figures:
            table = compare_methods(recorders, compare_dir, figures=False)
        else:
            table = draw_part_a(compare_dir, base, args.device)
        for name, row in table.items():
            print(f"  A-table {name:8s} {row}")

    # ---------------- Part B: IROS-21 crowd matrix ---------------------
    if "B" in parts:
        ervo = read_config(args.ervo_cfg)
        have_ervo_ckpt = os.path.exists(args.ervo_ckpt)
        for crowd in CROWDS:
            methods = [("ckpt_baseline", args.baseline_ckpt, 2),
                       ("mpc", None, 2)]
            if have_ervo_ckpt:
                methods.insert(1, ("ckpt_ervo", args.ervo_ckpt, 3))
            for method, ckpt, act_dim in methods:
                name = "ckpt" if method.startswith("ckpt") else method
                summary, dones = run_cell(
                    crowd_variant(ervo, crowd, act_dim), name, bank,
                    args.episodes, ckpt=ckpt, device=args.device)
                add_row("B", "ervo_crowd", crowd, method,
                        "policy" if act_dim == 3 else "n/a", summary)

    # ---------------- Part C: beep ablation ----------------------------
    if "C" in parts and os.path.exists(args.ervo_ckpt):
        ervo = read_config(args.ervo_cfg)
        for beep, off in (("on", False), ("off", True)):
            summary, dones = run_cell(
                ervo, "ckpt", bank, args.episodes, ckpt=args.ervo_ckpt,
                force_beep_off=off, device=args.device)
            add_row("C", "ervo_crowd", "ervoscene", "ckpt_ervo", beep,
                    summary)

    path = os.path.join(args.out, "matrix.csv")
    write_matrix(path, rows)
    print(f"wrote {path} ({len(rows)} cells x {args.episodes} episodes)")


if __name__ == "__main__":
    main()
