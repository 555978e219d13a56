"""Multi-method A/B comparison over one fixed scenario bank (port of
examples/compare_methods.py).

The reference workflow records one rosbag per method on identical episode
draws, then BagReader renders comparison figures and the cal_indicator
table (envs/utils/bag/bag.py).  Here the bank is a ScenarioBank of seeds,
each method replays the SAME episode sequence through the facade, and
``eval.plots.compare_methods`` writes the indicator csv and, unless
``--no-figures``, the per-method trajectory figures and the comparison bar
figure (matplotlib).

    python -m img_env_tpu_torch.eval.compare_methods [cfg.json] \
        --episodes 6 --methods mpc,random --out compare_out
"""

from __future__ import annotations

import argparse
import time

from img_env_tpu_torch.eval.evaluate import (STAGE5_CFG, STAGE5_NPZ,
                                             FacadeActor, bank_facade,
                                             run_episodes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg", nargs="?", default=STAGE5_CFG)
    ap.add_argument("--episodes", type=int, default=6)
    ap.add_argument("--max-steps", type=int, default=60)
    ap.add_argument("--methods", default="mpc,random",
                    help="comma list of mpc | random | ckpt")
    ap.add_argument("--ckpt", default=STAGE5_NPZ,
                    help="policy npz or the port's checkpoint (for 'ckpt')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="compare_methods_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-figures", action="store_true",
                    help="write the indicator csv only (no matplotlib)")
    args = ap.parse_args(argv)

    from img_env_tpu_torch.eval.plots import compare_methods
    from img_env_tpu_torch.eval.recorder import ScenarioBank

    bank_path = f"{args.out}_bank.npz"
    ScenarioBank.generate(args.seed, args.episodes).save(bank_path)
    recorders = {}
    statics = None
    for method in args.methods.split(","):
        method = method.strip()
        env = bank_facade(args.cfg, bank_path, args.episodes, args.device)
        statics = env.core.statics
        actor = FacadeActor(env, method, args.ckpt, seed=1)
        t0 = time.perf_counter()
        run_episodes(env, actor, args.episodes, args.max_steps)
        print(f"{method}: {args.episodes} episodes in "
              f"{time.perf_counter() - t0:.1f}s")
        recorders[method] = env.recorder

    table = compare_methods(recorders, args.out, statics=statics,
                            figures=not args.no_figures)
    for name, row in table.items():
        print(f"  {name:8s} {row}")
    print(f"{'csv' if args.no_figures else 'figures + csv'} under "
          f"{args.out}/")


if __name__ == "__main__":
    main()
