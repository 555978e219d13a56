"""TestEpisode-style evaluation over a fixed scenario bank (port of
examples/evaluate.py).

    python -m img_env_tpu_torch.eval.evaluate [cfg.json] --episodes 20 \
        --policy mpc --bank bank.npz --record episodes.npz --plots eval_out

Mirrors the reference's evaluation workflow (TestEpisodeWrapper +
init-pose bags + BagReader, SURVEY.md §4): every method evaluated against
the same ``--bank`` sees the same episode sequence; metrics cover
arrive/collision/stuck rates, smoothness (jerk, w-variance, zero
crossings), and extra time/distance vs the straight-line optimum.  The
default config and checkpoint are the committed stage-5 policy's
(``artifacts/stage5_policy_env.json``, ``stage5_policy.npz``); a yaml
config needs PyYAML and ``--plots`` matplotlib.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")
STAGE5_CFG = os.path.join(ARTIFACTS, "stage5_policy_env.json")
STAGE5_NPZ = os.path.join(ARTIFACTS, "stage5_policy.npz")


def random_policy(cfg, seed: int = 0):
    """Uniform (v, w) commands for a scene batch's robots ([S, N, 2]), the
    reference's env_test.py policy."""
    rng = np.random.default_rng(seed)

    def policy(generator, obs):
        s = obs.vector_states.shape[0]
        return rng.uniform([0.0, -0.9], [0.6, 0.9], (s, cfg.robot.total, 2))

    return policy


class FacadeActor:
    """One method's commands for the facade's robots ([N, 2] numpy): 'mpc'
    (MPPI H=8, K=64, planning from the env's state), 'ckpt' (the policy's
    mean action from ``last_raw_obs``) or 'random'."""

    def __init__(self, env, method: str, ckpt: str = STAGE5_NPZ,
                 seed: int = 0):
        self.env = env
        self.ctl = self.policy_fn = None
        if method == "mpc":
            from img_env_tpu_torch.mpc import MpcController, MppiConfig

            self.ctl = MpcController(env.core, MppiConfig(horizon=8,
                                                          samples=64),
                                     seed=seed)
        elif method == "ckpt":
            from img_env_tpu_torch.models.policy import load_ckpt_policy

            self.policy_fn = load_ckpt_policy(env.cfg, ckpt, env.device)[0]
        elif method != "random":
            raise SystemExit(f"unknown method {method!r}")
        self.rng = np.random.default_rng(0)
        self.ms = None

    def start(self) -> None:
        """A new episode: the planner's warm start is dropped."""
        self.ms = self.ctl.init_state() if self.ctl else None

    def __call__(self) -> np.ndarray:
        env = self.env
        if self.ctl is not None:
            actions, self.ms, _ = self.ctl.act(env.state, self.ms)
            return actions[:, :2].cpu().numpy()
        if self.policy_fn is not None:
            return self.policy_fn(None, env.last_raw_obs).cpu().numpy()
        n = env.robot_total
        return np.column_stack([self.rng.uniform(0.0, 0.6, n),
                                self.rng.uniform(-0.9, 0.9, n)])


def bank_facade(cfg_path: str, bank: str, episodes: int, device):
    """The facade replaying ``bank``'s episodes (``cfg_type: bag``), with
    the recorder on and no NeverStop auto-reset: the loop manages episode
    boundaries itself, as the reference's TestEpisodeWrapper does, and
    every method emits continuous (v, w) commands."""
    from img_env_tpu_torch.config import read_config
    from img_env_tpu_torch.env.gymapi import make_env

    d = read_config(cfg_path)
    d["cfg_type"] = "bag"
    d["init_pose_bag_name"] = bank
    d["init_pose_bag_episodes"] = episodes
    d["wrapper"] = [w for w in d.get("wrapper", []) if w != "NeverStopWrapper"]
    d["discrete_action"] = False
    return make_env(d, seed=0, record=True, device=device)


def run_episodes(env, actor: FacadeActor, episodes: int,
                 max_steps: int) -> None:
    """``episodes`` bank episodes of at most ``max_steps`` steps, each
    ended in the env's metrics and recorder."""
    for _ in range(episodes):
        env.reset(carry=False)
        actor.start()
        info = None
        for _ in range(max_steps):
            _, _, _, info = env.step(actor())
            if bool(info["all_down"]):
                break
        env.metrics.end_episode(info["dones_info"])
        env.recorder.end_episode(info["dones_info"])


def write_outputs(recorder, statics, record: str, plots: str) -> None:
    """Save the recorder's npz and draw the trajectory, outcome, episode
    split and v/w figures (matplotlib)."""
    if record:
        recorder.save(record)
        print(f"wrote {record}")
    if plots:
        from img_env_tpu_torch.eval import plots as plots_mod

        os.makedirs(plots, exist_ok=True)
        plots_mod.plot_trajectories(
            recorder, statics=statics,
            out=os.path.join(plots, "trajectories.png"))
        plots_mod.plot_outcomes(recorder,
                                out=os.path.join(plots, "outcomes.png"))
        try:
            plots_mod.plot_ep_split(recorder, statics=statics,
                                    out=os.path.join(plots, "ep_split.png"))
            plots_mod.plot_vw_odom(recorder,
                                   out=os.path.join(plots, "vw_odom.png"))
        except ValueError:
            pass          # no completed episodes recorded
        print(f"wrote plots to {plots}/")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg", nargs="?", default=STAGE5_CFG)
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--max-steps", type=int, default=0,
                    help="0 = cfg.time_max + 1 (the TimeLimitWrapper step)")
    ap.add_argument("--policy", choices=("random", "mpc", "ckpt"),
                    default="mpc")
    ap.add_argument("--ckpt", default=STAGE5_NPZ,
                    help="policy npz or the port's checkpoint (used with "
                         "--policy ckpt; deterministic mean actions; cfg "
                         "must match the training config)")
    ap.add_argument("--bank", default="",
                    help="ScenarioBank npz (shared across methods)")
    ap.add_argument("--record", default="", help="write episode npz here")
    ap.add_argument("--plots", default="",
                    help="write trajectory/outcome PNGs here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", action="store_true",
                    help="all episodes as parallel scenes: the trusted "
                         "evaluator (eval/batched_eval.py), the same "
                         "outcomes as the sequential loop; per-step "
                         "smoothness (jerk/w-variance) needs the "
                         "sequential path")
    args = ap.parse_args(argv)

    if args.batch:
        from img_env_tpu_torch.config import EnvConfig
        from img_env_tpu_torch.env.nav_env import NavEnv
        from img_env_tpu_torch.eval.batched_eval import evaluate_batched
        from img_env_tpu_torch.eval.recorder import ScenarioBank
        from img_env_tpu_torch.models.policy import load_ckpt_policy
        from img_env_tpu_torch.mpc import MppiConfig

        cfg = EnvConfig.from_yaml(args.cfg)
        bank = (ScenarioBank.load(args.bank)
                if args.bank and os.path.exists(args.bank) else
                ScenarioBank.generate(0, args.episodes))
        if args.bank and not os.path.exists(args.bank):
            bank.save(args.bank)
        policy = mpc = None
        if args.policy == "ckpt":
            policy = load_ckpt_policy(cfg, args.ckpt, args.device)[0]
        elif args.policy == "random":
            policy = random_policy(cfg)
        else:
            mpc = MppiConfig(horizon=8, samples=64)
        record = bool(args.record or args.plots)
        out = evaluate_batched(cfg, policy, args.episodes,
                               args.max_steps or None, bank=bank, mpc=mpc,
                               record=record, device=args.device)
        for k, v in out[0].items():
            print(f"  {k:22s} {v}")
        if record:
            statics = NavEnv(cfg, args.device).statics if args.plots else None
            write_outputs(out[2], statics, args.record, args.plots)
        return

    env = bank_facade(args.cfg, args.bank, args.episodes, args.device)
    actor = FacadeActor(env, args.policy, args.ckpt)
    t0 = time.perf_counter()
    run_episodes(env, actor, args.episodes,
                 args.max_steps or int(env.cfg.time_max) + 1)
    el = time.perf_counter() - t0
    print(f"{args.episodes} episodes in {el:.1f}s ({args.policy} policy)")
    for k, v in env.metrics.summary().items():
        print(f"  {k:22s} {v}")
    for k, v in env.recorder.summary().items():
        print(f"  {k:22s} {v:.4g}")
    write_outputs(env.recorder, env.core.statics, args.record, args.plots)


if __name__ == "__main__":
    main()
