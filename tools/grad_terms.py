"""The error model of the training gradient on the card: how far the card's
full-width gradient lies from the CPU's, against the sum of the magnitudes
of the per-sample terms whose sum it is.

    python3 tools/grad_terms.py [--minibatches 6] [--out FILE]

The inputs of ``tests/test_torch_card_train.py``'s gradient test: the
stage-5 continuation (``TRAIN_ARGS`` of ``card_common.py``, one update
through ``train.run``), then one unroll of its policy, whose samples give
``--minibatches`` random minibatches of ``GRAD_SAMPLES``.  For each: the
gradient of every leaf on the card (``ppo.loss_and_grads``, TF32 off) and
on the CPU, the TF32 control (a bare ``backward`` under torch's default
flags), and ``ppo.grad_term_sums`` (each element's sum over the samples
of its term's magnitude).  Per leaf it records the largest |gradient|, the
largest term sum, and the worst error of the card and of the control as a
share of
(a) 1e-4 of the leaf's largest |gradient| (an earlier form of the check),
(b) the element's own term sum, (c) the leaf's largest term sum (the
scale of ``ppo.GRAD_REL``); ``--out`` writes them, and each minibatch's
summary line prints the worst leaf of each.  Needs a card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import card_common as cs  # noqa: E402
from img_env_tpu_torch.train import ppo, run  # noqa: E402
from torch.func import functional_call  # noqa: E402


# an earlier form of the check: each leaf within 1e-4 of its largest
# |gradient|, plus 1e-8
OLD_TOL = 1e-4


def leaf_stats(err, want, sums):
    """(worst |err| / (OLD_TOL * max|want| + 1e-8), worst |err| / sums
    over the elements with a positive sum, worst |err| / the leaf's
    largest sum)."""
    pos = sums > 0
    return (float(err.max() / (OLD_TOL * want.abs().max() + 1e-8)),
            float((err[pos] / sums[pos]).max()) if bool(pos.any()) else 0.0,
            float(err.max() / sums.max()) if bool(pos.any()) else 0.0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minibatches", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.perf_counter()
    targs = list(cs.TRAIN_ARGS)
    targs[targs.index("--updates") + 1] = "1"
    res = run.train(run.parse_args(targs), log=lambda s: None)
    targs = run.parse_args(targs)
    pcfg = ppo.PpoConfig(unroll=targs.unroll, lr=targs.lr,
                         epochs=targs.epochs, minibatches=targs.minibatches,
                         ent_coef=targs.ent_coef,
                         reward_scale=targs.reward_scale)
    model, ts, gen = res["model"], res["ts"], res["generator"]
    _, obs, traj = res["train_step"].rollout(ts.params, res["states"],
                                             res["obs"], gen, None)
    with torch.no_grad():
        last_value = functional_call(model, ts.params,
                                     ppo.obs_features(obs, True))[-1]
    data, _ = ppo.rollout_data(traj, last_value, pcfg)
    model_c = copy.deepcopy(model).cpu()
    params_c = {k: v.cpu() for k, v in ts.params.items()}
    cpu = lambda x: None if x is None else x.cpu()
    rows = []
    for k in range(args.minibatches):
        idx = torch.randperm(data[1].shape[0], generator=gen,
                             device=gen.device)[:cs.GRAD_SAMPLES]
        mb = ppo.take(data, idx)
        mb_c = (tuple(cpu(f) for f in mb[0]), *(cpu(x) for x in mb[1:]))
        _, _, g_card = ppo.loss_and_grads(model, ts.params, mb, pcfg)
        _, _, g_cpu = ppo.loss_and_grads(model_c, params_c, mb_c, pcfg)
        p = {kk: v.detach().requires_grad_(True)
             for kk, v in ts.params.items()}
        loss, _ = ppo.minibatch_loss(model, p, mb, pcfg)
        loss.backward()
        sums = {kk: v.cpu() for kk, v in ppo.grad_term_sums(
            model, ts.params, mb, pcfg).items()}
        leaves = {}
        for name, want in g_cpu.items():
            card = leaf_stats((g_card[name].cpu() - want).abs(), want,
                              sums[name])
            ctl = leaf_stats((p[name].grad.cpu() - want).abs(), want,
                             sums[name])
            leaves[name] = {
                "max_grad": float(want.abs().max()),
                "max_sum": float(sums[name].max()),
                "card_old": card[0], "card_elem": card[1],
                "card_leaf": card[2],
                "tf32_old": ctl[0], "tf32_elem": ctl[1],
                "tf32_leaf": ctl[2]}
        bias = "pi_mean.bias"
        leaves[bias]["elements"] = {
            "grad": g_cpu[bias].tolist(), "sum": sums[bias].tolist(),
            "card_err": (g_card[bias].cpu() - g_cpu[bias]).tolist(),
            "tf32_err": (p[bias].grad.cpu() - g_cpu[bias]).tolist()}
        worst = lambda key: max(leaves, key=lambda n: leaves[n][key])
        rows.append({"leaves": leaves})
        print(f"minibatch {k}: worst leaf, ratio: " + "; ".join(
            f"{key} {worst(key)} {leaves[worst(key)][key]:.4g}"
            for key in ("card_old", "card_elem", "card_leaf", "tf32_old",
                        "tf32_leaf"))
            + f"; {bias} {leaves[bias]['elements']}", flush=True)
    out = {"device": torch.cuda.get_device_name(0), "card": cs.card_line(),
           "samples": cs.GRAD_SAMPLES, "seconds": time.perf_counter() - t0,
           "minibatches": rows}
    line = json.dumps(out)
    print(json.dumps({k: v for k, v in out.items() if k != "minibatches"}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
