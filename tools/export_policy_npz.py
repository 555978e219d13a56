"""Export a JAX-package policy checkpoint for ``img_env_tpu_torch``.

    python tools/export_policy_npz.py CKPT_DIR ENV_YAML OUT_PREFIX [--act-dim N]

Restores an orbax ``CrowdNavPolicy`` checkpoint the way
``img_env_tpu.models.policy.load_ckpt_policy`` does (shape-checked against
a fresh init for the env config), and writes

  * ``OUT_PREFIX.npz``: the flat float32 parameters keyed by flax path
    (``params/<module>/.../kernel``), which
    ``img_env_tpu_torch.models.policy.load_policy_npz`` reads;
  * ``OUT_PREFIX_env.json``: the env config it was trained with, as the
    yaml's dict, so that a machine without orbax or PyYAML can rebuild it.

This tool imports JAX, the JAX package and orbax; the port imports none of
them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def flat_params(tree, prefix: str = "") -> dict:
    """{'params/<module>/.../<leaf>': float32 array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(flat_params(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def restore(ckpt_dir: str, raw_cfg: dict) -> dict:
    """The checkpoint's flax variables ({'params': ...}) for ``raw_cfg``."""
    import jax

    from img_env_tpu.config import EnvConfig
    from img_env_tpu.models.policy import PolicyConfig, init_policy
    from img_env_tpu.train import checkpoint as ckpt_mod

    pcfg = PolicyConfig.from_env_config(EnvConfig.from_dict(raw_cfg))
    _, params0 = init_policy(jax.random.PRNGKey(0), pcfg, batch=1)
    return ckpt_mod.restore(ckpt_dir, like={"params": params0})["params"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("env_yaml")
    ap.add_argument("out_prefix")
    ap.add_argument("--act-dim", type=int, default=None,
                    help="override the yaml's act_dim")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from img_env_tpu.config import read_yaml

    raw = read_yaml(args.env_yaml)
    if args.act_dim is not None:
        raw["act_dim"] = args.act_dim
    flat = flat_params(restore(args.ckpt, raw))
    np.savez(args.out_prefix + ".npz", **flat)
    with open(args.out_prefix + "_env.json", "w", encoding="utf-8") as f:
        json.dump(raw, f, indent=1, sort_keys=True)
        f.write("\n")
    n = sum(v.size for v in flat.values())
    print(json.dumps({"npz": args.out_prefix + ".npz", "arrays": len(flat),
                      "parameters": int(n)}))


if __name__ == "__main__":
    # run as a script from anywhere: the repository root holds img_env_tpu
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
