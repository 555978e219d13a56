"""Episode recording, deterministic replay, sim-state checkpointing (torch
port of ``img_env_tpu.eval.recorder``).

The reference's persistence story (SURVEY.md §5) has two halves, both via
rosbag: init-pose bags (N episode scenarios so that different methods see
identical resets, yaml_env.py:268-294, 333-358) and EpRes bags (per-episode
pose/velocity histories, img_env.cpp:527-545).  Here both are arrays:

  * ``ScenarioBank`` stores one int64 seed per episode (or explicit
    ``ScenarioSample``s).  Episode e is the scenario that
    ``sample_scenario_retry`` draws from a CPU ``torch.Generator`` seeded
    with seed e, moved to the env's device: an episode is a pure function
    of its seed, whatever the device, the scene order or the batch size.
    These are the port's own episodes: torch cannot reproduce the JAX
    package's threefry draws, so a JAX bank file (``keys [E, 2] uint32``)
    loads as one seed per key, ``(k0 << 32 | k1) mod 2**63``, and gives
    other episodes than the JAX package draws from those keys;
  * ``EpisodeRecorder`` accumulates per-step state on the host and saves
    npz;
  * ``save_state``/``load_state`` snapshot a ``WorldState`` (any NamedTuple
    tree of tensors).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from img_env_tpu_torch.core.state import map_tree
from img_env_tpu_torch.env.sampler import (
    SamplerSpec,
    ScenarioSample,
    sample_scenario_retry,
)

_SEED_MASK = (1 << 63) - 1


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class ScenarioBank:
    """Fixed episode scenarios (init-pose-bag analogue): int64 seeds, or
    explicit ``ScenarioSample``s (one per episode; tests inject the JAX
    sampler's this way)."""

    def __init__(self, seeds: Optional[np.ndarray] = None,
                 samples: Optional[Sequence[ScenarioSample]] = None):
        if samples is not None:
            samples = list(samples)
            seeds = np.arange(len(samples), dtype=np.int64)
        self.seeds = (np.zeros((0,), np.int64) if seeds is None
                      else np.asarray(seeds, np.int64).reshape(-1))
        self.samples = samples

    @staticmethod
    def generate(seed: int, episodes: int) -> "ScenarioBank":
        rng = np.random.default_rng(seed)
        return ScenarioBank(rng.integers(0, _SEED_MASK, episodes,
                                         dtype=np.int64))

    @staticmethod
    def from_jax_keys(keys: np.ndarray) -> "ScenarioBank":
        """One seed per JAX PRNG key [E, 2] uint32 (the port's own
        episodes, not the JAX package's)."""
        k = np.asarray(keys, np.uint64).reshape(-1, 2)
        return ScenarioBank(((k[:, 0] << np.uint64(32)) | k[:, 1])
                            & np.uint64(_SEED_MASK))

    def __len__(self) -> int:
        return self.seeds.shape[0]

    def generator(self, episode: int) -> torch.Generator:
        """A CPU generator seeded with episode ``episode``'s seed."""
        return torch.Generator().manual_seed(
            int(self.seeds[episode % len(self)]))

    def sample(self, episode: int, spec: SamplerSpec,
               device="cpu") -> ScenarioSample:
        """Episode ``episode``'s scenario (cycling), on ``device``."""
        if self.samples is not None:
            s = self.samples[episode % len(self)]
        else:
            s = sample_scenario_retry(spec, self.generator(episode), "cpu")
        return ScenarioSample(*(torch.as_tensor(x).to(device) for x in s))

    def save(self, path: str) -> None:
        arrays = {"seeds": self.seeds}
        if self.samples is not None:
            for f in ScenarioSample._fields:
                arrays["sample_" + f] = np.stack(
                    [_np(getattr(s, f)) for s in self.samples])
        np.savez(path, **arrays)

    @staticmethod
    def load(path: str) -> "ScenarioBank":
        """A bank saved by ``save``, or a JAX bank file (``keys``)."""
        with np.load(path) as z:
            if "keys" in z:
                return ScenarioBank.from_jax_keys(z["keys"])
            if "sample_ok" in z:
                fields = [z["sample_" + f] for f in ScenarioSample._fields]
                return ScenarioBank(samples=[
                    ScenarioSample(*(torch.as_tensor(x[e]) for x in fields))
                    for e in range(fields[0].shape[0])])
            return ScenarioBank(z["seeds"])


@dataclasses.dataclass
class EpisodeRecord:
    """One episode's histories (EpRes message analogue, msg/EpRes.msg)."""

    robot_poses: List[np.ndarray] = dataclasses.field(default_factory=list)
    robot_vws: List[np.ndarray] = dataclasses.field(default_factory=list)
    ped_poses: List[np.ndarray] = dataclasses.field(default_factory=list)
    rewards: List[np.ndarray] = dataclasses.field(default_factory=list)
    goals: Optional[np.ndarray] = None      # [N,2] episode goals
    dones_info: Optional[np.ndarray] = None
    result: str = ""

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "robot_poses": np.asarray(self.robot_poses),   # [T,N,3]
            "robot_vws": np.asarray(self.robot_vws),       # [T,N,2]
            "ped_poses": np.asarray(self.ped_poses),       # [T,M,2]
            "rewards": np.asarray(self.rewards),           # [T,N]
        }


class EpisodeRecorder:
    """Accumulates episode records host-side; save/load npz; computes the
    BagReader-style summary (arrival rate, extra time/distance)."""

    def __init__(self, dt: float = 0.4):
        self.dt = dt
        self.episodes: List[EpisodeRecord] = []
        self._cur: Optional[EpisodeRecord] = None

    def start_episode(self) -> None:
        self._cur = EpisodeRecord()
        self.episodes.append(self._cur)

    def add_step(self, state, reward=None, speeds=None) -> None:
        if self._cur is None:
            self.start_episode()
        if self._cur.goals is None:
            self._cur.goals = _np(state.robots.goal)
        self._cur.robot_poses.append(_np(state.robots.pose))
        self._cur.robot_vws.append(_np(state.robots.vw_last0 if speeds is None
                                       else speeds))
        self._cur.ped_poses.append(_np(state.peds.pos))
        if reward is not None:
            self._cur.rewards.append(_np(reward))

    def end_episode(self, dones_info=None, result: str = "") -> None:
        if self._cur is not None:
            if dones_info is not None:
                self._cur.dones_info = _np(dones_info)
            self._cur.result = result
        self._cur = None

    # ------------------------------------------------------------------
    def summary(self, v_max: float = 0.6) -> Dict[str, float]:
        """BagReader-style stats (bag.py:897-1040): arrival rate, avg path
        time/distance, avg |v|/|w|, and the extra time/distance beyond the
        straight start->goal optimum (the reference's extra-time at v_max
        0.6 m/s and extra-distance measures)."""
        eps = [e for e in self.episodes if e.robot_poses]
        if not eps:
            return {}
        arrive = sum(
            1 for e in eps
            if e.dones_info is not None and np.any(np.asarray(e.dones_info) == 5)
        )
        times, dists, vs, ws = [], [], [], []
        extra_t, extra_d = [], []
        for e in eps:
            poses = np.asarray(e.robot_poses)   # [T,N,3]
            t_ep = poses.shape[0] * self.dt
            times.append(t_ep)
            seg = np.linalg.norm(np.diff(poses[:, :, :2], axis=0), axis=-1)
            path = seg.sum(0) if poses.shape[0] > 1 else np.zeros(poses.shape[1])
            dists.append(float(path.mean()))
            if e.goals is not None:
                straight = np.linalg.norm(
                    np.asarray(e.goals) - poses[0, :, :2], axis=-1)
                extra_d.append(float((path - straight).mean()))
                extra_t.append(float((t_ep - straight / v_max).mean()))
            vws = np.asarray(e.robot_vws)
            if vws.size:
                vs.append(float(np.abs(vws[..., 0]).mean()))
                ws.append(float(np.abs(vws[..., 1]).mean()))
        return {
            "episodes": float(len(eps)),
            "arrive_rate": arrive / len(eps),
            "avg_path_time": float(np.mean(times)),
            "avg_distance": float(np.mean(dists)),
            "avg_extra_time": float(np.mean(extra_t)) if extra_t else 0.0,
            "avg_extra_distance": float(np.mean(extra_d)) if extra_d else 0.0,
            "avg_abs_v": float(np.mean(vs)) if vs else 0.0,
            "avg_abs_w": float(np.mean(ws)) if ws else 0.0,
        }

    def save(self, path: str) -> None:
        payload: Dict[str, Any] = {"n_episodes": len(self.episodes),
                                   "dt": self.dt}
        arrays = {}
        for i, e in enumerate(self.episodes):
            for k, v in e.arrays().items():
                arrays[f"ep{i}_{k}"] = v
            if e.goals is not None:
                arrays[f"ep{i}_goals"] = e.goals
            if e.dones_info is not None:
                arrays[f"ep{i}_dones_info"] = e.dones_info
        np.savez_compressed(path, meta=json.dumps(payload), **arrays)

    @staticmethod
    def load(path: str) -> "EpisodeRecorder":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            rec = EpisodeRecorder(dt=meta["dt"])
            for i in range(meta["n_episodes"]):
                e = EpisodeRecord()
                if f"ep{i}_robot_poses" in z:
                    e.robot_poses = list(z[f"ep{i}_robot_poses"])
                    e.robot_vws = list(z[f"ep{i}_robot_vws"])
                    e.ped_poses = list(z[f"ep{i}_ped_poses"])
                    e.rewards = list(z[f"ep{i}_rewards"])
                if f"ep{i}_goals" in z:
                    e.goals = z[f"ep{i}_goals"]
                if f"ep{i}_dones_info" in z:
                    e.dones_info = z[f"ep{i}_dones_info"]
                rec.episodes.append(e)
            return rec


# ---------------------------------------------------------------------------
# WorldState checkpointing
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    map_tree(out.append, tree)
    return [x for x in out if x is not None]


def save_state(path: str, state) -> None:
    """Snapshot a NamedTuple tree of tensors (a ``WorldState``) to npz."""
    np.savez_compressed(path, **{f"leaf{i}": _np(x)
                                 for i, x in enumerate(_leaves(state))})


def load_state(path: str, like):
    """Restore a snapshot into the structure, dtypes and devices of
    ``like`` (shape-checked)."""
    with np.load(path) as z:
        arrays = iter([z[f"leaf{i}"] for i in range(len(z.files))])

    def restore(ref):
        arr = next(arrays)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"snapshot shape {arr.shape} != expected "
                             f"{tuple(ref.shape)}")
        return torch.as_tensor(arr, dtype=ref.dtype, device=ref.device)

    return map_tree(restore, like)
