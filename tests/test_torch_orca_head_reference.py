"""The port's 'orca' prediction head against the benchmark's plain
reference (``navbench/reference/mpc/orca_head.py``) on the CPU, at a small
ERVO scene (4 robots, 12 ORCA leg peds, 2 rectangles, so that the reset
splits segments): ``MpcController.act`` with the same MPPI noise gives the
same commands, nominal plan and costs.  Also: ``NavEnv.step`` hands
``beep_u`` to ``step_fn`` and, without it, steps as ``step_fn`` does; the
``mppi_beep`` actor's beep rule on a hand-built observation.  Imports
nothing of JAX."""

import os

import pytest
import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.mpc.controller import MpcController
from img_env_tpu_torch.mpc.mppi import MppiConfig
from navbench import check
from navbench.drive import tmap
from navbench.parts import load_part
from navbench.reference.config import EnvConfig as RefEnvConfig
from navbench.reference.env.orca_env import OrcaNavEnv
from navbench.reference.mpc import mppi as ref_mppi
from navbench.reference.mpc import orca_head

torch.set_num_threads(1)

NAVBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "navbench")
BOX = [[2.5, 7.5, 2.5, 7.5]]
ERVO = {
    "control_hz": 0.4,
    "robot": {"total": 4, "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
              "begin_poses_type": ["range"], "begin_poses": BOX,
              "target_poses_type": ["range"], "target_poses": BOX},
    "object": {"total": 2, "shape": ["rectangle"],
               "size_range": [[-0.15, 0.15, -0.15, 0.15]],
               "poses_type": ["range"], "poses": BOX},
    "ped_sim": {"total": 12, "type": "ervoscene", "max_speed": [0.5],
                "shape": ["leg"], "size": [[0.0, 0.1, 0.1]],
                "begin_poses_type": ["range"], "begin_poses": BOX,
                "target_poses_type": ["range"], "target_poses": BOX,
                "go_back": "yes"},
    "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
    "view_map": {"resolution": 0.05, "width": 3, "height": 3},
    "range_total": 64, "max_ped": 10, "beep_r": 1.0, "ped_ca_p": 0.8,
}
K, H = 16, 4
# every robot forward and turning, the even ones beeping
ACT = torch.tensor([[0.4, 0.3, 1.0], [0.3, -0.2, 0.0]]).repeat(2, 1)


def ervo_state(seed: int = 3):
    """The program's env and a state two beeping steps after its reset
    (so that the peds move), and the beep draws of a third step."""
    env = NavEnv(EnvConfig.from_dict(ERVO), "cpu", seed=seed)
    state, _ = env.reset()
    gen = torch.Generator().manual_seed(seed)
    for _ in range(2):
        state = env.step(state, ACT, beep_u=torch.rand(4, generator=gen))[0]
    return env, state, torch.rand(4, generator=gen)


def test_orca_head_act_equals_reference():
    """The program's 'orca'-head act and the reference's, from the same
    state and noise, the reference's state on its own split of the
    rectangles.  Tolerance 0: the reference is a copy of the same torch
    operations in the same order on the same device, so on the CPU the
    bits agree; the 'cv' head's act differs, so the comparison shows the
    head."""
    env, state, _ = ervo_state()
    assert float(state.peds.vel.abs().max()) > 0
    assert state.obstacles.segs is not None
    cfg = MppiConfig(horizon=H, samples=K)
    noise = torch.randn((4, K, H, 2), generator=torch.Generator()
                        .manual_seed(11))
    ctl = MpcController(env, cfg, ped_prediction="orca")
    a, ms, c = ctl.act(state, ctl.init_state(), noise)

    ref = check.load_reference()
    ref_env = OrcaNavEnv(RefEnvConfig.from_dict(ERVO), "cpu", seed=3)
    segs = ref_env.split(state.obstacles.aabb)
    for f in segs._fields:
        assert torch.equal(getattr(segs, f),
                           getattr(state.obstacles.segs, f)), f
    rstate = check.to_ref(ref, state._replace(
        obstacles=state.obstacles._replace(segs=None)))
    rstate = rstate._replace(obstacles=rstate.obstacles._replace(segs=segs))
    rcfg = ref_mppi.MppiConfig(horizon=H, samples=K)
    rctl = orca_head.MpcController(ref_env, rcfg, ped_prediction="orca")
    ra, rms, rc = rctl.act(rstate, rctl.init_state(), noise)
    assert torch.equal(a, ra)
    assert torch.equal(ms.nominal, rms.nominal)
    assert torch.equal(c, rc)

    cv = orca_head.MpcController(ref_env, rcfg, ped_prediction="cv")
    _, cms, _ = cv.act(rstate, cv.init_state(), noise)
    assert not torch.equal(cms.nominal, rms.nominal)


@pytest.mark.parametrize("given", [True, False], ids=["beep_u", "drawn"])
def test_step_hands_beep_u_to_step_fn(given):
    """``NavEnv.step(state, a, beep_u=u)`` equals ``step_fn(state, a, u)``
    leaf by leaf; without ``beep_u`` it equals ``step_fn(state, a)`` from
    the same generator state."""
    env, state, u = ervo_state()
    twin, _, _ = ervo_state()
    if given:
        got = env.step(state, ACT, beep_u=u)
        want = twin.step_fn(state, ACT, u)
    else:
        got = env.step(state, ACT)
        want = twin.step_fn(state, ACT)
    assert int(got[4]["beeps"].sum()) > 0
    same = []
    tmap(lambda x, y: same.append(x.dtype == y.dtype and torch.equal(x, y)),
         got, want)
    assert len(same) > 10 and all(same)


def test_mppi_beep_rule():
    """The actor's rule: the beep column 1 where ``ped_min_dists`` is below
    ``beep_r`` (1.0 m), else 0; the commands' other columns kept."""
    beeping = load_part(NAVBENCH, "actors", "mppi_beep").beeping
    actions = torch.tensor([[0.1, 0.2, 0.0], [0.3, -0.4, 1.0],
                            [0.5, 0.6, 1.0], [0.0, 0.0, 0.0]])
    dists = torch.tensor([0.5, 1.0, 7.0, -0.2])
    got = beeping(actions, dists, 1.0)
    assert torch.equal(got[:, :2], actions[:, :2])
    assert torch.equal(got[:, 2], torch.tensor([1.0, 0.0, 0.0, 1.0]))
    scenes = beeping(actions[None].expand(2, -1, -1), dists.expand(2, -1),
                     1.0)
    assert torch.equal(scenes, got.expand(2, -1, -1))
