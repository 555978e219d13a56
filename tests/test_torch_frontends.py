"""The port's hardware and external-simulator frontends
(``img_env_tpu_torch.env.hardware_env``, ``external_env``, ``ros_bridge``,
``gymapi.WrappedFrontend`` and ``make_env``'s 'real_env' / 'gazebo_env'
branches) and ``utils.transforms``, against the JAX package's.

The same scripted feeds (``tests/test_external_env.py``'s mock simulator,
``tests/test_ros_bridge.py``'s fake rospy) drive both packages' frontends;
observations, rewards, dones, ``dones_info``, every info key and the
episode metrics must be equal, the log-polar sensor map synthesized from
the scan included (the JAX side in float32, jitted as it runs).
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env import gymapi as jgymapi
from img_env_tpu.env import ros_bridge as jros
from img_env_tpu.utils import transforms as jtransforms
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.env import gymapi, ros_bridge
from img_env_tpu_torch.env.external_env import (ExternalSimEnv,
                                                ExternalSimTransport)
from img_env_tpu_torch.env.hardware_env import (HardwareEnv, ScanSample,
                                                TrackedPed)
from img_env_tpu_torch.models.policy import PolicyConfig, init_policy
from img_env_tpu_torch.utils import transforms
from tests.test_external_env import MockSim
from tests.test_frontend_wrappers import WRAPPERS
from tests.test_ros_bridge import FakeRospy, _ns
import tests.test_torch_env  # noqa: F401  (one torch thread per worker)


class PortSim(MockSim):
    """The mock simulator answering with the port's sample types."""

    def get_scan(self):
        return ScanSample(**dataclasses.asdict(super().get_scan()))

    def get_peds(self):
        return [TrackedPed(p.xy_world, p.v_world)
                for p in super().get_peds()]


def gazebo_dict(n_beams=90, target=(0.0, 3.0), wrappers=None, **over):
    d = {
        "robot": {"total": 1},
        "ped_sim": {"total": 0},
        "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
        "view_map": {"resolution": 0.05, "width": 3, "height": 3},
        "env_type": "gazebo_env",
        "range_total": n_beams,
        "robot_radius": 0.17,
        "start_global_pose": [0.0, 0.0, 0.0],
        "target_global_pose": list(target),
        "continuous_actions": [[0.0, 0.6], [-0.9, 0.9]],
    }
    if wrappers is not None:
        d["wrapper"] = list(wrappers)
    d.update(over)
    return d


def _transport(mod, sim, peds=True):
    return mod(get_scan=sim.get_scan, get_model_state=sim.get_model_state,
               set_model_state=sim.set_model_state, send_cmd=sim.send_cmd,
               get_contact=sim.get_contact,
               get_peds=sim.get_peds if peds else None)


def gazebo_pair(d, peds=True):
    """(port env, JAX env, port sim, JAX sim) over twin mock simulators."""
    from img_env_tpu.env.external_env import \
        ExternalSimTransport as JaxTransport

    sim_t, sim_j = PortSim(), MockSim()
    env_t = gymapi.make_env(d, device="cpu",
                            transport=_transport(ExternalSimTransport, sim_t,
                                                 peds))
    env_j = jgymapi.make_env(JaxEnvConfig.from_dict(d),
                             transport=_transport(JaxTransport, sim_j, peds))
    for env in (env_t, env_j):
        (env.env if hasattr(env, "stack") else env).real_time = False
    return env_t, env_j, sim_t, sim_j


def assert_same(got, want, what=""):
    """Equal nested lists / dicts / arrays (float32 bits where floats)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)


def _j(fn, *a):
    with jax.enable_x64(False):
        return fn(*a)


# ---------------------------------------------------------------- transforms


def test_transforms_match_jax_and_roundtrip():
    for yaw in [-2.5, -0.3, 0.0, 1.1, 3.0]:
        q = transforms.quaternion_from_yaw(yaw)
        np.testing.assert_array_equal(q, jtransforms.quaternion_from_yaw(yaw))
        np.testing.assert_allclose(transforms.yaw_from_quaternion(q), yaw,
                                   atol=1e-12)
    t, q = [1.0, 2.0, 0.5], transforms.quaternion_from_yaw(0.7)
    m = transforms.matrix_from_t_q(t, q)
    np.testing.assert_array_equal(m, jtransforms.matrix_from_t_q(t, q))
    np.testing.assert_allclose(transforms.t_from_matrix(m), t, atol=1e-12)
    assert transforms.rpy_from_matrix(m) == jtransforms.rpy_from_matrix(m)
    np.testing.assert_allclose(transforms.rpy_from_matrix(m)[2], 0.7,
                               atol=1e-12)
    np.testing.assert_array_equal(transforms.inverse(m),
                                  jtransforms.inverse(m))
    np.testing.assert_allclose(
        transforms.mul_matrix(m, transforms.inverse(m)), np.eye(4),
        atol=1e-12)
    m2 = transforms.matrix_from_t_q([1, 0, 0],
                                    transforms.quaternion_from_yaw(math.pi
                                                                   / 2))
    np.testing.assert_allclose(transforms.transform_point(m2, [1.0, 0.0])
                               [:2], [1.0, 1.0], atol=1e-12)


# ---------------------------------------------------------- external sim


def test_external_env_contract_matches_jax():
    """Reset teleports and observes; arrival (5), hard contact (1) and the
    minimum-laser collision (1) end episodes as in JAX, with equal
    observations (the scan's log-polar map included) on every step."""
    for target, act, expect in (((1.2, 0.0), [0.3, 0.0], 5),
                                ((0.0, 8.0), [0.6, 0.0], 1)):
        env_t, env_j, sim_t, sim_j = gazebo_pair(gazebo_dict(target=target))
        assert isinstance(env_t, ExternalSimEnv)
        sim_t.pose = sim_j.pose = np.asarray([5.0, 5.0, 1.0])
        assert_same(env_t.reset(), _j(env_j.reset), "reset")
        np.testing.assert_array_equal(sim_t.pose, [0, 0, 0])
        code = 0
        for k in range(30):
            out_t = env_t.step(act)
            out_j = _j(env_j.step, act)
            assert_same(out_t, out_j, f"step {k}")
            if out_t[2][0]:
                code = int(out_t[3]["dones_info"][0])
                break
        assert code == expect
    # the minimum laser alone flags a collision (gazebo_env.py:301)
    env_t, env_j, sim_t, sim_j = gazebo_pair(gazebo_dict(target=(0.0, 8.0)))
    env_t.reset(), _j(env_j.reset)
    sim_t.pose = sim_j.pose = np.asarray([sim_t.wall_x - 0.1, 0.0, 0.0])
    out_t, out_j = env_t.step([0.0, 0.0]), _j(env_j.step, [0.0, 0.0])
    assert_same(out_t, out_j)
    assert int(out_t[3]["dones_info"][0]) == 1


def test_sensor_map_from_scan_and_image_matches_jax():
    """The scan-synthesized map (hit and pre-hit cells both present), then
    a fed image, then a fed image of another size (nearest resampling)."""
    env_t, env_j, sim_t, sim_j = gazebo_pair(gazebo_dict())
    sm = env_t.reset()["sensor_maps"]
    assert_same(sm, _j(env_j.reset)["sensor_maps"])
    assert sm.shape == (1, 48, 48) and sm.dtype == np.float32
    assert np.any(sm == 1.0) and np.any(sm == 0.5)
    for shape in ((48, 48), (30, 70)):
        img = np.linspace(0, 1, shape[0] * shape[1],
                          dtype=np.float32).reshape(shape)
        env_t.feed_image(img), env_j.feed_image(img)
        assert_same(env_t.observe(), _j(env_j.observe))


def test_make_env_requires_transport():
    d = gazebo_dict()
    with pytest.raises(ValueError):
        gymapi.make_env(d, device="cpu")
    with pytest.raises(ValueError):
        jgymapi.make_env(JaxEnvConfig.from_dict(d))


# ------------------------------------------------------------- hardware env


def test_hardware_env_processing_matches_jax():
    """deal_scan in the laser frame, norm_lasers with inf and NaN (with and
    without laser_norm), ped_state with peds in and out of the 3 m window
    and the -x+3 image flip, state_goal, and step's arrival."""
    from img_env_tpu.env.hardware_env import HardwareEnv as JaxHardwareEnv
    from img_env_tpu.env.hardware_env import ScanSample as JaxScan
    from img_env_tpu.env.hardware_env import TrackedPed as JaxPed

    for norm in (True, False):
        d = gazebo_dict(env_type="real_env", laser_norm=norm, max_ped=3,
                        control_hz=0.0)
        env_t = HardwareEnv(EnvConfig.from_dict(d), device="cpu")
        env_j = JaxHardwareEnv(JaxEnvConfig.from_dict(d))
        ranges = np.linspace(0.3, 9.0, 90)
        ranges[3], ranges[7], ranges[11] = np.inf, np.nan, 40.0
        tf = np.asarray([[0.0, -1.0, 0.2], [1.0, 0.0, 0.0], [0, 0, 1.0]])
        peds = [((1.0, 0.5), (0.1, -0.2)), ((-2.9, 2.0), (0.0, 0.3)),
                ((5.0, 0.0), (0.2, 0.2)), ((0.3, -0.4), (-0.1, 0.0))]
        for env, scan_cls, ped_cls in ((env_t, ScanSample, TrackedPed),
                                       (env_j, JaxScan, JaxPed)):
            env.feed_scan(scan_cls(ranges, -math.pi / 2, math.pi / 90,
                                   in_base_frame=False, laser_tf=tf))
            env.feed_pose(0.5, -0.2, 0.4)
            env.set_goal(0.6, -0.25)
            env.feed_peds([ped_cls(*p) for p in peds])
        assert_same(env_t.reset(), _j(env_j.reset), "reset")
        assert_same(env_t.ped_state(), env_j.ped_state(), "ped_state")
        assert env_t.ped_state()[0][0] == 3          # max_ped tracks
        out_t, out_j = env_t.step([0.0, 0.0]), _j(env_j.step, [0.0, 0.0])
        assert_same(out_t, out_j, "step")
        assert out_t[3]["arrive"]


# ----------------------------------------------------- the wrapped frontends


def _scripted(env_t, env_j, actions):
    """Reset, then step both facades through ``actions``; compares every
    output on the way."""
    assert_same(env_t.reset(), _j(env_j.reset), "reset")
    for k, a in enumerate(actions):
        out_t = env_t.step(a)
        out_j = _j(env_j.step, a)
        assert_same(out_t, out_j, f"step {k}")
    assert_same(env_t.metrics.summary(), env_j.metrics.summary(), "metrics")


def test_gazebo_scripted_episode_matches_jax():
    """The wrapper stack over the external simulator with a tracked ped
    (proximity penalty), the time limit (code 10), NeverStop auto-resets
    and a drive into the wall (contact, code 1, -500)."""
    d = gazebo_dict(target=(0.0, 8.0), wrappers=WRAPPERS, time_max=3)
    env_t, env_j, _, _ = gazebo_pair(d)
    assert isinstance(env_t, gymapi.WrappedFrontend)
    assert env_t.env.device == torch.device("cpu")
    _scripted(env_t, env_j, [[0.0, 0.0]] * 5 + [[0.6, 0.1]] * 8
              + [[0.6, 0.0]] * 12)
    assert env_t.metrics.stuck >= 1


def test_real_env_scripted_episode_matches_jax():
    """The wrapper stack over fed scans, poses and tracked peds: steps
    toward a goal, an arrival (code 5, +500), the metrics."""
    from img_env_tpu.env.hardware_env import TrackedPed as JaxPed

    d = gazebo_dict(env_type="real_env", wrappers=WRAPPERS, control_hz=0.0,
                    max_ped=2, ped_sim={"total": 0})
    env_t = gymapi.make_env(d, device="cpu")
    env_j = jgymapi.make_env(JaxEnvConfig.from_dict(d))
    assert isinstance(env_t, gymapi.WrappedFrontend)
    assert isinstance(gymapi.make_env(d, device="cpu", wrap=False),
                      HardwareEnv)
    rng = np.random.default_rng(0)
    scans = rng.uniform(0.3, 8.0, (8, 90))
    for env, ped_cls in ((env_t.env, TrackedPed), (env_j.env, JaxPed)):
        env.feed_pose(0.0, 0.0, 0.0)
        env.set_goal(1.0, 0.2)
        env.feed_peds([ped_cls((1.2, 0.4), (0.1, 0.0))])
    assert_same(env_t.reset(), _j(env_j.reset), "reset")
    codes = []
    for k, x in enumerate(np.linspace(0.1, 0.9, 8)):
        for env, scan_cls in ((env_t.env, ScanSample), (env_j.env, None)):
            from img_env_tpu.env.hardware_env import ScanSample as JaxScan

            cls = scan_cls or JaxScan
            env.feed_scan(cls(scans[k], -math.pi / 2, math.pi / 90))
            env.feed_pose(float(x), 0.1 * float(x), 0.05 * k)
        out_t = env_t.step([0.3, 0.05])
        out_j = _j(env_j.step, [0.3, 0.05])
        assert_same(out_t, out_j, f"step {k}")
        codes.append(int(out_t[3]["dones_info"][0]))
    assert_same(env_t.metrics.summary(), env_j.metrics.summary())
    assert 5 in codes and float(out_t[1][0]) != 0.0


def test_wrapped_frontend_scan_image_drives_policy():
    """ObsStateTmp over the external simulator: the stacked sensor map is
    the scan's log-polar map (non-zero), equal to JAX's, and a fresh
    policy runs on it; a frontend dict without a sensor map gets it from
    the lasers (scaled back by laser_max)."""
    d = gazebo_dict(wrappers=["VelActionWrapper", "SensorsPaperRewardWrapper",
                              "TimeLimitWrapper", "InfoLogWrapper",
                              "ObsStateTmp"], image_batch=1)
    env_t, env_j, _, _ = gazebo_pair(d, peds=False)
    obs_t, obs_j = env_t.reset(), _j(env_j.reset)
    assert_same(obs_t, obs_j)
    assert np.any(obs_t[0] != 0.0)
    cfg = EnvConfig.from_dict(d)
    model, params = init_policy(torch.Generator().manual_seed(0),
                                PolicyConfig.from_env_config(cfg), "cpu")
    for _ in range(3):
        sm, vec, _pm = obs_t
        with torch.no_grad():
            mean, _, _ = model(torch.as_tensor(sm).reshape(1, 1, 48, 48),
                               torch.as_tensor(vec).reshape(1, -1))
        act = np.clip(mean.numpy()[0], [0.0, -0.9], [0.6, 0.9])
        obs_t = env_t.step(act)[0]
        assert_same(obs_t, _j(env_j.step, act)[0])
    raw = env_t.env.observe()
    raw.pop("sensor_maps")
    lifted = env_t._to_observation(raw, np.zeros(1))
    assert torch.equal(lifted.sensor_maps[0],
                       torch.as_tensor(env_t.env.observe()["sensor_maps"][0]))


# ------------------------------------------------------------------- ROS


def _ros_cfg():
    return {"robot": {"total": 1}, "ped_sim": {"total": 0},
            "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
            "view_map": {"resolution": 0.05, "width": 3, "height": 3},
            "range_total": 64, "max_ped": 2}


def test_real_robot_bridge_matches_jax():
    """The reference topic surface, pushed through a fake rospy into both
    packages' bridges: equal observations before and after a mono8 and a
    32FC1 laser image; commands published as (v, w)."""
    ros_t, ros_j = FakeRospy(), FakeRospy()
    b_t = ros_bridge.RealRobotBridge(EnvConfig.from_dict(_ros_cfg()),
                                     rospy=ros_t, device="cpu")
    b_j = jros.RealRobotBridge(JaxEnvConfig.from_dict(_ros_cfg()),
                               rospy=ros_j)
    assert set(ros_t.subs) == set(ros_j.subs)
    msgs = [
        ("robot0/scan", _ns(ranges=np.linspace(1.0, 3.0, 64),
                            angle_min=-math.pi / 2,
                            angle_increment=math.pi / 64)),
        ("robot0/odom", _ns(pose=_ns(pose=_ns(
            position=_ns(x=1.0, y=2.0, z=0.0),
            orientation=_ns(x=0.0, y=0.0, z=math.sin(0.35),
                            w=math.cos(0.35)))))),
        ("robot0/global_goal", _ns(pose=_ns(position=_ns(x=4.0, y=2.0,
                                                         z=0.0)))),
        ("/spencer/perception/tracked_persons", _ns(tracks=[
            _ns(pose=_ns(pose=_ns(position=_ns(x=2.0, y=2.5, z=0.0))),
                twist=_ns(twist=_ns(linear=_ns(x=0.1, y=-0.2, z=0.0))))])),
    ]
    for topic, msg in msgs:
        ros_t.push(topic, msg), ros_j.push(topic, msg)
    obs = b_t.env.observe()
    assert_same(obs, _j(b_j.env.observe))
    assert abs(math.hypot(*obs["vector_states"][0][:2]) - 3.0) < 1e-9
    assert np.any(obs["sensor_maps"][0] == 1.0)
    h, w = b_t.env.cfg.image_size
    for img in (_ns(height=h, width=w, data=np.arange(h * w,
                                                      dtype=np.uint8)),
                _ns(height=h, width=w, encoding="32FC1",
                    data=np.linspace(0, 1, h * w, dtype=np.float32)
                    .tobytes())):
        ros_t.push("robot0/laser_image", img)
        ros_j.push("robot0/laser_image", img)
        assert_same(b_t.env.observe(), _j(b_j.env.observe))
    b_t.env.send_cmd(0.4, -0.2)
    assert ros_t.pubs["robot0/cmd_vel"].sent[-1] == (0.4, -0.2)


def test_gazebo_bridge_matches_jax():
    """Teleport to the start pose through set_model_state, the goal in the
    base frame, the scan's map, and the one-shot contact latch."""
    obs = {}
    for name, mod, cfg_cls, kw in (("t", ros_bridge, EnvConfig,
                                    {"device": "cpu"}),
                                   ("j", jros, JaxEnvConfig, {})):
        rospy = FakeRospy()
        pose = [0.0, 0.0, 0.0]

        def get_state(model, frame, pose=pose):
            return _ns(pose=_ns(
                position=_ns(x=pose[0], y=pose[1], z=0.0),
                orientation=_ns(x=0.0, y=0.0, z=math.sin(pose[2] / 2),
                                w=math.cos(pose[2] / 2))))

        def set_state(model, x, y, yaw, pose=pose):
            pose[:] = [x, y, yaw]

        rospy.services["/gazebo/get_model_state"] = get_state
        rospy.services["/gazebo/set_model_state"] = set_state
        cfg = cfg_cls.from_dict(dict(_ros_cfg(),
                                     start_global_pose=[0.5, 0.5, 0.0],
                                     target_global_pose=[3.0, 0.5]))
        bridge = mod.GazeboBridge(cfg, model_name="tb3", rospy=rospy, **kw)
        rospy.push("/scan", _ns(ranges=np.full(64, 4.0),
                                angle_min=-math.pi / 2,
                                angle_increment=math.pi / 64))
        obs[name] = _j(bridge.env.reset)
        assert pose[:2] == [0.5, 0.5]
        rospy.push("/collision", _ns(data=True))
        assert bridge.transport.get_contact() is True
        assert bridge.transport.get_contact() is False
    assert_same(obs["t"], obs["j"])
    assert abs(math.hypot(*obs["t"]["vector_states"][0][:2]) - 2.5) < 1e-9


def test_frontend_vector_state_is_3_wide_in_both_packages():
    """F28: the frontends' vector state is ``state_goal``'s 3 values, so a
    state_dim-5 config fails in the StateBatch wrapper in both packages,
    and runs at state_dim 3."""
    d = gazebo_dict(wrappers=WRAPPERS, state_dim=5)
    env_t, env_j, _, _ = gazebo_pair(d)
    with pytest.raises(RuntimeError):
        env_t.reset()
    with pytest.raises(TypeError):
        _j(env_j.reset)
    env_t, env_j, _, _ = gazebo_pair(dict(d, state_dim=3))
    assert_same(env_t.reset(), _j(env_j.reset))
    assert env_t.last_raw_obs.vector_states.shape == (1, 3)
