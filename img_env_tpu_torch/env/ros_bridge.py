"""ROS1 bridge: wires rospy topics/services into the injected-transport
frontends (HardwareEnv / ExternalSimEnv); torch port of
``img_env_tpu.env.ros_bridge``.

The reference's RealEnv subscribes scan/odom/tracked_persons and publishes
cmd_vel (real_env.py:76-86); GazeboEnv additionally drives the
pause/unpause/set_model_state services (gazebo_env.py:70-78).  This module
is the missing deployment glue: it translates those exact topics into
``HardwareEnv.feed_*`` calls and an ``ExternalSimTransport`` so the same
policy checkpoint drives the simulator, Gazebo, or a real robot.

rospy is imported lazily inside the constructors — the module imports
fine without ROS, and tests exercise the full wiring against a fake
``rospy`` injected into ``sys.modules`` (tests/test_torch_frontends.py).

    # on the robot / sim host (ROS1 noetic):
    from img_env_tpu_torch.env.ros_bridge import RealRobotBridge
    bridge = RealRobotBridge(cfg, robot_name="robot0")
    env = make_env(cfg_dict, transport=None, frontend=bridge.env)
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from img_env_tpu_torch.env.hardware_env import HardwareEnv, ScanSample, TrackedPed


def _yaw_from_quat(x: float, y: float, z: float, w: float) -> float:
    """Planar yaw from a quaternion (ros_utils.py semantics, tf-free)."""
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def _msg_types():
    """Real ROS message classes when the ROS python packages are present;
    ``{}`` otherwise (tests drive the bridges with a fake rospy whose
    Subscriber/Publisher ignore the type argument)."""
    try:
        from geometry_msgs.msg import PoseStamped, Twist
        from nav_msgs.msg import Odometry
        from sensor_msgs.msg import Image, LaserScan
        from std_msgs.msg import Bool

        types = {"Twist": Twist, "PoseStamped": PoseStamped,
                 "Odometry": Odometry, "LaserScan": LaserScan,
                 "Image": Image, "Bool": Bool}
        try:
            from spencer_tracking_msgs.msg import TrackedPersons

            types["TrackedPersons"] = TrackedPersons
        except ImportError:
            types["TrackedPersons"] = None
        try:
            from gazebo_msgs.srv import GetModelState, SetModelState
            from std_srvs.srv import Empty

            types.update(GetModelState=GetModelState,
                         SetModelState=SetModelState, Empty=Empty)
        except ImportError:
            pass
        return types
    except ImportError:
        return {}


class RealRobotBridge:
    """RealEnv's ROS surface -> a live HardwareEnv.

    Topics (real_env.py:76-86):
      {robot_name}/scan            sensor_msgs/LaserScan   -> feed_scan
      {robot_name}/odom            nav_msgs/Odometry       -> feed_pose
      {robot_name}/global_goal     geometry_msgs/PoseStamped -> set_goal
      /spencer/perception/tracked_persons                  -> feed_peds
      {robot_name}/laser_image (optional) sensor_msgs/Image -> feed_image
      {robot_name}{cmd_topic}      geometry_msgs/Twist     <- send_cmd
    """

    def __init__(self, cfg, robot_name: str = "robot0",
                 cmd_topic: str = "/cmd_vel", rospy=None,
                 twist_cls=None, device="cuda"):
        if rospy is None:
            import rospy  # noqa: F401  (ROS1 runtime only)
        self.rospy = rospy
        self.robot_name = robot_name
        t = _msg_types()
        self._twist_cls = twist_cls if twist_cls is not None else t.get("Twist")
        self._vel_pub = rospy.Publisher(
            robot_name + cmd_topic, self._twist_cls, queue_size=1)
        self.env = HardwareEnv(cfg, send_cmd=self._send_cmd, device=device)
        rospy.Subscriber(robot_name + "/scan", t.get("LaserScan"),
                         self._on_scan, queue_size=1)
        rospy.Subscriber(robot_name + "/odom", t.get("Odometry"),
                         self._on_odom, queue_size=1)
        rospy.Subscriber(robot_name + "/global_goal", t.get("PoseStamped"),
                         self._on_goal, queue_size=1)
        # SPENCER is optional third-party: with real ROS but no
        # spencer_tracking_msgs, skip the subscription (real rospy rejects
        # a None data class); fake-rospy tests (t == {}) still wire it
        if not t or t.get("TrackedPersons") is not None:
            rospy.Subscriber("/spencer/perception/tracked_persons",
                             t.get("TrackedPersons"), self._on_peds,
                             queue_size=1)
        rospy.Subscriber(robot_name + "/laser_image", t.get("Image"),
                         self._on_image, queue_size=1)

    # -- outbound ------------------------------------------------------------
    def _send_cmd(self, v: float, w: float) -> None:
        if self._twist_cls is not None:
            msg = self._twist_cls()
            msg.linear.x = float(v)
            msg.angular.z = float(w)
        else:                       # duck-typed fake in tests
            msg = (float(v), float(w))
        self._vel_pub.publish(msg)

    # -- inbound callbacks (reference field layouts) --------------------------
    def _on_scan(self, msg) -> None:
        self.env.feed_scan(ScanSample(
            ranges=np.asarray(msg.ranges, np.float64),
            angle_min=float(msg.angle_min),
            angle_increment=float(msg.angle_increment),
            in_base_frame=True))

    def _on_odom(self, msg) -> None:
        p = msg.pose.pose.position
        q = msg.pose.pose.orientation
        self.env.feed_pose(float(p.x), float(p.y),
                           _yaw_from_quat(q.x, q.y, q.z, q.w))

    def _on_goal(self, msg) -> None:
        p = msg.pose.position
        self.env.set_goal(float(p.x), float(p.y))

    def _on_peds(self, msg) -> None:
        """SPENCER TrackedPersons -> TrackedPed list (real_env.py:267-316)."""
        peds = []
        for t in msg.tracks:
            pos = t.pose.pose.position
            tw = t.twist.twist.linear
            peds.append(TrackedPed(xy_world=(float(pos.x), float(pos.y)),
                                   v_world=(float(tw.x), float(tw.y))))
        self.env.feed_peds(peds)

    def _on_image(self, msg) -> None:
        """laser_image topic -> sensor_maps (image_last, real_env.py:233-240).
        Accepts mono8 (0..255 -> /255) or 32FC1.  Real sensor_msgs/Image
        carries ``data`` as BYTES — decode by encoding, not by ndarray
        dtype (a fake in tests may push an ndarray directly)."""
        h = int(msg.height)
        w = int(msg.width)
        enc = getattr(msg, "encoding", "")
        data = msg.data
        if isinstance(data, (bytes, bytearray, memoryview)):
            if enc == "32FC1":
                img = np.frombuffer(data, np.float32).reshape(h, w)
            else:                    # mono8 and friends
                img = np.frombuffer(
                    data, np.uint8).reshape(h, w).astype(np.float32) / 255.0
        else:
            data = np.asarray(data)
            if data.dtype == np.uint8:
                img = data.reshape(h, w).astype(np.float32) / 255.0
            else:
                img = data.reshape(h, w).astype(np.float32)
        self.env.feed_image(img)


class GazeboBridge:
    """GazeboEnv's ROS surface -> an ExternalSimTransport.

    Services + topics (gazebo_env.py:70-78, 176-185): get/set_model_state,
    pause/unpause_physics, /scan, /odom, /collision contact flag.
    """

    def __init__(self, cfg, model_name: str = "turtlebot3",
                 cmd_topic: str = "/cmd_vel", rospy=None, twist_cls=None,
                 device="cuda"):
        if rospy is None:
            import rospy  # noqa: F401
        self.rospy = rospy
        self.model_name = model_name
        t = _msg_types()
        self._twist_cls = twist_cls if twist_cls is not None else t.get("Twist")
        self._vel_pub = rospy.Publisher(cmd_topic, self._twist_cls,
                                        queue_size=1)
        self._pause = rospy.ServiceProxy("/gazebo/pause_physics",
                                         t.get("Empty"))
        self._unpause = rospy.ServiceProxy("/gazebo/unpause_physics",
                                           t.get("Empty"))
        self._set_state = rospy.ServiceProxy("/gazebo/set_model_state",
                                             t.get("SetModelState"))
        self._get_state = rospy.ServiceProxy("/gazebo/get_model_state",
                                             t.get("GetModelState"))
        self._scan = None
        self._contact = False
        rospy.Subscriber("/scan", t.get("LaserScan"), self._on_scan,
                         queue_size=1)
        rospy.Subscriber("/collision", t.get("Bool"), self._on_contact,
                         queue_size=1)

        from img_env_tpu_torch.env.external_env import (ExternalSimEnv,
                                                        ExternalSimTransport)

        self.transport = ExternalSimTransport(
            get_scan=self._get_scan,
            get_model_state=self._model_state,
            set_model_state=self._teleport,
            send_cmd=self._send_cmd,
            get_contact=self._get_contact,
            pause=lambda: self._pause(),
            unpause=lambda: self._unpause(),
        )
        self.env = ExternalSimEnv(cfg, self.transport, device=device)

    def _on_scan(self, msg) -> None:
        self._scan = ScanSample(
            ranges=np.asarray(msg.ranges, np.float64),
            angle_min=float(msg.angle_min),
            angle_increment=float(msg.angle_increment))

    def _on_contact(self, msg) -> None:
        self._contact = self._contact or bool(msg.data)

    def _get_scan(self) -> ScanSample:
        if self._scan is None:
            raise RuntimeError("no /scan message received yet")
        return self._scan

    def _get_contact(self) -> bool:
        c = self._contact
        self._contact = False
        return c

    def _model_state(self) -> Sequence[float]:
        st = self._get_state(self.model_name, "")
        p = st.pose.position
        q = st.pose.orientation
        return (float(p.x), float(p.y), _yaw_from_quat(q.x, q.y, q.z, q.w))

    def _teleport(self, x: float, y: float, yaw: float) -> None:
        # the reference teleports via set_model_state and never
        # /gazebo/reset_world (gazebo_env.py:106-118)
        try:
            from gazebo_msgs.msg import ModelState

            ms = ModelState()
            ms.model_name = self.model_name
            ms.pose.position.x = float(x)
            ms.pose.position.y = float(y)
            ms.pose.orientation.z = math.sin(yaw / 2.0)
            ms.pose.orientation.w = math.cos(yaw / 2.0)
            self._set_state(ms)
        except ImportError:         # fake-rospy test mode
            self._set_state(self.model_name, float(x), float(y), float(yaw))

    def _send_cmd(self, v: float, w: float) -> None:
        if self._twist_cls is not None:
            msg = self._twist_cls()
            msg.linear.x = float(v)
            msg.angular.z = float(w)
        else:
            msg = (float(v), float(w))
        self._vel_pub.publish(msg)
