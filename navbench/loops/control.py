"""The control loop: one ``NavEnv``, every robot of one scene, a control
step at a time (``envloop.py``)."""

from navbench.envloop import EnvLoop, EnvReference


class Loop(EnvLoop):
    batch = False
    Reference = EnvReference
