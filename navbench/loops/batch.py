"""The batch loop: one ``BatchedNavEnv`` of ``scenes`` scenes stepped
together, finished scenes redrawn where the traffic asks for it
(``envloop.py``)."""

from navbench.envloop import EnvLoop, EnvReference


class Loop(EnvLoop):
    batch = True
    Reference = EnvReference
