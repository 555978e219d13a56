"""The general driver of a cell's traffic: what every loop shares.

A traffic file (``navbench/traffic/<mix>.json``) is data.  Its ``loop``
names the module that drives the program (``navbench/loops/<loop>.py``,
which defines ``Loop``, a ``Drive``, and ``Reference``, its replay through
the frozen reference); the loop reads the rest of the file, among it an
``actor`` (``navbench/actors/<actor>.py``) where it has one.  Every loop
reads:

* ``warmup_steps``: steps run in set-up, before the window;
* ``trace_steps``: the steps the profiler covers in a ``--trace 1`` run;
* ``check`` = {count, within}: the steps whose outputs are compared,
  index 0 and ``count`` - 1 more drawn from the seed among the first
  ``within`` of the window, and one more: the first step to start once a
  share of the window drawn from the seed between ``LATE`` has passed.

A new loop or actor is a new file and a traffic file naming it; nothing
here or in ``run.py`` changes.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from navbench.parts import load_part

LATE = (0.5, 0.9)   # the late compared step: this share of the window


def tmap(fn, *trees):
    """``fn`` over the tensors of NamedTuple / tuple / dict trees of one
    structure; None leaves stay None, other leaves are kept as they are."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tmap(fn, *parts) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tmap(fn, *parts) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in first}
    return first


def clone(tree):
    return tmap(lambda x: x.clone(), tree)


def check_indices(seed: int, count: int, within: int):
    """The early step indices compared: 0 and ``count`` - 1 more drawn from
    the seed among 1 .. ``within`` - 1."""
    rng = np.random.default_rng(seed)
    rest = rng.choice(np.arange(1, within), size=count - 1, replace=False)
    return sorted({0, *(int(i) for i in rest)})


def late_share(seed: int) -> float:
    """The share of the window after which the late compared step starts,
    drawn from the seed within ``LATE``."""
    return float(np.random.default_rng([int(seed), 1]).uniform(*LATE))


class Drive:
    """One cell's timed loop.  ``mode``: 'plain' (the timed window: no
    extra synchronisation), 'spans' (each labelled call synchronised and
    timed on the host clock) or 'profile' (each labelled call's interval
    kept on the system clock, which the profiler's device timestamps
    share).

    A loop defines ``setup()`` (set-up: build, reset, keep what the check
    compares the start with), ``step()`` (one timed step; it calls
    ``due()`` once and, where that is true, keeps the step's inputs and
    outputs in ``checks``), and may extend ``finish()`` and ``free()``.
    ``harness_s`` is set-up time spent drawing the harness's own inputs,
    which ``setup_s`` leaves out."""

    Reference = None    # the loop's replay class

    def __init__(self, sut, ref, config: dict, traffic: dict, seed: int,
                 device: str, here: str):
        self.sut, self.ref = sut, ref
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.dev = torch.device(device)
        self.here = here
        self.mode = "plain"
        self.spans = {}
        self.labels = []        # (label, start_us, end_us), system clock
        self.checks = []
        self.pending = None
        self.k = 0
        self.scenes = self.robots = 1
        self.harness_s = 0.0
        chk = traffic["check"]
        self.check_at = set(check_indices(self.seed, chk["count"],
                                          chk["within"]))
        self.late_at = None

    def part(self, kind: str, name: str):
        """A module of this checkout's ``navbench/<kind>/<name>.py``."""
        return load_part(self.here, kind, name)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def region(self, label: str):
        if self.mode == "plain":
            yield
        elif self.mode == "spans":
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            self.spans.setdefault(label, []).append(
                (time.perf_counter() - t0) * 1e3)
        else:
            a = time.time_ns()
            yield
            self.labels.append((label, a / 1e3, time.time_ns() / 1e3))

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------------
    def warm_up(self) -> None:
        """The traffic's warm-up steps; the compared steps are counted from
        the first step after them."""
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        self.k = 0
        self.checks.clear()
        self.pending = None
        self._sync()

    def open_window(self, t0: float, seconds: float) -> None:
        """The window (or the part of it whose steps are compared) starts
        at ``t0`` on the host clock and lasts ``seconds``."""
        self.late_at = t0 + late_share(self.seed) * seconds

    def due(self) -> bool:
        """Whether the step about to run is compared."""
        if self.k in self.check_at:
            return True
        if self.late_at is not None and time.perf_counter() >= self.late_at:
            self.late_at = None
            return True
        return False

    def finish(self) -> None:
        """Completes what a compared step still waits for."""

    def log_lines(self):
        """Lines for standard error about the run's traffic."""
        return ()

    def free(self) -> None:
        """Drops the program's objects (the checks' copies stay)."""

    def reference(self, control=None):
        """The loop's replay through the frozen reference (``control``: a
        lower precision, see ``check.py``)."""
        return self.Reference(self.ref, self, control)

    def setup(self):
        raise NotImplementedError

    def step(self):
        raise NotImplementedError
