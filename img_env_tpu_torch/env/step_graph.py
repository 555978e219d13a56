"""The env step replayed from CUDA graphs (``NavEnv.step_scenes``).

    graphs = StepGraphs()
    out = graphs(fn, args, extra)    # fn(*args), replayed from a graph

A call flattens ``args`` (NamedTuples, tuples, dicts, tensors and None)
and keys it by everything the Python code of ``fn`` branches on that is
not a value: the tree's structure with its None leaves, each tensor's
shape and dtype, ``extra``, ``torch.is_grad_enabled()`` and the float32
precision settings (``key_of``).  A new key
copies the inputs into static buffers, runs ``fn`` on them once on a side
stream (the warm-up), then captures it as one ``torch.cuda.CUDAGraph``;
every call with that key replays the graph.  The last ``SIZE`` keys keep
their graphs, so a caller that varies a shape holds no more.

Inputs: a leaf is copied into its buffer (``torch._foreach_copy_``, one
call per dtype) only when the caller hands in another tensor than last
time, or one whose ``_version`` has moved; the maps and tables that the
step only reads are copied once per layout.

Outputs: a leaf that is one of the inputs, untouched (a map, a goal), is
the caller's own tensor, as the eager step hands it back.  The graph
writes every other leaf into one byte arena, and each replay hands back
views of a clone of it: no later replay overwrites what a step returned.

Counters: the kernel launches (``kernels.LAUNCHES``) and the trace counts
that the capture made are added again at every replay; the warm-up's and
the capture's own are not counted.  Trace counters: ``env.graph_captures``,
``env.graph_replays``, ``env.eager_steps`` (calls that did not replay) and
``env.graph_failures``.  A replay runs under the span ``env.graph``; the
spans inside ``fn`` appear only in the warm-up and the capture.

A key whose capture fails, or whose step writes into its inputs, stays
eager: counted, and warned about once.  Nothing random may run inside
``fn``: the caller draws before the call and passes the draws in.
"""

from __future__ import annotations

import collections
import warnings
import weakref

import torch

from img_env_tpu_torch.ops import kernels
from img_env_tpu_torch.utils import trace

SIZE = 4          # keys whose graphs are kept
_ALIGN = 16       # bytes: each dtype's region of the arena starts aligned
_LEAF = object()  # a tensor's place in a flattened structure


def flatten(tree, leaves: list):
    """The structure of ``tree`` (hashable); its tensors are appended to
    ``leaves`` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if tree is None:
        return None
    if isinstance(tree, dict):
        return (dict, tuple(tree),
                tuple(flatten(v, leaves) for v in tree.values()))
    if isinstance(tree, tuple):
        return (type(tree), tuple(flatten(v, leaves) for v in tree))
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def unflatten(spec, leaves):
    """The tree of structure ``spec`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(sp):
        if sp is _LEAF:
            return next(it)
        if sp is None:
            return None
        if sp[0] is dict:
            return dict(zip(sp[1], [build(x) for x in sp[2]]))
        parts = [build(x) for x in sp[1]]
        return sp[0](*parts) if hasattr(sp[0], "_fields") else sp[0](parts)
    return build(spec)


def key_of(args, extra=()):
    """``(key, leaves)`` of a call: the key is ``(structure, extra,
    torch.is_grad_enabled(), each leaf's (shape, dtype, device), the
    float32 matmul and cuDNN precision settings)``; the last pick the
    kernels a capture records, as they pick the eager step's."""
    leaves = []
    spec = flatten(args, leaves)
    return (spec, extra, torch.is_grad_enabled(),
            tuple((x.shape, x.dtype, x.device) for x in leaves),
            torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32), leaves


class _Graph:
    """One key's graph, its static inputs and how its outputs come back."""

    __slots__ = ("graph", "static", "seen", "arena", "regions", "plan",
                 "out_spec", "launches", "counts")

    def __init__(self, leaves):
        self.static = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                       for x in leaves]
        self.seen = [None] * len(leaves)
        with torch.no_grad():
            self.copy_in(leaves)

    def copy_in(self, leaves) -> None:
        """Copies each leaf that is not the tensor copied last time, as it
        was then, into its static buffer."""
        dst, src = {}, {}
        for i, x in enumerate(leaves):
            base = x if x._base is None else x._base
            last = self.seen[i]
            if (last is not None and last[0]() is base
                    and last[1] == x.data_ptr() and last[2] == x._version
                    and last[3] == x.stride()):
                continue
            self.seen[i] = (weakref.ref(base), x.data_ptr(), x._version,
                            x.stride())
            dst.setdefault(x.dtype, []).append(self.static[i])
            src.setdefault(x.dtype, []).append(x)
        for k in dst:
            torch._foreach_copy_(dst[k], src[k])

    def outputs(self, leaves):
        """The step's output tree after a replay: views of the arena's
        clone, and the caller's own tensors where the step passed an input
        through."""
        clone = self.arena.clone()
        parts = []
        for start, stop, dtype, numels, shapes in self.regions:
            split = torch.split_with_sizes(clone[start:stop].view(dtype),
                                           numels)
            parts.extend(p.view(s) for p, s in zip(split, shapes))
        return unflatten(self.out_spec,
                         [leaves[j] if src else parts[j]
                          for src, j in self.plan])


class StepGraphs:
    """The graphs of one step function, by key (module docstring)."""

    def __init__(self):
        self.graphs = collections.OrderedDict()   # key -> _Graph or None
        self.warned = False

    def __call__(self, fn, args: tuple, extra=()):
        key, leaves = key_of(args, extra)
        if not all(x.is_cuda for x in leaves) or (
                key[2] and any(x.requires_grad for x in leaves)):
            trace.count("env.eager_steps")
            return fn(*args)
        if key in self.graphs:
            self.graphs.move_to_end(key)
            g = self.graphs[key]
        else:
            g = self._capture(fn, key[0], leaves)
            self.graphs[key] = g
            if len(self.graphs) > SIZE:
                self.graphs.popitem(last=False)
        if g is None:
            trace.count("env.eager_steps")
            return fn(*args)
        with trace.span("env.graph"):
            g.copy_in(leaves)
            g.graph.replay()
            out = g.outputs(leaves)
            for name, n in g.launches.items():
                kernels.LAUNCHES[name] += n
            for name, n in g.counts.items():
                trace.count(name, n)
            trace.count("env.graph_replays")
        return out

    def _capture(self, fn, spec, leaves):
        """A warm-up and a capture of ``fn`` on static copies of
        ``leaves``; None (counted and warned about once) where either
        fails or the step writes into its inputs."""
        try:
            g = _capture(fn, spec, leaves)
        except Exception as e:  # a step the graph cannot hold runs eagerly
            trace.count("env.graph_failures")
            if not self.warned:
                self.warned = True
                warnings.warn(
                    f"the env step could not be captured as a CUDA graph "
                    f"({type(e).__name__}: {e}); steps of these shapes run "
                    f"eagerly", RuntimeWarning, stacklevel=3)
            return None
        trace.count("env.graph_captures")
        return g


def _capture(fn, spec, leaves) -> _Graph:
    g = _Graph(leaves)
    args = unflatten(spec, g.static)
    versions = [x._version for x in g.static]
    stream = torch.cuda.current_stream()
    saved = dict(kernels.LAUNCHES)
    try:
        side = torch.cuda.Stream(device=stream.device)
        side.wait_stream(stream)
        with trace.diverted(), torch.cuda.stream(side):
            fn(*args)
        stream.wait_stream(side)
        mark = dict(kernels.LAUNCHES)
        g.graph = torch.cuda.CUDAGraph()
        with trace.diverted() as counts, torch.cuda.graph(g.graph):
            outs = []
            g.out_spec = flatten(fn(*args), outs)
            _plan_outputs(g, outs)
        g.counts = counts
        g.launches = {k: kernels.LAUNCHES[k] - mark[k] for k in mark
                      if kernels.LAUNCHES[k] != mark[k]}
    finally:
        kernels.LAUNCHES.update(saved)
        torch.cuda.set_stream(stream)
    if [x._version for x in g.static] != versions:
        raise RuntimeError("the step writes into its inputs")
    return g


def _plan_outputs(g: _Graph, outs) -> None:
    """Inside the capture: each output is an input passed through
    (``(True, input index)``) or a slot of the arena (``(False, slot)``),
    one slot for outputs that are the same tensor; the graph's last
    operations copy the slots into the arena, one region per dtype."""
    ident = lambda x: (x.data_ptr(), x.shape, x.stride(), x.dtype)
    inputs = {ident(x): i for i, x in enumerate(g.static) if x.numel()}
    slots, where, g.plan = [], {}, []
    for x in outs:
        k = ident(x)
        if x.numel() and k in inputs:
            g.plan.append((True, inputs[k]))
            continue
        if not x.numel() or k not in where:
            where[k] = len(slots)
            slots.append(x)
        g.plan.append((False, where[k]))
    groups = {}
    for i, x in enumerate(slots):
        groups.setdefault(x.dtype, []).append(i)
    order = [i for idx in groups.values() for i in idx]
    rank = {i: r for r, i in enumerate(order)}
    g.plan = [(src, j if src else rank[j]) for src, j in g.plan]
    g.regions, start = [], 0
    for dtype, idx in groups.items():
        numels = [slots[i].numel() for i in idx]
        stop = start + sum(numels) * slots[idx[0]].element_size()
        g.regions.append((start, stop, dtype, numels,
                          [slots[i].shape for i in idx]))
        start = -(-stop // _ALIGN) * _ALIGN
    g.arena = torch.empty(max(start, 1), dtype=torch.uint8,
                          device=outs[0].device)
    for (a, b, dtype, numels, shapes), idx in zip(g.regions,
                                                  groups.values()):
        views = [p.view(s) for p, s in zip(torch.split_with_sizes(
            g.arena[a:b].view(dtype), numels), shapes)]
        torch._foreach_copy_(views, [slots[i] for i in idx])
