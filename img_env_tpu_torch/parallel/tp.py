"""The policy's forward over the model axis of a mesh (tensor parallel).

The JAX package places the parameters with ``tp_param_shardings`` and lets
GSPMD partition the forward.  Here each rank of the model axis computes
its share of every sharded layer from its piece of the parameter
(``tp_param_shardings``' placement on ``tp_view``) and the layer's output
is made whole again with ``all_reduce`` alone:

  * a column-sharded layer (output dim): the rank's output columns, then
    ``gather`` (each rank's columns written into zeros, summed: exact);
  * a row-sharded layer (input dim): the rank's slice of the input times
    its rows, then ``reduce_sum``, then the bias;
  * a replicated layer: as in ``CrowdNavPolicy``.

The rest of the forward is the policy's own (``policy_forward``).

The conjugate backward (Megatron's f and g) keeps every whole activation's
gradient whole on every rank: ``enter`` sums, over the model axis, the
partial input gradients of the rank-local layers; ``gather`` hands each
rank its own columns' gradient; ``reduce_sum`` passes its gradient
through.  So each rank's gradient of a sharded parameter is exact on its
piece and zero elsewhere, and of a replicated one exact and equal on every
rank.  The convolutions' and attention's placements have no DTensor
operator rules, so every layer takes this one explicit form.  The
forward computes the replicated function (sums in another order: the
row layers' partial products).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from img_env_tpu_torch.models.policy import CrowdNavPolicy, policy_forward
from img_env_tpu_torch.parallel.mesh import tp_view

Tensor = torch.Tensor


class _Enter(torch.autograd.Function):
    """Identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceSum(torch.autograd.Function):
    """Sum over the group; the backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The ranks' blocks along ``dim`` concatenated in rank order (each
    written into zeros, then summed); the backward takes the rank's
    block."""

    @staticmethod
    def forward(ctx, x, dim, rank, size, group):
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * size
        out = x.new_zeros(shape)
        out.narrow(dim, rank * n, n).copy_(x)
        dist.all_reduce(out, group=group)
        ctx.dim, ctx.start, ctx.n = dim, rank * n, n
        return out

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None,
                None, None)


def tp_forward(model: CrowdNavPolicy, params: Dict[str, Tensor], plan,
               group, sensor_maps: Tensor, vector_states: Tensor,
               ped_maps=None, ped_vectors=None):
    """``model``'s forward (``models.policy.policy_forward``) with
    ``params`` (whole on every rank) split by ``plan``
    (``tp_param_shardings``) over the model axis ``group``; the inputs
    are the same on every rank of the group.  Only its ``linear`` and
    ``conv`` layers are its own."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    enter = lambda x: _Enter.apply(x, group)

    def placement(name):
        p = plan[name][1]
        return p.dim if isinstance(p, Shard) else None

    def piece(name):
        """This rank's piece of a parameter, flattened back from its view
        to the parameter's own rank of dims."""
        x, d = params[name], placement(name)
        if d is None:
            return x
        v = tp_view(name, x)
        n = v.shape[d] // size
        p = v.narrow(d, rank * n, n)
        return p if v is x else p.reshape((-1,) + tuple(x.shape[1:]))

    def linear(x, name):
        w, b = name + ".weight", name + ".bias"
        d = placement(w)
        if d is None:
            return F.linear(x, params[w], params[b])
        if tp_view(w, params[w]).dim() == 2 and d == 1:   # row
            n = x.shape[-1] // size
            part = F.linear(enter(x).narrow(-1, rank * n, n), piece(w))
            return _ReduceSum.apply(part, group) + params[b]
        # column: the output viewed as the weight's view less its input dim
        y = F.linear(enter(x), piece(w), piece(b))
        view = tuple(tp_view(w, params[w]).shape[:-1])
        lead = y.dim() - 1
        y = y.unflatten(-1, view[:d] + (-1,) + view[d + 1:])
        return _Gather.apply(y, lead + d, rank, size, group).flatten(lead)

    def conv(x, name, pad):
        w, b = name + ".weight", name + ".bias"
        x = F.pad(x, pad)
        if placement(w) is None:
            return F.conv2d(x, params[w], params[b], stride=2)
        y = F.conv2d(enter(x), piece(w), piece(b), stride=2)
        return _Gather.apply(y, 1, rank, size, group)

    log_std = (None if model.cfg.discrete_actions > 0
               else params["pi_log_std"])
    return policy_forward(model, linear, conv, log_std, sensor_maps,
                          vector_states, ped_maps, ped_vectors)
