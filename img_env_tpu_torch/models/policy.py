"""Crowd-navigation actor-critic (torch port of
``img_env_tpu.models.policy``): the forward pass, the action draw, and the
trained weights carried across.

``CrowdNavPolicy`` consumes the observation layout the env emits:

  sensor_maps [B, k, 48, 48]  -> conv trunk (k frames as channels)
  ped_maps    [B, 3, 48, 48]  -> conv trunk
  vector      [B, k*state_dim]-> MLP
  ped_vectors [B, 1+7*max_ped]-> masked self-attention over ped tokens

It computes what the flax module computes, float32 throughout:
  * flax's ``padding="SAME"`` with stride 2 pads 0 before and 1 after
    (48 -> 24 -> 12 -> 6), not 1 on both sides: the input is padded
    explicitly and the convolution has no padding;
  * the trunk flattens NHWC, as flax does, before its projection;
  * masked attention logits are ``finfo(float32).min``, not -inf, so a
    robot that sees no ped gets finite uniform weights that the masked
    mean-pool then zeroes (a -inf mask gives NaN there);
  * on a CUDA device cuDNN would round convolution inputs to TF32 by
    default: the forward runs with TF32 off for convolutions and matmuls.

The forward is one body, ``policy_forward``, over its layers given as
callables: the module passes its own, and the tensor-parallel forward
(``parallel/tp.py``) its sharded ones.

Weights come from the JAX package's checkpoints as flat float32 arrays
keyed by flax path (``tools/export_policy_npz.py`` writes them):
``policy_params_from_numpy`` converts them to this module's state dict and
``load_policy_npz`` builds the module on a device.  ``init_policy`` draws
fresh weights as flax's defaults do (lecun-normal kernels, zero biases),
from a ``torch.Generator``; ``load_ckpt_policy`` reads a training
checkpoint (``train/checkpoint.py``) or such an npz.

The forward stays differentiable (the PPO loss backpropagates through it):
no tensor that autograd saves is written in place, and the masked
attention's ``finfo.min`` logits give finite gradients where a robot sees
no ped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from img_env_tpu_torch.utils import trace

Tensor = torch.Tensor
# the crowd attention's heads (flax's CrowdAttention.heads)
ATTN_HEADS = 4


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    state_dim: int = 3
    image_batch: int = 1
    image_size: Tuple[int, int] = (48, 48)
    max_ped: int = 10
    ped_vec_dim: int = 7
    use_ped_map: bool = True
    use_ped_vec: bool = True
    act_dim: int = 2             # (v, w); 3 adds the beep logit
    discrete_actions: int = 0    # >0 -> categorical head of this many actions
    hidden: int = 256
    crowd_dim: int = 64
    log_std_init: float = -0.5   # initial Gaussian exploration (continuous)

    @staticmethod
    def from_env_config(cfg) -> "PolicyConfig":
        return PolicyConfig(
            state_dim=cfg.state_dim,
            image_batch=max(cfg.image_batch, 1),
            image_size=tuple(cfg.image_size),
            max_ped=cfg.max_ped,
            ped_vec_dim=cfg.ped_vec_dim,
            use_ped_map=cfg.ped_sim.total > 0,
            use_ped_vec=cfg.ped_sim.total > 0,
            act_dim=cfg.act_dim,
            discrete_actions=(len(cfg.discrete_actions)
                              if cfg.discrete_action else 0),
        )


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN convolutions and CUDA matmuls, restored after."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def _same_pads(size: int, stride: int = 2, k: int = 3) -> Tuple[int, int]:
    """flax/XLA 'SAME': total padding split with the extra cell after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ConvTrunk(nn.Module):
    """HxWxC -> ``out`` feature vector, stride-2 downsampling (the layers;
    ``conv_trunk`` is the forward)."""

    def __init__(self, in_ch: int, size: Tuple[int, int],
                 features: Sequence[int] = (32, 64, 64), out: int = 256):
        super().__init__()
        self.convs = nn.ModuleList()
        self.pads = []
        h, w = size
        for f in features:
            self.convs.append(nn.Conv2d(in_ch, f, 3, stride=2))
            (t, b), (l, r) = _same_pads(h), _same_pads(w)
            self.pads.append((l, r, t, b))
            h, w, in_ch = -(-h // 2), -(-w // 2), f
        self.proj = nn.Linear(h * w * in_ch, out)


class CrowdAttention(nn.Module):
    """One masked self-attention block over pedestrian tokens (the layers;
    ``crowd_attention`` is the forward).

    Input is the reference ped_vector layout: [B, 1 + D*max_ped] where slot 0
    is the valid-ped count (yaml_env.py:449-458); invalid tokens are masked.
    """

    def __init__(self, max_ped: int, ped_vec_dim: int, dim: int = 64,
                 heads: int = ATTN_HEADS):
        super().__init__()
        self.max_ped, self.ped_vec_dim = max_ped, ped_vec_dim
        self.heads = heads
        self.embed = nn.Linear(ped_vec_dim, dim)
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.mlp = nn.Linear(dim, dim)


# The forward takes its layers as two callables, so that one body serves
# the plain module and the tensor-parallel forward (``parallel/tp.py``):
# ``linear(x, name)`` applies the Linear whose state-dict prefix is
# ``name``; ``conv(x, name, pad)`` pads ``x`` by ``pad`` and applies the
# stride-2 Conv ``name``.
Linear = Callable[[Tensor, str], Tensor]
Conv = Callable[[Tensor, str, Tuple[int, int, int, int]], Tensor]


def conv_trunk(trunk: ConvTrunk, prefix: str, x: Tensor, linear: Linear,
               conv: Conv) -> Tensor:
    """``trunk``'s forward; its layers are named ``prefix.convs.i`` and
    ``prefix.proj``."""
    for i, pad in enumerate(trunk.pads):
        x = F.relu(conv(x, f"{prefix}.convs.{i}", pad))
    # flax flattens NHWC
    x = x.permute(0, 2, 3, 1).flatten(1)
    return F.relu(linear(x, f"{prefix}.proj"))


def crowd_attention(attn: CrowdAttention, prefix: str, ped_vec: Tensor,
                    linear: Linear) -> Tensor:
    """``attn``'s forward; its layers are named ``prefix.<layer>``."""
    b, t = ped_vec.shape[0], attn.max_ped
    layer = lambda x, name: linear(x, f"{prefix}.{name}")
    count = ped_vec[:, 0].to(torch.int32)
    toks = ped_vec[:, 1:].reshape(b, t, attn.ped_vec_dim)
    mask = (torch.arange(t, device=ped_vec.device)[None, :]
            < torch.clamp(count, max=t)[:, None])               # [B,T]
    h = F.relu(layer(toks, "embed"))
    split = lambda x: x.unflatten(-1, (attn.heads, -1))
    q, k, v = (split(layer(h, name)) for name in ("query", "key", "value"))
    q = q / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits, dim=-1)
    att = torch.einsum("bhqk,bkhd->bqhd", weights, v).flatten(2)
    h = h + layer(att, "out")
    h = F.relu(layer(h, "mlp"))
    # masked mean-pool; zero when no peds visible
    w = mask.to(h.dtype)[..., None]
    return (h * w).sum(1) / torch.clamp(w.sum(1), min=1.0)


def policy_forward(model: "CrowdNavPolicy", linear: Linear, conv: Conv,
                   log_std: Optional[Tensor], sensor_maps: Tensor,
                   vector_states: Tensor, ped_maps: Optional[Tensor] = None,
                   ped_vectors: Optional[Tensor] = None):
    """``model``'s forward over the layers ``linear`` and ``conv`` (see
    above) and the Gaussian head's ``log_std`` (None for a discrete
    head): (mean, log_std, value) or (logits, value)."""
    c = model.cfg
    with full_float32():
        feats = [conv_trunk(model.sensor_trunk, "sensor_trunk",
                            sensor_maps.float(), linear, conv)]
        v = vector_states.flatten(1).float()
        feats.append(F.relu(linear(F.relu(linear(v, "vec0")), "vec1")))
        if c.use_ped_map and ped_maps is not None:
            feats.append(conv_trunk(model.ped_trunk, "ped_trunk",
                                    ped_maps.float(), linear, conv))
        if c.use_ped_vec and ped_vectors is not None:
            feats.append(crowd_attention(model.crowd_attn, "crowd_attn",
                                         ped_vectors.float(), linear))
        x = torch.cat(feats, dim=-1)
        x = F.relu(linear(x, "fuse0"))
        x = F.relu(linear(x, "fuse1"))
        value = linear(x, "value")[:, 0]
        if c.discrete_actions > 0:
            return linear(x, "pi_logits"), value
        mean = linear(x, "pi_mean")
        return mean, log_std.expand_as(mean), value


class CrowdNavPolicy(nn.Module):
    """Actor-critic over the full observation tuple.  ``forward`` returns
    (mean, log_std, value) for a continuous head, (logits, value) for a
    discrete one."""

    def __init__(self, cfg: PolicyConfig):
        super().__init__()
        self.cfg = c = cfg
        size = tuple(c.image_size)
        self.sensor_trunk = ConvTrunk(c.image_batch, size, out=c.hidden)
        self.vec0 = nn.Linear(c.state_dim, 64)
        self.vec1 = nn.Linear(64, 64)
        width = c.hidden + 64
        if c.use_ped_map:
            self.ped_trunk = ConvTrunk(3, size, out=128)
            width += 128
        if c.use_ped_vec:
            self.crowd_attn = CrowdAttention(c.max_ped, c.ped_vec_dim,
                                             c.crowd_dim)
            width += c.crowd_dim
        self.fuse0 = nn.Linear(width, c.hidden)
        self.fuse1 = nn.Linear(c.hidden, c.hidden)
        self.value = nn.Linear(c.hidden, 1)
        if c.discrete_actions > 0:
            self.pi_logits = nn.Linear(c.hidden, c.discrete_actions)
        else:
            self.pi_mean = nn.Linear(c.hidden, c.act_dim)
            self.pi_log_std = nn.Parameter(
                torch.full((c.act_dim,), float(c.log_std_init)))

    def forward(self, sensor_maps: Tensor, vector_states: Tensor,
                ped_maps: Optional[Tensor] = None,
                ped_vectors: Optional[Tensor] = None):
        layer = self.get_submodule
        return policy_forward(
            self, lambda x, name: layer(name)(x),
            lambda x, name, pad: layer(name)(F.pad(x, pad)),
            None if self.cfg.discrete_actions > 0 else self.pi_log_std,
            sensor_maps, vector_states, ped_maps, ped_vectors)


def example_inputs(cfg: PolicyConfig, batch: int = 8, device="cuda"):
    """Zero inputs of the policy's shapes (sensor maps, vector states, and
    the ped maps and vectors where the config uses them)."""
    h, w = cfg.image_size
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return (z(batch, cfg.image_batch, h, w), z(batch, cfg.state_dim),
            z(batch, 3, h, w) if cfg.use_ped_map else None,
            z(batch, 1 + cfg.ped_vec_dim * cfg.max_ped)
            if cfg.use_ped_vec else None)


# flax's lecun_normal: a standard normal truncated at +-2, scaled so that
# the truncated draw's std is sqrt(1 / fan_in) (the std of a standard normal
# truncated at +-2 is 0.87962566103423978)
_TRUNC_STD = 0.87962566103423978


def init_policy(generator: torch.Generator, cfg: PolicyConfig,
                device="cuda") -> Tuple[CrowdNavPolicy, Dict[str, Tensor]]:
    """A fresh ``CrowdNavPolicy`` on ``device`` (the card by default) with
    flax's default initialisation, and its parameters as a dict: every
    Dense, Conv and attention kernel lecun-normal with fan_in the flat
    input (kh*kw*in for a conv; heads*head_dim for the attention's output
    projection, as flax's ``DenseGeneral`` flattens it), every bias zero,
    ``pi_log_std`` the constant ``log_std_init``.  The draws come from
    ``generator`` (on ``device``) in the state dict's order; they are the
    port's own, not flax's (F4)."""
    dev = torch.device(device)
    policy = CrowdNavPolicy(cfg).to(dev)
    with torch.no_grad():
        for name, p in policy.named_parameters():
            if name == "pi_log_std":
                p.fill_(float(cfg.log_std_init))
            elif name.endswith(".bias"):
                p.zero_()
            else:
                std = math.sqrt(1.0 / p[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                p.mul_(std)
    params = {k: v.detach().clone() for k, v in policy.state_dict().items()}
    return policy, params


def sample_action(dist, generator: Optional[torch.Generator] = None,
                  draws: Optional[Tensor] = None, continuous_ranges=None):
    """Draw an action from the policy head output.

    dist: (mean, log_std, value) or (logits, value).  ``draws``: injected
    standard-normal draws (continuous, the shape of mean) or Gumbel draws
    (discrete, the shape of logits) in place of draws from ``generator``;
    a categorical draw is ``argmax(logits + gumbel)``, as JAX's.
    Returns (action, log_prob, value).
    """
    if len(dist) == 3:
        mean, log_std, value = dist
        eps = draws if draws is not None else torch.randn(
            mean.shape, generator=generator, device=mean.device,
            dtype=mean.dtype)
        act = mean + torch.exp(log_std) * eps
        logp = (-0.5 * ((act - mean) / torch.exp(log_std)) ** 2
                - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
        if continuous_ranges is not None:
            lo = torch.as_tensor([r[0] for r in continuous_ranges],
                                 dtype=act.dtype, device=act.device)
            hi = torch.as_tensor([r[1] for r in continuous_ranges],
                                 dtype=act.dtype, device=act.device)
            act = torch.clamp(act, lo, hi)
        return act, logp, value
    logits, value = dist
    if draws is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=logits.dtype)
        tiny = torch.finfo(logits.dtype).tiny
        draws = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    act = torch.argmax(logits + draws, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(
        -1, act[:, None])[:, 0]
    return act, logp, value


# ---------------------------------------------------------------------------
# Weights carried across from the JAX package's checkpoints
# ---------------------------------------------------------------------------


def _t(x, axes=None) -> Tensor:
    """A float32 copy of a numpy leaf, transposed to ``axes``."""
    x = np.array(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        x if axes is None else x.transpose(axes)))


def policy_params_from_numpy(flat: Dict[str, np.ndarray]
                             ) -> Dict[str, Tensor]:
    """The ``CrowdNavPolicy`` state dict of a flax parameter tree given as
    flat arrays keyed ``params/<module>/.../<leaf>`` (flax's paths).

    Dense kernels [in, out] become weights [out, in]; conv kernels
    [kh, kw, in, out] become [out, in, kh, kw]; the attention's query /
    key / value kernels [64, heads, 16] and biases [heads, 16], and its
    output kernel [heads, 16, 64], flatten their head axes (head-major, as
    flax's einsums read them)."""
    flat = {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in flat.items()}
    sd: Dict[str, Tensor] = {}

    def dense(path: str, out: str, k=None):
        k = flat[path + "/kernel"] if k is None else k
        sd[out + ".weight"] = _t(k, (1, 0))
        sd[out + ".bias"] = _t(flat[path + "/bias"]).reshape(-1)

    names = {k.split("/")[0] for k in flat}
    for trunk in ("sensor_trunk", "ped_trunk"):
        i = 0
        while f"{trunk}/conv{i}/kernel" in flat:
            sd[f"{trunk}.convs.{i}.weight"] = _t(
                flat[f"{trunk}/conv{i}/kernel"], (3, 2, 0, 1))
            sd[f"{trunk}.convs.{i}.bias"] = _t(flat[f"{trunk}/conv{i}/bias"])
            i += 1
        if i:
            dense(f"{trunk}/proj", f"{trunk}.proj")
    for name in ("vec0", "vec1", "fuse0", "fuse1", "value", "pi_mean",
                 "pi_logits"):
        if name in names:
            dense(name, name)
    if "crowd_attn" in names:
        for name in ("embed", "mlp"):
            dense(f"crowd_attn/{name}", f"crowd_attn.{name}")
        for name in ("query", "key", "value"):
            k = flat[f"crowd_attn/attn/{name}/kernel"]
            dense(f"crowd_attn/attn/{name}", f"crowd_attn.{name}",
                  np.reshape(k, (k.shape[0], -1)))
        k = flat["crowd_attn/attn/out/kernel"]
        dense("crowd_attn/attn/out", "crowd_attn.out",
              np.reshape(k, (-1, k.shape[-1])))
    if "pi_log_std" in flat:
        sd["pi_log_std"] = _t(flat["pi_log_std"])
    return sd


def load_policy_npz(path: str, env_cfg, device="cuda") -> CrowdNavPolicy:
    """A ``CrowdNavPolicy`` for ``env_cfg`` (the config it was trained
    with) holding the weights of an npz of flat flax arrays, in eval mode
    on ``device`` (the card by default)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    policy = CrowdNavPolicy(PolicyConfig.from_env_config(env_cfg))
    policy.load_state_dict(policy_params_from_numpy(flat), strict=True)
    return policy.to(torch.device(device)).eval()


def load_ckpt_policy(env_cfg, path: str, device="cuda"):
    """Deterministic-eval policy from a training checkpoint: the port's own
    (``train/checkpoint.save`` of ``{"params": ...}``, as ``train/run.py
    --save`` writes it) or a JAX-exported npz of flat flax arrays
    (``tools/export_policy_npz.py``).  ``env_cfg`` must match the training
    config (the load is strict).  Returns ``(policy_fn, policy)``, with
    ``policy_fn = mean_action_fn(policy, env_cfg)``."""
    if str(path).endswith(".npz"):
        policy = load_policy_npz(path, env_cfg, device)
    else:
        from img_env_tpu_torch.train import checkpoint as ckpt_mod

        policy = CrowdNavPolicy(PolicyConfig.from_env_config(env_cfg))
        params = ckpt_mod.restore(path, device="cpu")["params"]
        policy.load_state_dict(params, strict=True)
        policy = policy.to(torch.device(device)).eval()
    return mean_action_fn(policy, env_cfg), policy


def mean_action_fn(policy: CrowdNavPolicy, env_cfg) -> Callable:
    """Deterministic evaluation policy: ``(generator, obs) -> clipped mean
    actions [..., act_dim]`` from a raw Observation whose tensors carry any
    leading axes ([S, N] from ``evaluate_batched``, [N] from the facade's
    ``last_raw_obs``) — the port of ``load_ckpt_policy``'s policy_fn.  It
    makes no host sync."""
    use_ped = env_cfg.ped_sim.total > 0
    ranges = env_cfg.continuous_actions[: env_cfg.act_dim]
    dev = policy.pi_mean.weight.device
    lo = torch.as_tensor([r[0] for r in ranges], dtype=torch.float32,
                         device=dev)
    hi = torch.as_tensor([r[1] for r in ranges], dtype=torch.float32,
                         device=dev)

    @torch.no_grad()
    def policy_fn(generator, obs):
        lead = obs.vector_states.shape[:-1]
        flat = lambda x: x.reshape((-1,) + x.shape[len(lead):])
        sm = flat(obs.sensor_maps)[:, None]
        pm = flat(obs.ped_maps) if use_ped else None
        pv = flat(obs.ped_vector_states) if use_ped else None
        with trace.span("policy.forward"):
            mean, _, _ = policy(sm, flat(obs.vector_states), pm, pv)
            return torch.clamp(mean, lo, hi).reshape(lead + (-1,))

    return policy_fn
