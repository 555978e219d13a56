"""The floating-point operations of one PPO update, from the reference
policy's layer shapes and the traffic, counted as
``torch.utils.flop_counter.FlopCounterMode`` counts them: 2 per
multiply-add of every convolution, linear layer and attention product,
nothing for elementwise work; a backward counts the gradient of each
weight, and of each layer's input where that input needs one (the first
layer of every branch reads the observation, which needs none).

One update (the port's ``train_step`` after its rollout) is the last
value's forward over S*N samples, then ``epochs`` passes of forward and
backward over all T*S*N samples, in minibatches.

Imports nothing: ``cfg`` is the reference's ``PolicyConfig``
(``navbench/reference/models/policy.py``).
"""

TRUNK = (32, 64, 64)        # ConvTrunk's features; 3x3 kernels, stride 2


def _linear(n_in: int, n_out: int, rows: int, input_grad: bool):
    """(forward, backward) of a linear layer over ``rows`` rows."""
    f = 2 * rows * n_in * n_out
    return f, f * (2 if input_grad else 1)


def _trunk(in_ch: int, size, out: int):
    """(forward, backward) of ``ConvTrunk`` on one sample."""
    fwd = bwd = 0
    h, w = size
    for i, c in enumerate(TRUNK):
        h, w = -(-h // 2), -(-w // 2)
        f = 2 * h * w * c * in_ch * 9
        fwd += f
        bwd += f * (1 if i == 0 else 2)
        in_ch = c
    f, b = _linear(h * w * in_ch, out, 1, True)
    return fwd + f, bwd + b


def sample_flops(cfg):
    """(forward, backward) operations of the policy on one sample."""
    parts = [_trunk(cfg.image_batch, cfg.image_size, cfg.hidden),
             _linear(cfg.state_dim, 64, 1, False),
             _linear(64, 64, 1, True)]
    width = cfg.hidden + 64
    if cfg.use_ped_map:
        parts.append(_trunk(3, cfg.image_size, 128))
        width += 128
    if cfg.use_ped_vec:
        t, d = cfg.max_ped, cfg.crowd_dim
        parts.append(_linear(cfg.ped_vec_dim, d, t, False))       # embed
        parts += [_linear(d, d, t, True)] * 5          # q, k, v, out, mlp
        # the two products over the heads, logits and weighted values:
        # each a batched matmul (heads x T x T x d / heads multiply-adds)
        # whose backward takes both operands
        prod = 2 * t * t * d
        parts += [(prod, 2 * prod)] * 2
        width += d
    parts += [_linear(width, cfg.hidden, 1, True),
              _linear(cfg.hidden, cfg.hidden, 1, True),
              _linear(cfg.hidden, 1, 1, True)]
    n_out = (cfg.discrete_actions if cfg.discrete_actions > 0
             else cfg.act_dim)
    parts.append(_linear(cfg.hidden, n_out, 1, True))
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def update_flops(cfg, samples: int, epochs: int, last: int) -> int:
    """One update's operations: ``epochs`` forward and backward passes
    over ``samples`` (T*S*N) samples and the last value's forward over
    ``last`` (S*N)."""
    fwd, bwd = sample_flops(cfg)
    return epochs * samples * (fwd + bwd) + last * fwd
