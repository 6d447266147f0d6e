"""The model FLOPs of LR2PPO's stage-3 step at the flagship widths, counted
from shapes: a multiply-add is two operations; backward is twice forward;
nothing recomputed is counted.

Per item with T tags, S text tokens, I image tokens, width D, FFN width H:
the text projection (an MLP over T x S tokens), the image projection (I
tokens, once an item), the XiT block (queries from the T x S text tokens,
keys and values from the I image tokens, its FFN over T x S), the out_layer
MLP over T rows of (S + I) x D, the head; a sequence scorer adds the causal
XiT over its K gathered positions and its head.
"""


def _mlp(rows, d_in, h, d_out):
    return 2 * rows * (d_in * h + h * d_out)


def scorer_flops(m: dict, t: int, k: int = 0) -> float:
    """One item's forward through the actor (k = 0) or a sequence scorer
    over k positions."""
    d, s, i = m["feat_size"], m["seq_length"], m["max_imgs"]
    h = m["mlp_ratio"] * d
    f = _mlp(t * s, d, h, d) + _mlp(i, d, h, d)
    # XiT: q and output projections over T x S, k and v over I, the two
    # attention products, the FFN
    f += 2 * 2 * t * s * d * d + 2 * 2 * i * d * d
    f += 2 * 2 * t * s * i * d
    f += _mlp(t * s, d, h, d)
    f += _mlp(t, (s + i) * d, h, d)
    if k:
        f += 2 * 4 * k * d * d + 2 * 2 * k * k * d + _mlp(k, d, h, d)
        f += 2 * k * d
    else:
        f += 2 * t * d
    return float(f)


def ppo_flops(m: dict, batch: int, tags: int, rollouts: int,
              updates: int) -> float:
    """A rank's FLOPs for `rollouts` rollouts and `updates` updates of
    `batch` items: a rollout runs the actor, the critic (over the T tags)
    and the reward model (over 2 + T positions) forward; an update runs the
    actor and the critic forward and backward."""
    actor = scorer_flops(m, tags)
    critic = scorer_flops(m, tags, tags)
    reward = scorer_flops(m, tags, 2 + tags)
    return batch * (rollouts * (actor + critic + reward)
                    + updates * 3 * (actor + critic))
