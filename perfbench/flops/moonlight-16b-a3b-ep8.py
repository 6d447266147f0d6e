"""The model FLOPs of causal-LM pretraining of the latent MoE tower
(Moonlight-16B-A3B's block), counted from shapes: a multiply-add is two
operations; backward is twice forward; nothing recomputed is counted (the
layers' remat recompute is the program's choice, not the model's work).
Routed experts count at the held share: each token's k choices, times the
held experts over the routed ones, as one card of the expert-parallel
deployment computes them. Causal attention counts the (query, key) pairs at
or below the diagonal, S (S + 1) / 2 a head.

At the configuration's widths (hidden 2,048, 16 heads, 192 / 128 head
widths, latent 512, 9 layers of which 1 dense, 8 of 64 experts held, 6 a
token, vocabulary 20,480, 8,192 tokens) a token's forward is about 1.23
GFLOP: the MLA products 20%, attention 31%, the MoE block 31% (router,
held experts, shared experts), the dense layer 11%, the head 7%."""


def attention_flops(b: int, h: int, s: int, dqk: int, dv: int,
                    backward: bool) -> float:
    """Causal attention of b x h heads over s tokens: forward QKᵀ and PV;
    backward the recomputed QKᵀ, dV, dP, dQ and dK."""
    pairs = b * h * s * (s + 1) / 2.0
    per_pair = (3 * dqk + 2 * dv) if backward else (dqk + dv)
    return 2.0 * pairs * per_pair


def forward_per_token(c: dict, seq: int) -> dict:
    """A token's forward FLOPs by part, at sequence length seq."""
    d, h = c["hidden_size"], c["heads_num"]
    nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    rank = c["kv_lora_rank"]
    layers = c["layers_num"]
    dense = c["first_k_dense_replace"]
    held = c["n_routed_experts"] / c["router_experts"]
    mla = 2 * (d * h * (nope + rope) + d * (rank + rope)
               + rank * h * (nope + vd) + h * vd * d)
    attn = attention_flops(1, h, seq, nope + rope, vd, False) / seq
    swiglu = 6 * d  # three products of d x width a token
    moe = (2 * d * c["router_experts"]
           + c["num_experts_per_tok"] * held * swiglu
           * c["moe_intermediate_size"]
           + swiglu * c["moe_intermediate_size"] * c["n_shared_experts"])
    return {"mla": layers * mla, "attention": layers * attn,
            "moe": (layers - dense) * moe,
            "dense": dense * swiglu * c["feedforward_size"],
            "head": 2 * d * c["vocab_size"]}


def lm_flops(c: dict, sequences: int, seq: int) -> float:
    """FLOPs of `sequences` sequences of `seq` tokens, forward and
    backward."""
    return 3.0 * sequences * seq * sum(forward_per_token(c, seq).values())
