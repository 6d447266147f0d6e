"""The model FLOPs of masked-LM pretraining of a BERT-style tower, counted
from shapes: a multiply-add is two operations; backward is twice forward;
nothing recomputed is counted. The MLM head counts only the positions the
loss reads (the masked ones): a program that computes the vocabulary at
every position does work the loss does not need."""


def mlm_flops(c: dict, sequences: int, seq: int, masked: int) -> float:
    """FLOPs of `sequences` sequences of `seq` tokens, `masked` of whose
    positions the loss reads, forward and backward."""
    d, ff, layers = c["hidden_size"], c["feedforward_size"], c["layers_num"]
    tokens = sequences * seq
    per_token = layers * (4 * 2 * d * d + 2 * 2 * seq * d + 2 * 2 * d * ff)
    head = masked * (2 * d * d + 2 * d * c["vocab_size"])
    return 3.0 * (tokens * per_token + head)
