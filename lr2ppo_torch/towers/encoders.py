"""The transformer encoder of the towers (counterpart of
lr2ppo_tpu/towers/encoders.py:TransformerEncoder).

Its layers are `encoder.transformer.<i>` (or one shared `encoder.transformer`
under parameter sharing), then `encoder.layer_norm` for pre-LN stacks. With
`relative_position_embedding` (T5) the bidirectional bias table is
`encoder.relative_pos_emb`, computed once a pass and added in every layer;
with `has_residual_attention` each layer's chained scores pass to the next.
On a deterministic fully-visible pass with `pallas_attention` set and
neither of those two, the encoder hands each layer a (B, S) key bias, which
routes attention through the fused kernel (ops/attention.py), as the JAX
gate (encoders.py:84-89) does. The kernel has no backward: a training pass
takes the plain attention.

With `remat`, each layer of a pass that records gradients runs under
utils/remat.py, which recomputes its activations in the backward with the
dropout seeds of the forward (the JAX package's `nn.remat` of the layer).

With `seq_parallel` (--sp) and a tp mesh, the residual stream between the
layers is split along the sequence over tp, the JAX package's
`P('dp', 'tp')` constraint (encoders.py:91-120): the embedding's output is
split (parallel/tp.py:split_seq), every layer computes on its S/tp tokens
(towers/layers.py:TransformerLayer), and the stream is gathered whole again
before the final norm and the target. At tp 1 it does nothing, as in JAX.

The rest of the zoo (encoders.py:141-349 of the JAX package):

  * rnn, lstm and gru (`_RecurrentEncoder`): torch's flat parameters under
    `encoder.rnn` (`weight_ih_l{k}[_reverse]`, `weight_hh_...`, `bias_ih_...`,
    `bias_hh_...`, the reference's nn.RNN nesting). Each layer, or each
    layer's two directions, runs through torch's own fused recurrence
    (torch.rnn_tanh / lstm / gru: cuDNN on the card), which computes the
    JAX `lax.scan` cells in torch's gate order, straight through the pads,
    the reverse direction over the reversed padded sequence. The JAX
    package computes the recurrence outside any Pallas kernel. The port's
    dropout sits between the layers and at the output, where JAX calls
    `module_dropout`. The recurrence runs in float32, as JAX promotes it;
    on the card it refuses cuDNN's TF32 (device.py:require_cuda turns it
    off), which its backward would read too;
  * birnn, bilstm and bigru (`_BiStackEncoder`): two independent stacks of
    hidden_size / 2, `encoder.rnn_forward` over the sequence and
    `encoder.rnn_backward` over the flipped one, concatenated at the end;
  * gatedcnn: causal width-k windows and one product per convolution, GLU
    gating and a residual every `block_size` layers; the kernels keep the
    reference Conv2d keys and 4-D shapes (`conv_1`, `gate_1`, `conv.<i>`,
    `gate.<i>`) with JAX's single bias each;
  * dual (`DualEncoder`): `encoder_0` and `encoder_1` over the pair of
    streams, each built from the config overlaid with its `stream_0` /
    `stream_1` dict; `tie_weights` runs both streams through `encoder_0`
    (no `encoder_1` keys, as in the JAX tree).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lr2ppo_torch.models.layers import Linear
from lr2ppo_torch.ops.hash_dropout import module_dropout
from lr2ppo_torch.parallel.tp import gather_seq_replicated, split_seq
from lr2ppo_torch.towers.layers import (RelativePositionEmbedding,
                                        TransformerLayer,
                                        additive_mask_from_seg,
                                        make_layer_norm)
from lr2ppo_torch.utils.remat import remat


class TransformerEncoder(nn.Module):
    """transformer_encoder.py:7-138 (the BERT/ViT-style stack)."""

    seq_parallel = False
    sp_mesh = None

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.factorized_embedding_parameterization:
            self.linear = Linear(cfg.emb_size, cfg.hidden_size, dtype=dtype,
                                 device=device)
        if cfg.relative_position_embedding:
            self.relative_pos_emb = RelativePositionEmbedding(
                cfg.heads_num, bidirectional=True,
                num_buckets=cfg.relative_attention_buckets_num,
                device=device)

        def layer() -> TransformerLayer:
            return TransformerLayer(
                cfg.hidden_size, cfg.heads_num, cfg.feedforward_size,
                cfg.hidden_act, cfg.layernorm_positioning, cfg.layernorm,
                cfg.feed_forward, cfg.attention_head_size,
                has_bias=not cfg.remove_transformer_bias,
                with_scale=not cfg.remove_attention_scale, dtype=dtype,
                device=device, dropout=cfg.dropout,
                hash_dropout=cfg.hash_dropout)

        self.transformer = (layer() if cfg.parameter_sharing
                            else nn.ModuleList(layer()
                                               for _ in range(cfg.layers_num)))
        if cfg.seq_parallel:
            # the stack and every module inside it read the split stream
            # once shard_tp hands them the tp mesh
            self.seq_parallel = True
            for m in self.transformer.modules():
                if hasattr(type(m), "seq_parallel"):
                    m.seq_parallel = True
        if cfg.layernorm_positioning == "pre":
            self.layer_norm = make_layer_norm(cfg.layernorm, cfg.hidden_size,
                                              dtype, device)

    def forward(self, emb: torch.Tensor, seg: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        if cfg.factorized_embedding_parameterization:
            emb = self.linear(emb)
        # the key-only bias that takes the fused attention kernel, on a
        # deterministic pass without position bias or chained scores only
        key_bias = None
        if (cfg.pallas_attention and cfg.mask == "fully_visible"
                and deterministic and not cfg.has_residual_attention
                and not cfg.relative_position_embedding):
            key_bias = torch.where(seg > 0, 0.0, -10000.0)
        # the (B, 1, S, S) mask, where some layer takes the plain path
        mask = (additive_mask_from_seg(seg, cfg.mask)
                if key_bias is None or cfg.remove_attention_scale else None)
        position_bias = None
        if cfg.relative_position_embedding:
            layer = (self.transformer if cfg.parameter_sharing
                     else self.transformer[0])
            position_bias = self.relative_pos_emb(
                emb.shape[1], emb.shape[1], layer.self_attn.heads_mesh)
        recompute = cfg.remat and torch.is_grad_enabled()
        sp = self.sp_mesh
        hidden, prev_attn = (emb if sp is None else split_seq(emb, sp)), None
        for i in range(cfg.layers_num):
            blk = (self.transformer if cfg.parameter_sharing
                   else self.transformer[i])
            args = (hidden, mask, position_bias, prev_attn, key_bias,
                    deterministic)
            hidden, prev_attn = (remat(blk, *args, generator=generator)
                                 if recompute else blk(*args, generator))
            if not cfg.has_residual_attention:
                prev_attn = None
        if sp is not None:
            hidden = gather_seq_replicated(hidden, sp)
        if cfg.layernorm_positioning == "pre":
            hidden = self.layer_norm(hidden)
        return hidden


# -- the RNN family ----------------------------------------------------------
_GATES = {"rnn": 1, "lstm": 4, "gru": 3}
_RECURRENCES = {"rnn": torch.rnn_tanh, "lstm": torch.lstm, "gru": torch.gru}


class RnnWeights(nn.Module):
    """A stack of `layers` recurrent layers under torch nn.RNN/LSTM/GRU's
    flat names, and its forward: each layer through torch's fused op,
    dropout between the layers and at the output (rnn_encoder.py:6-93).
    Weights and biases start U(-1/sqrt(hs), 1/sqrt(hs)), as torch's and
    JAX's (encoders.py:196-206)."""

    def __init__(self, cell: str, input_size: int, hidden_size: int,
                 layers: int, bidirectional: bool, dropout: float,
                 hash_dropout: bool, device=None):
        super().__init__()
        self.cell, self.hidden_size, self.layers = cell, hidden_size, layers
        self.directions = 2 if bidirectional else 1
        self.dropout, self.hash_dropout = dropout, hash_dropout
        rows = _GATES[cell] * hidden_size
        for k in range(layers):
            in_dim = input_size if k == 0 else hidden_size * self.directions
            for sfx in self._suffixes(k):
                for name, shape in (("weight_ih", (rows, in_dim)),
                                    ("weight_hh", (rows, hidden_size)),
                                    ("bias_ih", (rows,)),
                                    ("bias_hh", (rows,))):
                    self.register_parameter(f"{name}_{sfx}", nn.Parameter(
                        torch.empty(shape, device=device)))

    def _suffixes(self, k: int):
        return [f"l{k}", f"l{k}_reverse"][:self.directions]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            p.uniform_(-bound, bound, generator=generator)

    def layer(self, k: int, x: torch.Tensor) -> torch.Tensor:
        """Layer k over x (B, S, in) from zero states: (B, S, hs x
        directions), the reverse direction's outputs at their own
        positions."""
        if x.is_cuda and torch.backends.cudnn.allow_tf32:
            raise RuntimeError(
                "cuDNN's TF32 is on: the float32 recurrence would run in "
                "TF32 forward and backward (lr2ppo_torch.device."
                "require_cuda turns it off)")
        params = [getattr(self, f"{name}_{sfx}") for sfx in self._suffixes(k)
                  for name in ("weight_ih", "weight_hh", "bias_ih",
                               "bias_hh")]
        h0 = x.new_zeros(self.directions, x.shape[0], self.hidden_size)
        hx = (h0, h0) if self.cell == "lstm" else h0
        with warnings.catch_warnings():
            # cuDNN copies separately stored weights into its own buffer
            # each call; it warns about that copy
            warnings.filterwarnings("ignore", message="RNN module weights")
            return _RECURRENCES[self.cell](
                x, hx, params, True, 1, 0.0, torch.is_grad_enabled(),
                self.directions == 2, True)[0]

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x.float()
        for k in range(self.layers):
            x = self.layer(k, x)
            if k < self.layers - 1:
                x = module_dropout(x, self.dropout, deterministic, generator,
                                   self.hash_dropout)
        return module_dropout(x, self.dropout, deterministic, generator,
                              self.hash_dropout)


class _RecurrentEncoder(nn.Module):
    """rnn, lstm or gru: one stack under `rnn`, (bi)directional per layer
    (hidden_size / 2 a direction where bidirectional)."""

    def __init__(self, cell: str, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        hs = cfg.hidden_size // 2 if cfg.bidirectional else cfg.hidden_size
        self.rnn = RnnWeights(cell, cfg.emb_size, hs, cfg.layers_num,
                              cfg.bidirectional, cfg.dropout,
                              cfg.hash_dropout, device)

    def forward(self, emb: torch.Tensor, seg: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.rnn(emb, deterministic, generator)


def RnnEncoder(cfg, dtype=None, device=None) -> _RecurrentEncoder:
    return _RecurrentEncoder("rnn", cfg, dtype, device)


def LstmEncoder(cfg, dtype=None, device=None) -> _RecurrentEncoder:
    return _RecurrentEncoder("lstm", cfg, dtype, device)


def GruEncoder(cfg, dtype=None, device=None) -> _RecurrentEncoder:
    return _RecurrentEncoder("gru", cfg, dtype, device)


class _BiStackEncoder(nn.Module):
    """The reference Bi{rnn,lstm,gru}Encoder (rnn_encoder.py:82-160): two
    independent unidirectional stacks of hidden_size / 2, `rnn_forward`
    over the sequence and `rnn_backward` over the flipped one (its output
    flipped back), concatenated only at the end. Unlike bidirectional=True
    a layer never reads the other direction."""

    def __init__(self, cell: str, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        if cfg.hidden_size % 2:
            raise ValueError("bi-stack encoders need an even hidden_size")
        for name in ("rnn_forward", "rnn_backward"):
            self.add_module(name, RnnWeights(
                cell, cfg.emb_size, cfg.hidden_size // 2, cfg.layers_num,
                False, cfg.dropout, cfg.hash_dropout, device))

    def forward(self, emb: torch.Tensor, seg: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        fwd = self.rnn_forward(emb, deterministic, generator)
        bwd = self.rnn_backward(emb.flip(1), deterministic, generator)
        return torch.cat([fwd, bwd.flip(1)], dim=-1)


# -- the gated CNN -----------------------------------------------------------
def causal_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, S, D) -> (B, S, k*D): the window of k positions ending at each
    position (zeros before the start), offset-major."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return torch.cat([xp[:, i:i + s] for i in range(k)], dim=-1)


class GatedcnnEncoder(nn.Module):
    """Gated CNN (cnn_encoder.py:4-94): a stem `conv_1` / `gate_1` over the
    embedding, then layers_num - 1 layers `conv.<i>` / `gate.<i>`, each
    h * sigmoid(gate), with the block's input added every `block_size`
    layers. A convolution keeps the reference Conv2d's key and shape (stem
    (hs, 1, k, emb), layer (hs, hs, k, 1)) and one bias, the sum of the
    reference's two (torch_import.py folds them); it is computed as JAX
    computes it: causal windows, then one product with the kernel flattened
    offset-major. Kernels start N(0, 0.02), biases N(0, 1)."""

    def __init__(self, cfg, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        k, hs = cfg.kernel_size, cfg.hidden_size

        def conv(in_ch, width):
            c = nn.Conv2d(in_ch, hs, (k, width), device=device)
            c.decay_bias = True        # JAX's leaf is `<name>_b`, decayed
            return c

        self.conv_1, self.gate_1 = (conv(1, cfg.emb_size),
                                    conv(1, cfg.emb_size))
        self.conv = nn.ModuleList(conv(hs, 1)
                                  for _ in range(cfg.layers_num - 1))
        self.gate = nn.ModuleList(conv(hs, 1)
                                  for _ in range(cfg.layers_num - 1))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for c in (self.conv_1, self.gate_1, *self.conv, *self.gate):
            c.weight.normal_(0.0, 0.02, generator=generator)
            c.bias.normal_(0.0, 1.0, generator=generator)

    def _apply_conv(self, c: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        w = c.weight
        if w.shape[1] == 1:                      # stem: (hs, 1, k, emb)
            kernel = w[:, 0].reshape(w.shape[0], -1)
        else:                                    # layer: (hs, hs, k, 1)
            kernel = w[..., 0].transpose(1, 2).reshape(w.shape[0], -1)
        windows = causal_windows(x, self.cfg.kernel_size)
        return torch.matmul(windows, kernel.t().to(x.dtype)) + c.bias

    def forward(self, emb: torch.Tensor, seg: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        hidden = (self._apply_conv(self.conv_1, emb)
                  * torch.sigmoid(self._apply_conv(self.gate_1, emb)))
        res_input = hidden
        for i, (c, g) in enumerate(zip(self.conv, self.gate)):
            hidden = (self._apply_conv(c, hidden)
                      * torch.sigmoid(self._apply_conv(g, hidden)))
            if (i + 1) % self.cfg.block_size == 0:
                hidden = hidden + res_input
                res_input = hidden
        return hidden


# -- the dual encoder ---------------------------------------------------------
def stream_config(cfg, stream: dict):
    """The base config overlaid with a stream dict, field by field (keys
    that are no field are ignored), as the JAX package builds each stream."""
    names = {f.name for f in dataclasses.fields(cfg)}
    return dataclasses.replace(cfg, **{k: v for k, v in stream.items()
                                       if k in names})


class DualEncoder(nn.Module):
    """Two-stream (CLIP/SBERT-style) encoder (dual_encoder.py:6-47):
    `encoder_0` over stream 0 and `encoder_1` over stream 1; takes and
    returns pairs. Under `tie_weights` both streams run `encoder_0`."""

    def __init__(self, cfg0, cfg1, tie_weights: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.tie_weights = tie_weights
        self.encoder_0 = build_encoder(cfg0, dtype, device)
        if not tie_weights:
            self.encoder_1 = build_encoder(cfg1, dtype, device)

    def forward(self, emb, seg, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        second = self.encoder_0 if self.tie_weights else self.encoder_1
        return (self.encoder_0(emb[0], seg[0], deterministic, generator),
                second(emb[1], seg[1], deterministic, generator))


_KINDS = {
    "transformer": TransformerEncoder,
    "rnn": RnnEncoder, "lstm": LstmEncoder, "gru": GruEncoder,
    "birnn": lambda cfg, dtype, device: _BiStackEncoder("rnn", cfg, dtype,
                                                        device),
    "bilstm": lambda cfg, dtype, device: _BiStackEncoder("lstm", cfg, dtype,
                                                         device),
    "bigru": lambda cfg, dtype, device: _BiStackEncoder("gru", cfg, dtype,
                                                        device),
    "gatedcnn": GatedcnnEncoder,
}


def build_encoder(cfg, dtype=None, device=None) -> nn.Module:
    """The encoder of `cfg.encoder` (lr2ppo_tpu/towers/encoders.py:
    build_encoder)."""
    if cfg.encoder == "dual":
        return DualEncoder(stream_config(cfg, cfg.stream_0),
                           stream_config(cfg, cfg.stream_1),
                           cfg.tie_weights, dtype, device)
    return _KINDS[cfg.encoder](cfg, dtype, device)
