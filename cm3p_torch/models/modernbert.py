"""ModernBERT-style encoder as torch ``nn.Module``s.

Counterpart of the JAX package's ``models/modernbert.py``:

* no position embeddings: rope inside attention, ``global_rope_theta`` on
  global layers and ``local_rope_theta`` on local ones; arange positions
  unless ``position_ids`` are given (the metadata tower's ``meta_pack`` rows
  restart them per segment);
* layer i is global iff ``i % global_attn_every_n_layers == 0``; local
  layers see |i - j| <= ``local_attention // 2``;
* pre-norm blocks with fused Wqkv and a GeGLU MLP; layer 0 has no
  attention pre-norm;
* LayerNorms in fp32, exact (erf) GELU.

Parameter names are the HF keys that ``flax_to_hf_state_dict`` emits
(``layers.3.attn.Wqkv.weight``, ``layers.3.mlp.Wi.weight``, ...), so an
HF-layout checkpoint loads without a second mapping.

Precision follows flax ``dtype``/``param_dtype``: parameters keep their own
dtype (fp32 masters in training) and every product casts its weight to the
activation dtype at use; LayerNorms run in fp32. The activation dtype is the
encoder's ``compute_dtype`` (None: the token embeddings' dtype, so a model
whose weights were cast to bf16 computes in bf16).

Routing. Without autograd, attention goes through
:func:`cm3p_torch.ops.attention` (rope in the kernel for arange positions)
and the MLP half-block through the :func:`cm3p_torch.ops.fused_ln_ffn` kernel.
Under autograd (the JAX training route) rope is applied outside the kernels,
attention runs the forward kernel with lse and the backward kernels, and the
MLP runs :class:`~cm3p_torch.ops.fused_ffn.LnFfnFunction`. Kernels on CUDA at
every length, plain versions on the CPU; ``plain=True`` on an encoder runs the
plain versions on any device (the on-card oracle).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import EncoderConfig
from ..ops import attention, fused_ln_ffn, fused_ln_ffn_plain, layer_norm_f32
from ..ops.fused_ffn import LnFfnFunction


def linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Bias-free Dense in x's dtype (flax ``dtype``): the weight is cast at use."""
    return F.linear(x, weight.to(x.dtype))


class LayerNormF32(nn.Module):
    """LayerNorm computed in fp32 whatever the activation dtype; keeps fp32 params."""

    def __init__(self, dim: int, eps: float, use_bias: bool):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.weight, self.bias, self.eps).to(x.dtype)


class SelfAttention(nn.Module):
    """Fused-QKV rotary self-attention (bias-free, as ModernBERT)."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        hidden = config.hidden_size
        self.heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.Wqkv = nn.Linear(hidden, 3 * hidden, bias=False)
        self.Wo = nn.Linear(hidden, hidden, bias=False)

    def forward(self, x, key_mask, segment_ids, window, rope_theta, plain: bool = False, positions=None):
        b, length, hidden = x.shape
        qkv = linear(x, self.Wqkv.weight).view(b, length, 3, self.heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)  # head-minor (B, L, H, D) views, no copies
        out = attention(q, k, v, key_mask, segment_ids, window, rope_theta, plain=plain, positions=positions)
        return linear(out.reshape(b, length, hidden), self.Wo.weight)


class GeGLU(nn.Module):
    """Parameter holder for the MLP (``Wi``: D -> 2F, ``Wo``: F -> D)."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.Wi = nn.Linear(config.hidden_size, 2 * config.intermediate_size, bias=False)
        self.Wo = nn.Linear(config.intermediate_size, config.hidden_size, bias=False)


class EncoderLayer(nn.Module):
    def __init__(self, config: EncoderConfig, layer_id: int):
        super().__init__()
        self.config = config
        self.is_global = config.layer_is_global(layer_id)
        # layer 0 has an identity attention pre-norm (ModernBERT quirk)
        self.attn_norm = (
            LayerNormF32(config.hidden_size, config.norm_eps, config.norm_bias) if layer_id != 0 else None
        )
        self.attn = SelfAttention(config)
        self.mlp_norm = LayerNormF32(config.hidden_size, config.norm_eps, config.norm_bias)
        self.mlp = GeGLU(config)

    def forward(self, x, key_mask=None, segment_ids=None, plain: bool = False, positions=None):
        cfg = self.config
        window = None if self.is_global else cfg.local_attention // 2
        theta = cfg.global_rope_theta if self.is_global else cfg.local_rope_theta
        attn_in = x if self.attn_norm is None else self.attn_norm(x)
        x = x + self.attn(attn_in, key_mask, segment_ids, window, theta, plain=plain, positions=positions)
        norm, mlp = self.mlp_norm, self.mlp
        if torch.is_grad_enabled():
            return LnFfnFunction.apply(x, norm.weight, norm.bias, mlp.Wi.weight, mlp.Wo.weight, cfg.norm_eps)
        ffn = fused_ln_ffn_plain if plain else fused_ln_ffn
        dt = x.dtype
        return ffn(x, norm.weight, norm.bias, mlp.Wi.weight.to(dt), mlp.Wo.weight.to(dt), cfg.norm_eps)


class Embeddings(nn.Module):
    def __init__(self, config: EncoderConfig, token_embeddings: bool):
        super().__init__()
        self.tok_embeddings = nn.Embedding(config.vocab_size, config.hidden_size) if token_embeddings else None
        self.norm = LayerNormF32(config.hidden_size, config.norm_eps, config.norm_bias)


class ModernBertEncoder(nn.Module):
    """Token/feature encoder with alternating local-global attention.

    Call with ``input_ids`` (B, L) or ``inputs_embeds`` (B, L, H); returns
    the final-norm hidden states (B, L, H). The audio tower consumes
    ``inputs_embeds`` only and is built with ``token_embeddings=False``.
    """

    def __init__(self, config: EncoderConfig, token_embeddings: bool = True):
        super().__init__()
        if config.attention_bias or config.mlp_bias:
            raise NotImplementedError("the port's encoder has no attention or MLP biases")
        if config.hidden_activation != "gelu":
            raise NotImplementedError(f"the port's GeGLU uses exact gelu, not {config.hidden_activation!r}")
        self.config = config
        self.embeddings = Embeddings(config, token_embeddings)
        self.layers = nn.ModuleList(EncoderLayer(config, i) for i in range(config.num_hidden_layers))
        self.final_norm = LayerNormF32(config.hidden_size, config.norm_eps, config.norm_bias)
        self.plain = False
        self.compute_dtype: Optional[torch.dtype] = None

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Raw token embeddings (pre-norm) in the activation dtype, for the
        audio-placeholder scatter."""
        table = self.embeddings.tok_embeddings.weight
        return F.embedding(input_ids, table).to(self.compute_dtype or table.dtype)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = self.embeddings.norm(inputs_embeds.to(self.compute_dtype or inputs_embeds.dtype))
        for layer in self.layers:
            x = layer(x, attention_mask, segment_ids, plain=self.plain, positions=position_ids)
        return self.final_norm(x)


def pool_hidden(hidden: torch.Tensor, attention_mask: Optional[torch.Tensor], cls_embed: bool) -> torch.Tensor:
    """CLS-token or masked-mean pooling."""
    if cls_embed:
        return hidden[..., 0, :]
    if attention_mask is not None:
        mask = attention_mask[..., None].float()
        summed = (hidden.float() * mask).sum(dim=-2)
        return (summed / mask.sum(dim=-2).clamp_min(1e-9)).to(hidden.dtype)
    return hidden.mean(dim=-2)
