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
Under autograd (the JAX training route) attention runs the forward kernel
with lse and the backward kernels. On the layers that
:func:`~cm3p_torch.ops.attention.rope_in_kernels` admits (arange positions,
head dim 64, an even head count: the JAX package's ``CM3P_TRAIN_FUSED_ROPE``
route) rope stays inside them: q/k are saved raw and the backward kernels'
rope forms rotate them on load and counter-rotate dq/dk. Elsewhere (the
metadata tower's ``meta_pack`` rows restart positions) rope is applied
outside. The MLP runs :class:`~cm3p_torch.ops.fused_ffn.LnFfnFunction`.
Kernels on CUDA at every length, plain versions on the CPU; ``plain=True`` on
an encoder runs the plain versions on any device, with rope outside under
autograd (the on-card oracle). The kernels take bf16, head dim 64 and the
towers' widths 256 / 512 / 768, and raise on CUDA on anything else: a model
outside them runs on the card only when its entry point asks for ``plain``
(``python -m cm3p_torch.extract --tiny-model``, and the training configs with
``attn_impl: xla``, as the JAX package runs those on XLA).

:class:`EncoderOptions` carries the extraction options that the JAX package
reads from the environment. They act on no-grad forwards only (under autograd
every projection is the exact unfused module, as in the JAX package):
``fused_lnmm_qkv`` sends raw ``x`` and the attention pre-norm's
parameters to :func:`~cm3p_torch.ops.fused_ln_matmul` (its W8A8 form when
``w8a8``) on every layer but layer 0, which has no pre-norm; the
out-projection with its residual goes to the attention kernel's epilogue
(``fused_wo``, int8 with ``fused_wo_q``) where :func:`wo_epilogue` admits it,
else to the LN-matmul kernel (``fused_lnmm_wo``, its W8A8 form when
``w8a8_wo``), else to ``residual + x @ Wo^T``; the MLP half-block gets
``w8a8`` / ``w8a8_wo``; ``xla_int8`` sends every product that no fused route
takes through :func:`~cm3p_torch.ops.xla_int8.int8_dot` (the QKV projection,
the out-projection, and the MLP's ``Wi`` and ``Wo`` where the JAX package runs
its MLP unfused: the ``xla`` route and widths ``ffn_fusable`` rejects). int8
weights are made from the parameters at first use and again whenever a
parameter changes (reload, cast, move), never per forward.

The ``xla`` route (:meth:`ModernBertEncoder.set_attn_impl`, the JAX package's
``attn_impl="xla"``) is the full model with no kernel: the plain versions of
every op and no fused route, so its options reduce to ``xla_int8``; with it the
no-grad MLP is the JAX ``GeGLU``: LN, ``int8_dot`` to 2F, ``gelu(a) * b`` in the
activation dtype, ``int8_dot`` back and the residual.

Sequence parallelism (the JAX package's ``sp_mesh``): with ``sp_group`` (a
``torch.distributed`` process group) the encoder takes the full (B, L) input
on every rank, keeps rows [r L/n, (r + 1) L/n) of rank r, applies rope outside
the kernels at those absolute positions, runs attention through
:func:`~cm3p_torch.parallel.sequence.sequence_sharded_attention` (K/V
all-gathered; global layers take the rectangular segment kernel) and gathers
the final hidden states, so every rank returns the full (B, L, H). Forward
only; packed ``segment_ids`` raise, and the attention kernels' Wo epilogue is
declined (the FFN and LN-matmul options still apply).

Rematerialisation (the JAX package's ``remat``): an encoder's ``remat`` is
False, True (each layer runs under ``torch.utils.checkpoint`` and its forward
runs again in the backward) or ``"dots"`` (the same, but the outputs of the
layer's ``mm`` / ``addmm`` products are kept and not recomputed; the kernels,
which are no such op, run again). It acts only where grad is on.

Tensor parallelism (the JAX package's ``model`` mesh axis): with a model
group (:meth:`ModernBertEncoder.set_model_group`, after
:func:`~cm3p_torch.parallel.tensor.shard_module` cut the layers' products
into Megatron shards) each layer runs ``Wqkv`` on its heads' rows
(:func:`~cm3p_torch.parallel.tensor.column_parallel_linear`), the same
attention kernels on its local heads (rope inside them where
:func:`~cm3p_torch.ops.attention.rope_in_kernels` admits the local head
count), multiplies by its columns of ``Wo`` and sums the fp32 partial over the
group (:func:`~cm3p_torch.parallel.tensor.row_parallel_linear`) before the
residual; the MLP is :class:`~cm3p_torch.ops.fused_ffn.LnFfnFunction`'s
model-group form. The same composition runs without grad: the fused FFN
kernel adds the residual inside its epilogue and so declines (logged), and
:class:`EncoderOptions` other than :data:`EXACT` raise, as the JAX package
runs no extraction option on a model axis. A model group and ``sp_group``
together raise.

Dropout is not ported: a nonzero ``attention_dropout``, ``embedding_dropout``
or ``mlp_dropout`` raises where it would apply (training mode under grad);
inference, where the JAX package applies none, runs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..configs import EncoderConfig
from ..ops import (
    attention,
    fused_ln_ffn,
    fused_ln_ffn_plain,
    fused_ln_matmul,
    fused_ln_matmul_plain,
    fused_ln_matmul_q,
    fused_ln_matmul_q_plain,
    layer_norm_f32,
    lnmm_fusable,
    quantize_weight_int8,
    wo_fusable,
    wo_shape_ok,
)
from ..ops.attention import apply_rope
from ..ops.fused_ffn import LnFfnFunction, ffn_fusable
from ..ops.xla_int8 import int8_dot, quant_weight_int8
from ..parallel.sequence import all_gather_seq, sequence_sharded_attention
from ..parallel.tensor import column_parallel_linear, group_size, row_parallel_linear

DROPOUT_FIELDS = ("attention_dropout", "embedding_dropout", "mlp_dropout")


@dataclasses.dataclass(frozen=True)
class EncoderOptions:
    """Extraction options of an encoder (no-grad forwards only).

    Each field stands for an environment variable of the JAX package:

    * ``w8a8`` - ``CM3P_W8A8``: int8 Wi in the MLP half-block, and int8 QKV
      projection where ``fused_lnmm_qkv`` routes it through the fused kernel;
    * ``w8a8_wo`` - ``CM3P_W8A8_WO``: int8 Wo in the MLP half-block, and int8
      attention out-projection where ``fused_lnmm_wo`` routes it;
    * ``fused_lnmm_qkv`` - ``CM3P_FUSED_LNMM_QKV`` (or the master
      ``CM3P_FUSED_LNMM``): attention pre-norm fused into the QKV projection;
    * ``fused_lnmm_wo`` - ``CM3P_FUSED_LNMM_WO`` (or ``CM3P_FUSED_LNMM``):
      attention out-projection fused with its residual add;
    * ``fused_wo`` - ``CM3P_FUSED_WO``: the attention kernel applies the
      out-projection and the residual add itself (``residual + o @ Wo^T``, o
      never stored); it takes precedence over ``fused_lnmm_wo`` on every layer
      :func:`wo_epilogue` admits;
    * ``fused_wo_q`` - ``CM3P_FUSED_WO_Q``: that epilogue in int8 (o quantised
      per row, int8 Wo per output channel); acts only with ``fused_wo``.
      ``w8a8_wo`` does not reach the epilogue, as in the JAX package;
    * ``xla_int8`` - ``CM3P_XLA_INT8``: W8A8 through
      :func:`~cm3p_torch.ops.xla_int8.int8_dot` (its own quantisers, an exact
      int32 product) on every bias-free product that runs unfused: QKV where
      ``fused_lnmm_qkv`` does not take it, the out-projection where neither
      the epilogue nor ``fused_lnmm_wo`` takes it, and the MLP's two products
      where the JAX package runs its MLP unfused (the ``xla`` route, widths
      ``ffn_fusable`` rejects).

    The port reads no environment variable: callers pass this object.
    """

    w8a8: bool = False
    w8a8_wo: bool = False
    fused_lnmm_qkv: bool = False
    fused_lnmm_wo: bool = False
    fused_wo: bool = False
    fused_wo_q: bool = False
    xla_int8: bool = False


EXACT = EncoderOptions()
ATTN_IMPLS = ("pallas", "xla")


def wo_epilogue(options: EncoderOptions, window: Optional[int], hidden: int, length: int) -> Optional[str]:
    """The form of the attention kernels' out-projection epilogue that a layer
    runs under ``options``: "int8", "bf16", or None (no epilogue).

    The JAX package applies the epilogue where its ``wo_fusable`` admits the
    layer (:func:`~cm3p_torch.ops.wo_fusable`), in int8 iff ``fused_wo_q``. It
    declines two kinds of layer. Those of another shape (a window wider than
    the single-pass kernel, widths not multiples of 128) get no epilogue here
    either. Global layers longer than 2048 tokens decline for the TPU's VMEM
    alone; the JAX route there is the LN-matmul (int8 iff ``w8a8_wo``) or the
    exact ``residual + o @ Wo`` in the activation dtype. Where it is exact,
    the bf16 epilogue gives the same numbers and runs here; where it is int8,
    the LN-matmul route runs as in the JAX package.
    """
    if not options.fused_wo or not wo_shape_ok(window, hidden, hidden, length, length):
        return None
    if wo_fusable(window, hidden, hidden, length, length):
        return "int8" if options.fused_wo_q else "bf16"
    return None if options.fused_lnmm_wo and options.w8a8_wo else "bf16"


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

    def forward(self, x, key_mask, segment_ids, window, rope_theta, plain: bool = False, positions=None,
                pre_norm: Optional[LayerNormF32] = None, residual: Optional[torch.Tensor] = None,
                options: EncoderOptions = EXACT, quantised=None, sp_group=None, model_group=None):
        """``pre_norm``: ``x`` is raw and the norm is fused into the QKV projection.
        ``residual``: the out-projection adds it (the caller must not add it
        again), by the route of the JAX package's order: the attention
        kernel's epilogue where :func:`wo_epilogue` gives a form, else the
        LN-matmul kernel under ``fused_lnmm_wo``, else ``residual + out @ Wo^T``.
        ``quantised(name, weight, quantiser)`` returns the cached int8 form of a weight.
        ``sp_group``: ``x`` is this rank's shard of the sequence and
        ``positions`` its absolute positions; attention all-gathers K/V (no
        epilogue). ``model_group``: ``Wqkv`` and ``Wo`` hold this rank's heads;
        the out-projection's partial sums over the group (no residual, no
        fused route)."""
        b, length, hidden = x.shape
        dt = x.dtype
        if pre_norm is not None:
            norm = dict(scale=pre_norm.weight, bias=pre_norm.bias, eps=pre_norm.eps)
            if options.w8a8:
                lnmm_q = fused_ln_matmul_q_plain if plain else fused_ln_matmul_q
                qkv = lnmm_q(x, self.Wqkv.weight, w_q=quantised("Wqkv", self.Wqkv.weight), **norm)
            else:
                lnmm = fused_ln_matmul_plain if plain else fused_ln_matmul
                qkv = lnmm(x, self.Wqkv.weight.to(dt), **norm)
        elif model_group is not None:
            qkv = column_parallel_linear(x, self.Wqkv.weight, model_group)
        elif options.xla_int8:
            qkv = int8_dot(x, self.Wqkv.weight, quantised("xla_Wqkv", self.Wqkv.weight, quant_weight_int8))
        else:
            qkv = linear(x, self.Wqkv.weight)
        heads = qkv.shape[-1] // (3 * self.head_dim)  # this rank's heads under a model group
        q, k, v = qkv.view(b, length, 3, heads, self.head_dim).unbind(dim=2)  # head-minor views, no copies
        form = wo_epilogue(options, window, hidden, length) if residual is not None and sp_group is None else None
        if sp_group is not None:
            q, k = apply_rope(q, rope_theta, positions), apply_rope(k, rope_theta, positions)
            out = sequence_sharded_attention(q, k, v, key_mask, sp_group, window, plain=plain)
        elif form is not None:
            return attention(
                q, k, v, key_mask, segment_ids, window, rope_theta, plain=plain, positions=positions,
                residual=residual, wo=self.Wo.weight.to(dt) if form == "bf16" else None,
                wo_q=quantised("Wo", self.Wo.weight) if form == "int8" else None,
            )
        else:
            out = attention(q, k, v, key_mask, segment_ids, window, rope_theta, plain=plain, positions=positions)
        out = out.reshape(b, length, -1)
        if model_group is not None:
            return row_parallel_linear(out, self.Wo.weight, model_group)
        if not (residual is not None and options.fused_lnmm_wo):
            if options.xla_int8:
                out = int8_dot(out, self.Wo.weight, quantised("xla_Wo", self.Wo.weight, quant_weight_int8))
            else:
                out = linear(out, self.Wo.weight)
            return out if residual is None else residual + out
        if options.w8a8_wo:
            lnmm_q = fused_ln_matmul_q_plain if plain else fused_ln_matmul_q
            return lnmm_q(out, self.Wo.weight, residual=residual, w_q=quantised("Wo", self.Wo.weight))
        lnmm = fused_ln_matmul_plain if plain else fused_ln_matmul
        return lnmm(out, self.Wo.weight.to(dt), residual=residual)


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
        self.options = EXACT
        self.attn_impl = "pallas"
        self.model_group = None
        self._quantised: dict = {}

    def quantised(self, name: str, weight: torch.Tensor, quantiser=quantize_weight_int8):
        """(int8 codes, fp32 scales) of ``weight`` by ``quantiser``, made once and again only
        when the parameter has changed (reloaded, cast or moved)."""
        key = (weight.data_ptr(), weight._version, weight.dtype, weight.device)
        hit = self._quantised.get(name)
        if hit is None or hit[0] != key:
            hit = (key, quantiser(weight.detach()))
            self._quantised[name] = hit
        return hit[1]

    def forward(self, x, key_mask=None, segment_ids=None, plain: bool = False, positions=None, sp_group=None):
        cfg = self.config
        hidden = cfg.hidden_size
        window = None if self.is_global else cfg.local_attention // 2
        theta = cfg.global_rope_theta if self.is_global else cfg.local_rope_theta
        norm, mlp = self.mlp_norm, self.mlp
        group = self.model_group
        if torch.is_grad_enabled() or group is not None:  # the training composition; without grad, the sharded one
            attn_in = x if self.attn_norm is None else self.attn_norm(x)
            x = x + self.attn(attn_in, key_mask, segment_ids, window, theta, plain=plain, positions=positions,
                              sp_group=sp_group, model_group=group)
            return LnFfnFunction.apply(x, norm.weight, norm.bias, mlp.Wi.weight, mlp.Wo.weight, cfg.norm_eps, group)
        opts = self.options
        fuse_qkv = opts.fused_lnmm_qkv and self.attn_norm is not None and lnmm_fusable(hidden, 3 * hidden)
        fuse_wo = (opts.fused_lnmm_wo or opts.fused_wo) and lnmm_fusable(hidden, hidden)
        attn_in = x if fuse_qkv or self.attn_norm is None else self.attn_norm(x)
        attn_out = self.attn(
            attn_in, key_mask, segment_ids, window, theta, plain=plain, positions=positions,
            pre_norm=self.attn_norm if fuse_qkv else None, residual=x if fuse_wo else None,
            options=opts, quantised=self.quantised, sp_group=sp_group,
        )
        x = attn_out if fuse_wo else x + attn_out
        quant_ok = ffn_fusable(hidden, cfg.intermediate_size)  # as the JAX package: else the exact MLP
        if opts.xla_int8 and (self.attn_impl == "xla" or not quant_ok):  # where the JAX package runs it unfused
            return x + self.geglu_int8(norm(x))
        ffn = fused_ln_ffn_plain if plain else fused_ln_ffn
        dt = x.dtype
        w8a8, w8a8_wo = opts.w8a8 and quant_ok, opts.w8a8_wo and quant_ok
        return ffn(
            x, norm.weight, norm.bias, mlp.Wi.weight.to(dt), mlp.Wo.weight.to(dt), cfg.norm_eps,
            w8a8=w8a8, w8a8_wo=w8a8_wo,
            wi_q=self.quantised("Wi", mlp.Wi.weight) if w8a8 else None,
            wo_q=self.quantised("mlp_Wo", mlp.Wo.weight) if w8a8_wo else None,
        )

    def geglu_int8(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's unfused ``GeGLU`` under ``xla_int8``: ``int8_dot`` to 2F, ``gelu(a) * b`` in the
        activation dtype, ``int8_dot`` back (the caller adds the residual)."""
        wi, wo, f = self.mlp.Wi.weight, self.mlp.Wo.weight, self.config.intermediate_size
        h = int8_dot(x, wi, self.quantised("xla_Wi", wi, quant_weight_int8))
        h = F.gelu(h[..., :f]) * h[..., f:]
        return int8_dot(h, wo, self.quantised("xla_mlp_Wo", wo, quant_weight_int8))


class Embeddings(nn.Module):
    def __init__(self, config: EncoderConfig, token_embeddings: bool):
        super().__init__()
        self.tok_embeddings = nn.Embedding(config.vocab_size, config.hidden_size) if token_embeddings else None
        self.norm = LayerNormF32(config.hidden_size, config.norm_eps, config.norm_bias)


REMAT_MODES = (False, True, "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat="dots"``: keep the weight products' outputs."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(layer: nn.Module, remat: Union[bool, str], *args, **kwargs):
    """``layer(*args, **kwargs)`` under ``torch.utils.checkpoint`` in ``remat``'s mode."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(layer, *args, use_reentrant=False, **extra, **kwargs)


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
        self.options = EXACT
        self.attn_impl = "pallas"
        self.remat: Union[bool, str] = False
        self.model_group = None

    def set_options(self, options: EncoderOptions) -> None:
        """Set the extraction options of every layer (int8 weights are remade at next use); on the ``xla``
        route they reduce to ``xla_int8``."""
        if self.attn_impl == "xla":
            options = EncoderOptions(xla_int8=options.xla_int8)
        _exact_under_model_group(options, self.model_group)
        self.options = options
        for layer in self.layers:
            layer.options = options
            layer._quantised.clear()

    def set_attn_impl(self, attn_impl: str) -> None:
        """``"pallas"`` (default): the kernels. ``"xla"``: the JAX package's route without its kernels, the
        plain version of every op, the options reduced to ``xla_int8`` and, with it, the unfused MLP."""
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, not {attn_impl!r}")
        self.attn_impl = attn_impl
        self.plain = attn_impl == "xla"
        for layer in self.layers:
            layer.attn_impl = attn_impl
        self.set_options(self.options)

    def set_model_group(self, group) -> None:
        """The model group the layers' products were sharded over (``parallel.tensor.shard_module``); None:
        whole layers."""
        group = None if group_size(group) == 1 else group
        _exact_under_model_group(self.options, group)
        self.model_group = group
        for layer in self.layers:
            layer.model_group = group

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
        sp_group=None,
    ) -> torch.Tensor:
        """Final-norm hidden states (B, L, H); with ``sp_group`` the sequence
        runs sharded over the group's ranks and each rank returns the whole."""
        if self.training and torch.is_grad_enabled():
            rates = {name: getattr(self.config, name) for name in DROPOUT_FIELDS if getattr(self.config, name)}
            if rates:
                raise NotImplementedError(f"dropout is not ported: training with {rates} would apply it; "
                                          "set these fields to 0 (inference applies no dropout and runs)")
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = self.embeddings.norm(inputs_embeds.to(self.compute_dtype or inputs_embeds.dtype))
        if sp_group is not None:
            if self.model_group is not None:
                raise ValueError("sequence parallelism and a model group together are not supported")
            return self._forward_sharded(x, attention_mask, segment_ids, position_ids, sp_group)
        remat = self.remat if torch.is_grad_enabled() else False
        for layer in self.layers:
            if remat:
                x = checkpointed(layer, remat, x, attention_mask, segment_ids, plain=self.plain, positions=position_ids)
            else:
                x = layer(x, attention_mask, segment_ids, plain=self.plain, positions=position_ids)
        return self.final_norm(x)

    def _forward_sharded(self, x, attention_mask, segment_ids, position_ids, group) -> torch.Tensor:
        if segment_ids is not None:
            raise ValueError("sequence parallelism does not support packed segment_ids")
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        length = x.shape[1]
        if length % n:
            raise ValueError(f"sequence length {length} does not divide over the {n} ranks of the group")
        rows = slice(rank * (length // n), (rank + 1) * (length // n))
        # arange positions stay on the host, where the dense route makes its rope tables
        # (ops.attention.rope_tables): the shard's tables are then those rows bit for bit, where tables made
        # on the card differ from the host's in the last bit on some entries
        positions = torch.arange(length) if position_ids is None else position_ids
        key_mask = None if attention_mask is None else attention_mask[:, rows]
        x = x[:, rows]
        for layer in self.layers:
            x = layer(x, key_mask, None, plain=self.plain, positions=positions[..., rows], sp_group=group)
        return all_gather_seq(self.final_norm(x), group)


def _exact_under_model_group(options: EncoderOptions, group) -> None:
    if group is not None and options != EXACT:
        raise ValueError(f"extraction options {options} under a model group: tensor parallelism runs the exact "
                         "composition only (the JAX package has no extraction option on a model axis)")


def pool_hidden(hidden: torch.Tensor, attention_mask: Optional[torch.Tensor], cls_embed: bool) -> torch.Tensor:
    """CLS-token or masked-mean pooling."""
    if cls_embed:
        return hidden[..., 0, :]
    if attention_mask is not None:
        mask = attention_mask[..., None].float()
        summed = (hidden.float() * mask).sum(dim=-2)
        return (summed / mask.sum(dim=-2).clamp_min(1e-9)).to(hidden.dtype)
    return hidden.mean(dim=-2)
