"""CM3P: audio encoder, beatmap and metadata towers, projections, losses.

Counterpart of the JAX package's ``models/cm3p.py``: ``MultiModalProjector``,
``AudioEncoder``, ``BeatmapTransformer``, the packed audio scatter of
``_packed_hidden``, ``_pool_packed``, ``l2_normalize``,
``_similarity_logits``, ``contrastive_loss``, ``cm3p_loss`` and
``CM3PModule`` (:class:`CM3PModel`: ``get_metadata_features`` with
``meta_pack``, ``forward_packed`` and the unpacked ``forward``, with the MLM
decoder head under ``has_decoder_head``), ``cross_entropy_ignore_index``,
``PredictionHead`` and the single-tower models ``BeatmapModelWithProjection``,
``MetadataModelWithProjection``, ``MaskedLMModule`` (:class:`MaskedLMModel`)
and ``ClassifierModule`` (:class:`ClassifierModel`).
:class:`CM3PBeatmapModel` is the beatmap tower with its projection alone, the
extraction model. Module paths follow the HF state-dict keys
(``beatmap_model.audio_encoder.conv1.weight``, ``beatmap_projection.weight``,
``metadata_model.encoder.layers.0.attn.Wqkv.weight``, ``logit_scale``,
``head.dense.weight``, ``head.norm.weight``, ``decoder.weight`` / ``.bias``,
``classifier.weight`` / ``.bias``). A tied MLM decoder's weight is the beatmap
token table; its bias is ``decoder.bias`` (``decoder_bias`` in the JAX tree).

The heads' products are ``nn.Linear`` layers (or the tied table's product)
through cuBLAS, as they are plain ``nn.Dense`` layers outside any kernel in the
JAX package; the towers under them run the kernels as everywhere else.
"""
from __future__ import annotations

import contextlib
import functools
import logging
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import AudioConfig, BeatmapConfig, CM3PConfig, MetadataConfig
from ..parallel.distributed import active as _dist_active
from ..parallel.distributed import all_gather_ints, all_reduce_sum, gather_rows
from ..parallel.tensor import column_parallel_linear, group_size, row_parallel_linear
from .modernbert import REMAT_MODES, EncoderOptions, LayerNormF32, ModernBertEncoder, linear, pool_hidden

logger = logging.getLogger(__name__)

# the projector's activations, as the JAX package's ``ACTIVATIONS``
ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_tanh": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


@contextlib.contextmanager
def fp32_convolutions(dtype: torch.dtype):
    """For an fp32 model, cuDNN's TF32 convolutions off for the calls inside (cuDNN runs fp32 convolutions in
    TF32 unless told otherwise), and back as they were after; other dtypes leave the setting alone."""
    if dtype != torch.float32:
        yield
        return
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the sqrt, as the JAX package: zero vectors stay finite
    nsq = x.float().square().sum(dim=-1, keepdim=True)
    return (x / torch.sqrt(nsq + eps * eps).to(x.dtype)).to(x.dtype)


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense`` in x's dtype: weight and bias cast at use."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class _CrossEntropyIgnoreIndex(torch.autograd.Function):
    """The loss in fp32 over logits of any dtype, holding no fp32 copy of them for the backward:
    it keeps the logits as given and each row's fp32 log-sum-exp, and remakes the softmax from them."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_index, count=None):
        flat = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1)
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        lse = torch.logsumexp(flat.float(), dim=-1)
        nll = torch.where(valid, lse - flat.gather(1, safe[:, None])[:, 0].float(), torch.zeros_like(lse))
        count = valid.sum().clamp_min(1) if count is None else count
        ctx.save_for_backward(logits, safe, valid, lse, count)
        return nll.sum() / count

    @staticmethod
    def backward(ctx, grad):
        logits, safe, valid, lse, count = ctx.saved_tensors
        flat = logits.reshape(-1, logits.shape[-1])
        g = torch.exp(flat.float() - lse[:, None])
        g.scatter_add_(1, safe[:, None], -torch.ones_like(lse)[:, None])
        g.mul_((valid.float() * (grad / count))[:, None])
        return g.to(logits.dtype).reshape(logits.shape), None, None, None


def data_group_of(module) -> Optional[object]:
    """The module's data-parallel process group (``TowerModel.dp_group``) when it spans more than one rank, else
    None: the losses then run over the global batch (every rank's rows, in rank order)."""
    group = getattr(module, "dp_group", None)
    if group is None or not _dist_active() or torch.distributed.get_world_size(group) == 1:
        return None
    return group


def cross_entropy_ignore_index(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
                               group=None) -> torch.Tensor:
    """Token-level cross entropy in fp32, the mean over labels that are not ``ignore_index``
    (divided by max(count, 1): all ignored gives 0). With a data ``group`` of more than one rank, the mean
    over every rank's labels: each rank's sum over the global count, summed over the ranks."""
    labels = labels.to(torch.int64)
    if group is None:
        return _CrossEntropyIgnoreIndex.apply(logits, labels, int(ignore_index))
    count = all_reduce_sum((labels != ignore_index).sum(), group).clamp_min(1)
    return all_reduce_sum(_CrossEntropyIgnoreIndex.apply(logits, labels, int(ignore_index), count), group)


class PredictionHead(nn.Module):
    """Dense(hidden) -> ``classifier_activation`` -> fp32 LayerNorm: the MLM and decoder head."""

    def __init__(self, config: BeatmapConfig):
        super().__init__()
        if config.classifier_activation not in ACTIVATIONS:
            raise ValueError(f"unknown classifier_activation {config.classifier_activation!r}; "
                             f"the port has {sorted(ACTIVATIONS)}")
        self.act = ACTIVATIONS[config.classifier_activation]
        self.dense = nn.Linear(config.hidden_size, config.hidden_size, bias=config.classifier_bias)
        self.norm = LayerNormF32(config.hidden_size, config.norm_eps, config.norm_bias)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.norm(self.act(dense(hidden, self.dense)))


def _pool_packed(hidden, segment_ids, window_rows, window_segments, cls_embed: bool):
    """Per-window pooling over packed rows: CLS gather or masked mean."""
    row_hidden = hidden[window_rows]  # (W, L, H)
    member = segment_ids[window_rows] == window_segments[:, None]  # (W, L)
    if cls_embed:
        first = member.to(torch.int32).argmax(dim=1)  # first token of each segment
        return row_hidden[torch.arange(row_hidden.shape[0], device=hidden.device), first]
    sel = member.to(hidden.dtype)
    summed = torch.einsum("wl,wlh->wh", sel, row_hidden)
    counts = sel.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return (summed / counts).to(hidden.dtype)


class MultiModalProjector(nn.Module):
    """Two-layer MLP projecting grouped audio frames to beatmap width.

    Under a model group (``model_group``) ``linear_1`` holds this rank's rows and ``linear_2`` the same
    columns: a column / row pair around the activation, the partial of ``linear_2`` summed over the group."""

    model_group = None

    def __init__(self, config: AudioConfig):
        super().__init__()
        if config.projector_hidden_act not in ACTIVATIONS:
            raise ValueError(f"unknown projector_hidden_act {config.projector_hidden_act!r}; "
                             f"the port has {sorted(ACTIVATIONS)}")
        self.act = ACTIVATIONS[config.projector_hidden_act]
        self.linear_1 = nn.Linear(config.projector_intermediate_size, config.projector_dim, bias=False)
        self.linear_2 = nn.Linear(config.projector_dim, config.projector_dim, bias=False)

    def forward(self, x):
        group = self.model_group
        if group is None:
            return linear(self.act(linear(x, self.linear_1.weight)), self.linear_2.weight)
        h = self.act(column_parallel_linear(x, self.linear_1.weight, group))
        return row_parallel_linear(h, self.linear_2.weight, group)


class AudioEncoder(nn.Module):
    """Whisper-style front end: 2 convs (2x downsample) -> encoder -> 4x frame
    grouping -> projector."""

    def __init__(self, config: AudioConfig):
        super().__init__()
        self.config = config
        self.conv1 = nn.Conv1d(config.n_mels, config.hidden_size, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(config.hidden_size, config.hidden_size, kernel_size=3, stride=2, padding=1)
        self.encoder = ModernBertEncoder(config, token_embeddings=False)
        self.multi_modal_projector = MultiModalProjector(config)

    def forward(self, input_features: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = self.encoder.compute_dtype or self.conv1.weight.dtype
        x = input_features.to(dt)  # (B, n_mels, frames)
        with fp32_convolutions(dt):
            x = F.gelu(F.conv1d(x, self.conv1.weight.to(dt), self.conv1.bias.to(dt), padding=1))
            x = F.gelu(F.conv1d(x, self.conv2.weight.to(dt), self.conv2.bias.to(dt), stride=2, padding=1))
        hidden = self.encoder(inputs_embeds=x.transpose(1, 2).contiguous())
        b, length, h = hidden.shape
        group = cfg.projector_intermediate_size // cfg.hidden_size  # 4x token reduction
        if length % group != 0:
            raise ValueError(
                f"audio frames after conv downsampling ({length}) must divide the projector group "
                f"size ({group}); use mel chunks divisible by {2 * group * 2}"
            )
        return self.multi_modal_projector(hidden.reshape(b, length // group, group * h))


class BeatmapTransformer(nn.Module):
    """Beatmap tower: token embeddings with the audio-embedding scatter."""

    def __init__(self, config: BeatmapConfig):
        super().__init__()
        self.config = config
        self.audio_encoder = AudioEncoder(config.audio_config)
        self.encoder = ModernBertEncoder(config)

    def forward(self, input_ids, input_features=None, attention_mask=None, segment_ids=None, position_ids=None,
                sp_group=None):
        """Final hidden states (B, L, H); ``sp_group`` runs the encoder
        sequence-parallel (the audio tower runs whole on every rank)."""
        if input_features is None:
            return self.encoder(
                input_ids=input_ids, attention_mask=attention_mask, segment_ids=segment_ids, position_ids=position_ids,
                sp_group=sp_group,
            )
        audio_embeds = self.audio_encoder(input_features)  # (B, tokens_per_window, H)
        # the k-th [AUDIO] placeholder of row i receives audio_embeds[i, k]
        mask = input_ids == self.config.audio_token_id
        idx = (mask.to(torch.int64).cumsum(dim=1) - 1).clamp(0, audio_embeds.shape[1] - 1)
        gathered = torch.gather(audio_embeds, 1, idx[:, :, None].expand(-1, -1, audio_embeds.shape[2]))
        embeds = self.encoder.embed(input_ids)
        embeds = torch.where(mask[:, :, None], gathered.to(embeds.dtype), embeds)
        return self.encoder(
            inputs_embeds=embeds, attention_mask=attention_mask, segment_ids=segment_ids, position_ids=position_ids,
            sp_group=sp_group,
        )


class TowerModel(nn.Module):
    """What every model of the family sets on all of its encoders (:meth:`encoders`), and its data group.

    ``dp_group`` (a ``torch.distributed`` process group, :meth:`set_data_group`) makes the losses those of the
    global batch, the rank-ordered concatenation of every rank's batch, as the JAX package's loss under a data
    mesh: contrastive negatives from every rank, means over global counts. None (the default) or a group of
    one rank is the one-process loss.

    ``model_group`` (:meth:`set_model_group`, which ``parallel.tensor.shard_module`` calls) is the group the
    towers' layers and the audio projector were sharded over (tensor parallelism); every other part of the
    model runs whole on every rank of it, and the losses stay those of the data group.
    """

    dp_group = None
    model_group = None

    def set_data_group(self, group) -> None:
        self.dp_group = group

    def set_model_group(self, group) -> None:
        """The model group of every tower and of the audio projector (None: whole layers)."""
        group = None if group_size(group) == 1 else group
        if group is not None:
            logger.info("under a model group of %d ranks the no-grad MLP runs the sharded composition in place of "
                        "the fused FFN kernel (whose epilogue adds the residual), and no Wo epilogue, LN-matmul or "
                        "W8A8 route runs", group_size(group))
        self.model_group = group
        for enc in self.encoders():
            enc.set_model_group(group)
        for module in self.modules():
            if isinstance(module, MultiModalProjector):
                module.model_group = group

    def encoders(self) -> list[ModernBertEncoder]:
        raise NotImplementedError

    def set_plain(self, plain: bool) -> None:
        """Route every attention and FFN call to its plain version (the oracle)."""
        for enc in self.encoders():
            enc.plain = plain

    def set_options(self, options: EncoderOptions) -> None:
        """Extraction options (W8A8, fused LN-matmul routes) of every tower."""
        for enc in self.encoders():
            enc.set_options(options)

    def set_attn_impl(self, attn_impl: str) -> None:
        """The route of every tower: ``"pallas"`` (the kernels) or ``"xla"`` (the JAX package's
        ``attn_impl="xla"``: no kernel, the plain version of every op, options reduced to ``xla_int8``,
        logged where that drops any)."""
        before = {enc.options for enc in self.encoders()}
        for enc in self.encoders():
            enc.set_attn_impl(attn_impl)
        after = {enc.options for enc in self.encoders()}
        if before != after:
            logger.info("attn_impl=%s: no kernel and no fused route runs; the options %s reduce to %s",
                        attn_impl, sorted(map(str, before)), sorted(map(str, after)))

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        """Activation dtype of every tower (flax ``dtype``); parameters keep theirs."""
        for enc in self.encoders():
            enc.compute_dtype = dtype

    def set_remat(self, remat: Union[bool, str]) -> None:
        """Per-layer rematerialisation under grad (``False``, ``True`` or ``"dots"``) of every tower."""
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, not {remat!r}")
        for enc in self.encoders():
            enc.remat = remat


class CM3PBeatmapModel(TowerModel):
    """The beatmap tower of CM3P with its projection: beatmap embeddings.

    ``beatmap_model`` and ``beatmap_projection`` carry the same names as in the
    full dual-tower model, so its state dict is a subset of the HF one.

    ``sp_group`` (a ``torch.distributed`` process group, the JAX package's
    ``sp_mesh``) runs the beatmap tower sequence-parallel over its ranks: each
    rank passes the full inputs and returns the same features. Forward only.
    """

    def __init__(self, config: CM3PConfig, sp_group=None):
        super().__init__()
        self.config = config
        self.sp_group = sp_group
        bc = config.beatmap_config
        self.beatmap_model = BeatmapTransformer(bc)
        self.beatmap_projection = nn.Linear(bc.hidden_size, config.projection_dim, bias=False)

    def encoders(self) -> list[ModernBertEncoder]:
        bm = self.beatmap_model
        return [bm.encoder, bm.audio_encoder.encoder]

    def get_beatmap_features(self, input_ids, input_features=None, attention_mask=None, normalize: bool = False):
        hidden = self.beatmap_model(
            input_ids, input_features=input_features, attention_mask=attention_mask, sp_group=self.sp_group
        )
        pooled = pool_hidden(hidden, attention_mask, self.config.beatmap_config.cls_embed)
        feats = linear(pooled, self.beatmap_projection.weight)
        return l2_normalize(feats) if normalize else feats

    def packed_hidden(self, input_ids, segment_ids, window_rows, window_segments, input_features=None,
                      window_valid=None):
        """Encode packed rows, scattering per-window audio when present.

        Every window carries the same audio-token count ``n_tok``, so window
        w's j-th audio embedding lands at its row's (segment - 1) * n_tok + j
        audio placeholder. ``window_valid`` (default: segment > 0) marks the
        windows whose audio is scattered.
        """
        bm = self.beatmap_model
        key_mask = (segment_ids > 0).to(torch.int32)
        if input_features is None:
            return bm.encoder(input_ids=input_ids, attention_mask=key_mask, segment_ids=segment_ids,
                              sp_group=self.sp_group)
        audio_embeds = bm.audio_encoder(input_features)
        w, n_tok, h = audio_embeds.shape
        rows, max_slots = input_ids.shape
        valid = window_valid > 0 if window_valid is not None else window_segments > 0
        slot = (window_segments - 1)[:, None] * n_tok + torch.arange(n_tok, device=input_ids.device)[None, :]
        slot = torch.where(valid[:, None], slot.clamp(0, max_slots - 1), torch.full_like(slot, max_slots - 1))
        flat_rows = window_rows.to(torch.int64).repeat_interleave(n_tok)
        values = torch.where(valid[:, None, None], audio_embeds, torch.zeros_like(audio_embeds)).reshape(-1, h)
        row_audio = torch.zeros(rows, max_slots, h, dtype=audio_embeds.dtype, device=audio_embeds.device)
        row_audio[flat_rows, slot.reshape(-1).to(torch.int64)] = values
        mask = input_ids == self.config.beatmap_config.audio_token_id
        idx = (mask.to(torch.int64).cumsum(dim=1) - 1).clamp(0, max_slots - 1)
        gathered = torch.gather(row_audio, 1, idx[:, :, None].expand(-1, -1, h))
        embeds = bm.encoder.embed(input_ids)
        embeds = torch.where(mask[:, :, None], gathered.to(embeds.dtype), embeds)
        return bm.encoder(inputs_embeds=embeds, attention_mask=key_mask, segment_ids=segment_ids,
                          sp_group=self.sp_group)

    def get_packed_beatmap_features(
        self, input_ids, segment_ids, window_rows, window_segments, input_features=None, normalize: bool = False
    ):
        """One embedding per window packed into rows (``processing/packing.py``)."""
        hidden = self.packed_hidden(input_ids, segment_ids, window_rows, window_segments, input_features)
        pooled = _pool_packed(hidden, segment_ids, window_rows, window_segments, self.config.beatmap_config.cls_embed)
        feats = linear(pooled, self.beatmap_projection.weight)
        return l2_normalize(feats) if normalize else feats


# --------------------------------------------------------------------- losses


def similarity_logits(metadata_embeds: torch.Tensor, beatmap_embeds: torch.Tensor, logit_scale: torch.Tensor):
    """Scaled cosine-similarity logits ``(..., b)`` in fp32 (``_similarity_logits``).

    The products of the activation-dtype embeddings accumulate in fp32; the
    scale exp(logit_scale) is rounded to the activation dtype first, as in
    the JAX package.
    """
    scale = logit_scale.exp().to(metadata_embeds.dtype).float()
    return torch.einsum("...p,bp->...b", metadata_embeds.float(), beatmap_embeds.float()) * scale


def contrastive_loss(logits, target=None, row_valid=None, col_valid=None):
    """Cross entropy against the diagonal (or explicit targets).

    ``row_valid``/``col_valid`` mask padded rows out of the mean and padded
    columns out of the softmax (packed batches with a padded window table).
    """
    if target is None:
        target = torch.arange(logits.shape[0], device=logits.device)
    logits = logits.float()
    if col_valid is not None:
        logits = torch.where(col_valid[None, :] > 0, logits, torch.full_like(logits, -1e30))
    picked = -torch.log_softmax(logits, dim=-1).gather(-1, target[:, None])[:, 0]
    if row_valid is not None:
        picked = picked * row_valid
        return picked.sum() / row_valid.sum().clamp_min(1.0)
    return picked.mean()


def cm3p_loss(similarity, metadata_variation_classes=None, valid=None):
    """Symmetric CLIP loss; the 3-D form (metadata, variations, beatmaps) ranks
    the original metadata (class 0) against its variations per beatmap.
    ``valid`` (B,) masks padded window slots (rows skipped, columns -inf)."""
    if similarity.dim() == 3:
        m, v, b = similarity.shape
        if metadata_variation_classes is None:
            true_idx = torch.zeros(m, dtype=torch.int64, device=similarity.device)
        else:
            true_idx = (metadata_variation_classes == 0).to(torch.int32).argmax(dim=1)
        metadata_loss = contrastive_loss(
            similarity[torch.arange(m, device=similarity.device), true_idx], row_valid=valid, col_valid=valid
        )
        beatmap_similarity = similarity.permute(2, 0, 1).reshape(b, m * v)
        target = torch.arange(0, m * v, v, device=similarity.device) + true_idx
        col_valid = valid.repeat_interleave(v) if valid is not None else None
        beatmap_loss = contrastive_loss(beatmap_similarity, target=target, row_valid=valid, col_valid=col_valid)
    else:
        metadata_loss = contrastive_loss(similarity, row_valid=valid, col_valid=valid)
        beatmap_loss = contrastive_loss(similarity.t(), row_valid=valid, col_valid=valid)
    return (metadata_loss + beatmap_loss) / 2.0


# --------------------------------------------------------------------- full model


class CM3POutput(NamedTuple):
    loss: Optional[torch.Tensor] = None
    logits_per_beatmap: Optional[torch.Tensor] = None
    logits_per_metadata: Optional[torch.Tensor] = None
    metadata_embeds: Optional[torch.Tensor] = None
    beatmap_embeds: Optional[torch.Tensor] = None
    logits: Optional[torch.Tensor] = None


class MetadataTransformer(nn.Module):
    """Holder of the metadata encoder (HF keys ``metadata_model.encoder.*``)."""

    def __init__(self, config: MetadataConfig):
        super().__init__()
        self.encoder = ModernBertEncoder(config)


class CM3PModel(CM3PBeatmapModel):
    """Dual-tower contrastive model: the counterpart of ``CM3PModule``.

    ``meta_pack`` packs that many metadata sequences per encoder row (0/1 =
    off) with block-diagonal segments and restarting positions: the same
    attention, in fewer, longer rows. With ``has_decoder_head`` the beatmap
    tower's hidden states also go through ``head`` and an untied ``decoder``
    to vocabulary logits (``forward`` and ``forward_packed`` only: the feature
    methods never call it); with ``labels`` the loss adds 0.5 x their cross
    entropy (ignore index -100).
    """

    def __init__(self, config: CM3PConfig, meta_pack: int = 0, sp_group=None):
        super().__init__(config, sp_group)
        mc, bc = config.metadata_config, config.beatmap_config
        self.meta_pack = int(meta_pack)
        self.metadata_model = MetadataTransformer(mc)
        self.metadata_projection = nn.Linear(mc.hidden_size, config.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(config.logit_scale_init_value, dtype=torch.float32))
        if config.has_decoder_head:
            self.head = PredictionHead(bc)
            self.decoder = nn.Linear(bc.hidden_size, bc.vocab_size, bias=bc.decoder_bias)

    def encoders(self) -> list[ModernBertEncoder]:
        return super().encoders() + [self.metadata_model.encoder]

    def set_remat(self, remat: Union[bool, str]) -> None:
        """The beatmap and audio towers take ``remat``; the metadata tower, small layers over many rows,
        takes full remat whenever any is on (as in the JAX package)."""
        super().set_remat(remat)
        self.metadata_model.encoder.remat = bool(remat)

    def get_metadata_features(self, metadata_ids, metadata_attention_mask=None, normalize: bool = False):
        is_3d = metadata_ids.dim() == 3
        length = metadata_ids.shape[-1]
        ids = metadata_ids.reshape(-1, length)
        mask = None if metadata_attention_mask is None else metadata_attention_mask.reshape(-1, length)
        n = ids.shape[0]
        g = min(self.meta_pack, n)
        encoder = self.metadata_model.encoder
        if g > 1 and n > 1:
            n_pad = -(-n // g) * g
            ids_p, mask_p = ids, mask
            if n_pad != n:
                # pad rows carry id 0 and mask 1: an all-masked row has no key
                ids_p = torch.cat([ids, ids.new_zeros(n_pad - n, length)])
                if mask is not None:
                    mask_p = torch.cat([mask, mask.new_ones(n_pad - n, length)])
            rows = n_pad // g
            dev = ids.device
            seg = torch.arange(1, g + 1, dtype=torch.int32, device=dev).repeat_interleave(length)
            hidden = encoder(
                input_ids=ids_p.reshape(rows, g * length),
                attention_mask=None if mask_p is None else mask_p.reshape(rows, g * length),
                position_ids=torch.arange(length, device=dev).repeat(g),
                segment_ids=seg[None, :].expand(rows, g * length),
            )
            hidden = hidden.reshape(n_pad, length, hidden.shape[-1])[:n]
        else:
            hidden = encoder(input_ids=ids, attention_mask=mask)
        pooled = pool_hidden(hidden, mask, self.config.metadata_config.cls_embed)
        feats = linear(pooled, self.metadata_projection.weight)
        if is_3d:
            feats = feats.reshape(*metadata_ids.shape[:2], -1)
        return l2_normalize(feats) if normalize else feats

    def _contrast(self, beatmap_embeds, metadata_ids, metadata_attention_mask, classes, valid, return_loss):
        loss = beatmap_embeds.new_zeros((), dtype=torch.float32) if return_loss else None
        if metadata_ids is None:
            return CM3POutput(loss=loss, beatmap_embeds=beatmap_embeds)
        metadata_embeds = self.get_metadata_features(metadata_ids, metadata_attention_mask, normalize=True)
        local = (metadata_embeds, beatmap_embeds)
        group = data_group_of(self)
        if group is not None:  # the global batch: every rank's embeddings, window table and classes
            metadata_embeds, beatmap_embeds = gather_rows(metadata_embeds, group), gather_rows(beatmap_embeds, group)
            classes = None if classes is None else gather_rows(classes, group)
            valid = None if valid is None else gather_rows(valid, group)
        logits_per_metadata = similarity_logits(metadata_embeds, beatmap_embeds, self.logit_scale)
        logits_per_beatmap = (
            logits_per_metadata.permute(2, 0, 1) if logits_per_metadata.dim() == 3 else logits_per_metadata.t()
        )
        if return_loss:
            loss = cm3p_loss(logits_per_metadata, classes, valid=valid)
        return CM3POutput(loss, logits_per_beatmap, logits_per_metadata, *local)

    def _decode(self, out: CM3POutput, hidden, labels, return_loss) -> CM3POutput:
        """The decoder head's logits, and 0.5 x their cross entropy added to the loss."""
        if not self.config.has_decoder_head:
            return out
        logits = dense(self.head(hidden), self.decoder)
        loss = out.loss
        if labels is not None and return_loss:
            loss = loss + 0.5 * cross_entropy_ignore_index(logits, labels, group=data_group_of(self))
        return out._replace(loss=loss, logits=logits)

    def forward_packed(
        self,
        input_ids,
        segment_ids,
        window_rows,
        window_segments,
        window_valid,
        input_features=None,
        metadata_ids=None,
        metadata_attention_mask=None,
        metadata_variation_classes=None,
        labels=None,
        return_loss: bool = True,
    ) -> CM3POutput:
        """Contrastive step over windows packed into rows (``packed_batches``).

        Windows are padded to a fixed count; ``window_valid`` marks the real
        ones, and dummy slots are excluded from the loss. ``labels`` (rows, L)
        are the decoder head's, per packed position.
        """
        window_rows = window_rows.to(torch.int64)
        window_segments = window_segments.to(torch.int64)
        hidden = self.packed_hidden(
            input_ids, segment_ids, window_rows, window_segments, input_features, window_valid=window_valid
        )
        pooled = _pool_packed(hidden, segment_ids, window_rows, window_segments, self.config.beatmap_config.cls_embed)
        beatmap_embeds = l2_normalize(linear(pooled, self.beatmap_projection.weight))
        out = self._contrast(
            beatmap_embeds, metadata_ids, metadata_attention_mask, metadata_variation_classes,
            window_valid.to(torch.float32), return_loss,
        )
        return self._decode(out, hidden, labels, return_loss)

    def forward(
        self,
        input_ids,
        input_features=None,
        metadata_ids=None,
        attention_mask=None,
        metadata_attention_mask=None,
        metadata_variation_classes=None,
        labels=None,
        return_loss: bool = True,
    ) -> CM3POutput:
        """The unpacked contrastive forward (``CM3PModule.__call__``)."""
        hidden = self.beatmap_model(
            input_ids, input_features=input_features, attention_mask=attention_mask, sp_group=self.sp_group
        )
        pooled = pool_hidden(hidden, attention_mask, self.config.beatmap_config.cls_embed)
        beatmap_embeds = l2_normalize(linear(pooled, self.beatmap_projection.weight))
        out = self._contrast(
            beatmap_embeds, metadata_ids, metadata_attention_mask, metadata_variation_classes, None, return_loss
        )
        return self._decode(out, hidden, labels, return_loss)


# --------------------------------------------------------------------- single-tower models


class BeatmapModelWithProjection(CM3PBeatmapModel):
    """``BeatmapModelWithProjection``: the beatmap tower and its projection, built from a flat
    ``BeatmapConfig`` (its own ``projection_dim``); calling it gives the beatmap features."""

    def __init__(self, config: BeatmapConfig):
        super().__init__(CM3PConfig(beatmap_config=config, projection_dim=config.projection_dim,
                                    initializer_factor=config.initializer_factor))

    def forward(self, input_ids, input_features=None, attention_mask=None, normalize: bool = False):
        return self.get_beatmap_features(input_ids, input_features, attention_mask, normalize=normalize)


class MetadataModelWithProjection(TowerModel):
    """``MetadataModelWithProjection``: the metadata tower and its projection from a ``MetadataConfig``."""

    def __init__(self, config: MetadataConfig):
        super().__init__()
        self.config = config
        self.metadata_model = MetadataTransformer(config)
        self.metadata_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def encoders(self) -> list[ModernBertEncoder]:
        return [self.metadata_model.encoder]

    def forward(self, input_ids, attention_mask=None, normalize: bool = False):
        hidden = self.metadata_model.encoder(input_ids=input_ids, attention_mask=attention_mask)
        pooled = pool_hidden(hidden, attention_mask, self.config.cls_embed)
        feats = linear(pooled, self.metadata_projection.weight)
        return l2_normalize(feats) if normalize else feats


class _BeatmapTowerModel(TowerModel):
    """A flat ``BeatmapConfig`` model: the beatmap tower (``beatmap_model``) under a head."""

    def __init__(self, config: BeatmapConfig):
        super().__init__()
        self.config = config
        self.beatmap_model = BeatmapTransformer(config)

    def encoders(self) -> list[ModernBertEncoder]:
        bm = self.beatmap_model
        return [bm.encoder, bm.audio_encoder.encoder]


class MaskedLMOutput(NamedTuple):
    loss: Optional[torch.Tensor] = None
    logits: Optional[torch.Tensor] = None


class TiedDecoder(nn.Module):
    """The tied decoder's own parameter, its bias (``decoder.bias``; ``decoder_bias`` in the JAX
    tree): the weight is the beatmap token table."""

    def __init__(self, vocab_size: int, bias: bool):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(vocab_size)) if bias else None


class MaskedLMModel(_BeatmapTowerModel):
    """``MaskedLMModule``: beatmap tower -> :class:`PredictionHead` -> vocabulary decoder.

    Untied (the default): ``decoder`` is an ``nn.Linear``. Tied
    (``tie_word_embeddings``): the logits are ``h @ table.T`` with the beatmap
    token table (whose gradient then takes both uses) plus :class:`TiedDecoder`'s
    bias. With ``sparse_prediction`` and ``labels`` only a static budget of
    ``max(1, int(N * 0.3))`` of the N positions is decoded: the masked ones in
    index order, then unmasked ones in index order up to the budget (the order of
    ``jax.lax.top_k`` over the mask flags; a stable descending sort here), those
    labelled ``sparse_pred_ignore_index``. Both losses ignore that index.
    """

    def __init__(self, config: BeatmapConfig):
        super().__init__(config)
        self.head = PredictionHead(config)
        if config.tie_word_embeddings:
            self.decoder = TiedDecoder(config.vocab_size, config.decoder_bias)
        else:
            self.decoder = nn.Linear(config.hidden_size, config.vocab_size, bias=config.decoder_bias)

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        if not self.config.tie_word_embeddings:
            return dense(h, self.decoder)
        table = self.beatmap_model.encoder.embeddings.tok_embeddings.weight
        logits = h @ table.t().to(h.dtype)
        bias = self.decoder.bias
        return logits if bias is None else logits + bias.to(h.dtype)

    def forward(self, input_ids, input_features=None, attention_mask=None, labels=None) -> MaskedLMOutput:
        hidden = self.beatmap_model(input_ids, input_features=input_features, attention_mask=attention_mask)
        ignore = self.config.sparse_pred_ignore_index
        group = data_group_of(self)
        if self.config.sparse_prediction and labels is not None:
            flat_h = hidden.reshape(-1, hidden.shape[-1])
            flat_labels = labels.reshape(-1)
            is_masked = flat_labels != ignore
            order = torch.sort(is_masked.to(torch.int32), descending=True, stable=True).indices
            if group is None:
                idx = order[: max(1, int(flat_labels.shape[0] * 0.3))]
            else:
                idx = order[_global_budget_rows(int(is_masked.sum()), flat_labels.shape[0], group).to(order.device)]
            sel_labels = torch.where(is_masked[idx], flat_labels[idx], torch.full_like(flat_labels[idx], ignore))
            logits = self.decode(self.head(flat_h[idx]))
            return MaskedLMOutput(cross_entropy_ignore_index(logits, sel_labels, ignore, group), logits)
        logits = self.decode(self.head(hidden))
        loss = None if labels is None else cross_entropy_ignore_index(logits, labels, ignore, group)
        return MaskedLMOutput(loss, logits)


def _global_budget_rows(masked: int, n: int, group) -> torch.Tensor:
    """The positions of this rank's stably sorted mask flags (its masked positions in index order, then its
    unmasked ones) that the global sparse-prediction budget takes: ``max(1, int(0.3 x global N))`` positions of
    the global batch, its masked ones in global index order first, then unmasked ones in global index order
    (``jax.lax.top_k`` over the global flags). Learns every rank's masked and total counts in one gather."""
    ms, ns = zip(*all_gather_ints((masked, n), group))
    rank = torch.distributed.get_rank(group)
    budget = max(1, int(sum(ns) * 0.3))
    take_masked = min(max(budget - sum(ms[:rank]), 0), masked)
    spare = max(budget - sum(ms), 0)  # what the global budget leaves for unmasked positions
    unmasked_before = sum(ns[:rank]) - sum(ms[:rank])
    take_unmasked = min(max(spare - unmasked_before, 0), n - masked)
    return torch.cat([torch.arange(take_masked), torch.arange(masked, masked + take_unmasked)])


class ClassifierOutput(NamedTuple):
    loss: Optional[torch.Tensor] = None
    logits: Optional[torch.Tensor] = None


def classification_loss(logits, labels, num_labels: int, problem_type: Optional[str]) -> torch.Tensor:
    """``ClassifierModule``'s loss; ``problem_type`` None is inferred from ``num_labels`` and the labels' dtype."""
    if problem_type is None:
        if num_labels == 1:
            problem_type = "regression"
        elif not (labels.is_floating_point() or labels.is_complex() or labels.dtype == torch.bool):
            problem_type = "single_label_classification"
        else:
            problem_type = "multi_label_classification"
    if problem_type == "regression":
        return (logits.squeeze().float() - labels.squeeze()).square().mean()
    if problem_type == "single_label_classification":
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        return -logprobs.gather(-1, labels[:, None].to(torch.int64)).mean()
    logits32 = logits.float()
    return (logits32.clamp_min(0) - logits32 * labels + torch.log1p(torch.exp(-logits32.abs()))).mean()


class ClassifierModel(_BeatmapTowerModel):
    """``ClassifierModule``: the pooled beatmap tower -> ``nn.Linear(num_labels)``, with
    :func:`classification_loss` when ``labels`` are given."""

    def __init__(self, config: BeatmapConfig):
        super().__init__(config)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(self, input_ids, input_features=None, attention_mask=None, labels=None) -> ClassifierOutput:
        cfg = self.config
        hidden = self.beatmap_model(input_ids, input_features=input_features, attention_mask=attention_mask)
        logits = dense(pool_hidden(hidden, attention_mask, cfg.cls_embed), self.classifier)
        loss = None
        if labels is not None:
            group = data_group_of(self)
            if group is None:
                loss = classification_loss(logits, labels, cfg.num_labels, cfg.problem_type)
            else:  # the means of the global batch
                loss = classification_loss(gather_rows(logits, group), gather_rows(labels, group), cfg.num_labels,
                                           cfg.problem_type)
        return ClassifierOutput(loss, logits)
