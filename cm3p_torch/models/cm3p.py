"""CM3P beatmap side: audio encoder, beatmap tower, projection and pooling.

Counterpart of the beatmap half of the JAX package's ``models/cm3p.py``:
``MultiModalProjector``, ``AudioEncoder``, ``BeatmapTransformer``, the
packed audio scatter of ``_packed_hidden``, ``_pool_packed``,
``l2_normalize`` and ``get_beatmap_features`` /
``get_packed_beatmap_features``. Module paths follow the HF state-dict keys
(``beatmap_model.audio_encoder.conv1.weight``, ``beatmap_projection.weight``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import AudioConfig, BeatmapConfig, CM3PConfig
from .modernbert import ModernBertEncoder, pool_hidden


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the sqrt, as the JAX package: zero vectors stay finite
    nsq = x.float().square().sum(dim=-1, keepdim=True)
    return (x / torch.sqrt(nsq + eps * eps).to(x.dtype)).to(x.dtype)


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
    """Two-layer MLP projecting grouped audio frames to beatmap width."""

    def __init__(self, config: AudioConfig):
        super().__init__()
        self.linear_1 = nn.Linear(config.projector_intermediate_size, config.projector_dim, bias=False)
        self.linear_2 = nn.Linear(config.projector_dim, config.projector_dim, bias=False)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x)))


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
        x = input_features.to(self.conv1.weight.dtype)  # (B, n_mels, frames)
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
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

    def forward(self, input_ids, input_features=None, attention_mask=None, segment_ids=None):
        if input_features is None:
            return self.encoder(input_ids=input_ids, attention_mask=attention_mask, segment_ids=segment_ids)
        audio_embeds = self.audio_encoder(input_features)  # (B, tokens_per_window, H)
        # the k-th [AUDIO] placeholder of row i receives audio_embeds[i, k]
        mask = input_ids == self.config.audio_token_id
        idx = (mask.to(torch.int64).cumsum(dim=1) - 1).clamp(0, audio_embeds.shape[1] - 1)
        gathered = torch.gather(audio_embeds, 1, idx[:, :, None].expand(-1, -1, audio_embeds.shape[2]))
        embeds = self.encoder.embed(input_ids)
        embeds = torch.where(mask[:, :, None], gathered.to(embeds.dtype), embeds)
        return self.encoder(inputs_embeds=embeds, attention_mask=attention_mask, segment_ids=segment_ids)


class CM3PBeatmapModel(nn.Module):
    """The beatmap tower of CM3P with its projection: beatmap embeddings.

    ``beatmap_model`` and ``beatmap_projection`` carry the same names as in the
    full dual-tower model, so its state dict is a subset of the HF one.
    """

    def __init__(self, config: CM3PConfig):
        super().__init__()
        self.config = config
        bc = config.beatmap_config
        self.beatmap_model = BeatmapTransformer(bc)
        self.beatmap_projection = nn.Linear(bc.hidden_size, config.projection_dim, bias=False)

    def set_plain(self, plain: bool) -> None:
        """Route every attention and FFN call to its plain version (the oracle)."""
        self.beatmap_model.encoder.plain = plain
        self.beatmap_model.audio_encoder.encoder.plain = plain

    def get_beatmap_features(self, input_ids, input_features=None, attention_mask=None, normalize: bool = False):
        hidden = self.beatmap_model(input_ids, input_features=input_features, attention_mask=attention_mask)
        pooled = pool_hidden(hidden, attention_mask, self.config.beatmap_config.cls_embed)
        feats = self.beatmap_projection(pooled)
        return l2_normalize(feats) if normalize else feats

    def packed_hidden(self, input_ids, segment_ids, window_rows, window_segments, input_features=None):
        """Encode packed rows, scattering per-window audio when present.

        Every window carries the same audio-token count ``n_tok``, so window
        w's j-th audio embedding lands at its row's (segment - 1) * n_tok + j
        audio placeholder.
        """
        bm = self.beatmap_model
        key_mask = (segment_ids > 0).to(torch.int32)
        if input_features is None:
            return bm.encoder(input_ids=input_ids, attention_mask=key_mask, segment_ids=segment_ids)
        audio_embeds = bm.audio_encoder(input_features)
        w, n_tok, h = audio_embeds.shape
        rows, max_slots = input_ids.shape
        valid = window_segments > 0
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
        return bm.encoder(inputs_embeds=embeds, attention_mask=key_mask, segment_ids=segment_ids)

    def get_packed_beatmap_features(
        self, input_ids, segment_ids, window_rows, window_segments, input_features=None, normalize: bool = False
    ):
        """One embedding per window packed into rows (``processing/packing.py``)."""
        hidden = self.packed_hidden(input_ids, segment_ids, window_rows, window_segments, input_features)
        pooled = _pool_packed(hidden, segment_ids, window_rows, window_segments, self.config.beatmap_config.cls_embed)
        feats = self.beatmap_projection(pooled)
        return l2_normalize(feats) if normalize else feats
