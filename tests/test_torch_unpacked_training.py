"""Unpacked training at the shapes of ``v6_mask`` / ``v7`` on the card: kernels against plain versions.

The masked-LM and classifier models (and ``v7``'s decoder head) train on
unpacked rows of ``max_length`` 2,000 tokens under an attention mask, with the
audio tower, where the contrastive ``v8_packed`` run trains packed rows of 4,096
without audio. These cases hold that route to its plain versions, bf16, seeded:

* the forward kernels with lse and the four backward kernels at B 2, L 2,000,
  H 12 (window 64 and segment), the second row's keys masked after 1,500, and
  at the audio tower's L 800 (H 8, no mask): outputs 2e-2 abs, lse 1e-3, dq /
  dk / dv 1e-2 of the largest entry, exactly 0 on masked rows;
* one micro-step of a :class:`MaskedLMModel` with the full widths (beatmap
  tower 768 / 12 heads, audio tower 512 / 8 heads) cut to 3 layers each (one
  global, two local), with and without audio: the kernel path against the
  all-plain path on the same weights and batch, loss within 1e-2, every
  gradient at cosine >= 0.99 or, below that, no further from the fp32 plain
  path than the plain bf16 path is, within 0.05 (the rule of ``chip_smoke.py``
  phase 6), and the kernels launched where the route says.

Imports torch only: ``python -m pytest tests/test_torch_unpacked_training.py
--noconftest -q`` on the card; every case is marked ``gpu`` and skips without
CUDA.
"""
import pytest
import torch

from cm3p_torch.configs import AudioConfig, BeatmapConfig
from cm3p_torch.interop import init_weights
from cm3p_torch.models import MaskedLMModel
from cm3p_torch.ops import KERNELS, launch_counts, reset_launch_counts
from cm3p_torch.ops.attention import (
    _attention_bwd_plain,
    attention_delta,
    segment_attention,
    segment_attention_dkv,
    segment_attention_dq,
    segment_attention_plain,
    window_attention,
    window_attention_dkv,
    window_attention_dq,
    window_attention_plain,
)

LENGTH = 2000
AUDIO_LENGTH = 800  # 1,600 mel frames after the stride-2 convolution
VOCAB, AUDIO_ID, SOS, EOS = 3968, 3966, 3964, 3965
N_AUDIO = 200  # audio tokens per 16 s window
LOSS_REL_TOL = 1e-2
GRAD_COS_MIN = 0.99
NOISY_COS_MARGIN = 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["beatmap", "audio"])
@pytest.mark.parametrize("window", [64, None], ids=["window", "segment"])
def test_attention_forward_and_backward_at_unpacked_shapes(cuda, shape, window):
    gen = torch.Generator(device=cuda).manual_seed(21)
    if shape == "beatmap":
        b, length, heads = 2, LENGTH, 12
        seg = torch.ones(b, length, dtype=torch.int32, device=cuda)
        seg[1, 1500:] = 0
    else:
        b, length, heads = 2, AUDIO_LENGTH, 8
        seg = torch.ones(b, length, dtype=torch.int32, device=cuda)
    q, k, v = torch.randn(b, length, 3, heads, 64, generator=gen, device=cuda).to(torch.bfloat16).unbind(2)
    dout = torch.randn(b, length, heads, 64, generator=gen, device=cuda).to(torch.bfloat16)
    if window is None:
        out, lse = segment_attention(q, k, v, seg, seg, return_lse=True)
        want_out, want_lse = segment_attention_plain(q, k, v, seg, seg, return_lse=True)
    else:
        out, lse = window_attention(q, k, v, seg, seg, window, return_lse=True)
        want_out, want_lse = window_attention_plain(q, k, v, seg, seg, window, return_lse=True)
    live = (seg > 0)[:, None, :].expand_as(lse)
    assert (out.float() - want_out.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse)[live].abs().max().item() <= 1e-3
    delta = attention_delta(want_out, dout)
    if window is None:
        dq = segment_attention_dq(q, k, v, dout, want_lse, delta, seg, seg)
        dk, dv = segment_attention_dkv(q, k, v, dout, want_lse, delta, seg, seg)
    else:
        dq = window_attention_dq(q, k, v, dout, want_lse, delta, seg, seg, window)
        dk, dv = window_attention_dkv(q, k, v, dout, want_lse, delta, seg, seg, window)
    want = _attention_bwd_plain(q, k, v, dout, want_lse, delta, seg, seg, window)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    dead = seg == 0
    if dead.any():
        assert dq[dead].abs().max().item() == 0.0
        assert dk[dead].abs().max().item() == 0.0 and dv[dead].abs().max().item() == 0.0


def _config() -> BeatmapConfig:
    audio = AudioConfig(num_hidden_layers=3)
    return BeatmapConfig(vocab_size=VOCAB, audio_token_id=AUDIO_ID, audio_sos_token_id=SOS, audio_eos_token_id=EOS,
                         num_hidden_layers=3, audio_config=audio)


def _batch(device, audio: bool) -> dict:
    gen = torch.Generator(device=device).manual_seed(22)
    ids = torch.randint(5, 3000, (2, LENGTH), generator=gen, device=device)
    mask = torch.ones(2, LENGTH, dtype=torch.int64, device=device)
    mask[1, 1500:] = 0
    batch = {"attention_mask": mask}
    if audio:
        ids[:, 0], ids[:, 1 : 1 + N_AUDIO], ids[:, 1 + N_AUDIO] = SOS, AUDIO_ID, EOS
        batch["input_features"] = torch.randn(2, 80, 2 * AUDIO_LENGTH, generator=gen, device=device)
    masked = (torch.rand(2, LENGTH, generator=gen, device=device) < 0.15) & (mask > 0)
    batch["input_ids"] = ids * mask
    batch["labels"] = torch.where(masked, ids, torch.full_like(ids, -100))
    return batch


def _grads(model, batch, plain=False, fp32=False):
    model.set_plain(plain)
    model.set_compute_dtype(torch.float32 if fp32 else torch.bfloat16)
    try:
        loss = model(**batch).loss
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    finally:
        model.set_plain(False)
        model.set_compute_dtype(torch.bfloat16)
    return float(loss.detach()), grads


def _cos(x, y):
    x, y = x.float(), y.float()
    return (x * y).sum().item() / max(x.norm().item() * y.norm().item(), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("audio", [True, False], ids=["audio", "no_audio"])
def test_masked_lm_micro_step_matches_the_plain_path(cuda, audio):
    cfg = _config()
    model = MaskedLMModel(cfg)
    model.load_state_dict(init_weights(cfg, torch.Generator(device=cuda).manual_seed(0), head="mlm"))
    model.to(cuda).train()
    batch = _batch(cuda, audio)
    reset_launch_counts()
    loss_k, grads_k = _grads(model, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    # one global and two local layers a tower, each once forward and once backward
    towers = 2 if audio else 1
    assert counts["segment_attention"] == towers and counts["window_attention"] == 2 * towers
    assert counts["segment_attention_dq_rope"] == towers and counts["window_attention_dkv_rope"] == 2 * towers
    assert counts["fused_ln_ffn"] == 0  # under autograd the FFN is LnFfnFunction's plain form
    assert set(counts) == set(KERNELS)
    reset_launch_counts()
    loss_p, grads_p = _grads(model, batch, plain=True)
    _, grads_f = _grads(model, batch, plain=True, fp32=True)
    assert not any(launch_counts().values())
    assert abs(loss_k - loss_p) <= LOSS_REL_TOL * abs(loss_p)
    names = [n for n, _ in model.named_parameters()]
    for name, gk, gp, gf in zip(names, grads_k, grads_p, grads_f):
        assert (gk is None) == (gp is None), name
        if gk is None:
            assert not audio and name.startswith("beatmap_model.audio_encoder."), name
            continue
        assert torch.isfinite(gk).all(), name
        cos = _cos(gk, gp)
        if cos < GRAD_COS_MIN:
            assert _cos(gk, gf) >= _cos(gp, gf) - NOISY_COS_MARGIN, (name, cos)
