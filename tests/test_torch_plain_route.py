"""The explicit plain route: models that no kernel takes, run on the card.

The kernels take bf16, head dim 64 and the towers' widths 256 / 512 / 768, and
raise on CUDA on anything else. A model outside them runs on the card only
where its entry point asks for the plain versions, as the JAX package runs
such models on XLA: ``python -m cm3p_torch.extract --tiny-model`` and the
training configs with ``attn_impl: xla`` (``configs/train/smoke.yaml``).

Imports torch only (no JAX), so it also runs on the card:
``python -m pytest tests/test_torch_plain_route.py --noconftest -q``.

* The entry points choose the plain route for those models and only for them.
* On the CPU every op runs its plain version and no kernel launches.
* On the card (``gpu``): ``tiny_cm3p_config()`` in fp32 and
  ``configs/model/tiny.yaml`` in bf16, whose head dims (16, 32) and widths
  (32-128) no kernel takes, raise without the plain route; with it they run
  a no-grad forward under the extraction options and one training step
  without a launch and match the same run on the CPU. Tolerances: fp32 1e-4
  abs on unit-norm embeddings and 1e-4 relative on the loss and gradient norm
  (the same fp32 arithmetic, summed in another order); bf16 cosine >= 0.999
  per embedding and 1e-2 relative on the loss and gradient norm (bf16
  products rounded in another order through the towers).
"""
import copy

import pytest
import torch

from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.extract import _random_model
from cm3p_torch.interop import init_weights
from cm3p_torch.models import CM3PModel
from cm3p_torch.models.modernbert import EncoderOptions
from cm3p_torch.ops import KERNELS, launch_counts, reset_launch_counts
from cm3p_torch.processing import CM3PProcessor
from cm3p_torch.train import TrainStep, to_device
from cm3p_torch.train.__main__ import (
    CONFIG_DIR,
    build_model,
    build_optimizer,
    build_processor,
    model_config,
    synthetic_batches,
)
from cm3p_torch.utils.config import load_config

BF16, FP32 = torch.bfloat16, torch.float32
_NONE = {name: 0 for name in KERNELS}
CPU = torch.device("cpu")


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny-model", "full-width"])
def test_extract_runs_plain_for_the_tiny_model_only(tiny, monkeypatch):
    import cm3p_torch.extract as extract

    built = {}

    def load_model(cfg, weights, **kw):  # the full-width model is not built here: only its route is read
        built["model"] = model = CM3PModel(tiny_cm3p_config())
        return model

    monkeypatch.setattr(extract, "load_model", load_model)
    monkeypatch.setattr(extract, "init_weights", lambda *a, **k: None)
    _random_model(CM3PProcessor(), tiny, CPU, FP32, None)
    encoders = built["model"].encoders()
    assert [enc.plain for enc in encoders] == [tiny] * len(encoders)


@pytest.mark.parametrize("attn_impl, plain", [("xla", True), ("pallas", False)])
def test_training_runs_plain_where_the_config_says_xla(attn_impl, plain):
    args = load_config(CONFIG_DIR, "smoke", [f"attn_impl={attn_impl}"])
    model = build_model(args, model_config(args, build_processor(args)), CPU, seed=0)
    encoders = model.encoders()
    assert [enc.plain for enc in encoders] == [plain] * len(encoders)


def _setup(which: str):
    """The smoke config's processor and synthetic batch, and the model config: ``tiny_cm3p_config()``
    (with the tokenizers' vocabularies and ids, as the trainer sets them) or ``configs/model/tiny.yaml``."""
    args = load_config(CONFIG_DIR, "smoke", [])
    cfg = model_config(args, build_processor(args))
    if which == "tiny_cm3p_config":
        tiny = tiny_cm3p_config()
        for src, dst in ((cfg.beatmap_config, tiny.beatmap_config), (cfg.metadata_config, tiny.metadata_config)):
            for key in ("vocab_size", "pad_token_id", "bos_token_id", "eos_token_id"):
                setattr(dst, key, getattr(src, key))
        for key in ("audio_sos_token_id", "audio_eos_token_id", "audio_token_id"):
            setattr(tiny.beatmap_config, key, getattr(cfg.beatmap_config, key))
        cfg = tiny
    batch = next(iter(synthetic_batches(args, cfg, test=False)()))
    return args, cfg, batch


# the extraction options a no-grad forward runs under: the tool's default, and every fused route
OPTIONS = {
    "D": EncoderOptions(w8a8=True, fused_wo=True),
    "C": EncoderOptions(w8a8=True, w8a8_wo=True, fused_lnmm_qkv=True, fused_lnmm_wo=True),
}


def _tiny_run(which: str, dtype: torch.dtype, device: torch.device, plain: bool) -> dict:
    """A seeded tiny model on ``device`` in ``dtype``: the no-grad forward under each of ``OPTIONS``, then
    one training step (exact options, Muon); returns the embeddings, losses, gradient norm and launches."""
    args, cfg, batch = _setup(which)
    model = CM3PModel(cfg, meta_pack=int(args.get("meta_pack", 0)))
    model.load_state_dict(init_weights(cfg, torch.Generator().manual_seed(0), with_metadata=True))
    model = copy.deepcopy(model).to(device)
    model.set_compute_dtype(dtype)
    model.set_plain(plain)
    inputs = to_device(batch, device, packed=False)
    out = {}
    reset_launch_counts()
    with torch.no_grad():
        model.eval()
        for name, options in OPTIONS.items():
            model.set_options(options)
            res = model(**inputs)
            out[f"embeds {name}"] = torch.cat([res.beatmap_embeds.float(), res.metadata_embeds.float().flatten(0, 1)])
            out[f"loss {name}"] = res.loss.float()
    model.set_options(EncoderOptions())
    step = TrainStep(model, build_optimizer(args, model), packed=False)
    res = step(inputs)
    out["loss step"], out["grad norm"] = res["loss"].float(), res["grad_norm"].float()
    if device.type == "cuda":
        torch.cuda.synchronize()
    out = {k: v.detach().cpu() for k, v in out.items()}
    out["launches"] = launch_counts()
    return out


TINY = [("tiny_cm3p_config", FP32), ("tiny.yaml", BF16)]


@pytest.mark.parametrize("which, dtype", TINY, ids=["tiny_cm3p_config-fp32", "tiny.yaml-bf16"])
def test_the_cpu_route_launches_nothing(which, dtype):
    out = _tiny_run(which, dtype, CPU, plain=False)
    assert out["launches"] == _NONE
    assert all(torch.isfinite(v).all() for k, v in out.items() if k != "launches")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("which, dtype", TINY, ids=["tiny_cm3p_config-fp32", "tiny.yaml-bf16"])
def test_tiny_configs_need_the_plain_route_on_the_card(cuda, which, dtype):
    """No kernel takes these configs: on the card their first kernel call raises, and nothing falls back."""
    with pytest.raises(ValueError):
        _tiny_run(which, dtype, cuda, plain=False)


@pytest.mark.gpu
@pytest.mark.parametrize("which, dtype", TINY, ids=["tiny_cm3p_config-fp32", "tiny.yaml-bf16"])
def test_tiny_configs_run_on_the_card(cuda, which, dtype):
    """The plain route the entry points choose for these configs, on the card against the CPU."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # full fp32 products
    try:
        got = _tiny_run(which, dtype, cuda, plain=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow_tf32
    want = _tiny_run(which, dtype, CPU, plain=True)
    assert got["launches"] == _NONE
    rel = 1e-4 if dtype == FP32 else 1e-2
    for key in want:
        if key == "launches":
            continue
        g, w = got[key], want[key]
        assert torch.isfinite(g).all(), key
        if key.startswith("embeds"):
            if dtype == FP32:
                assert (g - w).abs().max().item() <= 1e-4, key
            else:
                assert torch.nn.functional.cosine_similarity(g, w, dim=-1).min().item() >= 0.999, key
        else:
            assert abs(g.item() - w.item()) <= rel * abs(w.item()), key
