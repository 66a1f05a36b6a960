"""The port's tensor-parallel layout (``cm3p_torch/parallel/mesh.py``, ``tensor.py``) on the CPU.

* The layout against the JAX rules: every parameter of ``tiny_cm3p_config()``'s
  ``CM3PModel`` (with the decoder head) is mapped from its HF key to its flax
  path in the JAX module's parameter tree; the port splits it iff the JAX
  ``partition_spec_for`` names ``"model"``, along the same axis (a flax kernel
  is the transposed torch weight), except the parameters the port keeps whole
  on purpose (the token embeddings, the towers' projections, the decoder and
  the convolutions).
* ``shard_state_dict`` / ``gather_state_dict``: exact round trips at n = 2 and
  4; rank r's q, k and v rows are those of heads [rH/n, (r + 1)H/n) and its
  gate and up rows are matched; the optimizer state's round trip.
* ``check_model_axis`` names the tower (``python -m cm3p_torch.train``'s
  refusal is in ``tests/test_torch_distributed.py``).
* Two gloo ranks: ``column_parallel_linear`` and ``row_parallel_linear``
  (``copy_to_model_group`` and ``reduce_from_model_group``) forward and
  backward, and ``LnFfnFunction``'s model-group form against the
  whole function (fp64 inputs: within 1e-12, the gradients of x and the
  LayerNorm, which the function's backward forms in fp32, within 1e-5
  relative).
"""
import re

import pytest
import torch

from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.models import CM3PModel
from cm3p_torch.parallel.mesh import (
    check_model_axis,
    gather_state_dict,
    gather_tensor,
    shard_state_dict,
    tp_split_for,
)
from cm3p_torch.parallel.tensor import shard_optimizer_state

from tests.test_torch_distributed import run_ranks

# parameters the JAX rules shard and the port keeps whole (ROADMAP, deliberate differences)
KEPT_WHOLE = (r"tok_embeddings\.weight$", r"_projection\.weight$", r"^decoder\.weight$", r"conv[12]\.weight$")


def hf_to_flax(key: str) -> tuple:
    """The flax path of the port's (HF) key: the inverse of ``interop/from_jax.py``'s naming."""
    key = re.sub(r"^metadata_model\.encoder\.", "metadata_model.", key)
    key = re.sub(r"layers\.(\d+)\.", r"layers_\1.", key)
    key = key.replace("embeddings.tok_embeddings.weight", "tok_embeddings.embedding")
    key = key.replace("embeddings.norm.", "embeddings_norm.")
    key = re.sub(r"(norm)\.(weight|bias)$", lambda m: f"{m.group(1)}.LayerNorm_0.{'scale' if m.group(2) == 'weight' else 'bias'}", key)
    if not key.endswith(("LayerNorm_0.scale", "LayerNorm_0.bias", "embedding")) and key != "logit_scale":
        key = re.sub(r"\.weight$", ".kernel", key)
    return tuple(key.split("."))


@pytest.fixture(scope="module")
def jax_tree():
    import jax
    import jax.numpy as jnp

    from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
    from cm3p_tpu.models import CM3PModule

    cfg = jax_tiny_config()
    cfg.has_decoder_head = True
    module = CM3PModule(cfg, dtype=jnp.float32, attn_impl="xla")
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32),
                            input_features=jnp.zeros((2, 80, 64), jnp.float32),
                            metadata_ids=jnp.zeros((2, 12), jnp.int32))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def test_the_layout_matches_the_jax_rules(jax_tree):
    from cm3p_tpu.parallel.mesh import partition_spec_for

    cfg = tiny_cm3p_config()
    cfg.has_decoder_head = True
    model = CM3PModel(cfg)
    seen, split_names = set(), []
    for name, p in model.named_parameters():
        path = hf_to_flax(name)
        assert path in jax_tree, (name, path)
        seen.add(path)
        leaf = jax_tree[path]
        spec = tuple(partition_spec_for(path, leaf))
        port = tp_split_for(name, p.shape)
        if "model" not in spec:
            assert port is None, name
            continue
        if any(re.search(rule, name) for rule in KEPT_WHOLE):
            assert port is None, name
            continue
        assert port is not None, name
        split_names.append(name)
        # flax kernel (in, out): the "model" axis 1 (out) is torch's rows (dim 0), axis 0 (in) its columns
        assert port[0] == {1: 0, 0: 1}[spec.index("model")], (name, spec, port)
    assert seen == set(jax_tree), set(jax_tree) - seen
    n_layers = sum(c.num_hidden_layers for c in (cfg.beatmap_config, cfg.beatmap_config.audio_config,
                                                 cfg.metadata_config))
    assert len(split_names) == 4 * n_layers + 2


@pytest.mark.parametrize("n", [2, 4])
def test_shard_and_gather_round_trip_exactly_by_heads_and_matched_halves(n):
    cfg = tiny_cm3p_config()
    whole = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i), dtype=torch.float64)
             for i, (k, v) in enumerate(CM3PModel(cfg).state_dict().items())}
    shards = [shard_state_dict(whole, n, r) for r in range(n)]
    back = gather_state_dict(shards)
    assert back.keys() == whole.keys()
    assert all(torch.equal(back[k], whole[k]) for k in whole)
    bc = cfg.beatmap_config
    heads, hd, f = bc.num_attention_heads, bc.head_dim, bc.intermediate_size
    wqkv, wi = "beatmap_model.encoder.layers.1.attn.Wqkv.weight", "beatmap_model.encoder.layers.1.mlp.Wi.weight"
    wo, mlp_wo = "beatmap_model.encoder.layers.1.attn.Wo.weight", "beatmap_model.encoder.layers.1.mlp.Wo.weight"
    for r, shard in enumerate(shards):
        per = heads // n
        qkv = whole[wqkv].view(3, heads, hd, -1)[:, r * per: (r + 1) * per].reshape(-1, bc.hidden_size)
        assert torch.equal(shard[wqkv], qkv)  # the q, k and v rows of heads [r H/n, (r + 1) H/n)
        assert torch.equal(shard[wo], whole[wo][:, r * per * hd: (r + 1) * per * hd])
        rows = slice(r * f // n, (r + 1) * f // n)
        assert torch.equal(shard[wi], torch.cat([whole[wi][:f][rows], whole[wi][f:][rows]]))  # gate, up
        assert torch.equal(shard[mlp_wo], whole[mlp_wo][:, rows])
        assert shard["beatmap_model.encoder.embeddings.tok_embeddings.weight"] is \
            whole["beatmap_model.encoder.embeddings.tok_embeddings.weight"]
    # the optimizer's per-parameter state follows the same layout
    state = {"state": {0: {"momentum": whole[wqkv]}, 1: {"mu": whole[wi], "nu": whole[wi] * 2}},
             "param_groups": [{"params": [0, 1], "names": [wqkv, wi]}]}
    parts = [shard_optimizer_state(state, n, r) for r in range(n)]
    assert torch.equal(parts[1]["state"][0]["momentum"], shards[1][wqkv])
    assert torch.equal(gather_tensor([p["state"][1]["nu"] for p in parts], tp_split_for(wi, (1, 1))), 2 * whole[wi])
    assert state["state"][0]["momentum"] is whole[wqkv]  # the whole state is left as it was


def test_check_model_axis_names_the_tower():
    cfg = tiny_cm3p_config()
    towers = {"beatmap": cfg.beatmap_config, "audio": cfg.beatmap_config.audio_config,
              "metadata": cfg.metadata_config}
    check_model_axis(2, towers)
    check_model_axis(4, towers)
    with pytest.raises(ValueError, match="the metadata tower's 4 heads"):
        check_model_axis(3, towers)
    with pytest.raises(ValueError, match="the audio tower's 32 projector_dim"):
        cfg.beatmap_config.audio_config.projector_dim = 32
        check_model_axis(64, {"audio": cfg.beatmap_config.audio_config})


# ---------------------------------------------------------------- the collectives on two ranks


def _collectives(rank, world):
    from cm3p_torch.ops.fused_ffn import LnFfnFunction
    from cm3p_torch.parallel.mesh import make_mesh
    from cm3p_torch.parallel.tensor import column_parallel_linear, row_parallel_linear

    group = make_mesh(model=world).model_group
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=gen, dtype=torch.float64)
    w_in = torch.randn(2 * world, 8, generator=gen, dtype=torch.float64)
    w_out = torch.randn(8, 2 * world, generator=gen, dtype=torch.float64)
    xs = x.clone().requires_grad_(True)
    # a column / row pair: y = (x W_in^T) W_out^T over the ranks' blocks of the inner dim
    cols = slice(2 * rank, 2 * rank + 2)
    y = row_parallel_linear(column_parallel_linear(xs, w_in[cols], group), w_out[:, cols], group)
    y.square().sum().backward()
    out = {"y": y.detach(), "dx": xs.grad}
    scale = 1 + 0.1 * torch.randn(8, generator=gen, dtype=torch.float64)
    bias = 0.1 * torch.randn(8, generator=gen, dtype=torch.float64)
    wi = 0.3 * torch.randn(4 * world, 8, generator=gen, dtype=torch.float64)
    wo = 0.3 * torch.randn(8, 2 * world, generator=gen, dtype=torch.float64)
    f = 2 * world
    rows = slice(2 * rank, 2 * rank + 2)
    params = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    wi_r = torch.cat([wi[:f][rows], wi[f:][rows]]).requires_grad_(True)
    wo_r = wo[:, rows].clone().requires_grad_(True)
    z = LnFfnFunction.apply(*params, wi_r, wo_r, 1e-5, group)
    (z * torch.linspace(-1, 1, z.numel(), dtype=torch.float64).view_as(z)).sum().backward()
    out.update(z=z.detach(), ffn_grads=[p.grad for p in params], dwi=wi_r.grad, dwo=wo_r.grad)
    return out


def test_the_model_group_collectives_and_the_sharded_ffn(tmp_path):
    from cm3p_torch.ops.fused_ffn import LnFfnFunction

    world = 2
    got = run_ranks(_collectives, world, tmp_path)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=gen, dtype=torch.float64)
    w_in = torch.randn(2 * world, 8, generator=gen, dtype=torch.float64)
    w_out = torch.randn(8, 2 * world, generator=gen, dtype=torch.float64)
    xs = x.clone().requires_grad_(True)
    y = xs @ w_in.t() @ w_out.t()
    y.square().sum().backward()
    scale = 1 + 0.1 * torch.randn(8, generator=gen, dtype=torch.float64)
    bias = 0.1 * torch.randn(8, generator=gen, dtype=torch.float64)
    wi = (0.3 * torch.randn(4 * world, 8, generator=gen, dtype=torch.float64)).requires_grad_(True)
    wo = (0.3 * torch.randn(8, 2 * world, generator=gen, dtype=torch.float64)).requires_grad_(True)
    params = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    z = LnFfnFunction.apply(*params, wi, wo, 1e-5)
    (z * torch.linspace(-1, 1, z.numel(), dtype=torch.float64).view_as(z)).sum().backward()
    f = 2 * world
    for r, res in enumerate(got):
        torch.testing.assert_close(res["y"], y.detach(), rtol=0, atol=1e-12)
        torch.testing.assert_close(res["dx"], xs.grad, rtol=0, atol=1e-12)
        torch.testing.assert_close(res["z"], z.detach(), rtol=0, atol=1e-12)
        for g, want in zip(res["ffn_grads"], [p.grad for p in params]):  # its LayerNorm backward runs in fp32
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)
        rows = slice(2 * r, 2 * r + 2)
        torch.testing.assert_close(res["dwi"], torch.cat([wi.grad[:f][rows], wi.grad[f:][rows]]), rtol=0, atol=1e-12)
        torch.testing.assert_close(res["dwo"], wo.grad[:, rows], rtol=0, atol=1e-12)
    for key in ("y", "dx", "z"):  # the row's replicated values are bit-equal
        assert torch.equal(got[0][key], got[1][key])
    assert all(torch.equal(a, b) for a, b in zip(got[0]["ffn_grads"], got[1]["ffn_grads"]))
