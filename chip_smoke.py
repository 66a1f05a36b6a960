#!/usr/bin/env python3
"""Drive the PyTorch port's beatmap-embedding path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is skipped):
  1. build   - nvcc builds every kernel of ``cm3p_torch/csrc`` (one process
               per source, all at once) into ``cm3p_torch/_build``.
  2. kernels - each kernel against its plain PyTorch version at the shapes
               the main path gives it (packed 4096-token beatmap rows with
               several segments and a padding tail, unpacked rows with a key
               mask, the audio tower's L = 1500), bf16, seeded inputs.
               Tolerance: 2e-2 abs on outputs of magnitude ~1, and exactly 0
               on queries that see no key.
  3. slice   - full-width ``CM3PConfig()`` (vocab and [AUDIO] id from the
               tokenizer) with seeded random weights in bf16: the processor on
               the bundled map and the 16 maps of ``resources/perf_corpus``
               with a seeded synthetic waveform, then ``embed_beatmap``
               (unpacked) and ``get_packed_beatmap_features`` over rows of
               4096 tokens with audio. Launch counts must be 10 / 18 / 28 per
               forward (segment / window / FFN); embeddings finite, unit norm,
               and at cosine >= 0.999 per window with the all-plain path.
  4. times   - kernel, plain-version and library (SDPA) milliseconds with CUDA
               events at the packed beatmap shape, bounds from this run's
               inputs, windows/s and tokens/s of the packed path.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Needs one GPU and no network.
"""
from __future__ import annotations

import glob
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-2
COS_MIN = 0.999
ROW_LEN = 4096
WINDOW_KW = dict(window_length_sec=16.0, window_stride_sec=16.0, max_length=ROW_LEN)
PER_FORWARD = {"segment_attention": 8 + 2, "window_attention": 14 + 4, "fused_ln_ffn": 22 + 6}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense
KERNEL_SOURCES = {
    "window_attention": ("cm3p_torch/csrc/attention.cu", "cm3p_tpu/ops/flash_attention.py:294"),
    "segment_attention": ("cm3p_torch/csrc/attention.cu", "cm3p_tpu/ops/flash_attention.py:513"),
    "fused_ln_ffn": ("cm3p_torch/csrc/fused_ffn.cu", "cm3p_tpu/ops/fused_ffn.py:133"),
}


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(seg, window):
    """Number of (query, key) pairs the masks let through, for this run's segments."""
    import torch

    if window is None:
        total = 0
        for row in seg:
            counts = torch.bincount(row[row > 0])
            total += int((counts.to(torch.int64) ** 2).sum())
        return total
    total = 0
    length = seg.shape[1]
    for d in range(-window, window + 1):
        a = seg[:, max(0, -d): length - max(0, d)]
        b = seg[:, max(0, d): length - max(0, -d)]
        total += int(((a == b) & (a > 0)).sum())
    return total


def attention_bound_ms(b, length, heads, d, pairs):
    bytes_moved = 4 * b * length * heads * d * 2 + 2 * b * length * 4
    flops = 4 * d * heads * pairs
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S), (
        "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S else "operations"
    )


def ffn_bound_ms(rows, d, f):
    bytes_moved = 2 * rows * d * 2 + 3 * d * f * 2 + d * 4
    flops = 6 * rows * d * f
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_ms(q, k, v, seg, window, iters):
    """One PyTorch call over the same masked attention (yardstick only)."""
    import torch
    import torch.nn.functional as F

    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (seg[:, None, None, :] > 0) & (seg[:, None, :, None] == seg[:, None, None, :])
    if window is not None:
        idx = torch.arange(seg.shape[1], device=seg.device)
        mask = mask & ((idx[:, None] - idx[None, :]).abs() <= window)
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill_(~mask, float("-inf"))
    del mask
    # the memory-efficient backend takes an additive (B, 1, L, L) bias; the
    # math fallback would materialise (B, H, L, L) scores, so it is excluded
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), iters)
    del bias, qt, kt, vt
    return ms


_CATEGORIES = (  # kernel-name fragment -> category, first match wins
    ("attention_kernel<true>", "window_attention (ours)"),
    ("attention_kernel<false>", "segment_attention (ours)"),
    ("fused_ln_ffn_kernel", "fused_ln_ffn (ours)"),
    ("conv", "convolution (cuDNN)"),
    ("gemm", "matmul (cuBLAS)"),
    ("nvjet", "matmul (cuBLAS)"),
    ("xmma", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
)


def device_breakdown(torch, forward) -> None:
    """Device time per kernel category over one forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sums: dict[str, float] = {}
    others: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        cat = next((c for frag, c in _CATEGORIES if frag in evt.name), None)
        if cat is None:
            cat = "other (elementwise, copies)"
            others[evt.name] = others.get(evt.name, 0.0) + ms
        sums[cat] = sums.get(cat, 0.0) + ms
    busy = sum(sums.values())
    if busy == 0.0:
        log("  profiler: no device time recorded (breakdown not measured)")
        return
    log(f"  profiler, one packed forward: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f} %, idle {100 - 100 * busy / wall_ms:.1f} %)")
    for cat, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        log(f"    {cat:30s} {ms:9.2f} ms  {100 * ms / busy:5.1f} % of device time")
    for kname, ms in sorted(others.items(), key=lambda kv: -kv[1])[:6]:
        log(f"      other: {ms:8.2f} ms  {kname[:110]}")


def check_kernels(torch, ops, cases, gen):
    """Phase 2: kernels vs plain versions; returns max errors per kernel."""
    from cm3p_torch.ops.attention import segment_attention_plain, window_attention_plain

    errs = {name: 0.0 for name in PER_FORWARD}
    for label, b, length, heads, seg, key_mask_only in cases:
        qkv = torch.randn(b, length, 3, heads, 64, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        qseg = torch.ones_like(seg) if key_mask_only else seg
        for name, window in (("window_attention", 64), ("segment_attention", None)):
            theta = 10000.0 if window else 160000.0
            if window:
                got = ops.window_attention(q, k, v, qseg, seg, window, theta)
                want = window_attention_plain(q, k, v, qseg, seg, window, theta)
            else:
                got = ops.segment_attention(q, k, v, qseg, seg, theta)
                want = segment_attention_plain(q, k, v, qseg, seg, theta)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            dead = qseg == 0
            dead_max = got[dead].abs().max().item() if bool(dead.any()) else 0.0
            log(f"  {name:18s} {label:28s} max_abs_err {err:.3e} (tol {TOL}); masked rows max {dead_max}")
            if not err <= TOL or dead_max != 0.0:
                fail(f"{name} disagrees with its plain version on {label}")
            errs[name] = max(errs[name], err)
            del got, want
        del qkv, q, k, v
    for d, f, rows in ((768, 1152, cases[0][1] * ROW_LEN), (512, 1024, cases[-1][1] * cases[-1][2])):
        x = (0.5 * torch.randn(rows, d, generator=gen, device="cuda")).to(torch.bfloat16)
        scale = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        wi = (0.02 * torch.randn(2 * f, d, generator=gen, device="cuda")).to(torch.bfloat16)
        wo = (0.02 * torch.randn(d, f, generator=gen, device="cuda")).to(torch.bfloat16)
        got = ops.fused_ln_ffn(x, scale, None, wi, wo, 1e-5)
        want = ops.fused_ln_ffn_plain(x, scale, None, wi, wo, 1e-5)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        log(f"  fused_ln_ffn       rows {rows} x {d}, F {f}{'':8s} max_abs_err {err:.3e} (tol {TOL})")
        if not err <= TOL:
            fail(f"fused_ln_ffn disagrees with its plain version at D={d}")
        errs["fused_ln_ffn"] = max(errs["fused_ln_ffn"], err)
        del x, got, want
    return errs


def cosines(a, b):
    import torch

    a, b = a.float(), b.float()
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def check_embeddings(torch, label, emb, ref):
    emb = torch.as_tensor(emb)
    ref = torch.as_tensor(ref)
    if not bool(torch.isfinite(emb).all()):
        fail(f"{label}: non-finite embeddings")
    norms = emb.float().norm(dim=-1)
    if not bool(((norms - 1).abs() < 1e-2).all()):
        fail(f"{label}: embeddings are not unit norm (min {norms.min():.4f}, max {norms.max():.4f})")
    cos = cosines(emb, ref)
    log(f"  {label}: {emb.shape[0]} windows, norm in [{norms.min():.4f}, {norms.max():.4f}], "
        f"cosine to the plain path min {cos.min():.6f} (need >= {COS_MIN})")
    if not bool((cos >= COS_MIN).all()):
        fail(f"{label}: kernel path and plain path disagree (cosine {cos.min():.6f})")


def expect_counts(ops, label, forwards):
    counts = ops.launch_counts()
    want = {name: n * forwards for name, n in PER_FORWARD.items()}
    log(f"  {label} launches {counts} (want {want})")
    if counts != want:
        fail(f"{label}: the main path did not launch each kernel as expected")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "cm3p_torch" / "csrc").is_dir():
        print(f"chip_smoke: no cm3p_torch package beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from cm3p_torch import ops
    from cm3p_torch.configs import CM3PConfig
    from cm3p_torch.inference import embed_beatmap, load_model
    from cm3p_torch.interop import init_weights
    from cm3p_torch.ops import _build
    from cm3p_torch.processing import CM3PProcessor
    from cm3p_torch.processing.packing import pack_windows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x {torch.cuda.device_count()}, torch {torch.__version__}, cuda {torch.version.cuda}")

    # ---- 1. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[1] build: {time.perf_counter() - t0:.1f} s wall, per source {json.dumps({k: round(v, 1) for k, v in built.items()})}")
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # ---- host: processor over the bundled map and the corpus
    proc = CM3PProcessor()
    tok = proc.beatmap_tokenizer
    maps = sorted(glob.glob(str(ROOT / "resources" / "*.osu"))) + sorted(
        glob.glob(str(ROOT / "resources" / "perf_corpus" / "*.osu"))
    )
    if len(maps) != 17:
        fail(f"expected the bundled map and 16 corpus maps, found {len(maps)}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    seqs, feats, waves = [], [], {}
    from cm3p_torch.beatmap import load_beatmap
    from cm3p_torch.beatmap.parser import get_song_length

    for path in maps:
        seconds = get_song_length(None, 16000, load_beatmap(path)) + 1.0
        wav = (0.1 * rng.standard_normal(int(seconds * 16000))).astype(np.float32)
        waves[path] = wav
        out = proc(beatmap=path, audio=wav, **WINDOW_KW)
        lengths = np.asarray(out["attention_mask"]).sum(axis=1)
        ids = np.asarray(out["input_ids"])
        seqs.extend(ids[i, : lengths[i]] for i in range(len(ids)))
        feats.append(np.asarray(out["input_features"], np.float32))
    feats = np.concatenate(feats)
    packed = pack_windows(seqs, ROW_LEN, pad_id=tok.pad_token_id)
    n_windows, n_rows = len(seqs), packed["input_ids"].shape[0]
    n_tokens = int(sum(len(s) for s in seqs))
    log(f"host: processor over {len(maps)} maps -> {n_windows} windows, {n_tokens} tokens, "
        f"{n_rows} packed rows of {ROW_LEN} (fill {n_tokens / (n_rows * ROW_LEN):.3f}) in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    seg_packed = torch.as_tensor(packed["segment_ids"], device=dev)
    bundled = maps[0]
    unp = proc(beatmap=bundled, audio=waves[bundled], **WINDOW_KW)
    mask_unpacked = torch.as_tensor(np.asarray(unp["attention_mask"]), dtype=torch.int32, device=dev)
    audio_b, audio_l = feats.shape[0], feats.shape[2] // 2

    # ---- 2. kernels against their plain versions at the main path's shapes
    log("[2] kernels vs plain versions (bf16, seeded inputs)")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [
        (f"packed {n_rows}x{ROW_LEN} H12", n_rows, ROW_LEN, 12, seg_packed, False),
        (f"unpacked {tuple(mask_unpacked.shape)} H12", mask_unpacked.shape[0], mask_unpacked.shape[1], 12,
         mask_unpacked, True),
        (f"audio {audio_b}x{audio_l} H8", audio_b, audio_l, 8,
         torch.ones(audio_b, audio_l, dtype=torch.int32, device=dev), True),
    ]
    errs = check_kernels(torch, ops, cases, gen)

    # ---- 3. the slice end to end
    log("[3] slice: full-width CM3PConfig, seeded random bf16 weights")
    cfg = CM3PConfig()
    cfg.beatmap_config.vocab_size = tok.vocab_size
    cfg.beatmap_config.audio_token_id = tok.audio_token_id
    t0 = time.perf_counter()
    model = load_model(cfg, init_weights(cfg, torch.Generator(device=dev).manual_seed(0)), device=dev)
    torch.cuda.synchronize()
    log(f"  model: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, built in {time.perf_counter() - t0:.1f} s")
    main_counts = {name: 0 for name in PER_FORWARD}

    ops.reset_launch_counts()
    emb_unpacked = embed_beatmap(model, proc, bundled, audio=waves[bundled], mean_pool=False, device=dev, **WINDOW_KW)
    torch.cuda.synchronize()
    for k, v in expect_counts(ops, "unpacked embed_beatmap", 1).items():
        main_counts[k] += v
    model.set_plain(True)
    ops.reset_launch_counts()
    ref_unpacked = embed_beatmap(model, proc, bundled, audio=waves[bundled], mean_pool=False, device=dev, **WINDOW_KW)
    model.set_plain(False)
    if any(ops.launch_counts().values()):
        fail("the plain path launched a kernel")
    check_embeddings(torch, "unpacked", emb_unpacked, ref_unpacked)

    batch = dict(
        input_ids=torch.as_tensor(packed["input_ids"], dtype=torch.int64, device=dev),
        segment_ids=seg_packed,
        window_rows=torch.as_tensor(packed["window_to_row"], dtype=torch.int64, device=dev),
        window_segments=torch.as_tensor(packed["window_segment"], dtype=torch.int64, device=dev),
        input_features=torch.as_tensor(feats, device=dev),
    )
    with torch.no_grad():
        ops.reset_launch_counts()
        emb_packed = model.get_packed_beatmap_features(**batch, normalize=True)
        torch.cuda.synchronize()
        for k, v in expect_counts(ops, "packed get_packed_beatmap_features", 1).items():
            main_counts[k] += v
        model.set_plain(True)
        ref_packed = model.get_packed_beatmap_features(**batch, normalize=True)
        model.set_plain(False)
    check_embeddings(torch, "packed", emb_packed.cpu(), ref_packed.cpu())
    n_bundled = emb_unpacked.shape[0]
    cross = cosines(emb_packed[:n_bundled].cpu(), torch.as_tensor(emb_unpacked))
    log(f"  packed vs unpacked, bundled map's {n_bundled} windows: cosine min {cross.min():.6f}")
    if not bool((cross >= COS_MIN).all()):
        fail("packed and unpacked embeddings of the same windows disagree")
    del ref_packed

    # ---- 4. times
    log("[4] times (CUDA events; packed beatmap shape unless named)")
    with torch.no_grad():
        t_fwd = cuda_ms(lambda: model.get_packed_beatmap_features(**batch, normalize=True), 3) / 1e3
    log(f"  packed path: {n_windows / t_fwd:.2f} windows/s, {n_tokens / t_fwd:.0f} tokens/s "
        f"({t_fwd * 1e3:.1f} ms per forward of {n_windows} windows, {n_rows} rows, audio included)")
    device_breakdown(torch, lambda: model.get_packed_beatmap_features(**batch, normalize=True))

    from cm3p_torch.ops.attention import segment_attention_plain, window_attention_plain

    b, length, heads = n_rows, ROW_LEN, 12
    qkv = torch.randn(b, length, 3, heads, 64, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    kernels = []
    for kname, window, theta in (("window_attention", 64, 10000.0), ("segment_attention", None, 160000.0)):
        if window:
            run = lambda: ops.window_attention(q, k, v, seg_packed, seg_packed, window, theta)  # noqa: E731
            plain = lambda: window_attention_plain(q, k, v, seg_packed, seg_packed, window, theta)  # noqa: E731
        else:
            run = lambda: ops.segment_attention(q, k, v, seg_packed, seg_packed, theta)  # noqa: E731
            plain = lambda: segment_attention_plain(q, k, v, seg_packed, seg_packed, theta)  # noqa: E731
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 1)
        lib_ms = sdpa_ms(q, k, v, seg_packed, window, 5)
        pairs = visible_pairs(seg_packed, window)
        bound, bound_by = attention_bound_ms(b, length, heads, 64, pairs)
        kernels.append((kname, ms, plain_ms, bound, bound_by, lib_ms))
    del qkv, q, k, v
    rows = n_rows * ROW_LEN
    x = (0.5 * torch.randn(rows, 768, generator=gen, device=dev)).to(torch.bfloat16)
    mlp = model.beatmap_model.encoder.layers[1]
    args = (x, mlp.mlp_norm.weight, None, mlp.mlp.Wi.weight, mlp.mlp.Wo.weight, 1e-5)
    ms = cuda_ms(lambda: ops.fused_ln_ffn(*args), 5)
    plain_ms = cuda_ms(lambda: ops.fused_ln_ffn_plain(*args), 1)
    bound, bound_by = ffn_bound_ms(rows, 768, 1152)
    kernels.append(("fused_ln_ffn", ms, plain_ms, bound, bound_by, None))
    del x

    audio_q = torch.randn(audio_b, audio_l, 3, 8, 64, generator=gen, device=dev).to(torch.bfloat16).unbind(2)
    ones = torch.ones(audio_b, audio_l, dtype=torch.int32, device=dev)
    xa = (0.5 * torch.randn(audio_b * audio_l, 512, generator=gen, device=dev)).to(torch.bfloat16)
    amlp = model.beatmap_model.audio_encoder.encoder.layers[1]
    log("  audio tower shapes: window %.3f ms, segment %.3f ms, fused_ln_ffn %.3f ms" % (
        cuda_ms(lambda: ops.window_attention(*audio_q, ones, ones, 64, 10000.0), 10),
        cuda_ms(lambda: ops.segment_attention(*audio_q, ones, ones, 160000.0), 10),
        cuda_ms(lambda: ops.fused_ln_ffn(xa, amlp.mlp_norm.weight, None, amlp.mlp.Wi.weight, amlp.mlp.Wo.weight, 1e-5), 5),
    ))

    report = []
    for kname, ms, plain_ms, bound, bound_by, lib_ms in kernels:
        src, replaces = KERNEL_SOURCES[kname]
        log(f"  {kname:18s} {ms:9.3f} ms  plain {plain_ms:9.3f} ms  bound {bound:8.3f} ms ({bound_by})  "
            f"library {'-' if lib_ms is None else f'{lib_ms:.3f} ms'}  launches {main_counts[kname]}")
        report.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_counts[kname], "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": report}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
