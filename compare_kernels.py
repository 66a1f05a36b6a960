#!/usr/bin/env python3
"""Time one phase's kernels of two checkouts on one card, in turns.

    python3 compare_kernels.py --parent DIR [--phase quant|wo|ffn|attn|bwd|f32|f32attn] [--out DIR]
    python3 compare_kernels.py --phase parts|f32parts [--out DIR]

``DIR`` is another checkout of this repository (for example ``git archive
<commit> | tar -x -C _scratch/parent``). Each turn runs one tree's phase 7
check in its own process, with that tree's kernels built from its own
sources, in the order parent, change, change, parent, so that both are
measured on the same card within one run:

* ``quant`` (the default): ``chip_smoke.check_quant_kernels``, the LN-matmul
  and int8 FFN kernels against their plain versions, then their times, plain
  times, bounds and ``torch.addmm`` at the packed beatmap shape (323,584 rows);
  then the four LN-matmul forms at D 512 (bf16 and int8, LN -> QKV and Wo +
  residual) at the audio tower's 237 x 1,500 rows through the public ops, on
  the same seeded inputs in every turn, with their bounds;
* ``wo``: ``chip_smoke.check_wo_kernels``, the four attention forms with the
  Wo epilogue against their plain versions, then their times beside the
  unfused pair they replace, at the packed beatmap shape and the audio
  tower's. The packed segments are made once, from the 17 maps with this
  checkout's processor, saved under ``--out`` and loaded in every turn, so
  both trees get the same;
* ``ffn``: the FFN kernel's bf16 form (``ops.fused_ln_ffn``, row 3) at
  323,584 x 768 (F 1152), 80,896 x 512 (F 1024) and 49,152 x 256 (F 512),
  and its ``w8a8 + w8a8_wo`` form (``ops.fused_ln_ffn_q``, row 3qq) at the
  first two, on the same seeded inputs in every turn, through the public ops
  that both trees have; each first against its plain version at 4,037 rows
  (tolerance 2e-2), then timed beside the unfused composition (cuBLAS
  products, ``torch._int_mm`` for the int8 ones, PyTorch's elementwise
  passes; the same PyTorch code in every turn) and its bound;
* ``attn``: the forward attention kernels (rows 1 and 2 and the forms they
  serve) through the public ops on the same seeded inputs in every turn: the
  packed beatmap shape (79 x 4096, H 12, rope), the audio tower's (237 x
  1500, H 8, rope), the ``v8_packed`` training batch (10 x 4096, H 12) with
  lse and with rope and lse, the metadata tower's ``meta_pack`` rows (24 x
  2048, H 4, lse), the rectangular form at a sequence-parallel rank's shape
  (B 2, Lq 8,192 over Lk 16,384, the last 1,000 keys masked) and the window
  form at w = 192 and 256. Each form is first held to its plain version (2e-2;
  lse 1e-3 on live rows; the rectangular form 2e-3; exactly 0 on queries that
  see no key), then timed; the rope forms also without rope tables (what rope
  costs in each tree's design), the segment forms' key-tile ranges alone (the
  wrapper's PyTorch ops, inside the form's time). The segments are made once from the 17 maps,
  as for ``wo``. The first change turn also times the plain version and one
  SDPA call (memory-efficient backend, the same mask) and computes the bound.

* ``bwd``: the dQ and dK/dV forms of the attention backward through the public
  ops (``ops.segment_attention_dq`` / ``ops.window_attention_dq`` and the
  ``_dkv`` ones) on the same seeded inputs in every turn, lse from each tree's
  forward kernel: the ``v8_packed`` batch (10 x 4096, H 12) in the segment and
  window (w 64) forms with and without rope (rows 8ar, 8a, 7ar, 7a and 8br,
  8b, 7br, 7b), the window form at w = 192 and 256 (row 9's dQ and dK/dV) and
  the metadata tower's ``meta_pack`` rows (24 x 2048, H 4, rows 8a and 8b).
  Each is first held to its plain backward (1e-2 of the largest entry of each
  gradient; exactly 0 on queries that see no key and on keys no query sees),
  then timed (a rope form called alone runs its own rope pass); the first
  change turn also times the plain version and one SDPA backward and
  computes the bound. The segments are made as for ``attn``.

* ``f32``: the fp32 forms through the public ops at fp32 (TF32 off) on the
  same seeded inputs in every turn, at 323,584 rows (D 768) and the audio
  tower's 355,500 (D 512): the LN-matmul forms LN -> QKV and Wo + residual
  with fp32 weights (rows 5-f32, 5r-f32) and int8 weights (6-f32, 6r-f32), and
  the FFN forms with fp32 weights (3-f32), ``w8a8`` (3q-f32) and ``w8a8 +
  w8a8_wo`` (3qq-f32) at F 1152 / 1024. Each is first held to its plain
  version (``chip_smoke.F32_REL_TOL`` of the largest entry; the int8 forms on
  the rows whose exported codes are the plain quantiser's, at least 90 % of
  them), then timed beside its yardstick in every turn: one fp32
  ``torch.addmm`` for the Wo forms, the unfused fp32 composition
  (``chip_smoke.ffn_composition``) for the FFN; the first change turn also
  times the plain version, and the bound is computed.

* ``f32attn``: the fp32 forms of the forward attention (rows 1-f32, 2-f32,
  2r-f32, 4-f32) through the public ops at fp32 (TF32 off) on the same seeded
  inputs in every turn, on the ``attn`` phase's segments: window and segment
  at the packed beatmap shape (79 x 4096, H 12) and the audio tower's (237 x
  1500, H 8), with rope; the metadata tower's ``meta_pack`` rows (24 x 2048,
  H 4, segment, no rope); the window form at w 192 on the ``v8_packed`` batch
  (10 x 4096, H 12, rope); the rectangular form at phase 10's shape (B 2, Lq
  1,088 over Lk 8,704). Each is first held to its plain version
  (``chip_smoke.F32_REL_TOL`` of the largest entry, exactly 0 on queries that
  see no key), then timed; the first change turn also times the plain version
  and one fp32 SDPA call (memory-efficient backend, the same mask) and
  computes the bound (``chip_smoke._f32_bound``).

* ``f32parts`` (this tree only, no ``--parent``): the fp32 kernels at 323,584
  rows (D 768) beside copies built with one part cut out or one choice
  changed, each timed twice in turns on the same seeded inputs beside the one
  PyTorch call (fp32 ``torch.addmm``, the bare product for 5-f32 / 6-f32, the
  unfused fp32 composition for the FFN), with each copy's registers and spills:
  the fp32 LN-matmul (rows 5r-f32, 5-f32) with its slices' loads and stores cut
  (the products alone, wrong sums), at one block an SM and with 8 values of K a
  slice; the int8 LN-matmul (6r-f32, 6-f32) without its front end, without its
  epilogue, with the products alone and with four stages at one block an SM;
  the FFN (3-f32, 3q-f32, 3qq-f32)
  without g's round trip through the scratch (wrong sums) and at one block an
  SM; the fp32 attention (1-f32 with and without rope, audio, 4-f32, 2-f32
  and the metadata rows, on the ``attn`` phase's segments) with its products
  alone (no K / V copies after the first tile), at 8 query rows a thread
  (128-query blocks, two an SM) and without the test that skips a warp of
  padding queries. The copies are sed-edited ``csrc/``; an edit that no longer
  matches the source fails the run.

* ``parts`` (this tree only, no ``--parent``): the int8 LN-matmul kernel
  (rows 6 and 6r at 323,584 rows) beside copies of it built with one part cut
  out (the front end, the products, the epilogue, the TMA stores, the W loads,
  or all but one), each timed twice in turns on the same seeded inputs: what
  each part costs. The copies are sed-edited ``csrc/fused_ln_matmul.cu``; an
  edit that no longer matches the source fails the run.

Prints the card's name and power limit, each turn's timing lines and, per
kernel form (and shape), the four times; writes each turn's log and
``compare.json`` (``compare_wo.json`` for ``wo``, ``compare_ffn.json`` for
``ffn``, ``compare_attn.json`` for ``attn``, ``compare_bwd.json`` for ``bwd``,
``compare_f32.json`` for ``f32``, ``compare_f32attn.json`` for ``f32attn``) to
``--out``. Exits non-zero
if a turn fails. Needs one GPU.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ORDER = ("parent", "change", "change", "parent")
QUANT_TURN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch import ops
from cm3p_torch.ops import _build
_build.build(("fused_ln_matmul", "fused_ffn"))
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
errs, report = chip_smoke.check_quant_kernels(torch, ops, gen, torch.device("cuda"), 79 * 4096)
fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")  # a report row, as check_quant_kernels documents
report = {name: dict(zip(fields, row, strict=True)) for name, row in report.items()}
# the D 512 forms at the rows the audio tower gives them (237 windows x 1,500 frames), through the public ops
from cm3p_torch.ops.quant import quantize_weight_int8
audio, rows = {}, 237 * 1500
gen = torch.Generator(device="cuda").manual_seed(512)
x = (0.5 * torch.randn(rows, 512, generator=gen, device="cuda")).to(torch.bfloat16)
scale = 1 + 0.1 * torch.randn(512, generator=gen, device="cuda")
for n_out, suffix in ((1536, ""), (512, "_wo")):
    w = (0.02 * torch.randn(n_out, 512, generator=gen, device="cuda")).to(torch.bfloat16)
    w_q = quantize_weight_int8(w)
    res = (0.5 * torch.randn(rows, n_out, generator=gen, device="cuda")).to(torch.bfloat16) if suffix else None
    kw = dict(scale=None if suffix else scale, residual=res)
    audio["fused_ln_matmul" + suffix] = chip_smoke.cuda_ms(lambda: ops.fused_ln_matmul(x, w, **kw), 10)
    audio["fused_ln_matmul_q" + suffix] = chip_smoke.cuda_ms(lambda: ops.fused_ln_matmul_q(x, w, w_q=w_q, **kw), 10)
    for name in ("fused_ln_matmul" + suffix, "fused_ln_matmul_q" + suffix):
        print(f"  {name} 512 -> {n_out}, {rows} rows: {audio[name]:.3f} ms (audio tower shape)", flush=True)
print("REPORT " + json.dumps({"errs": errs, "report": report, "audio": audio}), flush=True)
"""
AUDIO_ROWS = 237 * 1500  # the rows of QUANT_TURN's audio-tower timings
# the 17 maps' packed segments and the audio tower's shape, as chip_smoke's main path makes them
WO_INPUTS = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch.processing import CM3PProcessor
from cm3p_torch.processing.packing import pack_windows
proc = CM3PProcessor()
_, seqs, feats, _ = chip_smoke.corpus_windows(proc)
packed = pack_windows(seqs, chip_smoke.ROW_LEN, pad_id=proc.beatmap_tokenizer.pad_token_id)
torch.save({"seg_packed": torch.as_tensor(packed["segment_ids"]), "audio_b": int(feats.shape[0]),
            "audio_l": int(feats.shape[2] // 2)}, sys.argv[2])
"""
WO_TURN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch import ops
from cm3p_torch.ops import _build
_build.build(("attention", "attention_wo"))
torch.backends.cuda.matmul.allow_tf32 = False
saved = torch.load(sys.argv[2])
dev = torch.device("cuda")
gen = torch.Generator(device="cuda").manual_seed(0)
errs, _, _ = chip_smoke.check_wo_kernels(torch, ops, gen, dev, saved["seg_packed"].to(dev), saved["audio_b"],
                                         saved["audio_l"])
print("REPORT " + json.dumps({"errs": errs}), flush=True)
"""
FFN_TURN = r"""
import json, sys, torch
import torch.nn.functional as F
sys.path.insert(0, sys.argv[1])
from cm3p_torch import ops
from cm3p_torch.ops import _build
from cm3p_torch.ops.fused_ffn import layer_norm_f32
from cm3p_torch.ops.quant import quant_rows_int8, quantize_weight_int8
_build.build(("fused_ffn",))
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")

def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters

def composition(x, scale, bias, wi, wo, eps, wi_q=None, wo_q=None):
    f = wo.shape[1]
    y = layer_norm_f32(x, scale, bias, eps)
    if wi_q is None:
        h = F.linear(y.to(x.dtype), wi)
    else:
        q, sa = quant_rows_int8(y)
        h = (torch._int_mm(q, wi_q[0].t()).float() * sa * wi_q[1]).to(x.dtype)
    gf = F.gelu(h[:, :f].float()) * h[:, f:].float()
    if wo_q is None:
        o = F.linear(gf.to(x.dtype), wo)
    else:
        gq, sg = quant_rows_int8(gf)
        o = (torch._int_mm(gq, wo_q[0].t()).float() * sg * wo_q[1]).to(x.dtype)
    return x + o

errs, times = {}, {}
for d, f, rows in ((768, 1152, 323584), (512, 1024, 80896), (256, 512, 49152)):
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = (0.5 * torch.randn(rows, d, generator=gen, device=dev)).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    wi = (0.02 * torch.randn(2 * f, d, generator=gen, device=dev)).to(torch.bfloat16)
    wo = (0.02 * torch.randn(d, f, generator=gen, device=dev)).to(torch.bfloat16)
    forms = [("fused_ln_ffn", dict(), {})]
    if d != 256:
        wi_q, wo_q = quantize_weight_int8(wi), quantize_weight_int8(wo)
        forms.append(("fused_ln_ffn_q_wo", dict(w8a8=True, w8a8_wo=True, wi_q=wi_q, wo_q=wo_q),
                      dict(wi_q=wi_q, wo_q=wo_q)))
    for name, kw, ckw in forms:
        run = (lambda a, kw=kw: ops.fused_ln_ffn_q(*a, **kw)) if kw else (lambda a: ops.fused_ln_ffn(*a))
        small = (x[:4037], scale, None, wi, wo, 1e-5)
        got, want = run(small), ops.fused_ln_ffn_plain(*small, **kw)
        errs[f"{name} {d}"] = err = (got.float() - want.float()).abs().max().item()
        if not err <= 2e-2:
            raise SystemExit(f"{name} at D {d} disagrees with its plain version: {err}")
        args = (x, scale, None, wi, wo, 1e-5)
        key = f"{name} {rows}x{d}"
        times[key] = {"rows": rows, "d": d, "f": f, "ms": cuda_ms(lambda: run(args), 10),
                      "composition_ms": cuda_ms(lambda: composition(*args, **ckw), 5)}
        print(f"  {key}: {times[key]['ms']:.3f} ms (composition {times[key]['composition_ms']:.3f} ms)", flush=True)
print("REPORT " + json.dumps({"errs": errs, "times": times}), flush=True)
"""
# the segments of the attn phase: the packed beatmap rows and the audio shape as for wo, the v8_packed training
# batch's rows and its metadata tower's meta_pack rows, as chip_smoke's phases 5 and 6 make them
ATTN_INPUTS = WO_INPUTS.replace("torch.save({", """from cm3p_torch.train.__main__ import CONFIG_DIR, beatmap_file_batches, beatmap_paths, build_processor
from cm3p_torch.utils.config import load_config
targs = load_config(CONFIG_DIR, "v8_packed", [])
paths = beatmap_paths([str(chip_smoke.ROOT / "resources"), str(chip_smoke.ROOT / "resources" / "perf_corpus")])
batch = next(iter(beatmap_file_batches(targs, build_processor(targs), paths, test=False)()))
seg10 = torch.as_tensor(batch["segment_ids"]).to(torch.int32)
meta = chip_smoke.meta_pack_segments(torch, batch, int(targs["meta_pack"]), "cpu")
torch.save({"seg10": seg10, "meta_seg": meta, """)
ATTN_TURN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch import ops
from cm3p_torch.ops import _build
from cm3p_torch.ops.attention import (segment_attention_plain, segment_attention_rect_plain, segment_tile_ranges,
                                      window_attention_plain)
_build.build(("attention",))
saved, library = torch.load(sys.argv[2]), sys.argv[3] == "1"
dev = torch.device("cuda")
ones = torch.ones(saved["audio_b"], saved["audio_l"], dtype=torch.int32, device=dev)
packed, seg10, meta = (saved[k].to(dev).contiguous() for k in ("seg_packed", "seg10", "meta_seg"))
rect_k = torch.ones(2, 16384, dtype=torch.int32, device=dev)
rect_k[:, -1000:] = 0
# key: (qseg, kseg, heads, window, rope theta, lse); window None is the segment form, "rect" the rectangular one
FORMS = {
    "window packed": (packed, packed, 12, 64, 10000.0, False),
    "segment packed": (packed, packed, 12, None, 160000.0, False),
    "window audio": (ones, ones, 8, 64, 10000.0, False),
    "segment audio": (ones, ones, 8, None, 160000.0, False),
    "window train lse": (seg10, seg10, 12, 64, None, True),
    "segment train lse": (seg10, seg10, 12, None, None, True),
    "window train rope+lse": (seg10, seg10, 12, 64, 10000.0, True),
    "segment train rope+lse": (seg10, seg10, 12, None, 160000.0, True),
    "segment metadata lse": (meta, meta, 4, None, None, True),
    "rect": (torch.ones(2, 8192, dtype=torch.int32, device=dev), rect_k, 12, "rect", None, False),
    "window w192": (seg10, seg10, 12, 192, None, False),
    "window w256": (seg10, seg10, 12, 256, None, False),
}
errs, times, lib = {}, {}, {}
for n, (key, (qseg, kseg, heads, window, theta, lse)) in enumerate(FORMS.items()):
    gen = torch.Generator(device=dev).manual_seed(n)
    b, lq = qseg.shape
    lk = kseg.shape[1]
    if window == "rect":
        q = torch.randn(b, lq, heads, 64, generator=gen, device=dev).to(torch.bfloat16)
        k, v = torch.randn(b, lk, 2, heads, 64, generator=gen, device=dev).to(torch.bfloat16).unbind(2)
        run = lambda theta=None, lse=False: ops.segment_attention_rect(q, k, v, qseg, kseg)
        plain = lambda: segment_attention_rect_plain(q, k, v, qseg, kseg)
        tol = chip_smoke.RECT_TOL
    else:
        q, k, v = torch.randn(b, lq, 3, heads, 64, generator=gen, device=dev).to(torch.bfloat16).unbind(2)
        if window is None:
            run = lambda theta=theta, lse=lse: ops.segment_attention(q, k, v, qseg, kseg, theta, lse)
            plain = lambda: segment_attention_plain(q, k, v, qseg, kseg, theta, lse)
        else:
            run = lambda theta=theta, lse=lse: ops.window_attention(q, k, v, qseg, kseg, window, theta, lse)
            plain = lambda: window_attention_plain(q, k, v, qseg, kseg, window, theta, lse)
        tol = chip_smoke.TOL
    got, want = run(), plain()
    torch.cuda.synchronize()
    (got, got_lse), (want, want_lse) = (got, want) if lse else ((got, None), (want, None))
    dead = (kseg > 0).sum(1) == 0 if window == "rect" else qseg == 0
    err = (got.float() - want.float()).abs().max().item()
    dead_max = got[dead].abs().max().item() if bool(dead.any()) else 0.0
    lse_err = 0.0
    if lse:
        live = (~dead)[:, None, :].expand_as(got_lse)
        lse_err = (got_lse - want_lse)[live].abs().max().item()
    errs[key] = {"out": err, "lse": lse_err, "dead_max": dead_max}
    if not (err <= tol and lse_err <= chip_smoke.LSE_TOL and dead_max == 0.0):
        raise SystemExit(f"{key}: the kernel disagrees with its plain version ({errs[key]}, tolerance {tol})")
    del got, want, got_lse, want_lse
    t = {"ms": chip_smoke.cuda_ms(run, 10)}
    if theta is not None:
        t["no_rope_ms"] = chip_smoke.cuda_ms(lambda: run(None), 10)
    if window in (None, "rect"):  # the wrapper's key-tile ranges (PyTorch ops), part of ms
        t["ranges_ms"] = chip_smoke.cuda_ms(lambda: segment_tile_ranges(qseg, kseg), 10)
    times[key] = t
    print(f"  {key}: {t['ms']:.3f} ms (" + (f"without rope {t['no_rope_ms']:.3f} ms; " if theta else "")
          + (f"key-tile ranges {t['ranges_ms']:.3f} ms; " if "ranges_ms" in t else "")
          + f"max_abs_err {err:.3e}, lse {lse_err:.3e})", flush=True)
    if library:
        if window == "rect":
            pairs = int((kseg > 0).sum()) * lq
            bound, by = chip_smoke.rect_bound_ms(b, lq, lk, heads, 64, pairs)
            sdpa = chip_smoke.sdpa_rect_ms(q, k, v, qseg, kseg, 5)
        else:
            pairs = chip_smoke.visible_pairs(qseg, window)
            bound, by = chip_smoke.attention_bound_ms(b, lq, heads, 64, pairs)
            sdpa = chip_smoke.sdpa_ms(q, k, v, qseg, window, 3)
        lib[key] = {"plain_ms": chip_smoke.cuda_ms(plain, 1), "sdpa_ms": sdpa, "bound_ms": bound, "bound_by": by,
                    "pairs": pairs}
    del q, k, v
    torch.cuda.empty_cache()
print("REPORT " + json.dumps({"errs": errs, "times": times, "library": lib}), flush=True)
"""
# the fp32 forms of the forward attention on the attn phase's segments: key -> (qseg, kseg, heads, window, theta)
F32ATTN_TURN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch import ops
from cm3p_torch.ops import _build
from cm3p_torch.ops.attention import segment_attention_plain, segment_attention_rect_plain, window_attention_plain
_build.build(("attention", "attention_f32"))
torch.backends.cuda.matmul.allow_tf32 = False
saved, library = torch.load(sys.argv[2]), sys.argv[3] == "1"
dev = torch.device("cuda")
ones = torch.ones(saved["audio_b"], saved["audio_l"], dtype=torch.int32, device=dev)
packed, seg10, meta = (saved[k].to(dev).contiguous() for k in ("seg_packed", "seg10", "meta_seg"))
lq, lk = chip_smoke.RECT_CASES[1]  # phase 10's rectangular case: the last 1,000 keys of row 0 masked, row 1 all
rect_q = torch.ones(2, lq, dtype=torch.int32, device=dev)
rect_k = torch.ones(2, lk, dtype=torch.int32, device=dev)
rect_k[0, -1000:], rect_k[1] = 0, 0
FORMS = {
    "window packed": (packed, packed, 12, 64, 10000.0),
    "segment packed": (packed, packed, 12, None, 160000.0),
    "window audio": (ones, ones, 8, 64, 10000.0),
    "segment audio": (ones, ones, 8, None, 160000.0),
    "segment metadata": (meta, meta, 4, None, None),
    "window w192": (seg10, seg10, 12, 192, 10000.0),
    "rect": (rect_q, rect_k, 12, "rect", None),
}
errs, times, lib = {}, {}, {}
for n, (key, (qseg, kseg, heads, window, theta)) in enumerate(FORMS.items()):
    gen = torch.Generator(device=dev).manual_seed(n)
    b, lq_, lk_ = qseg.shape[0], qseg.shape[1], kseg.shape[1]
    if window == "rect":
        q = torch.randn(b, lq_, heads, 64, generator=gen, device=dev)
        k, v = torch.randn(b, lk_, 2, heads, 64, generator=gen, device=dev).unbind(2)
        run = lambda: ops.segment_attention_rect(q, k, v, qseg, kseg)
        plain = lambda: segment_attention_rect_plain(q, k, v, qseg, kseg)
        dead = (kseg > 0).sum(1)[:, None].expand_as(qseg) == 0
    else:
        q, k, v = torch.randn(b, lq_, 3, heads, 64, generator=gen, device=dev).unbind(2)
        if window is None:
            run = lambda: ops.segment_attention(q, k, v, qseg, kseg, theta)
            plain = lambda: segment_attention_plain(q, k, v, qseg, kseg, theta)
        else:
            run = lambda: ops.window_attention(q, k, v, qseg, kseg, window, theta)
            plain = lambda: window_attention_plain(q, k, v, qseg, kseg, window, theta)
        dead = qseg == 0
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    dead_max = got[dead].abs().max().item() if bool(dead.any()) else 0.0
    errs[key] = {"max_abs_err": err, "rel": rel, "dead_max": dead_max}
    if not (rel <= chip_smoke.F32_REL_TOL and dead_max == 0.0):
        raise SystemExit(f"{key}: the fp32 kernel disagrees with its plain version ({errs[key]})")
    del got, want
    ms = chip_smoke.cuda_ms(run, 5)
    times[key] = {"ms": ms if ms >= 1.0 else chip_smoke.cuda_ms(run, 50)}  # short forms: more launches a reading
    print(f"  {key}: {times[key]['ms']:.3f} ms (max_abs_err {err:.3e}, {rel:.3e} of the largest entry)", flush=True)
    if library:
        if window == "rect":
            pairs = lq_ * int((kseg > 0).sum())
            bytes_moved = 2 * lq_ * heads * 64 * 4 * 2 + 2 * 2 * lk_ * heads * 64 * 4 + 2 * (lq_ + lk_) * 4
            sdpa = chip_smoke.sdpa_rect_ms(q, k, v, qseg, kseg, 3)
        else:
            pairs = chip_smoke.visible_pairs(qseg, window)
            bytes_moved = 4 * b * lq_ * heads * 64 * 4 + 2 * b * lq_ * 4
            sdpa = chip_smoke.sdpa_ms(q, k, v, qseg, window, 3)
        bound, by = chip_smoke._f32_bound(bytes_moved, 4 * 64 * heads * pairs)
        lib[key] = {"plain_ms": chip_smoke.cuda_ms(plain, 1), "sdpa_ms": sdpa, "bound_ms": bound, "bound_by": by,
                    "pairs": pairs}
    del q, k, v
    torch.cuda.empty_cache()
print("REPORT " + json.dumps({"errs": errs, "times": times, "library": lib}), flush=True)
"""
# the dQ and dK/dV forms of the backward on the attn phase's segments: key -> (segments, heads, window, rope theta,
# kernel)
BWD_TURN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch import ops
from cm3p_torch.ops import _build
from cm3p_torch.ops.attention import _attention_bwd_plain, attention_bwd_rope_plain, attention_delta
_build.build(("attention", "attention_bwd"))
saved, library = torch.load(sys.argv[2]), sys.argv[3] == "1"
dev = torch.device("cuda")
seg10, meta = (saved[k].to(dev).contiguous() for k in ("seg10", "meta_seg"))
SHAPES = {  # (segments, heads, window, rope theta) -> the rows of the dQ form and of the dK/dV form
    (0, 12, None, 160000.0): ("8ar segment train rope", "8br segment train rope"),
    (0, 12, None, None): ("8a segment train", "8b segment train"),
    (0, 12, 64, 10000.0): ("7ar window train rope", "7br window train rope"),
    (0, 12, 64, None): ("7a window train", "7b window train"),
    (0, 12, 192, None): ("9 dq w192", "9 dkv w192"),
    (0, 12, 256, None): ("9 dq w256", "9 dkv w256"),
    (1, 4, None, None): ("8a metadata", "8b metadata"),
}
errs, times, lib = {}, {}, {}
for n, ((si, heads, window, theta), keys) in enumerate(SHAPES.items()):
    seg = (seg10, meta)[si]
    gen = torch.Generator(device=dev).manual_seed(n)
    b, length = seg.shape
    q, k, v = torch.randn(b, length, 3, heads, 64, generator=gen, device=dev).to(torch.bfloat16).unbind(2)
    dout = torch.randn(b, length, heads, 64, generator=gen, device=dev).to(torch.bfloat16)
    wargs = () if window is None else (window,)
    fwd = ops.segment_attention if window is None else ops.window_attention
    out, lse = fwd(q, k, v, seg, seg, *wargs, theta, return_lse=True)
    delta = attention_delta(out, dout)
    if theta is None:
        plain = lambda: _attention_bwd_plain(q, k, v, dout, lse, delta, seg, seg, window)
    else:
        plain = lambda: attention_bwd_rope_plain(q, k, v, dout, lse, delta, seg, seg, window, theta)
    want = plain()
    dead = seg == 0
    for key, kernel in zip(keys, ("dq", "dkv")):
        fn = getattr(ops, ("segment_attention_" if window is None else "window_attention_") + kernel)
        run = lambda: fn(q, k, v, dout, lse, delta, seg, seg, *wargs, rope_theta=theta)
        got = run()
        got = (got,) if kernel == "dq" else got
        torch.cuda.synchronize()
        ref = want[:1] if kernel == "dq" else want[1:]
        err = max((g.float() - w.float()).abs().max().item() / w.float().abs().max().item() for g, w in zip(got, ref))
        dead_max = max(g[dead].abs().max().item() for g in got) if bool(dead.any()) else 0.0
        errs[key] = {"rel": err, "dead_max": dead_max}
        if not (err <= chip_smoke.BWD_REL_TOL and dead_max == 0.0):
            raise SystemExit(f"{key}: the {kernel} kernel disagrees with its plain version ({errs[key]})")
        del got
        # the metadata forms take about 0.1 ms: more launches, so that the host's share between them evens out
        t = {"ms": chip_smoke.cuda_ms(run, 100 if si else 10)}
        times[key] = t
        print(f"  {key}: {t['ms']:.3f} ms (relative error {err:.3e})", flush=True)
        if library:
            pairs = chip_smoke.visible_pairs(seg, window)
            bound, by = chip_smoke.attention_bwd_bound_ms(b, length, heads, 64, pairs, 1 if kernel == "dq" else 2,
                                                          theta is not None)
            lib[key] = {"plain_ms": chip_smoke.cuda_ms(plain, 1), "bound_ms": bound, "bound_by": by,
                        "sdpa_bwd_ms": chip_smoke.sdpa_bwd_ms(q, k, v, dout, seg, window, 3), "pairs": pairs}
    del q, k, v, dout, out, lse, delta, want
    torch.cuda.empty_cache()
print("REPORT " + json.dumps({"errs": errs, "times": times, "library": lib}), flush=True)
"""
# the fp32 forms at the towers' shapes: (row, D, N or F, LN / w8a8, int8 / w8a8_wo, rows). LN-matmul rows 5-f32 /
# 5r-f32 (fp32 W) and 6-f32 / 6r-f32 (int8 W), LN -> QKV and Wo + residual; FFN rows 3-f32, 3q-f32 and 3qq-f32
BEATMAP_ROWS = 79 * 4096
F32_SHAPES = tuple(
    [(row, d, n, ln, int8, rows) for d, rows in ((768, BEATMAP_ROWS), (512, AUDIO_ROWS))
     for row, n, ln, int8 in (("5-f32", 3 * d, True, False), ("5r-f32", d, False, False),
                              ("6-f32", 3 * d, True, True), ("6r-f32", d, False, True))]
    + [(row, d, f, w8a8, w8a8_wo, rows) for d, f, rows in ((768, 1152, BEATMAP_ROWS), (512, 1024, AUDIO_ROWS))
       for row, w8a8, w8a8_wo in (("3-f32", False, False), ("3q-f32", True, False), ("3qq-f32", True, True))])
F32_TURN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch import ops
from cm3p_torch.ops import _build
from cm3p_torch.ops.fused_ffn import layer_norm_f32
from cm3p_torch.ops.quant import int8_matmul, quant_rows_int8, quantize_weight_int8
_build.build(("fused_ln_matmul_f32", "fused_ffn_f32"))
torch.backends.cuda.matmul.allow_tf32 = False
library = sys.argv[2] == "1"
dev = torch.device("cuda")
errs, times = {}, {}
for row, d, n, opt1, opt2, rows in json.loads(sys.argv[3]):
    gen = torch.Generator(device=dev).manual_seed(d + n + 7 * opt1 + 13 * opt2)
    x = torch.randn(rows, d, generator=gen, device=dev)
    x[1000:1100] = 0
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    key = f"{row} {d} -> {n}, {rows} rows" if row[0] in "56" else f"{row} D {d} F {n}, {rows} rows"
    t, rows_ok = {}, torch.ones(rows, dtype=torch.bool, device=dev)
    if row[0] in "56":  # LN-matmul: opt1 = LN, opt2 = int8 W
        w = 0.02 * torch.randn(n, d, generator=gen, device=dev)
        w_q = quantize_weight_int8(w) if opt2 else None
        kw = dict(scale=scale) if opt1 else dict(residual=torch.randn(rows, n, generator=gen, device=dev))
        if opt2:
            run = lambda: ops.fused_ln_matmul_q(x, None, w_q=w_q, **kw)
            plain = lambda: ops.fused_ln_matmul_q_plain(x, None, w_q=w_q, **kw)
            codes = torch.empty(rows, d, dtype=torch.int8, device=dev)
            got = ops.fused_ln_matmul_q(x, None, w_q=w_q, codes_out=codes, **kw)
            rows_ok = (codes == quant_rows_int8(layer_norm_f32(x, scale, None, 1e-5) if opt1 else x)[0]).all(1)
            del codes
        else:
            run = lambda: ops.fused_ln_matmul(x, w, **kw)
            plain = lambda: ops.fused_ln_matmul_plain(x, w, **kw)
            got = run()
        if not opt1:  # one PyTorch call of the same function at fp32 (same code in every turn)
            lib = lambda: torch.addmm(kw["residual"], x, w.t())
            t["addmm_ms"] = chip_smoke.cuda_ms(lib, 5)
    else:  # FFN: opt1 = w8a8, opt2 = w8a8_wo
        wi = 0.02 * torch.randn(2 * n, d, generator=gen, device=dev)
        wo = 0.02 * torch.randn(d, n, generator=gen, device=dev)
        wi_q = quantize_weight_int8(wi) if opt1 else None
        wo_q = quantize_weight_int8(wo) if opt2 else None
        args, kw = (x, scale, None, wi, wo, 1e-5), dict(w8a8=bool(opt1), w8a8_wo=bool(opt2), wi_q=wi_q, wo_q=wo_q)
        run = lambda: ops.fused_ln_ffn(*args, **kw)
        plain = lambda: ops.fused_ln_ffn_plain(*args, **kw)
        if opt1:
            cy = torch.empty(rows, d, dtype=torch.int8, device=dev)
            cg = torch.empty(rows, n, dtype=torch.int8, device=dev) if opt2 else None
            got = ops.fused_ln_ffn_q(*args, **kw, codes_y=cy, codes_g=cg)
            y = layer_norm_f32(x, scale, None, 1e-5)
            qy, sa = quant_rows_int8(y)
            rows_ok &= (cy == qy).all(1)
            if opt2:  # g's codes from the plain h on the kernel's own y codes
                h = int8_matmul(cy, wi_q[0]) * sa * wi_q[1]
                rows_ok &= (cg == quant_rows_int8(torch.nn.functional.gelu(h[:, :n]) * h[:, n:])[0]).all(1)
                del h
            del cy, cg, y, qy, sa
        else:
            got = run()
        t["composition_ms"] = chip_smoke.cuda_ms(lambda: chip_smoke.ffn_composition(*args, wi_q=wi_q, wo_q=wo_q), 3)
    want = plain()
    torch.cuda.synchronize()
    errs[key] = err = (got[rows_ok] - want[rows_ok]).abs().max().item() / want.abs().max().item()
    share = rows_ok.float().mean().item()
    if not err <= chip_smoke.F32_REL_TOL or share < 0.9:
        raise SystemExit(f"{key}: the fp32 kernel disagrees with its plain version ({err:.3e} on {share:.4f} of rows)")
    del got, want
    t["ms"] = chip_smoke.cuda_ms(run, 5 if row[0] in "56" else 3)
    if library:
        t["plain_ms"] = chip_smoke.cuda_ms(plain, 1)
    times[key] = t
    extra = "; ".join(f"{k[:-3]} {v:.3f} ms" for k, v in t.items() if k not in ("ms", "plain_ms"))
    print(f"  {key}: {t['ms']:.3f} ms (" + (extra + "; " if extra else "")
          + f"relative error {err:.3e} on {share:.4f} of rows)", flush=True)
    del x
    torch.cuda.empty_cache()
print("REPORT " + json.dumps({"errs": errs, "times": times}), flush=True)
"""
# the int8 LN-matmul kernel beside copies with one part cut out (edits of its namespace's source)
PARTS = r"""
import ctypes, json, subprocess, sys, tempfile
from pathlib import Path
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch.ops import _build
from cm3p_torch.ops.fused_ln_matmul import _SIGNATURES
from cm3p_torch.ops.quant import quantize_weight_int8

csrc = Path(sys.argv[1]) / "cm3p_torch" / "csrc"
text = (csrc / "fused_ln_matmul.cu").read_text()
head, body = text.split("namespace w8a8 {", 1)
CUTS = {
    "front end": [("    for (int r = 16 * wl; r < 16 * wl + 16; r += 2) {",
                   "    if (0) for (int r = 16 * wl; r < 16 * wl + 16; r += 2) {")],
    "products": [("        for (int k = 0; k < KQ / 32; ++k) wgmma_s8_n256(",
                  "        if (0) for (int k = 0; k < KQ / 32; ++k) wgmma_s8_n256(")],
    "epilogue": [("        if (n0 + 64 * sl >= N) break;", "        if (1) break;")],
    "TMA stores": [("          tma_store_2d(&map_out, ebuf, n0 + 64 * sl, r0 + 16 * wl);\n", "")],
    "W loads": [("            mbar_expect_tx(&full[stage], W_BYTES);\n            tma_load_2d_multicast(", "            mbar_arrive(&full[stage]);\n            if (0) tma_load_2d_multicast(")],
}
COPIES = {"kernel": [], **{f"without the {k}": [k] for k in CUTS},
          "the front end alone": ["products", "epilogue", "W loads"], "the W ring alone": ["front end", "products", "epilogue"]}
libs = {}
with tempfile.TemporaryDirectory() as tmp:
    procs = {}
    for n, (name, cuts) in enumerate(COPIES.items()):
        src = body
        for cut in cuts:
            for a, b in CUTS[cut]:
                if src.count(a) != 1:
                    raise SystemExit(f"the cut of the {cut} no longer matches csrc/fused_ln_matmul.cu")
                src = src.replace(a, b)
        path = Path(tmp) / f"part{n}.cu"
        path.write_text(head + "namespace w8a8 {" + src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(Path(tmp) / f"part{n}.so"), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), n)
    for name, (proc, n) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(Path(tmp) / f"part{n}.so"))
        lib.cm3p_ln_matmul_q.argtypes = _SIGNATURES["cm3p_ln_matmul_q"]
        lib.cm3p_ln_matmul_q.restype = ctypes.c_int
        libs[name] = lib
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
stream = torch.cuda.current_stream().cuda_stream
times = {}
for row, rows, d, n, ln in (("6", 323584, 768, 2304, True), ("6r", 323584, 768, 768, False)):
    x = (0.5 * torch.randn(rows, d, generator=gen, device=dev)).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    wq, sw = quantize_weight_int8((0.02 * torch.randn(n, d, generator=gen, device=dev)).to(torch.bfloat16))
    res = None if ln else (0.5 * torch.randn(rows, n, generator=gen, device=dev)).to(torch.bfloat16)
    out = torch.empty(rows, n, dtype=torch.bfloat16, device=dev)
    for turn in range(2):
        for name, lib in libs.items():
            def run(lib=lib):
                err = lib.cm3p_ln_matmul_q(x.data_ptr(), scale.data_ptr() if ln else None, None, wq.data_ptr(),
                                           sw.data_ptr(), None if res is None else res.data_ptr(), out.data_ptr(),
                                           None, rows, d, n, 1e-5, int(ln), stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
            times.setdefault(f"{row} {name}", []).append(chip_smoke.cuda_ms(run, 20))
    for name in libs:
        print(f"  row {row}, {name}: " + " / ".join(f"{t:.3f}" for t in times[f"{row} {name}"]) + " ms", flush=True)
    del x, wq, sw, res, out
print("REPORT " + json.dumps({"times": times}), flush=True)
"""
# the fp32 kernels beside copies with one part cut out or one choice changed (edits of csrc/)
F32_PARTS = r"""
import ctypes, json, shutil, subprocess, sys, tempfile
from pathlib import Path
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch.ops import _build
from cm3p_torch.ops.fused_ffn import _F32_SIGNATURES as FFN_SIGNATURES
from cm3p_torch.ops.attention import _F32_SIGNATURES as ATTN_SIGNATURES, key_tile_ranges, rope_k_f32, rope_tables
from cm3p_torch.ops.fused_ln_matmul import _F32_SIGNATURES as LNMM_SIGNATURES
from cm3p_torch.ops.quant import quantize_weight_int8

csrc = Path(sys.argv[1]) / "cm3p_torch" / "csrc"
ATTN_ROWS = ("1-f32", "1-f32 no rope", "1-f32 audio", "4-f32", "2-f32", "2-f32 metadata")
NEVER = "if (gv.x == -1234.5f) "  # a store the run never makes, so that what feeds it stays computed
CUT_FRONT = ("  for (int r = 16 * warp; r < 16 * warp + 16; r += FRONT_ROWS) {",
             "  if (0) for (int r = 16 * warp; r < 16 * warp + 16; r += FRONT_ROWS) {")
CUT_EPILOGUE = ("        if (r0 + r >= a.R) continue;\n        const float s = sa_s[r];\n        float* out_row",
                "        if (r0 + r >= 0) continue;\n        const float s = sa_s[r];\n        float* out_row")
# the fp32 attention at 8 query rows a thread: a block spans two query tiles of the key-tile ranges, so it walks
# the union of their ranges and each warp skips the tiles outside its own tile's range
RPT8 = [
    ("constexpr int RPT = 4; ", "constexpr int RPT = 8; "),
    ("constexpr int BQ = 64; ", "constexpr int TILE = 64;\nconstexpr int BQ = 128; "),
    ("constexpr int BLOCKS_PER_SM = 3;", "constexpr int BLOCKS_PER_SM = 2;"),
    ("static_assert(RPT == 4 && BQ == 16 * RPT,", "static_assert(BQ == 16 * RPT,"),
    ("  int kt_begin, kt_end;\n", "  int kt_begin, kt_end, w_begin = 0, w_end = 0;\n"),
    ('''    const long long t = (long long)b * ((L + BQ - 1) / BQ) + qt;
    kt_begin = p.tile_start[t];
    kt_end = kt_begin + p.tile_count[t];''',
     '''    const int nq = (L + TILE - 1) / TILE, t0 = q0 / TILE;
    kt_begin = 1 << 30, kt_end = 0;
    for (int t = t0; t < min(t0 + BQ / TILE, nq); ++t) {
      const int s = p.tile_start[(long long)b * nq + t], n = p.tile_count[(long long)b * nq + t];
      if (n > 0) kt_begin = min(kt_begin, s), kt_end = max(kt_end, s + n);
      if (t == wr0 / TILE) w_begin = s, w_end = s + n;
    }'''),
    ("(!WINDOW || (k0 <= wr1 + p.window && k0 + BK - 1 >= wr0 - p.window));",
     "(WINDOW ? (k0 <= wr1 + p.window && k0 + BK - 1 >= wr0 - p.window) : (kt >= w_begin && kt < w_end));"),
    ("        *reinterpret_cast<float4*>(sPt + (tx + 8 * j) * LDP + RPT * ty) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);",
     '''#pragma unroll
        for (int i = 0; i < RPT; i += 4)
          *reinterpret_cast<float4*>(sPt + (tx + 8 * j) * LDP + RPT * ty + i) =
              make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);'''),
    ('''        const float4 t = *reinterpret_cast<const float4*>(sPt + kk * LDP + RPT * ty);
        const float pv[RPT] = {t.x, t.y, t.z, t.w};''',
     '''        float pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; i += 4) {
          const float4 t = *reinterpret_cast<const float4*>(sPt + kk * LDP + RPT * ty + i);
          pv[i] = t.x, pv[i + 1] = t.y, pv[i + 2] = t.z, pv[i + 3] = t.w;
        }'''),
]
COPIES = {  # name -> ({file: [(text, replacement)]}, the rows it is timed on)
    "kernel": ({}, ("5r-f32", "5-f32", "6r-f32", "6-f32", "3-f32", "3q-f32", "3qq-f32", *ATTN_ROWS)),
    "attention products alone (no K / V copies after the first tile: wrong sums)": ({"attention_f32.cu": [
        ("    if (kt + 1 < kt_end) {\n      issue_rows<BK, LDQ>(sK", "    if (0) {\n      issue_rows<BK, LDQ>(sK"),
        ("    if (kt + 1 < kt_end) issue_rows<BK, D>(sV", "    if (0) issue_rows<BK, D>(sV")]}, ATTN_ROWS),
    "attention at 8 query rows a thread (128-query blocks, two an SM)": ({"attention_f32.cu": RPT8}, ATTN_ROWS),
    "attention without the padding-warp test": ({"attention_f32.cu": [
        ("  const bool has_rows = __any_sync(0xffffffffu, qr < L && p.qseg[(long long)b * L + qr] > 0);",
         "  const bool has_rows = qr == qr && wr0 < L;")]}, ATTN_ROWS),
    "fp32 products alone (no slice loads or stores: wrong sums)": ({"rows_f32.cuh": [
        ("    if (t + 1 < steps) fetch(t + 1);", "    if (0) fetch(t + 1);"),
        ("    if (t + 1 < steps) stash(t + 1);", "    if (0) stash(t + 1);")]}, ("5r-f32", "5-f32", "3-f32")),
    "fp32 LN-matmul at one block an SM": ({"fused_ln_matmul_f32.cu": [
        ("__launch_bounds__(ft::THREADS, 2) ln_matmul_kernel", "__launch_bounds__(ft::THREADS, 1) ln_matmul_kernel")]},
        ("5r-f32", "5-f32")),
    "8 values of K a slice": ({"rows_f32.cuh": [("constexpr int KS = 16;", "constexpr int KS = 8;")]},
                              ("5r-f32", "5-f32")),
    "int8 LN-matmul without its front end (wrong codes)": ({"fused_ln_matmul_f32.cu": [CUT_FRONT]}, ("6r-f32", "6-f32")),
    "int8 LN-matmul without its epilogue (no output)": ({"fused_ln_matmul_f32.cu": [CUT_EPILOGUE]}, ("6r-f32", "6-f32")),
    "int8 products alone (no front end, no epilogue)": ({"fused_ln_matmul_f32.cu": [CUT_FRONT, CUT_EPILOGUE]},
                                                        ("6r-f32", "6-f32")),
    "int8 LN-matmul with 4 stages at one block an SM": ({"fused_ln_matmul_f32.cu": [
        ("constexpr int Q_STAGES = 2;", "constexpr int Q_STAGES = 4;"),
        ("__launch_bounds__(ft::THREADS, 2) ln_matmul_q_kernel", "__launch_bounds__(ft::THREADS, 1) ln_matmul_q_kernel")]},
        ("6r-f32", "6-f32")),
    "FFN without g's round trip through the scratch (wrong sums)": ({"fused_ffn_f32.cu": [
        ("              *reinterpret_cast<float4*>(g + r * F + j) = gv;\n              m = fmaxf",
         "              " + NEVER + "*reinterpret_cast<float4*>(g + r * F + j) = gv;\n              m = fmaxf"),
        ("          *reinterpret_cast<float4*>(g + r * F + j) = gv;\n          if (W8A8_WO)",
         "          " + NEVER + "*reinterpret_cast<float4*>(g + r * F + j) = gv;\n          if (W8A8_WO)"),
        ("return __ldcg(reinterpret_cast<const float4*>(g + row * F + k)); };",
         "return make_float4((float)row, (float)k, 0.f, 1.f); };"),
        ("          const uint32_t q = quant4(__ldcg(reinterpret_cast<const float4*>(g + r * F + c)), sg, inv);",
         "          const uint32_t q = quant4(make_float4((float)r, (float)c, 0.f, 1.f), sg, inv);")]},
        ("3-f32", "3q-f32", "3qq-f32")),
    "FFN at one block an SM": ({"fused_ffn_f32.cu": [
        ("__launch_bounds__(ft::THREADS, 2) ffn_kernel", "__launch_bounds__(ft::THREADS, 1) ffn_kernel")]},
        ("3-f32", "3q-f32", "3qq-f32")),
}
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
stream = torch.cuda.current_stream().cuda_stream
times = {}
with tempfile.TemporaryDirectory() as tmp:
    procs, libs = {}, {}
    for n, (name, (edits, _)) in enumerate(COPIES.items()):
        d = Path(tmp) / f"copy{n}"
        shutil.copytree(csrc, d)
        for fname, reps in edits.items():
            text = (d / fname).read_text()
            for a, b in reps:
                if text.count(a) != 1:
                    raise SystemExit(f"{name}: the edit no longer matches csrc/{fname}")
                text = text.replace(a, b)
            (d / fname).write_text(text)
        rows_of = COPIES[name][1]
        srcs = [src for src, on in (("fused_ln_matmul_f32", any(r[0] in "56" for r in rows_of)),
                                    ("fused_ffn_f32", any(r[0] == "3" for r in rows_of)),
                                    ("attention_f32", any(r in ATTN_ROWS for r in rows_of))) if on]
        for src in srcs:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{src}.so"), str(d / f"{src}.cu")]
            procs[name, src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    for (name, src), (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: {src} build failed\n{log[-3000:]}")
        for kernel, regs, spills in chip_smoke.ptxas_report(log):
            if kernel.startswith("f32::"):
                print(f"  {name}, {kernel}: {regs}; {spills}", flush=True)
        lib = libs.setdefault(name, {})[src] = ctypes.CDLL(str(d / f"{src}.so"))
        sigs = {"fused_ln_matmul_f32": LNMM_SIGNATURES, "fused_ffn_f32": FFN_SIGNATURES, "attention_f32": ATTN_SIGNATURES}
        for fn, argtypes in sigs[src].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = 79 * 4096
    x = torch.randn(rows, 768, generator=gen, device=dev)
    scale = 1 + 0.1 * torch.randn(768, generator=gen, device=dev)
    ROWS = {"5r-f32": (768, False, False), "5-f32": (2304, True, False), "6r-f32": (768, False, True),
            "6-f32": (2304, True, True), "3-f32": (1152, False, False), "3q-f32": (1152, True, False),
            "3qq-f32": (1152, True, True)}
    for row, (n, opt1, opt2) in ROWS.items():
        names = [name for name, (_, rows_of) in COPIES.items() if row in rows_of]
        if row[0] in "56":
            w = 0.02 * torch.randn(n, 768, generator=gen, device=dev)
            wq, sw = quantize_weight_int8(w)
            res = None if opt1 else torch.randn(rows, n, generator=gen, device=dev)
            out = torch.empty(rows, n, device=dev)
            def run(lib):
                ln, resp = scale.data_ptr() if opt1 else None, None if res is None else res.data_ptr()
                if opt2:
                    return lib["fused_ln_matmul_f32"].cm3p_ln_matmul_q_f32(
                        x.data_ptr(), ln, None, wq.data_ptr(), sw.data_ptr(), resp, out.data_ptr(), None, rows, 768,
                        n, 1e-5, int(opt1), stream)
                return lib["fused_ln_matmul_f32"].cm3p_ln_matmul_f32(
                    x.data_ptr(), ln, None, w.data_ptr(), resp, out.data_ptr(), rows, 768, n, 1e-5, int(opt1), stream)
            one_call = (lambda: torch.addmm(res, x, w.t())) if res is not None else (lambda: x @ w.t())
        else:
            wi = 0.02 * torch.randn(2 * n, 768, generator=gen, device=dev)
            wo = 0.02 * torch.randn(768, n, generator=gen, device=dev)
            wiq, swi = quantize_weight_int8(wi)
            woq, swo = quantize_weight_int8(wo)
            wi_arg, swi_arg = (wiq, swi) if opt1 else (wi, None)
            wo_arg, swo_arg = (woq, swo) if opt2 else (wo, None)
            out = torch.empty(rows, 768, device=dev)
            scratch = {}
            for name in names:
                nb = ctypes.c_longlong(0)
                assert libs[name]["fused_ffn_f32"].cm3p_fused_ln_ffn_f32_scratch_bytes(
                    rows, 768, n, int(opt1), int(opt2), ctypes.byref(nb)) == 0
                scratch[name] = torch.empty(nb.value, dtype=torch.uint8, device=dev)
                print(f"  row {row}, {name}: scratch {nb.value} bytes", flush=True)
            def run(lib, name=None):
                sc = scratch[name]
                return lib["fused_ffn_f32"].cm3p_fused_ln_ffn_f32(
                    x.data_ptr(), scale.data_ptr(), None, wi_arg.data_ptr(), None if swi_arg is None else swi_arg.data_ptr(),
                    wo_arg.data_ptr(), None if swo_arg is None else swo_arg.data_ptr(), out.data_ptr(), None, None,
                    sc.data_ptr(), sc.numel(), rows, 768, n, 1e-5, int(opt1), int(opt2), stream)
            one_call = lambda: chip_smoke.ffn_composition(x, scale, None, wi, wo, 1e-5, (wiq, swi) if opt1 else None,
                                                          (woq, swo) if opt2 else None)
        for turn in range(2):
            for name in names:
                def call(name=name):
                    err = run(libs[name], name) if row[0] == "3" else run(libs[name])
                    if err:
                        raise SystemExit(f"{name}: CUDA error {err}")
                times.setdefault(f"{row} {name}", []).append(chip_smoke.cuda_ms(call, 5 if row[0] in "56" else 3))
            times.setdefault(f"{row} torch", []).append(chip_smoke.cuda_ms(one_call, 3))
        for name in (*names, "torch"):
            print(f"  row {row}, {name}: " + " / ".join(f"{t:.3f}" for t in times[f"{row} {name}"]) + " ms",
                  flush=True)
        del out
        torch.cuda.empty_cache()
    # the fp32 attention forms on the attn phase's segments (the segment form's k rotated by the pass beforehand)
    saved = torch.load(sys.argv[2])
    ones = torch.ones(saved["audio_b"], saved["audio_l"], dtype=torch.int32, device=dev)
    packed, seg10, meta = (saved[k].to(dev).contiguous() for k in ("seg_packed", "seg10", "meta_seg"))
    SHAPES = {"1-f32": (packed, 12, 64, 10000.0), "1-f32 no rope": (packed, 12, 64, None),
              "1-f32 audio": (ones, 8, 64, 10000.0), "4-f32": (seg10, 12, 192, 10000.0),
              "2-f32": (packed, 12, None, 160000.0), "2-f32 metadata": (meta, 4, None, None)}
    for row, (seg, heads, window, theta) in SHAPES.items():
        names = [name for name, (_, rows_of) in COPIES.items() if row in rows_of]
        b, length = seg.shape
        q, k, v = torch.randn(b, length, 3, heads, 64, generator=gen, device=dev).unbind(2)
        out = torch.empty(b, length, heads, 64, device=dev)
        tables = rope_tables(length, 64, theta, str(dev)) if theta is not None else None
        tabs = (tables[0].data_ptr(), tables[1].data_ptr()) if tables is not None else (None, None)
        if window is None:
            start, count = key_tile_ranges(seg, seg)
            k = rope_k_f32(k, theta) if theta is not None else k
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), k.stride(0), v.stride(0), q.stride(1),
                k.stride(1), v.stride(1), seg.data_ptr(), seg.data_ptr(), *tabs)
        def run(lib):
            if window is None:
                return lib["attention_f32"].cm3p_segment_attention_f32(
                    *args, start.data_ptr(), count.data_ptr(), out.data_ptr(), b, length, length, heads, stream)
            return lib["attention_f32"].cm3p_window_attention_f32(*args, out.data_ptr(), b, length, heads, window,
                                                                  stream)
        for turn in range(2):
            for name in names:
                def call(name=name):
                    err = run(libs[name])
                    if err:
                        raise SystemExit(f"{name}: CUDA error {err}")
                times.setdefault(f"{row} {name}", []).append(chip_smoke.cuda_ms(call, 5 if window else 3))
        for name in names:
            print(f"  row {row}, {name}: " + " / ".join(f"{t:.3f}" for t in times[f"{row} {name}"]) + " ms",
                  flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
print("REPORT " + json.dumps({"times": times}), flush=True)
"""
# a timing line of check_wo_kernels: form, shape, ms, ..., the unfused pair's ms
WO_LINE = re.compile(r"^\s*(\w+)\s+(packed|audio)\b.*?: ([0-9.]+) ms \(plain .* ([0-9.]+) ms\)$")


def wo_times(stdout: str) -> dict[str, dict[str, float]]:
    """``{"<form> <shape>": {"ms": ..., "pair_ms": ...}}`` from a ``wo`` turn's timing lines."""
    times = {}
    for line in stdout.splitlines():
        m = WO_LINE.match(line)
        if m:
            times[f"{m.group(1)} {m.group(2)}"] = {"ms": float(m.group(3)), "pair_ms": float(m.group(4))}
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="root of the other checkout (every phase but parts)")
    parser.add_argument("--phase", choices=("quant", "wo", "ffn", "attn", "bwd", "f32", "f32attn", "parts",
                                            "f32parts"),
                        default="quant",
                        help="the kernels to compare")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out", help="directory for the logs")
    args = parser.parse_args()
    alone = args.phase in ("parts", "f32parts")  # this tree only
    if (args.parent is None) != alone:
        parser.error("--parent is needed by every phase but parts and f32parts, which take none")
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    turn_args = []
    if args.phase in ("wo", "attn", "bwd", "f32attn", "f32parts"):
        inputs = (args.out / f"{'wo' if args.phase == 'wo' else 'attn'}_inputs.pt").resolve()
        prep = subprocess.run([sys.executable, "-c", WO_INPUTS if args.phase == "wo" else ATTN_INPUTS, str(ROOT),
                               str(inputs)], cwd=ROOT, capture_output=True, text=True, timeout=900)
        if prep.returncode != 0:
            print((prep.stdout + prep.stderr)[-3000:], file=sys.stderr)
            return 1
        turn_args = [str(inputs)]
    if alone:
        run = subprocess.run([sys.executable, "-c", PARTS if args.phase == "parts" else F32_PARTS, str(ROOT),
                              *turn_args], cwd=ROOT, capture_output=True, text=True, timeout=900)
        (args.out / f"{args.phase}.log").write_text(run.stdout + run.stderr)
        print(run.stdout if run.returncode == 0 else (run.stdout + run.stderr)[-3000:], flush=True)
        return run.returncode
    script, prefix = {"quant": (QUANT_TURN, "compare"), "wo": (WO_TURN, "compare_wo"),
                      "ffn": (FFN_TURN, "compare_ffn"), "attn": (ATTN_TURN, "compare_attn"),
                      "bwd": (BWD_TURN, "compare_bwd"), "f32": (F32_TURN, "compare_f32"),
                      "f32attn": (F32ATTN_TURN, "compare_f32attn")}[args.phase]
    results = []
    for turn, label in enumerate(ORDER):
        tree = (args.parent if label == "parent" else ROOT).resolve()
        t0 = time.perf_counter()
        extra = [str(int(turn == ORDER.index("change")))] if args.phase in ("attn", "bwd", "f32", "f32attn") else []
        if args.phase == "f32":
            extra.append(json.dumps(F32_SHAPES))
        run = subprocess.run([sys.executable, "-c", script, str(tree), *turn_args, *extra], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        (args.out / f"{prefix}_{turn}_{label}.log").write_text(run.stdout + run.stderr)
        print(f"== {label} (turn {turn}) rc={run.returncode} {time.perf_counter() - t0:.1f} s", flush=True)
        for line in run.stdout.splitlines():
            if " ms (" in line:
                print("   ", line.strip(), flush=True)
        report = [line[7:] for line in run.stdout.splitlines() if line.startswith("REPORT ")]
        if run.returncode != 0 or not report:
            print((run.stdout + run.stderr)[-3000:], file=sys.stderr)
            return 1
        result = {"tree": label, **json.loads(report[0])}
        if args.phase == "wo":
            result["times"] = wo_times(run.stdout)
        results.append(result)
    (args.out / f"{prefix}.json").write_text(json.dumps({"card": card, "turns": results}, indent=1))
    if args.phase == "ffn":
        from chip_smoke import ffn_bound_ms, ffn_q_bound_ms

        for key, t in results[0]["times"].items():
            shape = (t["rows"], t["d"], t["f"])
            bound = ffn_bound_ms(*shape)[0] if key.startswith("fused_ln_ffn ") else ffn_q_bound_ms(*shape, True, True)[0]
            print(f"{key}: ms " + ", ".join(f"{r['tree']} {r['times'][key]['ms']:.3f}" for r in results)
                  + "; composition " + ", ".join(f"{r['times'][key]['composition_ms']:.3f}" for r in results)
                  + f"; bound {bound:.3f}", flush=True)
        return 0
    if args.phase == "attn":
        lib = results[ORDER.index("change")]["library"]
        for key, row in lib.items():
            line = f"{key}: ms " + ", ".join(f"{r['tree']} {r['times'][key]['ms']:.3f}" for r in results)
            for part, label in (("no_rope_ms", "without rope"), ("ranges_ms", "key-tile ranges")):
                if part in results[0]["times"][key]:
                    line += f"; {label} " + ", ".join(f"{r['times'][key][part]:.3f}" for r in results)
            print(line + f"; plain {row['plain_ms']:.3f}; bound {row['bound_ms']:.3f} ({row['bound_by']}); "
                  f"SDPA {row['sdpa_ms']:.3f}", flush=True)
        return 0
    if args.phase == "f32attn":
        lib = results[ORDER.index("change")]["library"]
        for key, row in lib.items():
            print(f"{key}: ms " + ", ".join(f"{r['tree']} {r['times'][key]['ms']:.3f}" for r in results)
                  + f"; plain {row['plain_ms']:.3f}; bound {row['bound_ms']:.3f} ({row['bound_by']}); "
                  f"fp32 SDPA {row['sdpa_ms']:.3f}", flush=True)
        return 0
    if args.phase == "bwd":
        lib = results[ORDER.index("change")]["library"]
        for key, row in lib.items():
            print(f"{key}: ms " + ", ".join(f"{r['tree']} {r['times'][key]['ms']:.3f}" for r in results)
                  + f"; plain {row['plain_ms']:.3f}; bound {row['bound_ms']:.3f} ({row['bound_by']}); "
                  f"SDPA backward {row['sdpa_bwd_ms']:.3f}", flush=True)
        return 0
    if args.phase == "f32":
        from chip_smoke import _f32_bound

        first = results[ORDER.index("change")]["times"]
        for (row, d, n, opt1, opt2, rows), key in zip(F32_SHAPES, first):
            line = f"{key}: ms " + ", ".join(f"{r['tree']} {r['times'][key]['ms']:.3f}" for r in results)
            for part, label in (("addmm_ms", "fp32 torch.addmm"), ("composition_ms", "the unfused fp32 composition")):
                if part in first[key]:
                    line += f"; {label} " + ", ".join(f"{r['times'][key][part]:.3f}" for r in results)
            if row[0] in "56":  # LN-matmul: x in, W, out (and the residual) once
                ops_ = 2 * rows * d * n
                bytes_moved = rows * d * 4 + n * d * (1 if opt2 else 4) + rows * n * 4 * (1 if opt1 else 2) + d * 4
                bound, by = _f32_bound(bytes_moved, 0 if opt2 else ops_, ops_ if opt2 else 0)
            else:  # FFN: x in, out, the weights once
                wi_ops, wo_ops = 4 * rows * d * n, 2 * rows * d * n
                bytes_moved = 2 * rows * d * 4 + 2 * n * d * (1 if opt1 else 4) + d * n * (1 if opt2 else 4) + d * 4
                bound, by = _f32_bound(bytes_moved, (0 if opt1 else wi_ops) + (0 if opt2 else wo_ops),
                                       (wi_ops if opt1 else 0) + (wo_ops if opt2 else 0))
            print(line + f"; plain {first[key]['plain_ms']:.3f}; bound {bound:.3f} ({by})", flush=True)
        return 0
    if args.phase == "wo":
        for key in results[0]["times"]:
            print(f"{key}: ms " + ", ".join(f"{r['tree']} {r['times'][key]['ms']:.3f}" for r in results)
                  + "; unfused pair " + ", ".join(f"{r['times'][key]['pair_ms']:.3f}" for r in results), flush=True)
        return 0
    def each(name, key):  # a report entry of every turn; "-" where a tree does not report it
        values = [r["report"].get(name, {}).get(key) for r in results]
        return ", ".join(f"{r['tree']} " + ("-" if v is None else f"{v:.3f}") for r, v in zip(results, values))

    for name in dict.fromkeys(n for r in results for n in r["report"]):
        print(f"{name}: ms " + each(name, "ms"), flush=True)
        if any(r["report"].get(name, {}).get("library_ms") is not None for r in results):
            print(f"{name}, one PyTorch call: ms " + each(name, "library_ms"), flush=True)
    from chip_smoke import lnmm_bound_ms

    for name in results[0]["audio"]:
        wo = name.endswith("_wo")
        bound, by = lnmm_bound_ms(AUDIO_ROWS, 512, 512 if wo else 1536, wo, "_q" in name)
        print(f"{name} at {AUDIO_ROWS} x 512: ms " + ", ".join(f"{r['tree']} {r['audio'][name]:.3f}" for r in results)
              + f"; bound {bound:.3f} ({by})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
