"""Batch embedding extraction to parquet: the port's ``extract_beatmap_embeddings.py``.

    python -m cm3p_torch.extract --model-dir out/model --beatmap-files path/to/maps --output embeddings.parquet
    python -m cm3p_torch.extract --model-dir out/model --dataset-path ROOT --output embeddings.parquet

Iterates loose ``.osu`` / ``.osz`` files (``--beatmap-files``) or MMRS dataset
roots (``--dataset-path``: ``metadata.parquet`` beside ``data/<set folder>/``,
every beatmap of the filtered metadata, no augmentation) through the processor
(optionally in worker processes), packs the windows into fixed rows with segment ids, runs
the packed forward on each flush of ``--flush-rows`` rows, mean-pools the
per-window embeddings per beatmap id, re-normalises, joins the metadata
columns and writes a parquet file, optionally merged into an existing one
(new rows win). The rows follow the dataset's order (beatmapsets in order of
first appearance, their beatmaps in order), whatever order the loader workers
deliver them in. Runs on ``cuda`` unless ``--device cpu``; without a GPU it
raises unless asked for the CPU.

The model computes with the JAX tool's default options unless ``--precise``:
``w8a8`` (int8 Wi in every MLP half-block) and ``fused_wo`` (the attention
kernels apply the out-projection and its residual add themselves, which
changes no number). ``--precise`` turns both off (exact bf16). ``--no-fused-wo``
turns the epilogue off (the JAX tool's ``CM3P_FUSED_WO=0``), ``--fused-wo-q``
runs it in int8, ``--fused-lnmm`` adds the fused LN-matmul routes of the QKV
and out-projections (int8 QKV under ``w8a8``; the epilogue keeps the
out-projection where it applies), ``--w8a8-wo`` the int8 Wo forms and
``--xla-int8`` the W8A8 product outside any kernel (``int8_dot``) on every
projection that no fused route takes; see
:class:`~cm3p_torch.models.EncoderOptions`. ``--attn-impl xla`` is the JAX
tool's route without its kernels: the full model with the plain version of
every op and no fused route (its options reduce to ``--xla-int8``), a
no-kernel reference run of the model.

:func:`extract_embeddings` is the core and needs no pandas; the DataFrame and
parquet work lives in :func:`write_output`.

The host front end is the JAX tool's: beatmaps parse, lower and tokenize in the
host library's C++ and WAVE files decode there (``--no-native``: the Python path
only). On the packed path with audio the mel travels in the compact form, dense
frames plus one tail value per window, and the full (windows, 80, 3000) mel is
rebuilt on the device (``--no-compact-mel``: the full fp32 mel). ``--mel-wire``
picks the compact form: ``bf16`` (the dense block in the towers' dtype, bf16 for
the default model), ``int8`` (per-window symmetric codes, dequantised on the
device) or ``pcm`` (the windows' waveforms; the log-mel runs on the device,
:class:`~cm3p_torch.audio.device_mel.DeviceLogMel`). ``--int8-ipc`` sends the
mel from the loader workers as int8; with ``--mel-wire int8`` the codes go to
the device as they are, on the other wires they are dequantised on the host.

Data parallel, one rank per GPU (the JAX tool's mesh over the local devices):
``torchrun --nproc-per-node N -m cm3p_torch.extract ...``. Each rank takes a
strided share of whole beatmaps (a beatmap's windows and its mean-pool stay on
one rank) through its own loader workers; rank 0 gathers the per-beatmap
embeddings and alone writes the parquet (``--merge-with`` included).
``--batch-size`` is then the rows of one step across all ranks, rounded up to
a multiple of the world size; ``--no-mesh`` under the launcher leaves the
whole job to rank 0 on one device.

Not ported: what only exists for XLA (the AOT executable cache, ``--prewarm``, shape padding against recompiles).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path
from typing import Any, Iterable, Optional, Union

import numpy as np
import torch

from .audio.device_mel import DeviceLogMel
from .configs import CM3PConfig, tiny_cm3p_config
from .data import (
    BeatmapFilesDataset,
    BeatmapFilesDatasetFactory,
    DatasetConfig,
    MmrsDataset,
    MmrsDatasetFactory,
    SampleLoader,
    batched_loader,
)
from .data.loader import _IPC_SCALE, _dequantize_features_from_ipc
from .inference import load_model, load_pretrained, resolve_device
from .interop import init_weights
from .models import CM3PBeatmapModel, EncoderOptions
from .parallel import distributed
from .processing.packing import pack_windows
from .processing.processor import CM3PProcessor

logger = logging.getLogger(__name__)

DEFAULT_OPTIONS = EncoderOptions(w8a8=True, fused_wo=True)  # the JAX tool's default
_DROPPED_KEYS = ("metadata_ids", "metadata_attention_mask", "metadata_variation_classes", "labels")
MEL_WIRES = ("bf16", "int8", "pcm")


def configure_mel_wire(processor: CM3PProcessor, pack: bool, include_audio: bool, compact: bool = True,
                       mel_wire: str = "bf16") -> str:
    """Set the processor's audio kwargs for the mel wire and return the wire the run uses: ``full``,
    ``bf16``, ``int8`` or ``pcm``.

    The compact forms need the packed path with audio and windows whose zero tail lies inside one
    30 s chunk with no dither (the JAX tool's conditions); otherwise the full mel travels.
    """
    if mel_wire not in MEL_WIRES:
        raise ValueError(f"mel_wire must be one of {MEL_WIRES}, got {mel_wire!r}")
    fe = processor.audio_feature_extractor
    ak = processor.default_kwargs["audio_kwargs"]
    wls = processor.default_kwargs["beatmap_kwargs"].get("window_length_sec", 30.0)
    chunk_samples = fe.chunk_length * fe.sampling_rate
    if not (
        pack and include_audio and compact and not fe.dither
        and ak.get("pad_to_multiple_of", 480000) == chunk_samples
        and wls * ak.get("sampling_rate", fe.sampling_rate) + fe.n_fft <= chunk_samples
    ):
        if include_audio and mel_wire != "bf16":
            logger.info("--mel-wire %s needs the packed compact path; the full mel travels", mel_wire)
        return "full"
    if mel_wire == "pcm":
        ak.pop("compact_tail", None)
        ak["pcm_wire"] = True
    else:
        ak.pop("pcm_wire", None)
        ak["compact_tail"] = True
    return mel_wire


def default_batch_size(pack: bool, row_len: int, device: torch.device) -> int:
    """Packed rows (the JAX tool's 192 x 4096 token budget at any row length,
    32..256 rows) or dense windows (32) per device batch; 16 at most on the CPU."""
    size = min(256, max(32, (192 * 4096 // row_len) // 32 * 32)) if pack else 32
    return min(size, 16) if device.type == "cpu" else size


def _beatmap_key(bid) -> int:
    return int(bid[-1]) if isinstance(bid, (tuple, list)) else int(bid)


@torch.no_grad()
def extract_embeddings(
    model: CM3PBeatmapModel,
    processor: CM3PProcessor,
    samples: Iterable[dict],
    device: Optional[Union[str, torch.device]] = None,
    pack: bool = True,
    batch_size: int = 0,
    flush_rows: int = 0,
    stats: Optional[dict] = None,
    windows_out: Optional[dict] = None,
    mel_wire: str = "bf16",
) -> dict[int, np.ndarray]:
    """One unit-norm embedding per beatmap id from a stream of window samples.

    ``samples`` yields the dataset's per-window dicts (``input_ids``,
    ``attention_mask``, ``beatmap_id``, optionally ``input_features``). Packed
    (default): windows are first-fit into rows of the processor's
    ``max_length``; a device batch is dispatched as soon as ``flush_rows`` rows
    have filled (default min(64, ``batch_size``)), never more than
    ``batch_size`` rows, and the previous batch is fetched while the next is
    being assembled. Dense (``pack=False``): ``batch_size`` windows per call.
    Window embeddings are summed per beatmap id, divided by the count and
    re-normalised. ``stats`` receives counts and seconds per stage (and the
    device milliseconds of the forwards on CUDA), the mel bytes sent to the
    device (``wire_bytes``) and, where ``samples`` has them (``SampleLoader``),
    its ``host_counts``; ``windows_out`` receives each beatmap's window
    embeddings in arrival order.

    The mel travels as the samples carry it (``mel_wire`` as
    :func:`configure_mel_wire` returned it): full ``input_features``, sent in
    fp32 and cast on the device; compact dense frames plus
    ``input_features_tail``, sent in the towers' dtype (``bf16``) or as int8
    codes with a per-window scale (``int8``; codes a loader worker made,
    ``SampleLoader(int8_ipc=True)``, are taken as they are, and dequantised
    on the host for the other wires); or ``input_features_pcm`` (``pcm``), turned into the
    compact form by :class:`DeviceLogMel`. The compact forms are
    rebuilt into the full (windows, n_mels, max_source_positions) mel on the
    device.
    """
    if mel_wire not in ("full",) + MEL_WIRES:
        raise ValueError(f"mel_wire must be 'full' or one of {MEL_WIRES}, got {mel_wire!r}")
    device = resolve_device(device)
    param = model.beatmap_projection.weight
    if param.device.type != device.type:
        raise ValueError(f"model lies on {param.device}, inputs were asked on {device}")
    wire = param.dtype  # mel features travel in the towers' weight dtype
    seq_len = processor.default_kwargs["beatmap_kwargs"].get("max_length", 4000)
    batch_size = batch_size or default_batch_size(pack, seq_len, device)
    flush_rows = flush_rows or min(64, batch_size)
    pad_id = processor.beatmap_tokenizer.pad_token_id
    accumulator: dict[Any, dict[str, Any]] = {}
    stage = {"loader": 0.0, "pack": 0.0, "dispatch": 0.0, "drain": 0.0}
    counts = {"windows": 0, "tokens": 0, "flushes": 0, "rows": 0, "device_ms": 0.0, "wire_bytes": 0}
    msp = processor.default_kwargs["audio_kwargs"].get("max_source_positions", 3000)
    fe = processor.audio_feature_extractor
    device_mel = (DeviceLogMel(fe.feature_size, fe.sampling_rate, fe.hop_length, fe.n_fft, device)
                  if mel_wire == "pcm" else None)
    inflight: list = []
    t0 = time.perf_counter()

    def accumulate(embeds: np.ndarray, ids: list) -> None:
        for i, bid in enumerate(ids):
            key = _beatmap_key(bid)
            slot = accumulator.get(key)
            if slot is None:
                accumulator[key] = {"sum": embeds[i].copy(), "count": 1}
            else:
                slot["sum"] += embeds[i]
                slot["count"] += 1
            if windows_out is not None:
                windows_out.setdefault(key, []).append(embeds[i].copy())

    def to_dev(array, dtype):
        return torch.as_tensor(np.asarray(array), device=device).to(dtype)

    def features(batch: list[dict]) -> Optional[torch.Tensor]:
        """The windows' full mel on the device from the form the samples carry."""
        if mel_wire != "int8":  # int8 codes from the loader's queue hop go to the device only on the int8 wire
            batch = [_dequantize_features_from_ipc(dict(b)) if _IPC_SCALE in b else b for b in batch]
        first = batch[0]
        if "input_features_pcm" in first:
            if mel_wire != "pcm":
                raise ValueError("samples carry PCM windows: pass mel_wire='pcm'")
            pcm = torch.from_numpy(np.stack([np.asarray(b["input_features_pcm"], np.float32) for b in batch]))
            counts["wire_bytes"] += pcm.nbytes
            dense, tail = device_mel(pcm.to(device))
            dense, tail = dense.to(wire), tail.to(wire)
        elif "input_features_tail" in first:
            tail = to_dev(np.asarray([b["input_features_tail"] for b in batch], np.float32), wire)
            counts["wire_bytes"] += tail.numel() * 4
            if mel_wire == "int8":
                codes = np.empty((len(batch),) + np.shape(first["input_features"]), np.int8)
                scales = np.empty(len(batch), np.float32)
                for i, b in enumerate(batch):
                    f = np.asarray(b["input_features"])
                    if f.dtype == np.int8:  # a loader worker quantised it with the same absmax scale
                        codes[i], scales[i] = f, b[_IPC_SCALE]
                        continue
                    f = np.asarray(f, np.float32)
                    s = float(np.max(np.abs(f))) / 127.0 or 1.0
                    scales[i] = s
                    codes[i] = np.rint(f / s).astype(np.int8)
                counts["wire_bytes"] += codes.nbytes + scales.nbytes
                dense = to_dev(codes, wire) * to_dev(scales, wire)[:, None, None]
            else:
                # numpy has no bfloat16: the host buffer is a torch tensor in the towers' dtype, each
                # window rounded as it is copied in (the same rounding as a cast on the device)
                host = torch.empty((len(batch),) + np.shape(first["input_features"]), dtype=wire)
                for i, b in enumerate(batch):
                    host[i] = torch.from_numpy(np.asarray(b["input_features"], np.float32))
                counts["wire_bytes"] += host.numel() * host.element_size()
                dense = host.to(device)
        elif "input_features" in first:
            full = np.stack([np.asarray(b["input_features"], np.float32) for b in batch])
            counts["wire_bytes"] += full.nbytes
            return to_dev(full, wire)
        else:
            return None
        w, n_mels, f_cap = dense.shape
        # rebuild the exact full mel: the dense frames, then each window's tail value to max_source_positions
        return torch.cat([dense, tail[:, None, None].expand(w, n_mels, msp - f_cap)], dim=2)

    def dispatch(call, n: int, ids: list) -> None:
        t_dispatch = time.perf_counter()
        events = None
        if device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        out = call()
        if events:
            events[1].record()
        stage["dispatch"] += time.perf_counter() - t_dispatch
        # double-buffer: leave this batch in flight and fetch the previous one
        inflight.append((out, n, ids, events))
        if len(inflight) > 1:
            drain(inflight.pop(0))
        counts["windows"] += n
        counts["flushes"] += 1

    def drain(item) -> None:
        out, n, ids, events = item
        t_drain = time.perf_counter()
        embeds = out.float().cpu().numpy()[:n]
        if events:
            counts["device_ms"] += events[0].elapsed_time(events[1])
        stage["drain"] += time.perf_counter() - t_drain
        accumulate(embeds, ids)

    def flush(pending: list) -> None:
        if not pending:
            return
        t_flush = time.perf_counter()
        seqs = [seq for seq, _ in pending]
        packed = pack_windows(seqs, seq_len, pad_id=pad_id)
        if packed["input_ids"].shape[0] > batch_size and len(pending) > 1:
            # the arrival-order simulation under-estimates rows when first-fit
            # fragments: bisect so that no device batch exceeds the row budget
            stage["pack"] += time.perf_counter() - t_flush
            mid = len(pending) // 2
            flush(pending[:mid])
            flush(pending[mid:])
            return
        args = dict(
            input_ids=to_dev(packed["input_ids"], torch.int64),
            segment_ids=to_dev(packed["segment_ids"], torch.int32),
            window_rows=to_dev(packed["window_to_row"], torch.int64),
            window_segments=to_dev(packed["window_segment"], torch.int64),
            input_features=features([sample for _, sample in pending]),
        )
        rows = packed["input_ids"].shape[0]
        counts["rows"] += rows
        counts["tokens"] += int(sum(len(s) for s in seqs))
        stage["pack"] += time.perf_counter() - t_flush
        logger.info("flush: rows=%d windows=%d", rows, len(seqs))
        dispatch(lambda: model.get_packed_beatmap_features(**args, normalize=True), len(seqs),
                 [sample.get("beatmap_id") for _, sample in pending])

    sample_it = iter(samples)

    def next_item(it):
        t_wait = time.perf_counter()
        item = next(it, None)
        stage["loader"] += time.perf_counter() - t_wait
        return item

    if pack:
        pending: list = []
        sim_space: list[int] = []  # free tokens per simulated packed row, in arrival order
        while (sample := next_item(sample_it)) is not None:
            length = int(np.asarray(sample["attention_mask"]).sum())
            seq = np.asarray(sample["input_ids"])[:length]
            need = min(len(seq), seq_len)
            for r, free in enumerate(sim_space):
                if free >= need:
                    sim_space[r] = free - need
                    break
            else:
                if len(sim_space) >= flush_rows and pending:
                    flush(pending)
                    pending, sim_space = [], []
                sim_space.append(seq_len - need)
            pending.append((seq, sample))
        flush(pending)
    else:
        batch_it = batched_loader(sample_it, batch_size, drop_last=False)
        while (batch := next_item(batch_it)) is not None:
            if "input_features_tail" in batch or "input_features_pcm" in batch:
                raise ValueError("the compact and PCM mel wires run on the packed path only")
            ids = batch.pop("beatmap_id")
            _dequantize_features_from_ipc(batch)
            for key in _DROPPED_KEYS:
                batch.pop(key, None)
            args = dict(
                input_ids=to_dev(batch["input_ids"], torch.int64),
                attention_mask=to_dev(batch["attention_mask"], torch.int32),
                input_features=to_dev(batch["input_features"], wire) if "input_features" in batch else None,
            )
            if "input_features" in batch:
                counts["wire_bytes"] += np.asarray(batch["input_features"], np.float32).nbytes
            counts["tokens"] += int(np.asarray(batch["attention_mask"]).sum())
            counts["rows"] += len(ids)
            dispatch(lambda: model.get_beatmap_features(**args, normalize=True), len(ids), np.asarray(ids).tolist())
    while inflight:
        drain(inflight.pop(0))

    dt = time.perf_counter() - t0
    logger.info(
        "%s %d window embeddings in %.1fs (%.1f windows/s)",
        "Packed-extracted" if pack else "Extracted", counts["windows"], dt, counts["windows"] / max(dt, 1e-9),
    )
    logger.info(
        "Stage breakdown: %s (accounted %.1fs of %.1fs wall)",
        ", ".join(f"{k} {v:.1f}s" for k, v in stage.items()), sum(stage.values()), dt,
    )
    if stats is not None:
        stats.update(counts, seconds=dt, stage_seconds=stage)
        host_counts = getattr(samples, "host_counts", None)
        if host_counts is not None:
            stats["host"] = dict(host_counts)
    if windows_out is not None:
        for key, chunks in windows_out.items():
            windows_out[key] = np.stack(chunks)

    # mean-pool per beatmap + re-normalize
    out: dict[int, np.ndarray] = {}
    for key, slot in accumulator.items():
        mean_vec = slot["sum"] / slot["count"]
        norm = float((mean_vec**2).sum() ** 0.5)
        out[key] = mean_vec / norm if norm > 0 else mean_vec
    return out


def write_output(embeddings: dict[int, np.ndarray], metadata, output, merge_with=None) -> None:
    """Join the embeddings with the metadata table and write the parquet file.

    ``metadata`` is the dataset's DataFrame indexed by (BeatmapSetId, Id). With
    ``merge_with`` the rows of that existing parquet are kept except where this
    run produced a row with the same ``Id``.
    """
    import pandas as pd

    rows = [{"beatmap_id": int(bid), "embedding": vec.tolist()} for bid, vec in embeddings.items()]
    embeddings_df = pd.DataFrame(rows)

    meta_df = metadata.reset_index()
    if "Id" in meta_df.columns:
        meta_df["Id"] = meta_df["Id"].astype("int64")
        merged_df = embeddings_df.merge(meta_df, left_on="beatmap_id", right_on="Id", how="left")
    else:
        merged_df = embeddings_df

    final_df = merged_df
    if merge_with:
        try:
            existing_df = pd.read_parquet(merge_with)
            existing_df["Id"] = existing_df["Id"].astype("int64")
            for col in merged_df.columns:
                if col not in existing_df.columns:
                    existing_df[col] = pd.NA
            existing_idx = existing_df.set_index("Id").reindex(columns=merged_df.columns.drop("Id"))
            merged_idx = merged_df.set_index("Id").reindex(columns=existing_idx.columns)
            final_df = merged_idx.combine_first(existing_idx).reset_index()
            logger.info("Merged: existing=%d new=%d result=%d", len(existing_df), len(merged_df), len(final_df))
        except Exception as e:
            logger.warning("Merge with %s failed: %s", merge_with, e)

    output_path = Path(output)
    final_df.to_parquet(output_path, index=False)
    logger.info("Saved %d beatmap embeddings to %s", len(final_df), output_path.resolve())


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m cm3p_torch.extract", description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-dir", default=None, help="HF-layout model dir (config.json + model.safetensors)")
    parser.add_argument("--processor-dir", default=None, help="saved processor dir")
    parser.add_argument("--dataset-path", action="append", default=None, help="MMRS dataset root (repeatable)")
    parser.add_argument("--beatmap-files", action="append", default=None,
                        help=".osu/.osz files or dirs (repeatable)")
    parser.add_argument("--output", required=True, help="output parquet")
    parser.add_argument("--merge-with", default=None, help="existing embeddings parquet to merge into")
    parser.add_argument("--batch-size", type=int, default=0,
                        help="device batch cap: packed rows (default: a 192 x 4096 token budget) or dense windows (32)")
    parser.add_argument("--flush-rows", type=int, default=0,
                        help="packed rows that trigger a device batch (default min(64, --batch-size))")
    parser.add_argument("--num-workers", type=int, default=0, help="loader worker processes (0 = inline)")
    parser.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                        help="weight and activation dtype (default bfloat16; float32 with --tiny-model)")
    parser.add_argument("--no-audio", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    parser.add_argument("--attn-impl", default="pallas", choices=["pallas", "xla"],
                        help="pallas (default): the kernels; xla: the plain version of every op and no fused "
                        "route, options but --xla-int8 dropped (not with --tiny-model, whose route is plain)")
    parser.add_argument("--max-length", type=int, default=None, help="override beatmap token max_length")
    parser.add_argument("--window-length", type=float, default=None,
                        help="override window_length_sec; the stride follows unless --window-stride is given")
    parser.add_argument("--window-stride", type=float, default=None, help="override window_stride_sec")
    parser.add_argument("--tiny-model", action="store_true",
                        help="seeded random tiny model (smoke runs; plain PyTorch ops, no kernel)")
    parser.add_argument("--no-pack", dest="pack", action="store_false",
                        help="per-window dense batches instead of packed rows")
    parser.add_argument("--precise", action="store_true",
                        help="exact bf16 math: turn the default options (int8 FFN Wi, the attention kernels' "
                        "out-projection epilogue) off")
    parser.add_argument("--no-fused-wo", dest="fused_wo", action="store_false",
                        help="out-projection and residual add outside the attention kernels")
    parser.add_argument("--fused-wo-q", action="store_true",
                        help="the attention kernels' out-projection epilogue in int8 (not with --precise or "
                        "--no-fused-wo)")
    parser.add_argument("--fused-lnmm", action="store_true",
                        help="fused LN-matmul kernels for the QKV projection (int8 unless --precise) and the "
                        "out-projection with its residual where the attention epilogue does not apply")
    parser.add_argument("--w8a8-wo", action="store_true",
                        help="int8 Wo in the MLP and, with --fused-lnmm, in the attention out-projection")
    parser.add_argument("--xla-int8", action="store_true",
                        help="W8A8 outside the kernels (int8_dot) on every projection no fused route takes: QKV "
                        "and the out-projection there, and the MLP on the xla route")
    parser.add_argument("--mel-wire", default="bf16", choices=MEL_WIRES,
                        help="host-to-device form of the compact mel: bf16 (the dense frames in the towers' "
                        "dtype), int8 (per-window symmetric codes, dequantised on the device) or pcm (the "
                        "windows' waveforms, log-mel on the device)")
    parser.add_argument("--no-compact-mel", dest="compact_mel", action="store_false",
                        help="send the full 80 x 3000 fp32 mel of each window")
    parser.add_argument("--int8-ipc", action="store_true",
                        help="loader workers send the mel as int8 codes and a per-window scale")
    parser.add_argument("--no-native", dest="native", action="store_false",
                        help="parse beatmaps and decode WAVE files on the Python path only")
    parser.add_argument("--no-mesh", action="store_true",
                        help="no data parallelism: under torchrun rank 0 alone runs the whole job on one device")
    return parser


def options_from_args(ns: argparse.Namespace) -> EncoderOptions:
    """The tool's options: ``DEFAULT_OPTIONS`` changed by the flags."""
    fused_wo = ns.fused_wo and not ns.precise
    return EncoderOptions(
        w8a8=not ns.precise, w8a8_wo=ns.w8a8_wo, fused_lnmm_qkv=ns.fused_lnmm, fused_lnmm_wo=ns.fused_lnmm,
        fused_wo=fused_wo, fused_wo_q=ns.fused_wo_q and fused_wo, xla_int8=ns.xla_int8,
    )


def _random_model(processor: CM3PProcessor, tiny: bool, device, dtype, options, attn_impl="pallas"):
    cfg = tiny_cm3p_config() if tiny else CM3PConfig()
    bt = processor.beatmap_tokenizer
    cfg.beatmap_config.vocab_size = bt.vocab_size
    cfg.beatmap_config.audio_token_id = bt.audio_token_id
    weights = init_weights(cfg, torch.Generator().manual_seed(0))
    model = load_model(cfg, weights, device=device, dtype=dtype, options=options)
    if tiny:  # head dims and widths no kernel takes: the JAX tool runs this model on XLA
        logger.info("--tiny-model: every op runs its plain PyTorch version on %s", device)
        model.set_plain(True)
    else:
        model.set_attn_impl(attn_impl)
    return model


def dataset_order(metadata) -> dict[int, int]:
    """Each beatmap id's place in the dataset's order: beatmapsets in order of first appearance in the metadata,
    their beatmaps in order (a run without loader workers over beatmap files visits them so)."""
    meta = metadata.reset_index()
    sets = {s: i for i, s in enumerate(dict.fromkeys(meta["BeatmapSetId"].tolist()))}
    keys = sorted(range(len(meta)), key=lambda i: (sets[meta["BeatmapSetId"].iat[i]], i))
    return {int(meta["Id"].iat[i]): n for n, i in enumerate(keys)}


def in_dataset_order(embeddings: dict[int, np.ndarray], metadata) -> dict[int, np.ndarray]:
    """``embeddings`` in :func:`dataset_order`, ids the metadata lacks last in their own order: the same rows in
    the same order whatever the loader workers' or the ranks' interleaving."""
    order = dataset_order(metadata)
    return {k: embeddings[k] for k in sorted(embeddings, key=lambda k: (0, order[k]) if k in order else (1, 0))}


def gather_embeddings(embeddings: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
    """Every rank's per-beatmap embeddings on rank 0, in rank order; the other ranks get an empty dict."""
    parts = [None] * distributed.process_count() if distributed.is_primary() else None
    torch.distributed.gather_object(embeddings, parts, dst=0)
    merged: dict[int, np.ndarray] = {}
    for part in parts or ():
        merged.update(part)
    return merged


def main(argv=None) -> dict[int, np.ndarray]:
    parser = build_parser()
    ns = parser.parse_args(argv)
    if not (ns.beatmap_files or ns.dataset_path):
        parser.error("Provide --dataset-path or --beatmap-files")
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    if ns.cpu:
        ns.device = "cpu"
    device = resolve_device(ns.device)
    if distributed.launched_by_torchrun():
        distributed.initialize_distributed(device=device)
        device = distributed.local_device(device)
        if ns.no_mesh:  # the group only told each rank its index: rank 0 runs the whole job alone
            rank = distributed.process_index()
            distributed.shutdown()
            if rank != 0:
                logger.info("--no-mesh: rank %d leaves the job to rank 0", rank)
                return {}
            logger.info("--no-mesh: rank 0 runs the whole job on %s", device)
    else:
        distributed.log_single_process("cm3p_torch.extract")
    rank, world = distributed.process_index(), distributed.process_count()
    if world > 1 and ns.batch_size:
        total = -(-ns.batch_size // world) * world
        if total != ns.batch_size:
            logger.info("Rounded --batch-size up to %d for %d ranks", total, world)
        ns.batch_size = total // world
    options = options_from_args(ns)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: None}[ns.dtype]

    processor = None
    if ns.model_dir and not ns.tiny_model:
        processor, model = load_pretrained(
            ns.model_dir, processor_dir=ns.processor_dir, device=device, dtype=dtype, options=options,
            attn_impl=ns.attn_impl,
        )
    if processor is None:
        processor = CM3PProcessor.from_pretrained(ns.processor_dir) if ns.processor_dir else CM3PProcessor()
        if not ns.tiny_model:
            logger.warning("No --model-dir given: using a randomly initialized full-width model")
        model = _random_model(
            processor, ns.tiny_model, device, dtype or (torch.float32 if ns.tiny_model else torch.bfloat16), options,
            ns.attn_impl,
        )
    if ns.attn_impl == "xla" and not ns.tiny_model:
        logger.info("--attn-impl xla: every op runs its plain PyTorch version on %s, options %s", device,
                    model.encoders()[0].options)
    processor.native = ns.native
    bk = processor.default_kwargs["beatmap_kwargs"]
    if ns.max_length:
        bk["max_length"] = ns.max_length
    if ns.window_length:
        bk["window_length_sec"] = ns.window_length
        bk["window_stride_sec"] = ns.window_stride or ns.window_length
    elif ns.window_stride:
        bk["window_stride_sec"] = ns.window_stride

    include_audio = not ns.no_audio
    mel_wire = configure_mel_wire(processor, ns.pack, include_audio, ns.compact_mel, ns.mel_wire)
    logger.info("mel wire: %s; native host paths: %s", mel_wire, ns.native)
    if ns.beatmap_files:
        factory = BeatmapFilesDatasetFactory(ns.beatmap_files, processor, include_audio, rank, world)
        metadata = BeatmapFilesDataset(ns.beatmap_files, processor, include_audio=False).metadata
    else:
        ds_cfg = DatasetConfig(
            train_dataset_paths=ns.dataset_path, include_audio=include_audio, include_metadata=False,
            include_source_metadata=True, dt_augment_prob=0.0, cycle_length=1,
        )
        factory = MmrsDatasetFactory(ds_cfg, processor, test=False, process_id=rank, process_count=world)
        metadata = MmrsDataset(ds_cfg, processor).get_filtered_metadata()
    try:
        n_cores = len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - non-linux
        n_cores = os.cpu_count() or 1
    if ns.num_workers > n_cores:
        logger.info("Capping --num-workers %d to the %d available core(s)", ns.num_workers, n_cores)
        ns.num_workers = n_cores
    loader = SampleLoader(factory, num_workers=ns.num_workers, int8_ipc=ns.int8_ipc,
                          log_dir="dataloader" if world == 1 else f"dataloader/rank{rank}")
    stats: dict = {}
    embeddings = extract_embeddings(
        model, processor, loader, device=device, pack=ns.pack, batch_size=ns.batch_size, flush_rows=ns.flush_rows,
        stats=stats, mel_wire=mel_wire,
    )
    logger.info("host routes: %s; mel bytes to the device: %d (%.0f a window)", stats.get("host"),
                stats["wire_bytes"], stats["wire_bytes"] / max(stats["windows"], 1))
    if world > 1:
        logger.info("rank %d of %d: %d beatmaps", rank, world, len(embeddings))
        embeddings = gather_embeddings(embeddings)
    if distributed.is_primary():
        embeddings = in_dataset_order(embeddings, metadata)
        write_output(embeddings, metadata, ns.output, ns.merge_with)
    distributed.barrier()
    distributed.shutdown()
    return embeddings


if __name__ == "__main__":
    main()
