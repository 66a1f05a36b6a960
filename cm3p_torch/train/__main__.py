"""Training from the composed YAML config: the port's ``train.py``.

    python -m cm3p_torch.train --config-name v8_packed 'dataset.train_dataset_paths=[ROOT]' 'dataset.test_dataset_paths=[ROOT]'
    python -m cm3p_torch.train --config-name smoke_mmrs --device cpu 'dataset.train_dataset_paths=[ROOT]' 'dataset.test_dataset_paths=[ROOT]'
    python -m cm3p_torch.train --config-name v8_packed --beatmap-files resources --beatmap-files resources/perf_corpus dataset.include_audio=false
    python -m cm3p_torch.train --config-name smoke --device cpu      # synthetic data, tiny model

Builds the processor (metadata vocabularies filled from the dataset's
``metadata.parquet`` where the config leaves them unset), the model (seeded
fp32 master weights; bf16 compute on the GPU, fp32 on the CPU), the optimizer
(Muon + AdamW, or AdamW; ``freeze_beatmap_model`` / ``freeze_metadata_model``
hold a tower until ``unfreeze_beatmap_model_at_step``) and the batch source
from ``configs/train/<name>.yaml`` with ``a.b=c`` overrides, then runs
:class:`~cm3p_torch.train.trainer.Trainer` and a final evaluation.
``model_cls`` keeps the JAX names: ``CM3PModule`` (:class:`CM3PModel`, with
the decoder head under ``model.has_decoder_head``), ``MaskedLMModule``
(:class:`MaskedLMModel`) and ``ClassifierModule`` (:class:`ClassifierModel`),
the last two on ``model.beatmap_config``. ``remat`` (False, True or
``"dots"``) rematerialises every encoder layer in the backward
(:meth:`~cm3p_torch.models.cm3p.TowerModel.set_remat`). ``from_pretrained`` (a
local HF-layout directory, such as an earlier run's ``<output_dir>/model``)
initialises the parameters it holds (:func:`~cm3p_torch.train.trainer.from_pretrained`;
``from_pretrained_allow_missing`` lets the rest keep their seeded values).
The final model goes to ``<output_dir>/model`` in the layout
:func:`~cm3p_torch.inference.load_pretrained` reads (``model.safetensors``,
the HF ``config.json`` and the processor's files); periodic checkpoints stay
``torch.save`` files under ``checkpoints/``.

Batches come, as in ``train.py``, from the MMRS dataset roots of
``dataset.train_dataset_paths`` / ``test_dataset_paths``
(:func:`mmrs_batches`: audio, augmentations and ``dataset.labels`` from the
data, ``training.num_workers`` loader processes, packed when
``training.packed``, a resume seeks its batch through ``start_step``); or
they are synthetic (``dataset.synthetic``); or they come from local ``.osu``
files (``--beatmap-files``: files or directories of them, no audio and no
labels), processed with generated metadata. Runs on ``cuda`` unless
``--device cpu``; without a GPU it raises unless asked for the CPU.

Data parallelism, one rank per GPU (:mod:`cm3p_torch.parallel.distributed`):

    torchrun --nproc-per-node 2 -m cm3p_torch.train --config-name v8_packed ...
    python -m cm3p_torch.train ... training.multihost=true training.coordinator_address=HOST:PORT \
        training.num_processes=2 training.process_id=0     # and process_id=1 on the other

The r-th rank of a host computes on ``cuda:r`` (every rank on the CPU with
``--device cpu``); the data group's backend is NCCL when each rank of the
host has a GPU of its own, else gloo; ``training.heartbeat_timeout_seconds``
bounds every collective's wait. Each data group reads its own shard of the data
(:func:`~cm3p_torch.parallel.distributed.data_shard_group`: MMRS roots by
beatmap, the synthetic and ``.osu`` routes their rows of one seeded global
stream), ``per_device_train_batch_size`` is per rank, and the losses and
gradients are the global batch's.

Tensor parallelism, ``training.model_axis=N`` (:mod:`cm3p_torch.parallel.tensor`):

    torchrun --nproc-per-node 4 -m cm3p_torch.train --config-name v8_packed ... training.model_axis=2

lays the ranks out as a (data, model) grid (``parallel/mesh.py``): each row
of N ranks holds one copy of the model in Megatron shards (every tower's
layers by heads and matched intermediate columns, the audio projector's pair)
and takes the same batch; each column is a data group. The whole model is
built (and ``from_pretrained`` read) on every rank, broadcast, then sharded;
Muon runs NS5 on whole matrices; checkpoints and ``<output_dir>/model`` hold
whole tensors, so ``extract --model-dir`` and a resume at another model axis
read them unchanged. A model axis that does not divide every tower's heads
and intermediate width raises, naming the tower.
"""
from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..audio import LogMelExtractor
from ..beatmap import BeatmapEventParser
from ..configs import BeatmapConfig, CM3PConfig, MetadataConfig
from ..data import DatasetConfig, MmrsDatasetFactory, SampleLoader, batched_loader, packed_batches
from ..data.data_utils import filter_mmrs_metadata, load_mmrs_metadata
from ..inference import resolve_device, save_pretrained
from ..interop import init_weights
from ..models import ClassifierModel, CM3PModel, MaskedLMModel, TowerModel
from ..parallel import distributed
from ..parallel.mesh import check_model_axis, make_mesh
from ..parallel.tensor import gather_module_state, shard_module
from ..processing import CM3PProcessor
from ..tokenize import BeatmapTokenizer, MetadataTokenizer
from ..utils.config import load_config
from .muon import MuonAdamW, flax_layouts
from .step import lr_schedule
from .trainer import Trainer, from_pretrained

logger = logging.getLogger(__name__)

REPO_ROOT = Path(__file__).resolve().parents[2]
CONFIG_DIR = REPO_ROOT / "configs" / "train"
SYNTHETIC_VOCAB = {
    "modes": {0: "osu", 1: "taiko", 2: "fruits", 3: "mania"},
    "statuses": {1: "ranked", -2: "graveyard"},
    "mappers": {0: "mapper_a", 1: "mapper_b"},
    "tags": {1: {"name": "jump"}, 2: {"name": "stream"}},
}


def dataset_config(args: dict) -> DatasetConfig:
    return DatasetConfig(**{k: v for k, v in args["dataset"].items() if k != "synthetic"})


def dataset_vocabularies(ds_cfg: DatasetConfig, metadata_tok_cfg: dict) -> None:
    """Fill ``modes``, ``statuses``, ``mappers`` and ``tags`` that ``metadata_tok_cfg`` lacks from the
    filtered training metadata (tags: the ``TopTagIds`` found there, described by ``resources/tags.json``)."""
    train_meta = filter_mmrs_metadata(
        load_mmrs_metadata(ds_cfg.train_dataset_paths),
        start=ds_cfg.train_dataset_start,
        end=ds_cfg.train_dataset_end,
        gamemodes=ds_cfg.gamemodes,
        min_year=ds_cfg.min_year,
        max_year=ds_cfg.max_year,
        min_difficulty=ds_cfg.min_difficulty,
        max_difficulty=ds_cfg.max_difficulty,
    )
    reset = train_meta.reset_index()
    metadata_tok_cfg.setdefault("modes", reset.set_index("ModeInt")["Mode"].to_dict())
    metadata_tok_cfg.setdefault("statuses", reset.set_index("Ranked")["Status"].to_dict())
    metadata_tok_cfg.setdefault("mappers", reset.set_index("UserId")["Creator"].to_dict())
    if not metadata_tok_cfg.get("tags"):
        all_tag_ids = set(train_meta["TopTagIds"].explode().dropna().unique().tolist())
        with open(REPO_ROOT / "resources" / "tags.json", encoding="utf-8") as f:
            tags_info = json.load(f)["tags"]
        metadata_tok_cfg["tags"] = {
            int(t["id"]): {"name": t["name"], "ruleset_id": t["ruleset_id"], "description": t["description"]}
            for t in tags_info
            if int(t["id"]) in all_tag_ids
        }


def build_processor(args: dict) -> CM3PProcessor:
    proc_cfg = args["processor"]
    metadata_tok_cfg = dict(proc_cfg["metadata_tokenizer"])
    needs_vocab = not all(metadata_tok_cfg.get(k) for k in SYNTHETIC_VOCAB)
    if needs_vocab and args["dataset"].get("synthetic"):
        # deterministic small vocabularies for synthetic runs
        for key, value in SYNTHETIC_VOCAB.items():
            metadata_tok_cfg.setdefault(key, value)
    elif needs_vocab:
        ds_cfg = dataset_config(args)
        found = bool(ds_cfg.train_dataset_paths)
        try:
            if found:
                dataset_vocabularies(ds_cfg, metadata_tok_cfg)
        except FileNotFoundError:
            found = False
        if not found:
            logger.warning("Dataset metadata not found; metadata vocabularies stay minimal")
    metadata_tok_cfg = {k: v for k, v in metadata_tok_cfg.items() if v is not None}
    return CM3PProcessor(
        audio_feature_extractor=LogMelExtractor(**proc_cfg["audio_feature_extractor"]),
        beatmap_parser=BeatmapEventParser(**proc_cfg["beatmap_parser"]),
        beatmap_tokenizer=BeatmapTokenizer(**proc_cfg["beatmap_tokenizer"]),
        metadata_tokenizer=MetadataTokenizer(**metadata_tok_cfg),
        default_kwargs=proc_cfg.get("default_kwargs"),
    )


def model_config(args: dict, processor: CM3PProcessor) -> CM3PConfig:
    """``CM3PConfig`` from ``args["model"]`` with the tokenizers' vocab sizes and ids."""
    model = args["model"]
    cfg = CM3PConfig(
        metadata_config=MetadataConfig(**model["metadata_config"]),
        beatmap_config=BeatmapConfig(**model["beatmap_config"]),
        **{k: v for k, v in model.items() if k not in ("metadata_config", "beatmap_config")},
    )
    bt, mt = processor.beatmap_tokenizer, processor.metadata_tokenizer
    bc, mc = cfg.beatmap_config, cfg.metadata_config
    bc.vocab_size, bc.pad_token_id = bt.vocab_size, bt.pad_token_id
    bc.bos_token_id, bc.eos_token_id = bt.bos_token_id, bt.eos_token_id
    bc.audio_sos_token_id = bt.convert_tokens_to_ids(bt.audio_bos_token)
    bc.audio_eos_token_id = bt.convert_tokens_to_ids(bt.audio_eos_token)
    bc.audio_token_id = bt.audio_token_id
    mc.vocab_size, mc.pad_token_id = mt.vocab_size, mt.pad_token_id
    mc.bos_token_id, mc.eos_token_id = mt.bos_token_id, mt.eos_token_id
    return cfg


MODEL_CLASSES = ("CM3PModule", "MaskedLMModule", "ClassifierModule")


def build_model(args: dict, cfg: CM3PConfig, device: torch.device, seed: int) -> TowerModel:
    """``model_cls``'s model with seeded fp32 master weights on ``device``; bf16 compute unless on
    the CPU; the plain versions of every op with ``attn_impl: xla`` (the smoke configs: no kernel takes
    their head dims), else the kernels, which raise on a shape or dtype they do not take."""
    model_cls = args.get("model_cls", "CM3PModule")
    if model_cls not in MODEL_CLASSES:
        raise ValueError(f"model_cls must be one of {MODEL_CLASSES}, not {model_cls!r}")
    gen = torch.Generator(device=device).manual_seed(seed)
    bc = cfg.beatmap_config
    if model_cls == "MaskedLMModule":
        model, weights = MaskedLMModel(bc), init_weights(bc, gen, head="mlm")
    elif model_cls == "ClassifierModule":
        model, weights = ClassifierModel(bc), init_weights(bc, gen, head="classifier")
    else:
        model = CM3PModel(cfg, meta_pack=int(args.get("meta_pack", 0)))
        weights = init_weights(cfg, gen, with_metadata=True)
    model.load_state_dict(weights)
    model.to(device)
    model.set_compute_dtype(torch.bfloat16 if device.type != "cpu" else torch.float32)
    model.set_remat(args.get("remat", True))
    if args.get("attn_impl", "pallas") == "xla":  # the JAX package's route without its kernels
        logger.info("attn_impl=xla: every op runs its plain PyTorch version on %s", device)
        model.set_plain(True)
    return model


def build_optimizer(args: dict, model: torch.nn.Module) -> MuonAdamW:
    training = args["training"]
    schedule = lr_schedule(training["learning_rate"], training["max_steps"], training.get("warmup_steps", 0))
    betas = (training.get("adam_beta1", 0.9), training.get("adam_beta2", 0.999))
    frozen = [name for name, key in (("beatmap_model", "freeze_beatmap_model"),
                                     ("metadata_model", "freeze_metadata_model")) if args.get(key)]
    common = dict(
        adamw_betas=betas, adamw_eps=training.get("adam_epsilon", 1e-8),
        adamw_weight_decay=training.get("weight_decay", 0.0),
        frozen=frozen, unfreeze_at=args.get("unfreeze_beatmap_model_at_step") if frozen else None,
        model_group=getattr(model, "model_group", None),
    )
    named, layouts = list(model.named_parameters()), flax_layouts(model)
    if training.get("optim") == "muon":
        return MuonAdamW(named, layouts, schedule, adamw_lr_ratio=0.25,
                         compat_adamw_lr=bool(training.get("muon_compat_adamw_lr", False)), **common)
    # plain AdamW: every tensor on the AdamW branch at the full rate
    return MuonAdamW(named, layouts, schedule, adamw_lr_ratio=1.0, label_fn=lambda *_: "adamw", **common)


def synthetic_batches(args: dict, cfg: CM3PConfig, test: bool, seed: int = 0, shard: tuple[int, int] = (0, 1)):
    """Random fixed-shape unpacked batches of the processor's contract (``train.py``'s): metadata for
    ``CM3PModule`` only, ``labels`` for ``dataset.labels`` ``masked_lm`` (15 % of the ids, else -100)
    and ``ranked_classification`` (0 or 1 per row). ``shard`` (group, groups): each batch is this data
    group's rows of a seeded global batch of ``groups`` x the per-device size."""
    training, dataset = args["training"], args["dataset"]
    group, groups = shard
    bsz = training["per_device_eval_batch_size" if test else "per_device_train_batch_size"] * groups
    kwargs = args["processor"]["default_kwargs"]
    seq = kwargs["beatmap_kwargs"]["max_length"]
    mel_frames = kwargs["audio_kwargs"]["pad_to_multiple_of"] // kwargs["audio_kwargs"]["hop_length"]
    variations = dataset["test_metadata_variations" if test else "train_metadata_variations"]
    bc = cfg.beatmap_config
    rng = np.random.default_rng(seed + int(test))

    def gen():
        n_audio = mel_frames // 8
        for _ in range(10_000):
            ids = rng.integers(5, min(bc.vocab_size - 20, 3000), (bsz, seq)).astype(np.int32)
            ids[:, 0] = bc.audio_sos_token_id
            ids[:, 1 : 1 + n_audio] = bc.audio_token_id
            ids[:, 1 + n_audio] = bc.audio_eos_token_id
            batch = {
                "input_ids": ids,
                "attention_mask": np.ones((bsz, seq), np.int32),
                "input_features": rng.standard_normal((bsz, bc.audio_config.n_mels, mel_frames)).astype(np.float32),
            }
            if dataset["include_metadata"] and args.get("model_cls", "CM3PModule") == "CM3PModule":
                mv = max(variations, 1)
                batch["metadata_ids"] = rng.integers(0, cfg.metadata_config.vocab_size, (bsz, mv, 24)).astype(np.int32)
                batch["metadata_attention_mask"] = np.ones((bsz, mv, 24), np.int32)
                classes = np.ones((bsz, mv), np.int32)
                classes[:, 0] = 0
                batch["metadata_variation_classes"] = classes
            if dataset.get("labels") == "masked_lm":
                batch["labels"] = np.where(rng.random((bsz, seq)) < 0.15, ids, -100).astype(np.int32)
            elif dataset.get("labels") == "ranked_classification":
                batch["labels"] = rng.integers(0, 2, (bsz,)).astype(np.int32)
            rows = slice(group * bsz // groups, (group + 1) * bsz // groups)
            yield {k: v[rows] for k, v in batch.items()} if groups > 1 else batch

    return gen


def beatmap_paths(specs: list[str]) -> list[str]:
    """``.osu`` files named directly or found (non-recursively) in named directories."""
    paths: list[str] = []
    for spec in specs:
        if os.path.isdir(spec):
            paths.extend(sorted(glob.glob(os.path.join(spec, "*.osu"))))
        else:
            paths.append(spec)
    if not paths:
        raise FileNotFoundError(f"no .osu files in {specs}")
    return paths


def beatmap_file_batches(args: dict, processor: CM3PProcessor, paths: list[str], test: bool, seed: int = 0,
                         shard: tuple[int, int] = (0, 1)):
    """Batches from local ``.osu`` files: every window with metadata generated from
    its beatmap and ``*_metadata_variations`` variations; packed rows when
    ``training.packed`` (``packed_batches``), else stacked windows. Each pass over
    the files reseeds the processor from (seed, test, pass). ``shard`` (group,
    groups): every data group processes the same seeded window stream and keeps
    its windows i with i mod groups = group."""
    training, dataset = args["training"], args["dataset"]
    if dataset.get("include_audio"):
        raise NotImplementedError("batches from .osu files carry no audio: set dataset.include_audio=false, or "
                                  "train from MMRS roots (dataset.train_dataset_paths) for audio")
    if dataset.get("labels", "none") != "none":
        raise NotImplementedError(
            f"dataset.labels={dataset['labels']!r}: batches from .osu files carry no labels; masked-LM masking and "
            "ranked-classification labels come from MMRS roots (dataset.train_dataset_paths)"
        )
    bsz = training["per_device_eval_batch_size" if test else "per_device_train_batch_size"]
    variations = dataset["test_metadata_variations" if test else "train_metadata_variations"]
    dropout = 0.0 if test else dataset.get("metadata_dropout_prob", 0.0)
    seq_len = args["processor"]["default_kwargs"]["beatmap_kwargs"]["max_length"]
    passes = {"n": 0}

    group, groups = shard

    def samples():
        n = 0
        for path in paths:
            out = dict(processor(
                beatmap=path, populate_metadata=True, multiply_metadata=True, metadata_variations=variations,
                metadata_dropout_prob=dropout, padding="max_length",
            ))
            for i in range(len(out["input_ids"])):
                if n % groups == group:
                    yield {k: v[i] for k, v in out.items()}
                n += 1

    def factory():
        processor.rng = np.random.default_rng([seed, int(test), passes["n"]])
        passes["n"] += 1
        if training.get("packed", False):
            return packed_batches(
                samples(), rows=bsz, seq_len=seq_len, pad_id=processor.beatmap_tokenizer.pad_token_id,
                max_windows=training.get("packed_max_windows", bsz * 8),
            )
        return _stacked(samples(), bsz)

    return factory


def mmrs_batches(args: dict, processor: CM3PProcessor, test: bool, shard: tuple[int, int] = (0, 1)):
    """``train.py``'s ``mmrs_batches``: a factory of batch streams over the MMRS roots of the config, of the
    data shard ``shard`` (group, groups: :func:`~cm3p_torch.parallel.distributed.data_shard_group`).

    Each call of the factory is one epoch of ``SampleLoader`` over :class:`MmrsDatasetFactory`
    (``training.num_workers`` processes for training, inline for evaluation) through ``packed_batches``
    or ``batched_loader``; the epoch counter advances the seeded shuffle. ``start_step`` (a resume) seeks
    the stream an uninterrupted run would be at: whole epochs through ``training.batches_per_epoch``,
    then a replay of the rest; without it a replay of a seeded stream, a fresh epoch of an unseeded one.
    """
    ds_cfg = dataset_config(args)
    training = args["training"]
    bsz = training["per_device_eval_batch_size" if test else "per_device_train_batch_size"]
    num_workers = 0 if test else training.get("num_workers", 0)
    packed = training.get("packed", False)
    data_seed = training.get("seed")
    epoch_state = {"next": 0}
    log_dir = Path(training["output_dir"]) / "dataloader"
    log_dir = str(log_dir if shard[1] == 1 else log_dir / f"shard{shard[0]}")

    def build_iter(epoch: int):
        dataset_factory = MmrsDatasetFactory(ds_cfg, processor, test, *shard, seed=data_seed, epoch=epoch)
        loader = SampleLoader(dataset_factory, num_workers=num_workers, log_dir=log_dir)
        if packed:
            return packed_batches(
                iter(loader), rows=bsz,
                seq_len=args["processor"]["default_kwargs"]["beatmap_kwargs"].get("max_length", 4000),
                pad_id=processor.beatmap_tokenizer.pad_token_id,
                max_windows=training.get("packed_max_windows", bsz * 8),
            )
        return batched_loader(iter(loader), bsz, drop_last=True)

    def factory(start_step: int = 0):
        epoch = 0 if test else epoch_state["next"]
        skip = 0
        bpe = training.get("batches_per_epoch")
        if start_step and not test:
            if bpe:
                epoch, skip = divmod(start_step, int(bpe))
                logger.info("resume seek: epoch %d + %d-batch replay (training.batches_per_epoch=%d)",
                            epoch, skip, int(bpe))
            elif data_seed is not None:
                skip = start_step
                logger.info("resume seek: replaying %d batches through the host pipeline (set "
                            "training.batches_per_epoch to make deep resumes cheap)", skip)
            else:
                logger.info("resume seek: unseeded data stream - starting a fresh epoch instead of replaying "
                            "%d batches", start_step)
        if not test:
            epoch_state["next"] = epoch + 1
        it = build_iter(epoch)
        for done in range(skip):
            try:
                next(it)
            except StopIteration:
                logger.warning("resume seek: epoch %d ended after %d batches (< the configured replay of %d); "
                               "continuing at epoch %d", epoch, done, skip, epoch + 1)
                epoch_state["next"] = epoch + 2
                it = build_iter(epoch + 1)
                break
        return it

    return factory


def _stacked(samples, bsz: int):
    buf: list[dict] = []
    for sample in samples:
        buf.append(sample)
        if len(buf) == bsz:
            yield {k: np.stack([s[k] for s in buf]) for k in buf[0]}
            buf = []


def main(argv: Optional[list[str]] = None) -> Trainer:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-name", "-cn", default="v1")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--beatmap-files", action="append", default=None, metavar="PATH",
                        help="an .osu file or a directory of them (repeatable)")
    parser.add_argument("overrides", nargs="*", help="dotted config overrides a.b=c")
    cli = parser.parse_args(argv)
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        handlers=[logging.StreamHandler(sys.stdout)], level=logging.INFO,
    )

    args = load_config(cli.config_dir, cli.config_name, cli.overrides)
    training = args["training"]
    processor = build_processor(args)
    cfg = model_config(args, processor)
    device = launch(training, resolve_device(cli.device), model_towers(args, cfg))
    mesh = make_mesh(model=int(training.get("model_axis", 1)))
    shard = distributed.data_shard_group(mesh)
    seed = int(training["seed"])
    np.random.seed(seed)
    torch.manual_seed(seed)

    model = build_model(args, cfg, device, seed)
    if args.get("from_pretrained"):
        from_pretrained(model, args["from_pretrained"], bool(args.get("from_pretrained_allow_missing", False)))
    if distributed.active():
        model.set_data_group(mesh.data_group)
        distributed.broadcast_parameters(model)  # over every rank: the whole model, before the rows shard it
        shard_module(model, mesh)
        logger.info("data shard %d of %d, %d rows a rank per micro-step; model shard %d of %d", *shard,
                    training["per_device_train_batch_size"], mesh.coords()[1], mesh.shape["model"])
    packed = bool(training.get("packed", False))
    if packed and args.get("model_cls", "CM3PModule") != "CM3PModule":
        raise ValueError("training.packed currently supports model_cls=CM3PModule")
    if args["dataset"].get("synthetic"):
        if packed:
            raise NotImplementedError("synthetic batches are unpacked; set training.packed=false")
        train_factory = synthetic_batches(args, cfg, test=False, seed=seed, shard=shard)
        eval_factory = synthetic_batches(args, cfg, test=True, seed=seed, shard=shard)
    elif cli.beatmap_files:
        paths = beatmap_paths(cli.beatmap_files)
        train_factory = beatmap_file_batches(args, processor, paths, test=False, seed=seed, shard=shard)
        eval_factory = beatmap_file_batches(args, processor, paths, test=True, seed=seed, shard=shard)
    else:
        train_factory = mmrs_batches(args, processor, test=False, shard=shard)
        eval_factory = mmrs_batches(args, processor, test=True, shard=shard)

    output_dir = Path(training["output_dir"])
    trainer = Trainer(
        model, build_optimizer(args, model), train_factory, eval_factory,
        device=device,
        packed=packed,
        output_dir=str(output_dir),
        max_steps=training["max_steps"],
        gradient_accumulation_steps=training["gradient_accumulation_steps"],
        logging_steps=training["logging_steps"],
        eval_steps=training["eval_steps"],
        max_eval_batches=training.get("max_eval_batches", 50),
        save_steps=training["save_steps"],
        save_total_limit=training["save_total_limit"],
        resume=not training.get("overwrite_output_dir", False),
        load_best_model_at_end=training.get("load_best_model_at_end", False),
        labels_kind=args["dataset"].get("labels", "none"),
        wandb_project=args.get("wandb_project"),
        wandb_entity=args.get("wandb_entity"),
        wandb_mode=args.get("wandb_mode"),
        run_config=args,
    )
    try:
        results = trainer.train()
        final = trainer.evaluate()
        trainer._log({"step": results["final_step"],
                      **{f"final_eval_{k}": v for k, v in final.items() if v is not None}})
        state = gather_module_state(model)  # whole tensors (every rank of a model group takes part)
        if distributed.is_primary():
            # the layout load_pretrained reads (python -m cm3p_torch.extract --model-dir <output_dir>/model)
            save_pretrained(model, output_dir / "model", processor=processor, state=state)
            processor.save_pretrained(str(output_dir / "processor"))
        distributed.barrier()
    finally:
        trainer.close()
    logger.info("Training complete; artifacts in %s", output_dir)
    distributed.shutdown()
    return trainer


def model_towers(args: dict, cfg: CM3PConfig) -> dict:
    """Tower name -> encoder config of the towers ``model_cls``'s model holds."""
    bc = cfg.beatmap_config
    towers = {"beatmap": bc, "audio": bc.audio_config}
    if args.get("model_cls", "CM3PModule") == "CM3PModule":
        towers["metadata"] = cfg.metadata_config
    return towers


def launch(training: dict, device: torch.device, towers: Optional[dict] = None) -> torch.device:
    """Form the process group when ``torchrun`` started this process or ``training.multihost`` is set, and
    return the device this rank computes on. ``training.model_axis`` must divide every tower's heads and
    intermediate width (``towers``: :func:`model_towers`), else it raises naming the tower; a model axis above
    1 also needs a process group of a multiple of it."""
    model_axis = int(training.get("model_axis", 1))
    if towers is not None:
        check_model_axis(model_axis, towers)
    multihost = bool(training.get("multihost", False))
    if not (multihost or distributed.launched_by_torchrun()):
        distributed.log_single_process("cm3p_torch.train")
        return device
    distributed.initialize_distributed(
        coordinator_address=training.get("coordinator_address") if multihost else None,
        num_processes=training.get("num_processes") if multihost else None,
        process_id=training.get("process_id") if multihost else None,
        heartbeat_timeout_seconds=training.get("heartbeat_timeout_seconds"),
        device=device,
    )
    return distributed.local_device(device)


if __name__ == "__main__":
    main()
