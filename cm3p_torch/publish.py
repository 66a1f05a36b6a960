"""Bundle a trained model for release: the port's ``publish_model.py``.

    python -m cm3p_torch.publish --model-dir out/model --processor-dir out/processor --output release/cm3p-v1
    python -m cm3p_torch.publish ... --hf [--repo-id user/CM3P --revision v1 --create-pr]

Copies the trainer's ``<output_dir>/model`` (``config.json`` and
``model.safetensors`` in the HF layout, with the processor's files) to
``model/`` and its ``<output_dir>/processor`` to ``processor/`` as they are,
and writes ``README.md``, a model card naming the architecture of the
config (:func:`~cm3p_torch.interop.hf_config.default_architecture`). With
``--hf`` it also writes ``hf/``: ``config.json`` and the weight files of
``model/`` copied byte for byte (that layout is the reference's), and the
processor in the reference's
``AutoProcessor`` layout (:func:`~cm3p_torch.interop.hf_export.export_hf_processor`),
which the reference's ``from_pretrained`` loads. ``--repo-id`` then pushes the
whole directory to the Hugging Face Hub (``huggingface_hub`` is imported
only there); a failed push or a missing package logs the reason and returns
1, the local bundle complete. Nothing else needs the network, and nothing
runs on a device.
"""
from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
from pathlib import Path

from .interop.hf_config import default_architecture, hf_config_to_cm3p
from .interop.hf_export import export_hf_processor
from .processing.processor import CM3PProcessor

logger = logging.getLogger(__name__)

MODEL_CARD = """---
library_name: cm3p_torch
tags:
- osu
- beatmap
- contrastive
- pytorch
- cuda
pipeline_tag: feature-extraction
---

# {name}

CM3P (Contrastive Metadata-Map Masked Pre-training) checkpoint trained with
the PyTorch / CUDA framework. Dual-tower ModernBERT-style encoders over osu!
beatmap token streams and structured metadata with optional audio fusion.
Architecture: `{architecture}`.

## Usage

```python
from cm3p_torch.inference import load_pretrained
from cm3p_torch.processing import CM3PProcessor

processor = CM3PProcessor.from_pretrained("{name}/processor")
_, model = load_pretrained("{name}/model", processor_dir="{name}/processor")  # on cuda; device="cpu" otherwise
```

{hf_section}## Contents

- `model/` — `model.safetensors` + HF `config.json` (+ the processor's files)
- `processor/` — parser / tokenizer / feature-extractor configs and vocabularies
{hf_contents}
## Training details

{training_details}
"""

HF_SECTION = """## Loading with the reference PyTorch stack

The `hf/` subfolder is an HF-layout bundle (`model.safetensors` +
`config.json`, and the processor in the `AutoProcessor` layout) loadable
directly by the reference implementation:

```python
from cm3p.modeling_cm3p import {architecture}  # the reference package
from cm3p.processing_cm3p import CM3PProcessor
model = {architecture}.from_pretrained("{name}/hf")
processor = CM3PProcessor.from_pretrained("{name}/hf")
```

"""


# the weight files of an HF-layout model directory, which the reference's from_pretrained reads as they are
WEIGHT_FILES = ("config.json", "*.safetensors", "*.safetensors.index.json", "pytorch_model*.bin",
                "pytorch_model*.bin.index.json")


def copy_hf_model(model_dir: Path, out_dir: Path) -> None:
    """``config.json`` and the weight files of ``model_dir`` (the HF layout the port's trainer writes) copied
    into ``out_dir`` byte for byte."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for pattern in WEIGHT_FILES:
        for path in sorted(model_dir.glob(pattern)):
            shutil.copy2(path, out_dir / path.name)


def push(out: Path, repo_id: str, revision, create_pr: bool, name: str) -> int:
    """Upload ``out`` to the Hub as ``publish_model.py`` does: ``create_repo``, ``create_branch`` for
    ``revision``, ``upload_folder``. Returns 0, or 1 after logging why the push failed."""
    try:
        from huggingface_hub import HfApi

        api = HfApi()
        api.create_repo(repo_id, exist_ok=True)
        if revision:
            try:
                api.create_branch(repo_id=repo_id, branch=revision, exist_ok=True)
            except Exception as e:  # the branch may exist already
                logger.info("create_branch %s: %s", revision, e)
        api.upload_folder(folder_path=str(out), repo_id=repo_id, revision=revision, create_pr=create_pr,
                          commit_message=f"Upload {name}")
    except Exception as e:
        logger.error("Hub push failed (%s: %s); the local bundle at %s is complete", type(e).__name__, e, out)
        return 1
    logger.info("Pushed to hub: %s", repo_id)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m cm3p_torch.publish", description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-dir", required=True, help="the trainer's <output_dir>/model")
    parser.add_argument("--processor-dir", required=True, help="the trainer's <output_dir>/processor")
    parser.add_argument("--output", required=True)
    parser.add_argument("--name", default=None, help="the release's name (default: the output folder's)")
    parser.add_argument("--training-details", default="(not provided)")
    parser.add_argument("--repo-id", default=None, help="push to this HF Hub repo if set")
    parser.add_argument("--revision", default=None)
    parser.add_argument("--create-pr", action="store_true")
    parser.add_argument("--hf", action="store_true",
                        help="also write hf/: the weights and config.json, and the processor in the reference's "
                        "AutoProcessor layout")
    return parser


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)

    out = Path(ns.output)
    out.mkdir(parents=True, exist_ok=True)
    shutil.copytree(ns.model_dir, out / "model", dirs_exist_ok=True)
    shutil.copytree(ns.processor_dir, out / "processor", dirs_exist_ok=True)
    name = ns.name or out.name
    with open(out / "model" / "config.json") as f:
        architecture = default_architecture(hf_config_to_cm3p(json.load(f)))
    hf_section = hf_contents = ""
    if ns.hf:
        copy_hf_model(out / "model", out / "hf")
        export_hf_processor(CM3PProcessor.from_pretrained(out / "processor"), out / "hf")
        # str.format never rescans substituted values, so the formatted section nests safely
        hf_section = HF_SECTION.format(name=name, architecture=architecture)
        hf_contents = ("- `hf/` — reference-loadable HF bundle (safetensors + config.json "
                       "+ AutoProcessor-layout processor subfolders)\n")
        logger.info("Exported the reference-loadable bundle (model + processor) to %s", out / "hf")
    card = MODEL_CARD.format(name=name, architecture=architecture, training_details=ns.training_details,
                             hf_section=hf_section, hf_contents=hf_contents)
    (out / "README.md").write_text(card)
    logger.info("Packaged %s (architecture: %s)", out, architecture)
    if ns.repo_id:
        return push(out, ns.repo_id, ns.revision, ns.create_pr, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
