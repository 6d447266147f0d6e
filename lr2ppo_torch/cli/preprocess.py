"""Feature-extraction CLI (counterpart of lr2ppo_tpu/cli/preprocess.py):

    python -m lr2ppo_torch.cli.preprocess \\
      --data_json LRMovieNet/train.json --image_root keyframes/ \\
      --text_config models/xlm-roberta/base_config.json \\
      --text_ckpt pretrained_models/roberta.bin \\
      --vit_config models/vit/base-16-224_config.json \\
      --vit_ckpt pretrained_models/vit.bin \\
      --vocab_path xlmr_vocab.tsv --output LRMovieNet/clean_feat.h5

Reads a data JSON ({"id", "tags": [{"tag", "target"}...]}) and a keyframe
root (one directory of images per item id), embeds the tag texts with the
XLM-R tower and the frames with the ViT tower, and writes clean_feat.h5 in
the layout the MovieNet datasets read. The checkpoints are reference tower
`.bin` files (TencentPretrain keys). It takes the JAX CLI's flags and runs
on one GPU; from Python, `main(argv, device="cpu")` runs it on the CPU.
PIL and h5py are imported at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from lr2ppo_torch.device import require_cuda
from lr2ppo_torch.towers import TowerConfig, load_tower_checkpoint
from lr2ppo_torch.towers.extract import (
    ImageFeatureExtractor,
    TextFeatureExtractor,
    write_clean_feat,
)
from lr2ppo_torch.towers.torch_import import encoder_state


def load_frames(image_dir: str, height: int, width: int,
                workers: int = 1) -> np.ndarray:
    """All images of one item -> (N, 3, H, W) float32 in [0, 1]
    (ZeroOneNormalize, reference utils/misc.py:37-39), in sorted file order,
    unreadable files skipped. `workers` > 1 decodes on a thread pool (PIL
    releases the GIL while it decodes and resizes)."""
    from PIL import Image

    def one(name: str):
        p = os.path.join(image_dir, name)
        try:
            img = Image.open(p).convert("RGB").resize((width, height))
        except Exception:
            return None
        return (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)

    names = sorted(os.listdir(image_dir))
    if workers > 1 and len(names) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(workers, len(names))) as ex:
            frames = [f for f in ex.map(one, names) if f is not None]
    else:
        frames = [f for f in map(one, names) if f is not None]
    if not frames:
        raise FileNotFoundError(f"no readable frames in {image_dir}")
    return np.stack(frames)


def extract_items(items, frames_of, sink, text_x: TextFeatureExtractor,
                  img_x: ImageFeatureExtractor, batch: int = 32,
                  log=print) -> dict:
    """The per-item loop: item k + 1's frames are read (`frames_of(item)`,
    on a helper thread) while the towers embed item k; then
    `sink(item_id, text_emb, img_emb)`. An item whose frames cannot be read
    is skipped with a line on `log`. Returns the items written, the items
    skipped and each written item's seconds, host clock."""
    from concurrent.futures import ThreadPoolExecutor

    def decode(item):
        try:
            return item, frames_of(item), None
        except (FileNotFoundError, NotADirectoryError, OSError) as e:
            return item, None, str(e)

    written, skipped, seconds = 0, 0, []
    lookahead = ThreadPoolExecutor(1)
    try:
        pending = lookahead.submit(decode, items[0]) if items else None
        for k in range(len(items)):
            item, frames, err = pending.result()
            pending = (lookahead.submit(decode, items[k + 1])
                       if k + 1 < len(items) else None)
            iid = item["id"]
            if err is not None or len(frames) == 0:
                log(f"SKIP {iid}: keyframes unreadable ({err})"
                    if err is not None else
                    f"SKIP {iid}: no decodable keyframes")
                skipped += 1
                continue
            t0 = time.perf_counter()
            tags = [t["tag"] for t in item["tags"]]
            text_emb = text_x(tags, batch)
            img_emb = img_x(frames, batch)
            sink(iid, text_emb, img_emb)
            seconds.append(time.perf_counter() - t0)
            written += 1
            log(f"{iid}: text {text_emb.shape} img {img_emb.shape}")
    finally:
        lookahead.shutdown(wait=True)
    return {"items": written, "skipped": skipped, "item_seconds": seconds}


def main(argv=None, device=None) -> dict:
    """`device` defaults to the GPU (raising where there is none)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_json", required=True)
    p.add_argument("--image_root", required=True)
    p.add_argument("--text_config", required=True)
    p.add_argument("--text_ckpt", required=True)
    p.add_argument("--vit_config", required=True)
    p.add_argument("--vit_ckpt", required=True)
    p.add_argument("--tokenizer_json", default=None)
    p.add_argument("--spm_model", default=None)
    p.add_argument("--vocab_path", default=None,
                   help="plain token<TAB>score vocab for the built-in "
                        "Unigram backend (no sentencepiece needed)")
    p.add_argument("--output", required=True)
    p.add_argument("--seq_length", type=int, default=196)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--decode_workers", type=int,
                   default=min(os.cpu_count() or 1, 8))
    args = p.parse_args(argv)
    device = require_cuda() if device is None else torch.device(device)

    from lr2ppo_torch.data.tokenizers import XLMRobertaTokenizer

    tok = XLMRobertaTokenizer(spm_model_path=args.spm_model,
                              tokenizer_json_path=args.tokenizer_json,
                              vocab_path=args.vocab_path)
    text_cfg = TowerConfig.from_json(args.text_config)
    vit_cfg = TowerConfig.from_json(args.vit_config)
    text_x = TextFeatureExtractor(
        text_cfg, encoder_state(load_tower_checkpoint(args.text_ckpt)), tok,
        args.seq_length, device=device)
    img_x = ImageFeatureExtractor(
        vit_cfg, encoder_state(load_tower_checkpoint(args.vit_ckpt)),
        device=device)

    with open(args.data_json) as f:
        items = json.load(f)
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(args.output)) or ".",
                exist_ok=True)

    def frames_of(item):
        return load_frames(os.path.join(args.image_root, str(item["id"])),
                           vit_cfg.image_height, vit_cfg.image_width,
                           workers=args.decode_workers)

    with h5py.File(args.output, "w") as hf:
        return extract_items(
            items, frames_of,
            lambda iid, t, i: write_clean_feat(args.output, iid, t, i,
                                               h5_file=hf),
            text_x, img_x, args.batch)


if __name__ == "__main__":
    main()
