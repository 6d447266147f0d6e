"""Tower pretraining CLI (counterpart of lr2ppo_tpu/cli/pretrain.py): MLM,
causal LM or classification pretraining of a tower config on one GPU, or on
one process per GPU under `torchrun --nproc_per_node N -m lr2ppo_torch.cli
pretrain ...` or `--distributed --coordinator --num_processes
--process_id`.

    python -m lr2ppo_torch.cli pretrain --corpus_path corpus.txt \\
        --tower_config models/xlm-roberta/base_config.json \\
        --data_processor mlm --tokenizer space --vocab_path vocab.txt \\
        --hash_dropout --output_model_path ckpt/mlm --total_steps 10000

It takes the JAX CLI's flags, with their meaning: --batch_size is the
global batch, --dp -1 takes the world over --pp and --tp, --zero1 and
--fsdp shard the optimizer and the parameters over dp, --pp N runs the
encoder as N pipeline stages of --pp_microbatches microbatches (GPipe,
parallel/pipeline.py), --sp (with --tp > 1) splits the residual stream
along the sequence over tp. Every processor of the JAX CLI runs (mlm, lm,
cls, bert, albert, cls_mlm, bilm, prefixlm, mt, t5, gsg, bart, vit, clip,
vilt, s2t, beit, dalle; data/pretrain_processors.py,
data/pretrain_data.py, in the batch form of str2form), as the JAX CLI
builds them: t5 grows the vocabulary by its 100 sentinels from
--sentinel_start (default: the vocabulary's end); the image and speech
corpora are tsv manifests, vit 'label<TAB>image path', clip, vilt and dalle
'caption<TAB>image path', beit one image path a row, s2t
'transcript<TAB>wav path', at the image size of the tower config's top
level; beit and dalle tokenize the images with the VQGAN of
--vqgan_model_path (seeded weights without it) on the run's device, beit's
head spans its 1,024 codes and dalle grows the vocabulary by them; s2t
reads --max_audio_frames frames (default: the tower JSON's, else 256), and
its position tables count them. It runs on the GPU unless `--device cpu`
is given, and raises where there is no GPU. The checkpoints are
reference-keyed `.bin` files. --profile_dir DIR, which the JAX CLI lacks,
traces steps 10 to 20 as the stage CLIs do.
"""

from __future__ import annotations

import argparse
import json

from lr2ppo_torch.config import Config, _parse_bool
from lr2ppo_torch.data import pretrain_processors as processors
from lr2ppo_torch.data.pipeline import Loader
from lr2ppo_torch.data.pretrain_data import (ClipPairDataset, ClsTsvDataset,
                                             LmCorpusDataset,
                                             MlmCorpusDataset,
                                             VitImageDataset)
from lr2ppo_torch.data.pretrain_processors import (AlbertDocsDataset,
                                                   BartDocsDataset,
                                                   BeitImageDataset,
                                                   BertDocsDataset,
                                                   BilmCorpusDataset,
                                                   ClsMlmTsvDataset,
                                                   DalleDataset,
                                                   GsgDocsDataset,
                                                   MtTsvDataset,
                                                   PrefixlmTsvDataset,
                                                   S2tDataset,
                                                   T5CorpusDataset,
                                                   ViltPairsDataset)
from lr2ppo_torch.data.tokenizers import ImageTokenizer, str2tokenizer
from lr2ppo_torch.towers.model import TowerConfig
from lr2ppo_torch.towers.vqgan import VQGANConfig
from lr2ppo_torch.train.pretrain import PretrainTrainer

# the T5 sentinels, past --sentinel_start
N_SENTINELS = 100


def _special_ids(tok):
    """(cls, pad, sep) ids from the tokenizer's resolved specials,
    falling back to the XLM-R layout (0/1/2) when the vocab has none
    (e.g. GPT-2 BPE)."""
    v = tok.vocab or {}

    def gid(key, default):
        t = tok.specials.get(key)
        return v[t] if t in v else default

    return gid("cls_token", 0), gid("pad_token", 1), gid("sep_token", 2)


def _special_ids_csp(tok):
    """(cls, sep, pad) — the pretrain_data constructors' arg order."""
    c, p, sep = _special_ids(tok)
    return c, sep, p


def _mask_id(tok):
    name = tok.specials.get("mask_token", "<mask>")
    mid = tok.vocab.get(name)
    if mid is None:
        # a silent fallback would conflate a real token with the mask
        raise SystemExit(
            f"tokenizer vocab has no mask token ({name!r}); masked "
            f"pretraining needs one — add it to the vocab or pick a "
            f"tokenizer that defines it")
    return mid


# data_processor -> the trainer's batch form (train/pretrain.py:form_args),
# as in the JAX CLI
str2form = {"mlm": "simple", "lm": "simple", "cls": "simple",
            "prefixlm": "simple", "bert": "pair_sp", "albert": "pair_sp",
            "cls_mlm": "pair_cls", "bilm": "bilm", "mt": "seq2seq",
            "t5": "seq2seq", "gsg": "seq2seq", "bart": "seq2seq",
            "vit": "simple", "clip": "clip", "vilt": "vilt", "s2t": "seq2seq",
            "beit": "beit", "dalle": "simple"}

# data_processor -> dataset builder, the JAX CLI's
str2dataset = {
    "mlm": lambda path, tok, args, cfg: MlmCorpusDataset(
        path, tok, args.seq_length, cfg.vocab_size, _mask_id(tok),
        *_special_ids_csp(tok), seed=args.seed),
    "lm": lambda path, tok, args, cfg: LmCorpusDataset(
        path, tok, args.seq_length + 1, cfg.vocab_size, 0,
        *_special_ids_csp(tok)),
    "cls": lambda path, tok, args, cfg: ClsTsvDataset(
        path, tok, args.seq_length, *_special_ids_csp(tok)),
    "bert": lambda path, tok, args, cfg: BertDocsDataset(
        path, tok, args.seq_length, cfg.vocab_size, _mask_id(tok),
        seed=args.seed, short_seq_prob=args.short_seq_prob,
        dup_factor=args.dup_factor),
    "albert": lambda path, tok, args, cfg: AlbertDocsDataset(
        path, tok, args.seq_length, cfg.vocab_size, _mask_id(tok),
        seed=args.seed, short_seq_prob=args.short_seq_prob,
        dup_factor=args.dup_factor),
    "cls_mlm": lambda path, tok, args, cfg: ClsMlmTsvDataset(
        path, tok, args.seq_length, cfg.vocab_size, _mask_id(tok),
        seed=args.seed),
    "bilm": lambda path, tok, args, cfg: BilmCorpusDataset(
        path, tok, args.seq_length),
    "prefixlm": lambda path, tok, args, cfg: PrefixlmTsvDataset(
        path, tok, args.seq_length),
    "mt": lambda path, tok, args, cfg: MtTsvDataset(
        path, tok, args.seq_length, args.tgt_seq_length),
    "t5": lambda path, tok, args, cfg: T5CorpusDataset(
        path, tok, args.seq_length, args.tgt_seq_length, cfg.vocab_size,
        sentinel_start=_sentinel_start(tok, args), n_sentinels=N_SENTINELS,
        seed=args.seed),
    "gsg": lambda path, tok, args, cfg: GsgDocsDataset(
        path, tok, args.seq_length, args.tgt_seq_length, _mask_id(tok),
        strategy=args.sentence_selection_strategy, seed=args.seed),
    "bart": lambda path, tok, args, cfg: BartDocsDataset(
        path, tok, args.seq_length, cfg.vocab_size, _mask_id(tok),
        seed=args.seed),
    "vit": lambda path, tok, args, cfg: VitImageDataset(
        [(p, int(lbl)) for lbl, p in _read_tsv(path)],
        cfg.image_height, cfg.image_width, cfg.patch_size),
    # the JAX CLI frames the captions with the datasets' default ids
    "clip": lambda path, tok, args, cfg: ClipPairDataset(
        _read_tsv(path), tok, args.seq_length, cfg.image_height,
        cfg.image_width, cfg.patch_size),
    "vilt": lambda path, tok, args, cfg: ViltPairsDataset(
        _read_tsv(path), tok, args.seq_length, cfg.vocab_size,
        _mask_id(tok), cfg.image_height, cfg.image_width,
        cfg.patch_size, seed=args.seed),
    "s2t": lambda path, tok, args, cfg: S2tDataset(
        path, tok, args.tgt_seq_length, args.max_audio_frames),
    "beit": lambda path, tok, args, cfg: BeitImageDataset(
        [row[0] for row in _read_tsv(path, n=1)], _image_tok(args),
        cfg.image_height, cfg.image_width, cfg.patch_size,
        seed=args.seed),
    "dalle": lambda path, tok, args, cfg: DalleDataset(
        _read_tsv(path), tok, _image_tok(args), args.seq_length,
        vocab_bias=len(tok.vocab)),
}


def _read_tsv(path: str, n: int = 2) -> list:
    """The first n fields of each tsv row with n fields or more whose first
    is not empty (the JAX CLI's manifest reader)."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= n and parts[0]:
                rows.append(tuple(parts[:n]))
    return rows


def _image_tok(args) -> ImageTokenizer:
    """The VQGAN of --vqgan_model_path (seeded by --seed without it), on
    the run's device (build sets args.device)."""
    return ImageTokenizer(vqgan_model_path=args.vqgan_model_path,
                          seed=args.seed, device=args.device)


def _sentinel_start(tok, args) -> int:
    return (args.sentinel_start if args.sentinel_start is not None
            else len(tok.vocab))


def parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, and --device."""
    p = argparse.ArgumentParser(description="lr2ppo-torch tower pretraining")
    p.add_argument("--corpus_path", required=True)
    p.add_argument("--tower_config", required=True)
    p.add_argument("--data_processor", default="mlm",
                   choices=sorted(str2dataset))
    p.add_argument("--tokenizer", default="bpe",
                   choices=["char", "space", "bert", "bpe", "xlmroberta"])
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--merges_path", default=None)
    p.add_argument("--spm_model_path", default=None)
    p.add_argument("--tokenizer_json", default=None)
    p.add_argument("--output_model_path", default="ckpt/pretrained")
    p.add_argument("--pretrained_model_path", default=None)
    p.add_argument("--resume_path", default=None,
                   help="step-numbered .state checkpoint to resume from")
    p.add_argument("--log_path", default=None)
    p.add_argument("--profile_dir", default=None,
                   help="a torch.profiler Chrome trace of steps 10 to 20 in "
                        "DIR/trace_steps_10-20.json (rank 0)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--seq_length", type=int, default=128)
    p.add_argument("--tgt_seq_length", type=int, default=128)
    p.add_argument("--short_seq_prob", type=float, default=0.1)
    p.add_argument("--dup_factor", type=int, default=1)
    p.add_argument("--sentinel_start", type=int, default=None)
    p.add_argument("--sentence_selection_strategy", default="random",
                   choices=["random", "lead"])
    p.add_argument("--vqgan_model_path", default=None)
    p.add_argument("--max_audio_frames", type=int, default=None)
    p.add_argument("--total_steps", type=int, default=None)
    p.add_argument("--epochs_num", type=int, default=1)
    p.add_argument("--report_steps", type=int, default=100)
    p.add_argument("--save_checkpoint_steps", type=int, default=0)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--compute_dtype", default="float32")
    p.add_argument("--hash_dropout", action="store_true",
                   help="hash dropout at every tower dropout site "
                        "(ops/hash_dropout.py, the CUDA kernel on a GPU)")
    p.add_argument("--sp", action="store_true")
    p.add_argument("--ckpt_backend", default="pickle",
                   choices=["pickle", "orbax", "orbax_async"])
    p.add_argument("--distributed", type=_parse_bool, nargs="?",
                   const=True, default=False)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--jax_platform", default="",
                   help="the JAX package's backend flag; the port refuses it "
                        "(pass --device)")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one)")
    return p


def build(args, device=None):
    """(trainer, loader) from parsed flags; raises on what the JAX CLI
    refuses."""
    if args.jax_platform:
        raise SystemExit("--jax_platform names a JAX backend; lr2ppo_torch "
                         "takes --device")
    if args.tokenizer == "bpe":
        tok = str2tokenizer["bpe"](args.vocab_path, args.merges_path)
    elif args.tokenizer == "xlmroberta":
        tok = str2tokenizer["xlmroberta"](
            spm_model_path=args.spm_model_path,
            tokenizer_json_path=args.tokenizer_json)
    else:
        tok = str2tokenizer[args.tokenizer](args.vocab_path)
    # frame the processors' instances with the tokenizer's own special ids
    # (their defaults are the XLM-R layout), as the JAX CLI does
    processors.set_special_ids(*_special_ids(tok))

    vocab_size = max(len(tok.vocab), 1)
    if args.data_processor == "t5":
        # the sentinels fill [start, start + 100): grow the vocabulary to
        # cover them wherever they start
        vocab_size += max(0, _sentinel_start(tok, args) + N_SENTINELS
                          - len(tok.vocab))
    elif args.data_processor == "dalle":
        # the image's codes follow the text's vocabulary
        vocab_size += VQGANConfig().n_embed
    elif args.data_processor == "beit":
        # the mlm head spans the image codebook
        vocab_size = VQGANConfig().n_embed
    # grow-only max_seq_length: keep the JSON's own value (XLM-R's 514)
    with open(args.tower_config) as f:
        raw = json.load(f)
    raw_msl = raw.get("max_seq_length", TowerConfig().max_seq_length)
    maf = (args.max_audio_frames if args.max_audio_frames is not None
           else raw.get("max_audio_frames", 256))
    args.max_audio_frames = maf
    if args.sp and args.tp <= 1:
        raise SystemExit("--sp shards the sequence over tp; pass --tp > 1")
    tower_cfg = TowerConfig.from_json(
        args.tower_config, vocab_size=vocab_size,
        max_seq_length=max(args.seq_length, raw_msl), max_audio_frames=maf,
        **({"hash_dropout": True} if args.hash_dropout else {}),
        **({"seq_parallel": True} if args.sp else {}))

    tgt_kinds = set(tower_cfg.tgt_embedding or tower_cfg.embedding)
    # the position tables are sized by --seq_length (or the JSON's
    # max_seq_length), and by the audio frames under speech, as in the JAX
    # CLI
    pos_rows = tower_cfg.max_seq_length
    if "speech" in tower_cfg.embedding:
        pos_rows = max(pos_rows, tower_cfg.max_audio_frames)
    if (str2form[args.data_processor] == "seq2seq"
            and args.tgt_seq_length > pos_rows
            and tgt_kinds & {"pos", "sinusoidalpos"}):
        raise SystemExit(f"--tgt_seq_length {args.tgt_seq_length} exceeds "
                         f"the position tables' {pos_rows} rows; raise "
                         "--seq_length")

    cfg = Config()
    cfg = cfg.replace(
        epochs_num=args.epochs_num, batch_size=args.batch_size,
        report_steps=args.report_steps, seed=args.seed,
        output_model_path=args.output_model_path, log_path=args.log_path,
        pretrained_model_path=args.pretrained_model_path,
        resume_path=args.resume_path, ckpt_backend=args.ckpt_backend,
        profile_dir=args.profile_dir)
    cfg.optim.learning_rate = args.learning_rate
    cfg.mesh.dp = args.dp
    cfg.mesh.tp = args.tp
    cfg.mesh.zero1 = args.zero1
    cfg.mesh.fsdp = args.fsdp
    cfg.mesh.pp = args.pp
    cfg.mesh.pp_microbatches = args.pp_microbatches
    cfg.mesh.compute_dtype = args.compute_dtype
    cfg.mesh.distributed = args.distributed
    cfg.mesh.coordinator = args.coordinator or ""
    cfg.mesh.num_processes = args.num_processes or 0
    cfg.mesh.process_id = (args.process_id if args.process_id is not None
                           else -1)
    # refuses what the JAX trainer refuses before the corpus is read
    trainer = PretrainTrainer(cfg, tower_cfg, args.accumulation_steps,
                              device=device,
                              form=str2form[args.data_processor])

    # beit and dalle tokenize their images on the run's device
    args.device = str(trainer.device)
    ds = str2dataset[args.data_processor](args.corpus_path, tok, args,
                                          tower_cfg)
    # each optimizer step takes accumulation_steps micro-batches of
    # batch_size rows (the trainer folds them)
    mesh = trainer.ctx.mesh
    loader = Loader(ds, args.batch_size * args.accumulation_steps,
                    shuffle=True, seed=args.seed, reuse_buffers=True,
                    shard=(mesh.dp_rank, mesh.dp) if mesh.dp > 1 else None,
                    shard_chunks=max(args.accumulation_steps, 1))
    return trainer, loader


def main(argv=None, device=None) -> float:
    """Returns the best accuracy. `device` (or --device) defaults to the
    GPU."""
    args = parser().parse_args(argv)
    trainer, loader = build(args, device or args.device)
    _state, best = trainer.fit(loader, args.total_steps,
                               args.save_checkpoint_steps)
    return best


if __name__ == "__main__":
    main()
