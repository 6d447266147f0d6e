"""The text pretraining processors (counterpart of
lr2ppo_tpu/data/pretrain_processors.py, the reference's dataset.py:86-861
and dataloader.py): bert (mlm + next sentence), albert (mlm + sentence
order), cls_mlm, bilm, prefixlm, and the seq2seq ones, mt, t5 (span
corruption), gsg (gap sentences) and bart (denoising). The port keeps its
own copy: the instances are built from the same numpy draws as the JAX
package's, from the same seeds, so the items are equal array for array
(tests/test_torch_pretrain_processors.py, tests/test_torch_seq2seq.py).

Every dataset emits fixed-shape numpy arrays; dynamic masking reseeds per
(epoch, item) like data/pretrain_data.py:MlmCorpusDataset. Batch-key
conventions (train/pretrain.py:form_args):
  simple   {src, tgt, seg}                       prefixlm
  pair_sp  {src, tgt_mlm, tgt_sp, seg}           bert (NSP), albert (SOP)
  pair_cls {src, tgt_mlm, tgt_cls, seg}          cls_mlm
  bilm     {src, tgt_fwd, tgt_bwd, seg}          bilm
  seq2seq  {src, tgt_out, seg, tgt_in, tgt_seg}  mt, t5, gsg, bart
Each takes the frame ids (CLS, SEP, PAD) that set_special_ids holds when it
is built. The image and speech processors wait (ROADMAP.md, queue A5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from lr2ppo_torch.data.pretrain_data import MlmCorpusDataset, mask_tokens

# id conventions follow the repo's xlmroberta-style defaults
CLS, PAD, SEP = 0, 1, 2


def set_special_ids(cls_id: int = 0, pad_id: int = 1,
                    sep_id: int = 2) -> None:
    """Align the instance-frame layout with the ACTIVE tokenizer's vocab
    (module defaults are the XLM-R layout, <s>=0 <pad>=1 </s>=2, which
    the reference hardcodes via utils/constants.py). The pretrain CLI
    calls this after building the tokenizer so e.g. a BERT vocab frames
    with [CLS]=101/[SEP]=102/[PAD]=0 instead of unrelated token ids.
    Every processor reads the module globals at build time."""
    global CLS, PAD, SEP
    CLS, PAD, SEP = cls_id, pad_id, sep_id


def read_documents(path: str, tokenizer) -> List[List[List[int]]]:
    """Blank-line-separated documents, one sentence per line (the
    reference's BertDataset corpus format, dataset.py:86-92)."""
    docs, doc = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                if doc:
                    docs.append(doc)
                doc = []
                continue
            ids = tokenizer.encode(line.strip())
            if ids:
                doc.append(ids)
    if doc:
        docs.append(doc)
    return docs


def _truncate_pair(a: List[int], b: List[int], max_tokens: int,
                   rng: np.random.Generator) -> None:
    """Random front/back truncation of the longer side
    (dataset.py:29-41)."""
    while len(a) + len(b) > max_tokens:
        t = a if len(a) > len(b) else b
        if rng.random() < 0.5:
            del t[0]
        else:
            t.pop()


def _pad_pair_instance(tokens_a, tokens_b, label, seq_length):
    """[CLS] a [SEP] b [SEP] -> fixed (src, seg∈{1,2,0}, label)."""
    src = np.full(seq_length, PAD, np.int32)
    seg = np.zeros(seq_length, np.int32)
    ids = [CLS] + tokens_a + [SEP]
    n_a = len(ids)
    ids = ids + tokens_b + [SEP]
    ids = ids[:seq_length]
    src[: len(ids)] = ids
    seg[: min(n_a, seq_length)] = 1
    if len(ids) > n_a:
        seg[n_a: len(ids)] = 2
    return src, seg, np.int32(label)


class _MaskedPairDataset:
    """Shared base: instances of (src, seg, aux-label) + per-(epoch, item)
    dynamic MLM masking."""

    def __init__(self, vocab_size: int, mask_id: int, seed: int = 7,
                 mlm_prob: float = 0.15, special_limit: int = 5):
        self.vocab_size = vocab_size
        self.mask_id = mask_id
        self.seed = seed
        self.epoch = 0
        self.mlm_prob = mlm_prob
        self.special_limit = special_limit
        # snapshot the frame ids the instances are about to be built
        # with: a later set_special_ids (e.g. a second tokenizer in the
        # same process) must not desynchronize masking from data that
        # was framed under the previous layout
        self.frame_ids = (CLS, SEP, PAD)
        self.instances: List[Tuple[np.ndarray, np.ndarray, np.int32]] = []

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.instances)

    def _mask(self, src, seg, i):
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + i)
        return mask_tokens(src, seg, self.vocab_size, self.mask_id, rng,
                           self.mlm_prob, special_limit=self.special_limit,
                           exclude_ids=(*self.frame_ids, self.mask_id))


class BertDocsDataset(_MaskedPairDataset):
    """MLM + next-sentence-prediction instances (dataset.py:86-224):
    chunk a document to ~target length, split at a random sentence
    boundary into A/B, and with p=0.5 replace B with a span from a random
    other document (tgt_sp=1 means 'random next', matching the
    reference's is_random_next labeling)."""

    aux_key = "tgt_sp"

    def __init__(self, corpus_path: str, tokenizer, seq_length: int,
                 vocab_size: int, mask_id: int, seed: int = 7,
                 short_seq_prob: float = 0.1, dup_factor: int = 1,
                 mlm_prob: float = 0.15, special_limit: int = 5):
        super().__init__(vocab_size, mask_id, seed, mlm_prob, special_limit)
        self.seq_length = seq_length
        docs = read_documents(corpus_path, tokenizer)
        rng = np.random.default_rng(seed)
        for _ in range(dup_factor):
            for di in range(len(docs)):
                self.instances.extend(
                    self._from_doc(docs, di, rng, short_seq_prob))

    def _build_pair(self, docs, di, chunk, a_end, target_len, rng):
        """(tokens_a, tokens_b, label, segments_consumed). NSP: with
        p=0.5 (or a one-segment chunk) B comes from a random OTHER
        document and the unconsumed segments are handed back to the
        chunker (dataset.py:150-186)."""
        tokens_a = [t for s in chunk[:a_end] for t in s]
        if len(chunk) == 1 or rng.random() < 0.5:
            is_random = 1
            want_b = target_len - len(tokens_a)
            rdi = di
            for _ in range(10):
                rdi = int(rng.integers(0, len(docs)))
                if rdi != di:
                    break
            rdoc = docs[rdi]
            rstart = int(rng.integers(0, len(rdoc)))
            tokens_b = []
            for s in rdoc[rstart:]:
                tokens_b.extend(s)
                if len(tokens_b) >= want_b:
                    break
            return tokens_a, tokens_b, is_random, a_end
        tokens_b = [t for s in chunk[a_end:] for t in s]
        return tokens_a, tokens_b, 0, len(chunk)

    def _from_doc(self, docs, di, rng, short_seq_prob):
        doc = docs[di]
        max_tokens = self.seq_length - 3
        target_len = max_tokens
        if rng.random() < short_seq_prob:
            target_len = int(rng.integers(2, max_tokens + 1))
        out, chunk, clen, i = [], [], 0, 0
        while i < len(doc):
            chunk.append(doc[i])
            clen += len(doc[i])
            if i == len(doc) - 1 or clen >= target_len:
                if chunk:
                    a_end = 1
                    if len(chunk) >= 2:
                        a_end = int(rng.integers(1, len(chunk)))
                    tokens_a, tokens_b, label, consumed = self._build_pair(
                        docs, di, chunk, a_end, target_len, rng)
                    i -= len(chunk) - consumed  # reuse unconsumed segs
                    _truncate_pair(tokens_a, tokens_b, max_tokens, rng)
                    if tokens_a and tokens_b:
                        out.append(_pad_pair_instance(
                            tokens_a, tokens_b, label, self.seq_length))
                chunk, clen = [], 0
            i += 1
        return out

    def get(self, i: int) -> Dict[str, np.ndarray]:
        src, seg, aux = self.instances[i]
        masked, tgt = self._mask(src, seg, i)
        return {"src": masked, "tgt_mlm": tgt, self.aux_key: aux,
                "seg": seg}


class AlbertDocsDataset(BertDocsDataset):
    """MLM + sentence-order-prediction (dataset.py:321-430): A/B from the
    same chunk, swapped with p=0.5; tgt_sp=1 means wrong order. Shares
    BertDocsDataset's chunker; only the pair construction differs."""

    def _build_pair(self, docs, di, chunk, a_end, target_len, rng):
        tokens_a = [t for s in chunk[:a_end] for t in s]
        tokens_b = [t for s in chunk[a_end:] for t in s]
        is_wrong = 0
        if rng.random() < 0.5:
            is_wrong = 1
            tokens_a, tokens_b = tokens_b, tokens_a
        return tokens_a, tokens_b, is_wrong, len(chunk)


class ClsMlmTsvDataset(_MaskedPairDataset):
    """Joint classification + MLM (dataset.py:796-861): tsv rows
    'label<TAB>text' or 'label<TAB>text_a<TAB>text_b'."""

    aux_key = "tgt_cls"

    def __init__(self, tsv_path: str, tokenizer, seq_length: int,
                 vocab_size: int, mask_id: int, seed: int = 7,
                 mlm_prob: float = 0.15, special_limit: int = 5):
        super().__init__(vocab_size, mask_id, seed, mlm_prob, special_limit)
        self.seq_length = seq_length
        with open(tsv_path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    label, a, b = int(parts[0]), \
                        tokenizer.encode(parts[1]), []
                elif len(parts) == 3:
                    label = int(parts[0])
                    a = tokenizer.encode(parts[1])
                    b = tokenizer.encode(parts[2])
                else:
                    continue
                src = np.full(seq_length, PAD, np.int32)
                seg = np.zeros(seq_length, np.int32)
                ids = [CLS] + a + [SEP]
                n_a = len(ids)
                if b:
                    ids = ids + b + [SEP]
                ids = ids[:seq_length]
                src[: len(ids)] = ids
                seg[: min(n_a, seq_length)] = 1
                if len(ids) > n_a:
                    seg[n_a: len(ids)] = 2
                self.instances.append((src, seg, np.int32(label)))

    def get(self, i: int) -> Dict[str, np.ndarray]:
        src, seg, label = self.instances[i]
        masked, tgt = self._mask(src, seg, i)
        return {"src": masked, "tgt_mlm": tgt, "tgt_cls": label,
                "seg": seg}


class BilmCorpusDataset:
    """Bidirectional-LM processor (dataset.py:470-508): raw token stream
    in seq_length chunks; forward target = next token (SEP at the end),
    backward target = previous token (CLS at the start). Pad positions
    get target 0 so the loss mask excludes them (the reference pads
    targets with PAD and counts them — a bug we do not reproduce)."""

    def __init__(self, corpus_path: str, tokenizer, seq_length: int):
        self.seq_length = seq_length
        self.cls, self.sep, self.pad = CLS, SEP, PAD  # frame snapshot
        rows = []
        with open(corpus_path, encoding="utf-8") as f:
            for line in f:
                ids = tokenizer.encode(line.strip())
                for s in range(0, len(ids), seq_length):
                    chunk = ids[s: s + seq_length]
                    if chunk:
                        rows.append(chunk)
        self.rows = rows

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.rows)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        S = self.seq_length
        chunk = self.rows[i]
        n = len(chunk)
        src = np.full(S, self.pad, np.int32)
        src[:n] = chunk
        seg = np.zeros(S, np.int32)
        seg[:n] = 1
        fwd = np.zeros(S, np.int32)
        fwd[: n - 1] = chunk[1:]
        fwd[n - 1] = self.sep
        bwd = np.zeros(S, np.int32)
        bwd[0] = self.cls
        bwd[1:n] = chunk[: n - 1]
        return {"src": src, "tgt_fwd": fwd, "tgt_bwd": bwd, "seg": seg}


def _seq2seq_item(src_ids: List[int], tgt_ids: List[int],
                  seq_length: int, tgt_seq_length: int,
                  pad_id: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack encoder/decoder ids into the fixed 5-key seq2seq batch
    (dataloader.py MtDataloader semantics: tgt_in/tgt_out are the
    shifted decoder stream, targets 0 on padding). Callers that build
    items at get()-time pass their init-time pad snapshot via pad_id."""
    pad = PAD if pad_id is None else pad_id
    src = np.full(seq_length, pad, np.int32)
    seg = np.zeros(seq_length, np.int32)
    s = src_ids[:seq_length]
    src[: len(s)] = s
    seg[: len(s)] = 1

    full = tgt_ids[: tgt_seq_length + 1]
    n = len(full)
    tgt_in = np.full(tgt_seq_length, pad, np.int32)
    tgt_in[: min(n, tgt_seq_length)] = full[:tgt_seq_length]
    tgt_out = np.zeros(tgt_seq_length, np.int32)
    tgt_out[: n - 1] = full[1:]
    tgt_seg = np.zeros(tgt_seq_length, np.int32)
    tgt_seg[: min(n, tgt_seq_length)] = 1
    return {"src": src, "tgt_out": tgt_out, "seg": seg,
            "tgt_in": tgt_in, "tgt_seg": tgt_seg}


class MtTsvDataset:
    """Machine-translation processor (dataset.py:511-556 +
    dataloader.py:227-264): tsv rows 'source<TAB>target', independently
    tokenized (tgt_tokenizer optional), CLS/SEP wrapped."""

    def __init__(self, tsv_path: str, tokenizer, seq_length: int,
                 tgt_seq_length: int, tgt_tokenizer=None):
        tgt_tok = tgt_tokenizer or tokenizer
        self.items = []
        with open(tsv_path, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    continue
                src_ids = [CLS] + tokenizer.encode(parts[0]) + [SEP]
                tgt_ids = [CLS] + tgt_tok.encode(parts[1]) + [SEP]
                self.items.append(_seq2seq_item(
                    src_ids, tgt_ids, seq_length, tgt_seq_length))

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.items)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        return self.items[i]


class PrefixlmTsvDataset:
    """Prefix-LM processor (dataset.py:750-793): src = [CLS] prefix [SEP]
    target [SEP] with seg 1 on the prefix and 2 on the target; tgt is the
    next-token stream over the target region only (zeros elsewhere). The
    encoder runs with mask='causal_with_prefix'."""

    def __init__(self, tsv_path: str, tokenizer, seq_length: int):
        self.items = []
        with open(tsv_path, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    continue
                a = [CLS] + tokenizer.encode(parts[0]) + [SEP]
                b = tokenizer.encode(parts[1]) + [SEP]
                n_a = len(a)
                if n_a >= seq_length:
                    continue
                ids = (a + b)[:seq_length]
                src = np.full(seq_length, PAD, np.int32)
                src[: len(ids)] = ids
                seg = np.zeros(seq_length, np.int32)
                seg[:n_a] = 1
                seg[n_a: len(ids)] = 2
                # position n_a-1 (the [SEP]) predicts b[0], etc.
                tgt = np.zeros(seq_length, np.int32)
                nb = len(ids) - n_a
                tgt[n_a - 1: n_a - 1 + nb] = b[:nb]
                self.items.append({"src": src, "tgt": tgt, "seg": seg})

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.items)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        return self.items[i]


class T5CorpusDataset:
    """T5 span-corruption processor (dataset.py:559-563 reuses the MLM
    packing; the sentinel construction lives in dataloader.py:267-349):
    ~mlm_prob of tokens are masked per (epoch, item), contiguous masked
    runs collapse to one sentinel id in the (re-compacted, re-padded)
    encoder stream, and the decoder stream is
    [CLS] s0 <run0> s1 <run1> ... s_k [SEP].

    Deviation for static shapes: the reference pads the decoder side to
    the longest target in each batch; here `tgt_seq_length` is fixed.
    """

    def __init__(self, corpus_path: str, tokenizer, seq_length: int,
                 tgt_seq_length: int, vocab_size: int,
                 sentinel_start: int, n_sentinels: int = 100,
                 seed: int = 7, mlm_prob: float = 0.15,
                 special_limit: int = 5):
        # reuse the MLM corpus packing (CLS/SEP framing + fixed rows),
        # framed with the ACTIVE tokenizer's specials (the module
        # globals set_special_ids aligned) — the constructor defaults
        # are the XLM-R layout and would frame a BERT vocab with
        # arbitrary wordpieces as CLS/SEP
        base = MlmCorpusDataset(corpus_path, tokenizer, seq_length,
                                vocab_size, mask_id=0, cls_id=CLS,
                                sep_id=SEP, pad_id=PAD, seed=seed)
        self.cls, self.sep, self.pad = CLS, SEP, PAD  # frame snapshot
        self.ids, self.seg = base.ids, base.seg
        self.seq_length = seq_length
        self.tgt_seq_length = tgt_seq_length
        self.sentinel_start = sentinel_start
        self.n_sentinels = n_sentinels
        self.seed = seed
        self.epoch = 0
        self.mlm_prob = mlm_prob
        self.special_limit = special_limit

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.ids.shape[0]

    def get(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + i)
        ids, seg = self.ids[i], self.seg[i]
        # specials excluded by identity too: a BERT-layout vocab has
        # CLS/SEP above special_limit and they must keep their framing
        # (the reference never masks them, utils/mask.py)
        real = ((seg > 0) & (ids >= self.special_limit)
                & ~np.isin(ids, (self.cls, self.sep, self.pad)))
        sel = real & (rng.random(ids.shape) < self.mlm_prob)
        if not sel.any():  # force at least one corrupted token
            cand = np.flatnonzero(real)
            if cand.size:
                sel[cand[int(rng.integers(0, cand.size))]] = True

        src_c: List[int] = []
        tgt: List[int] = [self.cls]
        sentinel = self.sentinel_start
        last = self.sentinel_start + self.n_sentinels - 1
        in_span = False
        for j in range(self.seq_length):
            if not seg[j]:
                break
            if sel[j]:
                if not in_span:
                    src_c.append(sentinel)
                    tgt.append(sentinel)
                    sentinel = min(sentinel + 1, last)
                    in_span = True
                tgt.append(int(ids[j]))
            else:
                src_c.append(int(ids[j]))
                in_span = False
        tgt.append(sentinel)
        tgt.append(self.sep)

        src = np.full(self.seq_length, self.pad, np.int32)
        src[: len(src_c)] = src_c[: self.seq_length]
        seg_out = np.zeros(self.seq_length, np.int32)
        seg_out[: min(len(src_c), self.seq_length)] = 1

        item = _seq2seq_item([], tgt, self.seq_length,
                             self.tgt_seq_length, pad_id=self.pad)
        item["src"], item["seg"] = src, seg_out
        return item


class GsgDocsDataset:
    """PEGASUS gap-sentence-generation processor (dataset.py:566-625):
    ~30% of a document's sentences become the decoder target; each
    selected sentence is replaced by a single [MASK] in the encoder
    stream. `strategy` is 'random' or 'lead' (the reference's
    sentence_selection_strategy)."""

    def __init__(self, corpus_path: str, tokenizer, seq_length: int,
                 tgt_seq_length: int, mask_id: int,
                 strategy: str = "random", seed: int = 7):
        docs = read_documents(corpus_path, tokenizer)
        rng = np.random.default_rng(seed)
        self.items = []
        max_src, max_tgt = seq_length - 2, tgt_seq_length - 2
        for doc in docs:
            doc = [s for s in doc if len(s) < max_src and len(s) < max_tgt]
            if not doc:
                continue
            n_mask = int(round(len(doc) * 0.3))
            if strategy == "random" and len(doc) > 1:
                masked = set(int(x) for x in rng.choice(
                    len(doc) - 1, size=min(n_mask, len(doc) - 1),
                    replace=False))
            else:
                masked = set(range(n_mask))
            src: List[int] = []
            tgt: List[int] = []
            for si, sent in enumerate(doc):
                if (si in masked and len(tgt) + len(sent) < max_tgt
                        and len(src) + 1 < max_src):
                    tgt.extend(sent)
                    src.append(mask_id)
                elif si not in masked and len(src) + len(sent) < max_src:
                    src.extend(sent)
                else:
                    if src and tgt:
                        self._emit(src, tgt, seq_length, tgt_seq_length)
                    if si in masked:
                        src, tgt = [mask_id], list(sent)
                    else:
                        src, tgt = list(sent), []
            if src and tgt:
                self._emit(src, tgt, seq_length, tgt_seq_length)

    def _emit(self, src, tgt, seq_length, tgt_seq_length):
        self.items.append(_seq2seq_item(
            [CLS] + src + [SEP], [CLS] + tgt + [SEP],
            seq_length, tgt_seq_length))

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.items)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        return self.items[i]


class BartDocsDataset:
    """BART denoising processor (dataset.py:628-683 +
    dataloader.py:356-414): sentences of a chunk are shuffled for the
    encoder stream while the decoder reconstructs the original order;
    per (epoch, item), ~mlm_prob tokens are masked and consecutive masks
    collapse to a single [MASK] (span infilling), re-compacted and
    re-padded."""

    def __init__(self, corpus_path: str, tokenizer, seq_length: int,
                 vocab_size: int, mask_id: int, seed: int = 7,
                 mlm_prob: float = 0.15, special_limit: int = 5):
        self.seq_length = seq_length
        self.mask_id = mask_id
        self.seed = seed
        self.epoch = 0
        self.mlm_prob = mlm_prob
        self.special_limit = special_limit
        self.cls, self.sep, self.pad = CLS, SEP, PAD  # frame snapshot
        docs = read_documents(corpus_path, tokenizer)
        rng = np.random.default_rng(seed)
        self.pairs: List[Tuple[List[int], List[int]]] = []
        budget = seq_length - 2
        for doc in docs:
            chunk: List[List[int]] = []
            clen = 0
            for sent in doc:
                if len(sent) > budget:
                    continue
                if clen + len(sent) < budget:
                    chunk.append(sent)
                    clen += len(sent)
                else:
                    self._emit(chunk, rng)
                    chunk, clen = [sent], len(sent)
            self._emit(chunk, rng)

    def _emit(self, chunk, rng):
        if not chunk:
            return
        order = rng.permutation(len(chunk))
        src = [t for k in order for t in chunk[k]]
        tgt = [t for s in chunk for t in s]
        self.pairs.append((src, tgt))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.pairs)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + i)
        src_ids, tgt_ids = self.pairs[i]
        sel = rng.random(len(src_ids)) < self.mlm_prob
        src_c: List[int] = [self.cls]
        prev_mask = False
        for j, t in enumerate(src_ids):
            if sel[j] and t >= self.special_limit and t not in (
                    self.cls, self.sep, self.pad, self.mask_id):
                if not prev_mask:
                    src_c.append(self.mask_id)
                prev_mask = True
            else:
                src_c.append(int(t))
                prev_mask = False
        src_c.append(self.sep)
        item = _seq2seq_item(src_c, [self.cls] + tgt_ids + [self.sep],
                             self.seq_length, self.seq_length,
                             pad_id=self.pad)
        return item
