"""The pretraining processors (counterpart of
lr2ppo_tpu/data/pretrain_processors.py, the reference's dataset.py:86-969
and dataloader.py): bert (mlm + next sentence), albert (mlm + sentence
order), cls_mlm, bilm, prefixlm, the seq2seq ones, mt, t5 (span
corruption), gsg (gap sentences) and bart (denoising), and the image and
speech ones, vilt (text + image, mlm + match), s2t (log-mel filterbanks of
wav files, the decoder's text), beit (VQGAN codes of masked patches) and
dalle (text, then VQGAN codes, as one causal stream). The port keeps its
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
  seq2seq  {src, tgt_out, seg, tgt_in, tgt_seg}  mt, t5, gsg, bart, s2t
  vilt     {src_text, src_image, tgt_mlm, tgt_match, seg}   vilt
  beit     {src_image, mask, tgt, seg}           beit
  simple                                         dalle
Each takes the frame ids (CLS, SEP, PAD) that set_special_ids holds when it
is built. The image datasets read a file through their `_pixels` method
(PIL, imported at first use); the wav reader is the stdlib's `wave`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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


class ViltPairsDataset:
    """ViLT processor (dataset.py:953 + dataloader.py:606-673): (text,
    image) pairs; per (epoch, item) the text is MLM-masked and with
    p=0.5 the image is swapped for a random other image (tgt_match=0).
    tgt_mlm spans the concatenated text+patch sequence (zeros over the
    image region); seg is 1/0 on text and 2 on the patch tokens."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], tokenizer,
                 seq_length: int, vocab_size: int, mask_id: int,
                 image_height: int = 224, image_width: int = 224,
                 patch_size: int = 16, seed: int = 7,
                 mlm_prob: float = 0.15, special_limit: int = 5):
        self.pairs = list(pairs)          # [(text, image_path), ...]
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self.mask_id = mask_id
        self.h, self.w = image_height, image_width
        self.img_seq = (image_height // patch_size) * (
            image_width // patch_size) + 1
        self.seed = seed
        self.epoch = 0
        self.mlm_prob = mlm_prob
        self.special_limit = special_limit
        self.frame_ids = (CLS, SEP, PAD)  # snapshot at framing time
        self.texts = []
        for text, _ in self.pairs:
            ids = [CLS] + tokenizer.encode(text)[: seq_length - 2] + [SEP]
            src = np.full(seq_length, PAD, np.int32)
            seg = np.zeros(seq_length, np.int32)
            src[: len(ids)] = ids
            seg[: len(ids)] = 1
            self.texts.append((src, seg))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.pairs)

    def _pixels(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB").resize((self.w, self.h))
        return (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + i)
        src, seg_text = self.texts[i]
        masked, tgt_text = mask_tokens(
            src, seg_text, self.vocab_size, self.mask_id, rng,
            self.mlm_prob, special_limit=self.special_limit,
            exclude_ids=(*self.frame_ids, self.mask_id))
        if rng.random() < 0.5 or len(self.pairs) == 1:
            match, path = 1, self.pairs[i][1]
        else:
            j = int(rng.integers(0, len(self.pairs)))
            match, path = int(j == i), self.pairs[j][1]
        tgt_mlm = np.concatenate(
            [tgt_text, np.zeros(self.img_seq, np.int32)])
        seg = np.concatenate(
            [seg_text, np.full(self.img_seq, 2, np.int32)])
        return {"src_text": masked, "src_image": self._pixels(path),
                "tgt_mlm": tgt_mlm, "tgt_match": np.int32(match),
                "seg": seg}


def logmel_fbank(waveform: np.ndarray, sample_rate: int = 16000,
                 n_mels: int = 80, frame_ms: float = 25.0,
                 shift_ms: float = 10.0, preemph: float = 0.97
                 ) -> np.ndarray:
    """Kaldi-style log-mel filterbank in pure numpy (replaces the
    reference's torchaudio.compliance.kaldi.fbank, dataloader.py:794).
    Returns (frames, n_mels) float32."""
    win = int(sample_rate * frame_ms / 1000)
    hop = int(sample_rate * shift_ms / 1000)
    x = np.asarray(waveform, np.float64)
    if x.ndim > 1:
        x = x[0]
    n_frames = max(1 + (len(x) - win) // hop, 0)
    if n_frames == 0:
        return np.zeros((0, n_mels), np.float32)
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx]
    frames = frames - preemph * np.concatenate(
        [frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames * np.hamming(win)
    nfft = 1 << (win - 1).bit_length()
    spec = np.abs(np.fft.rfft(frames, nfft)) ** 2
    # mel filter bank
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = np.linspace(hz2mel(20.0), hz2mel(sample_rate / 2),
                          n_mels + 2)
    bins = np.floor((nfft + 1) * mel2hz(mel_pts) / sample_rate).astype(int)
    fb = np.zeros((n_mels, nfft // 2 + 1))
    for m in range(1, n_mels + 1):
        l, c, r = bins[m - 1], bins[m], bins[m + 1]
        for k in range(l, c):
            fb[m - 1, k] = (k - l) / max(c - l, 1)
        for k in range(c, r):
            fb[m - 1, k] = (r - k) / max(r - c, 1)
    feat = np.log(np.maximum(spec @ fb.T, 1e-10))
    return feat.astype(np.float32)


def utterance_cmvn(feat: np.ndarray, norm_means: bool = True,
                   norm_vars: bool = True) -> np.ndarray:
    """Per-utterance cepstral mean/variance normalization
    (dataloader.py:746-760). float64 internally: the reference's
    E[x^2]-mean^2 form catastrophically cancels in float32 on
    near-constant bins."""
    out = np.asarray(feat, np.float64)
    mean = out.mean(axis=0)
    if norm_means:
        out = out - mean
    if norm_vars:
        var = (np.asarray(feat, np.float64) ** 2).sum(axis=0) \
            / max(len(feat), 1) - mean ** 2
        out = out / np.sqrt(np.maximum(var, 1e-10))
    return out.astype(np.float32)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a PCM wav via the stdlib (the torchaudio.load equivalent for
    the 16-bit mono/stereo files the recipe uses)."""
    import wave

    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 1:
        # 8-bit PCM WAV is UNSIGNED (0..255 around a 128 midpoint)
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        dtype = {2: np.int16, 4: np.int32}[width]
        x = np.frombuffer(raw, dtype).astype(np.float32)
        x /= float(np.iinfo(dtype).max)
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


class S2tDataset:
    """Speech-to-text processor (dataset.py:961 + dataloader.py:763-822):
    tsv rows 'transcript<TAB>wav_path' -> log-mel fbank (CMVN'd, padded
    to max_audio_frames) + the shifted decoder text stream. seg marks
    the conv-subsampled frame count (the speech embedding downsamples by
    2 per conv layer)."""

    def __init__(self, tsv_path: str, tokenizer, tgt_seq_length: int,
                 max_audio_frames: int = 256, n_mels: int = 80,
                 conv_layers: int = 2, sample_rate: int = 16000):
        self.items = []
        sub = 2 ** conv_layers
        for line in open(tsv_path, encoding="utf-8"):
            parts = line.strip().split("\t")
            if len(parts) != 2:
                continue
            text, wav = parts
            x, rate = read_wav(wav)
            feat = utterance_cmvn(logmel_fbank(
                x * (2 ** 15), rate, n_mels))
            if feat.shape[0] > max_audio_frames or feat.shape[0] == 0:
                continue
            audio = np.zeros((max_audio_frames, n_mels), np.float32)
            audio[: feat.shape[0]] = feat
            seg = np.zeros(max_audio_frames // sub, np.int32)
            seg[: max(feat.shape[0] // sub, 1)] = 1
            item = _seq2seq_item([], [CLS] + tokenizer.encode(text)
                                 + [SEP], 1, tgt_seq_length)
            item["src"], item["seg"] = audio, seg
            self.items.append(item)

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.items)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        return self.items[i]


class BeitImageDataset:
    """BEiT processor (dataset.py:965 + dataloader.py:825-886): VQGAN
    tokens of each image become MLM targets on a fixed count of masked
    patch positions; the model sees pixels with those patches replaced by
    a learned mask embedding (towers/embeddings.py MaskedPatchEmbedding).
    `image_tok` is a data/tokenizers.ImageTokenizer (weight-loadable
    VQGAN; seeded weights without a checkpoint)."""

    def __init__(self, paths: Sequence[str], image_tok,
                 image_height: int = 224, image_width: int = 224,
                 patch_size: int = 16, mask_rate: float = 0.15,
                 seed: int = 7):
        self.paths = list(paths)
        self.tok = image_tok
        self.h, self.w = image_height, image_width
        self.gh, self.gw = image_height // patch_size, image_width // patch_size
        self.seq = self.gh * self.gw + 1
        self.n_mask = max(int((self.seq - 1) * mask_rate), 1)
        self.seed = seed
        self.epoch = 0
        self._cache: Dict[int, np.ndarray] = {}

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.paths)

    def _pixels(self, path):
        from PIL import Image

        img = Image.open(path).convert("RGB").resize((self.w, self.h))
        return (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)

    def _grid_align(self, tokens: np.ndarray) -> np.ndarray:
        """Map the VQGAN token grid onto the (gh, gw) patch grid so
        masked patch j is paired with the code of the SAME image region.
        When the VQGAN downsample equals the patch size (the reference
        configuration, dataloader.py:878: tokenize the model-resolution
        image) the grids coincide and this is the identity."""
        n = tokens.size
        if n == self.gh * self.gw:
            return tokens
        # token grid dims follow the image aspect: th/tw == h/w with
        # th*tw == n (the VQGAN downsamples h and w by the same factor)
        th = int(round((n * self.h / self.w) ** 0.5))
        tw = n // max(th, 1)
        if th * tw != n:
            raise ValueError(
                f"cannot infer a (h/w={self.h}/{self.w})-shaped grid "
                f"for {n} VQGAN tokens")
        grid = tokens.reshape(th, tw)
        rows = (np.arange(self.gh) * th) // self.gh
        cols = (np.arange(self.gw) * tw) // self.gw
        return grid[rows][:, cols].reshape(-1)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + i)
        # one decode per get: the VQGAN tokenizes the SAME
        # model-resolution pixels the model sees (the reference feeds
        # its transform()ed 224px image to image_tokenize,
        # dataloader.py:873-878) so token grid == patch grid
        model_pixels = self._pixels(self.paths[i])
        if i not in self._cache:
            raw = self.tok.tokenize_images(model_pixels[None])[0]
            self._cache[i] = self._grid_align(np.asarray(raw))
        tokens = np.concatenate([[0], self._cache[i]])[: self.seq]
        mask = rng.choice(np.arange(1, self.seq), self.n_mask,
                          replace=False).astype(np.int32)
        tgt = np.zeros(self.seq, np.int32)
        tgt[mask] = tokens[mask]
        return {"src_image": model_pixels, "mask": mask, "tgt": tgt,
                "seg": np.ones(self.seq, np.int32)}


class DalleDataset:
    """DALL-E processor (dataset.py:969 + dataloader.py:889-933): causal
    LM over [CLS] text [SEP] ++ (vqgan tokens + vocab_bias); seg 1 on
    text, 2 on image tokens."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], tokenizer,
                 image_tok, text_seq_length: int, vocab_bias: int):
        self.pairs = list(pairs)
        self.tok = tokenizer
        self.image_tok = image_tok
        self.text_len = text_seq_length
        self.bias = vocab_bias
        self.n_img = image_tok.cfg.tokens_per_image
        self._cache: Dict[int, np.ndarray] = {}

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return len(self.pairs)

    def _pixels(self, path: str) -> np.ndarray:
        """The image at the tokenizer's resolution, r x r."""
        from PIL import Image

        r = self.image_tok.cfg.resolution
        img = Image.open(path).convert("RGB").resize((r, r))
        return (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        text, path = self.pairs[i]
        if i not in self._cache:
            px = self._pixels(path)
            self._cache[i] = self.image_tok.tokenize_images(px[None])[0]
        ids = [CLS] + self.tok.encode(text)[: self.text_len - 2] + [SEP]
        S = self.text_len + self.n_img
        # reference packing (dataloader.py:922-928): text tokens, image
        # tokens IMMEDIATELY after (no mid-sequence pad gap — the
        # text->image transition is a learned prediction), pads at the
        # end; tgt = src[1:] ++ [SEP], so the last image token targets
        # SEP (the stopping signal) and the pad tail contributes nothing
        n_real = len(ids) + self.n_img
        src = np.full(S, PAD, np.int32)
        seg = np.zeros(S, np.int32)
        src[: len(ids)] = ids
        seg[: len(ids)] = 1
        src[len(ids): n_real] = self._cache[i] + self.bias
        seg[len(ids): n_real] = 2
        tgt = np.zeros(S, np.int32)
        tgt[: S - 1] = src[1:]
        tgt[n_real - 1] = SEP
        tgt[n_real:] = 0
        return {"src": src, "tgt": tgt, "seg": seg}
