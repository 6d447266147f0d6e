"""LETOR tabular pipeline (the port's own copy of lr2ppo_tpu/data/letor.py):
MSLR-Web10K / MQ2008 svmlight -> tsv -> grouped per-query arrays, and the
LTR dataset variants of the *_trad stages.

Offline steps (reference datasets_trad/):
  parse_svmlight_file / write_tsv  — preprocess.py:31-113 (dense tsv
                                     [label, qid, features...], qid-sorted)
  make_qids_disjoint               — make_indices_disjoint.py:26-39
                                     (+100000 on MQ2008 qids)
  group_queries                    — convert_to_h5py.py:7-43 (group rows by
                                     qid, resample every query to exactly
                                     20 docs, seed 0)

Dataset variants:
  LTRPointwiseDataset — full 20-doc matrix per query (pointwise_trad.py:88-110)
  LTRRewardDataset    — cross-class 4-index chosen/reject pairs
                        (reward_trad.py:87-134; 5 relevance classes)
  LTRPPODataset       — max_tags random 2-doc subsets per query, eval = all
                        docs (ppo_trad.py:63-97)

The svmlight parse runs the C++ parser (lr2ppo_torch.native) unless the
caller asks for the numpy one (`use_native=False`, --use_native_loader 0).
A native parser that does not build, or that rejects the file, raises: it
never falls back to numpy on its own. h5py is imported at first use.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def parse_svmlight_file(path: str, num_features: int,
                        use_native: bool = True) -> np.ndarray:
    """svmlight 'label qid:N f:v ...' -> dense (rows, 2+F) [label, qid, feats],
    stably sorted by qid. `use_native=False` picks the numpy parser."""
    if use_native:
        from lr2ppo_torch.native import parse_svmlight

        return parse_svmlight(path, num_features)
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue            # blank / full-line comment header
            label = float(parts[0])
            qid = float(parts[1].split(":")[1])
            feats = np.zeros(num_features, dtype=np.float32)
            for tok in parts[2:]:
                if tok.startswith("#"):
                    break
                k, v = tok.split(":")
                feats[int(k) - 1] = float(v)
            rows.append(np.concatenate([[label, qid], feats]))
    arr = np.asarray(rows, dtype=np.float32)
    return arr[np.argsort(arr[:, 1], kind="stable")]


def write_tsv(arr: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    # %.9g: exact float32 round-trip — %g's 6 digits silently
    # rounds large LETOR features (IDF/stream-length sums reach 1e8)
    np.savetxt(path, arr, delimiter="\t", fmt="%.9g")


def read_tsv(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter="\t", dtype=np.float32, ndmin=2)


def make_qids_disjoint(arr: np.ndarray, offset: int = 100000) -> np.ndarray:
    out = arr.copy()
    out[:, 1] += offset
    return out


def group_queries(arr: np.ndarray, docs_per_query: int = 20,
                  seed: int = 0) -> Dict[int, np.ndarray]:
    """Group rows by qid and resample each group to exactly docs_per_query
    (up with replacement / down without), matching convert_to_h5py.py:19-23."""
    rng = np.random.RandomState(seed)
    out: Dict[int, np.ndarray] = {}
    qids = arr[:, 1].astype(np.int64)
    for q in np.unique(qids):
        grp = arr[qids == q]
        n = grp.shape[0]
        if n < docs_per_query:
            pick = rng.choice(n, size=docs_per_query, replace=True)
            grp = grp[pick]
        elif n > docs_per_query:
            pick = rng.choice(n, size=docs_per_query, replace=False)
            grp = grp[pick]
        out[int(q)] = grp.astype(np.float32)
    return out


def save_grouped_h5(groups: Dict[int, np.ndarray], path: str) -> None:
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with h5py.File(path, "w") as hf:
        for q, v in groups.items():
            hf.create_dataset(str(q), data=v)


def load_grouped_h5(path: str) -> Dict[int, np.ndarray]:
    import h5py

    out = {}
    with h5py.File(path, "r") as hf:
        for k in hf.keys():
            out[int(k)] = np.asarray(hf[k][()], dtype=np.float32)
    return out


class LetorQueries:
    """Shared backing store: {qid: (docs, 2+F)} with [:,0]=label, [:,2:]=feats."""

    def __init__(self, groups: Dict[int, np.ndarray]):
        self.qids = sorted(groups.keys())
        self.groups = groups

    @classmethod
    def from_h5(cls, path: str) -> "LetorQueries":
        return cls(load_grouped_h5(path))

    @classmethod
    def from_dir(cls, dirpath: str, split: str) -> "LetorQueries":
        """Reference convention: <dir>/{train,test}.h5 (ppo_trad.py:64-68)."""
        return cls.from_h5(os.path.join(dirpath, f"{split}.h5"))


class LTRPointwiseDataset:
    """One example per query: all docs (pointwise_trad.py:88-110)."""

    def __init__(self, queries: LetorQueries):
        self.q = queries

    def __len__(self):
        return len(self.q.qids)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        g = self.q.groups[self.q.qids[i]]
        return {"text": g[:, 2:], "tgts": g[:, 0].astype(np.int32)}


class LTRRewardDataset:
    """Cross-class chosen/reject 4-index pairs (reward_trad.py:97-118)."""

    def __init__(self, queries: LetorQueries, max_tags: int = 20,
                 relevance_classes: int = 5, seed: int = 0):
        self.q = queries
        self.examples: List[tuple] = []
        rng = np.random.default_rng(seed)
        for qid in self.q.qids:
            g = self.q.groups[qid]
            labels = g[:, 0].astype(int)
            by_cls = {c: np.flatnonzero(labels == c)
                      for c in range(relevance_classes)}
            for _ in range(max_tags):
                sampled = [int(rng.choice(by_cls[c]))
                           for c in range(relevance_classes) if len(by_cls[c])]
                if len(sampled) < 2:
                    continue
                pair = rng.choice(sampled, 2, replace=False)
                a, b = int(pair[0]), int(pair[1])
                if labels[a] == labels[b]:
                    continue
                if labels[a] > labels[b]:
                    ch, rj = [a, b, a, b], [a, b, b, a]
                else:
                    ch, rj = [a, b, b, a], [a, b, a, b]
                self.examples.append((qid, ch, rj))

    def __len__(self):
        return len(self.examples)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        qid, ch, rj = self.examples[i]
        g = self.q.groups[qid]
        return {
            "text": g[:, 2:],
            "tgts": g[:, 0].astype(np.int32),
            "chosen_index": np.asarray(ch, dtype=np.int32),
            "reject_index": np.asarray(rj, dtype=np.int32),
        }


class LTRPPODataset:
    """Train: max_tags random 2-doc subsets per query; eval: all docs
    (ppo_trad.py:63-97)."""

    def __init__(self, queries: LetorQueries, is_train: bool,
                 max_tags: int = 20, seed: int = 0):
        self.q = queries
        self.examples: List[tuple] = []
        rng = np.random.default_rng(seed)
        for qid in self.q.qids:
            n = self.q.groups[qid].shape[0]
            if is_train:
                if n < 2:          # a 2-doc pair needs 2 docs
                    continue
                for _ in range(max_tags):
                    pair = rng.permutation(n)[:2]
                    self.examples.append((qid, [int(pair[0]), int(pair[1])]))
            else:
                self.examples.append((qid, list(range(n))))

    def __len__(self):
        return len(self.examples)

    def get(self, i: int) -> Dict[str, np.ndarray]:
        qid, idx = self.examples[i]
        g = self.q.groups[qid]
        return {"text": g[idx, 2:], "tgts": g[idx, 0].astype(np.int32)}
