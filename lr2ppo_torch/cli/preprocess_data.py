"""LETOR offline pipeline CLI (counterpart of lr2ppo_tpu/cli/preprocess_data.py;
reference datasets_trad/: preprocess.py,
preprocess_data.py, make_indices_disjoint.py, convert_to_h5py.py,
combine_web10k_mq2008_fold1.sh).

Subcommands:
  svm2tsv   <in.svmlight> <out.tsv> --num_features N
            dense qid-sorted tsv [label, qid, feats...] + dataset stats
  disjoint  <in.tsv> <out.tsv> [--offset 100000]
            offset qids so two domains never collide
  tsv2h5    <in.tsv> <out.h5> [--docs_per_query 20]
            group rows by qid, resample each query to exactly N docs
  combine   <a.tsv> <b.tsv> <out.tsv>
            concatenate two domains' rows (merged train set)
  check     <a.tsv> <b.tsv>
            verify qid sets are disjoint (check_intersec.py)

    python -m lr2ppo_torch.cli preprocess_data <subcommand> ...

svm2tsv uses the C++ parser and raises where it does not build or rejects
the file; --use_native_loader 0 picks the numpy parser. tsv2h5 needs h5py.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from lr2ppo_torch.data.letor import (
    group_queries,
    make_qids_disjoint,
    parse_svmlight_file,
    read_tsv,
    save_grouped_h5,
    write_tsv,
)


def _stats(arr: np.ndarray, name: str) -> None:
    labels = arr[:, 0].astype(int)
    print(f"{name}: rows={arr.shape[0]} features={arr.shape[1]-2} "
          f"queries={len(np.unique(arr[:, 1]))} "
          f"labels={sorted(np.unique(labels).tolist())}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("svm2tsv")
    s.add_argument("input"), s.add_argument("output")
    s.add_argument("--num_features", type=int, required=True)
    s.add_argument("--use_native_loader", type=int, default=1,
                   help="0 forces the pure-numpy svmlight parser")

    s = sub.add_parser("disjoint")
    s.add_argument("input"), s.add_argument("output")
    s.add_argument("--offset", type=int, default=100000)

    s = sub.add_parser("tsv2h5")
    s.add_argument("input"), s.add_argument("output")
    s.add_argument("--docs_per_query", type=int, default=20)
    s.add_argument("--seed", type=int, default=0)

    s = sub.add_parser("combine")
    s.add_argument("a"), s.add_argument("b"), s.add_argument("output")

    s = sub.add_parser("check")
    s.add_argument("a"), s.add_argument("b")

    args = p.parse_args(argv)
    if args.cmd == "svm2tsv":
        arr = parse_svmlight_file(args.input, args.num_features,
                                  use_native=bool(args.use_native_loader))
        _stats(arr, args.input)
        write_tsv(arr, args.output)
    elif args.cmd == "disjoint":
        write_tsv(make_qids_disjoint(read_tsv(args.input), args.offset),
                  args.output)
    elif args.cmd == "tsv2h5":
        groups = group_queries(read_tsv(args.input), args.docs_per_query,
                               args.seed)
        save_grouped_h5(groups, args.output)
        print(f"wrote {len(groups)} queries x {args.docs_per_query} docs")
    elif args.cmd == "combine":
        a, b = read_tsv(args.a), read_tsv(args.b)
        assert a.shape[1] == b.shape[1], "feature dims differ; project first"
        write_tsv(np.concatenate([a, b], axis=0), args.output)
    elif args.cmd == "check":
        qa = set(np.unique(read_tsv(args.a)[:, 1]).tolist())
        qb = set(np.unique(read_tsv(args.b)[:, 1]).tolist())
        inter = qa & qb
        print(f"intersection: {len(inter)}")
        if inter:
            sys.exit(1)


if __name__ == "__main__":
    main()
