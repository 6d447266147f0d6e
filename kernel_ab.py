#!/usr/bin/env python3
"""Time the fused int8 FFN (K1), the narrow int8 GEMM (K2), the tower
attention kernel (K4) and hash dropout of one or more checkouts of this
repository on one CUDA card, in the order given:

    python3 kernel_ab.py [--only hash_dropout] _tree/parent . . _tree/parent

Each tree must lie inside this checkout (unpack another commit with `git
archive` into a git-ignored directory such as `_tree/`). Each runs in a
process of its own, imports its own `chip_smoke.py` and calls its
`check_kernel` (phase 3), `check_k2` (phase 11), `check_attention` (phase
9) and `check_dropout` (phase 6), so its kernels build from its own sources
and the shapes, inputs and checks are that phase's: K1 at the rollout's
100,352 and a served batch's 200,704 rows (D 768, H 3072, bfloat16), K2 at
the rollout and serve fc2 sites (those rows x 3072 -> 768, bfloat16), K4 at
the text (32, 12, 196, 64) and image (32, 12, 197, 64) shapes in float32
and bfloat16, hash dropout at the update's 100,352 x 3072 site in
bfloat16. Only the timing is made alike for every tree: each timed run of
the tree's `cuda_ms` is n calls back to back (3 for K1, K2 and hash
dropout, 20 for K4), divided by n, so a time is the device's and not the
host's time to launch. Hash dropout is also timed one call between two
events, so the wrapper's host path counts, at a tabular site (512 x 3072,
bfloat16) and at the tower pretraining sites ((32, 128, 768) and
(32, 12, 128, 128), float32). `--only hash_dropout` times hash dropout
alone. Prints the card's name and power limit, then each tree's name and
its phases' JSON lines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPS = {"int8_mlp": 3, "int8_matmul": 3, "fused_attention": 20,
        "hash_dropout": 3}
# hash dropout's sites beside the update's: (shape, dtype), one call a run
HASH_ONE_CALL = (((512, 3072), "bfloat16"), ((32, 128, 768), "float32"),
                 ((32, 12, 128, 128), "float32"))


def back_to_back(cuda_ms, n: int):
    """The tree's cuda_ms, each timed run n calls of fn, divided by n."""
    def timed(fn, iters: int = 10, warmup: int = 2, reps: int = 1) -> float:
        return cuda_ms(lambda: [fn() for _ in range(n)], iters, warmup) / n
    return timed


def child(tree: str, only: str = "") -> None:
    """Time one tree's kernels through its own chip_smoke.py."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA device")
    print(json.dumps({"tree": tree, "chip_smoke": cs.__file__}), flush=True)
    dev = torch.device("cuda", 0)
    card_line = cs.card()
    own = cs.cuda_ms
    if only not in ("", "hash_dropout"):
        raise SystemExit(f"--only {only}: only hash_dropout is selectable")
    if not only:
        cs.cuda_ms = back_to_back(own, REPS["int8_mlp"])
        for rows in (cs.ROLLOUT_ROWS, cs.SERVE_ROWS):
            cs.check_kernel(rows, torch.bfloat16, 0, dev, True, card_line)
            torch.cuda.empty_cache()
        cs.cuda_ms = back_to_back(own, REPS["int8_matmul"])
        for name in ("rollout", "serve"):
            cs.check_k2(name, 0, dev, card_line)
            torch.cuda.empty_cache()
        cs.cuda_ms = back_to_back(own, REPS["fused_attention"])
        for name in ("text", "image"):
            for dtype in (torch.float32, torch.bfloat16):
                cs.check_attention(name, dtype, 0, dev, card_line)
    cs.cuda_ms = back_to_back(own, REPS["hash_dropout"])
    cs.check_dropout("hash_dropout", (cs.ROLLOUT_ROWS, cs.H), torch.bfloat16,
                     1, dev, True, card_line)
    cs.cuda_ms = own
    for shape, dtype in HASH_ONE_CALL:
        cs.check_dropout("hash_dropout", shape, getattr(torch, dtype), 2,
                         dev, True, card_line)


def main(argv: list) -> None:
    if argv[:1] == ["--child"]:
        child(*argv[1:])
        return
    only = ""
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    if not argv:
        raise SystemExit(__doc__)
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [os.path.realpath(t) for t in argv]
    for tree in trees:
        if os.path.commonpath([tree, here]) != here:
            raise SystemExit(f"{tree} lies outside this checkout ({here})")
        if not os.path.exists(os.path.join(tree, "chip_smoke.py")):
            raise SystemExit(f"{tree} holds no chip_smoke.py")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip(), flush=True)
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree, only], check=True, cwd=tree)


if __name__ == "__main__":
    main(sys.argv[1:])
