"""lr2ppo_torch, and chip_smoke.py imported as a module, leave JAX, its
libraries and every module of the JAX package out of the process."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import lr2ppo_torch
names = [m.name for m in pkgutil.walk_packages(lr2ppo_torch.__path__,
                                               "lr2ppo_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax",
                                       "orbax", "lr2ppo_tpu"})
# imported at first use only: the card's machine has none of them
lazy = sorted(m for m in sys.modules
              if m.split(".")[0] in {"PIL", "h5py", "sentencepiece",
                                     "tokenizers", "triton"})
print(json.dumps({"modules": names, "loaded": loaded, "lazy": lazy}))
"""


def test_port_never_imports_jax():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"lr2ppo_torch.cli.serve", "lr2ppo_torch.kernels.build",
            "lr2ppo_torch.ops.int8_mlp", "lr2ppo_torch.config",
            "lr2ppo_torch.data.movienet", "lr2ppo_torch.data.pipeline",
            "lr2ppo_torch.cli._common", "lr2ppo_torch.cli.ppo",
            "lr2ppo_torch.ops.hash_dropout", "lr2ppo_torch.ops.dropout",
            "lr2ppo_torch.ops.losses", "lr2ppo_torch.train.optim",
            "lr2ppo_torch.train.common", "lr2ppo_torch.train.ppo",
            "lr2ppo_torch.utils.guards",
            "lr2ppo_torch.utils.logging", "lr2ppo_torch.ops.attention",
            "lr2ppo_torch.towers", "lr2ppo_torch.towers.model",
            "lr2ppo_torch.towers.layers", "lr2ppo_torch.towers.embeddings",
            "lr2ppo_torch.towers.encoders", "lr2ppo_torch.towers.extract",
            "lr2ppo_torch.towers.torch_import",
            "lr2ppo_torch.data.tokenizers",
            "lr2ppo_torch.cli.preprocess", "lr2ppo_torch.ops.int8_matmul",
            "lr2ppo_torch.train.pointwise", "lr2ppo_torch.train.reward",
            "lr2ppo_torch.cli.pointwise",
            "lr2ppo_torch.cli.reward_pair_dataloader",
            "lr2ppo_torch.cli.ppo_eval", "lr2ppo_torch.data.letor",
            "lr2ppo_torch.native", "lr2ppo_torch.cli.__main__",
            "lr2ppo_torch.cli.preprocess_data",
            "lr2ppo_torch.cli.pointwise_trad",
            "lr2ppo_torch.cli.pointwise_2data_trad",
            "lr2ppo_torch.cli.pointwise_2data_infer_trad",
            "lr2ppo_torch.cli.reward_trad", "lr2ppo_torch.cli.ppo_trad",
            "lr2ppo_torch.cli.ppo_eval_trad", "lr2ppo_torch.cli.pretrain",
            "lr2ppo_torch.data.pretrain_data",
            "lr2ppo_torch.data.pretrain_processors",
            "lr2ppo_torch.ops.fast_dropout", "lr2ppo_torch.towers.targets",
            "lr2ppo_torch.train.pretrain",
            "lr2ppo_torch.utils.remat", "lr2ppo_torch.parallel",
            "lr2ppo_torch.parallel.mesh", "lr2ppo_torch.parallel.tp",
            "lr2ppo_torch.parallel.fsdp",
            "lr2ppo_torch.parallel.dryrun",
            "lr2ppo_torch.parallel.pipeline", "lr2ppo_torch.towers.vqgan",
            "lr2ppo_torch.data.augment", "lr2ppo_torch.models.video",
            "lr2ppo_torch.ops.adversarial"} <= set(res["modules"])
    assert res["loaded"] == [], f"the port imported {res['loaded']}"
    assert res["lazy"] == [], f"imported at import time: {res['lazy']}"


def test_chip_smoke_names_no_jax_package_module():
    """chip_smoke.py reaches the JAX package's host side only through the
    port's own modules."""
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        tree = ast.parse(src.read())
    named = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    named += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    roots = {m.split(".")[0] for m in named}
    assert not roots & {"lr2ppo_tpu", "jax", "jaxlib", "flax", "optax",
                        "orbax"}, sorted(roots)


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No CUDA device here: the script exits non-zero and prints no result;
    alone in a directory it cannot import the port and fails too."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run_smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    alone = _run_smoke(str(tmp_path), env)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout
