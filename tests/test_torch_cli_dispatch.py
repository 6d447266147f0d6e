"""The port's CLI dispatcher, `python -m lr2ppo_torch.cli <entry>`, against
the JAX package's: the same 14 entries (`pretrain` included), each entry's
module has a main, and the usage, help and unknown-entry paths print and
exit alike."""

import importlib
import os
import subprocess
import sys

import pytest

from lr2ppo_tpu.cli import ENTRY_POINTS as JAX_ENTRY_POINTS
from lr2ppo_torch.cli import ENTRY_POINTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_points_are_the_jax_packages_but_pretrain():
    """Every JAX entry, in its order; pretrain is ported too."""
    assert ENTRY_POINTS == JAX_ENTRY_POINTS
    assert len(ENTRY_POINTS) == 14 and "pretrain" in ENTRY_POINTS


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_every_entry_module_has_main(name):
    assert callable(importlib.import_module(f"lr2ppo_torch.cli.{name}").main)


def _run(package, args):
    proc = subprocess.run([sys.executable, "-m", f"{package}.cli", *args],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    return proc.returncode, proc.stdout


@pytest.mark.parametrize("args", [[], ["-h"], ["--help"], ["not_a_thing"]],
                         ids=["no_entry", "h", "help", "unknown"])
def test_dispatcher_behaves_as_the_jax_packages(args):
    """Usage with no entry (exit 2), with -h/--help (exit 0), an unknown
    entry (exit 2); the text is the JAX package's with the port's package
    name and entries."""
    jrc, jout = _run("lr2ppo_tpu", args)
    trc, tout = _run("lr2ppo_torch", args)
    assert trc == jrc == (0 if args and args[0].startswith("-") else 2)
    entries = ", ".join(ENTRY_POINTS)
    want = jout.replace("lr2ppo_tpu", "lr2ppo_torch").replace(
        ", ".join(JAX_ENTRY_POINTS), entries)
    assert tout == want and entries in tout


def test_dispatcher_runs_an_entry():
    """`python -m lr2ppo_torch.cli preprocess_data -h` runs the entry's
    main on the flags after the entry's name."""
    rc, out = _run("lr2ppo_torch", ["preprocess_data", "-h"])
    assert rc == 0 and "svm2tsv" in out
