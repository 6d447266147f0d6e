"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the references import nothing of the program either."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest

from perfbench.common import harness

PROGRAM = "lr2ppo_torch"


def imported_tops(path):
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


FILES = sorted(glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"),
                         recursive=True))


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, harness.BENCH_DIR)
                              for p in FILES])
def test_perfbench_sources_import_no_jax(path):
    tops = imported_tops(path)
    assert not tops & set(harness.FORBIDDEN), tops
    if os.sep + "reference" + os.sep in path:
        assert PROGRAM not in tops, tops


def test_perfbench_whole_names():
    """lr2ppo_torch is not lr2ppo_tpu: the check compares whole names."""
    sys.modules.setdefault("lr2ppo_tpu_lookalike", sys)
    try:
        assert "lr2ppo_tpu_lookalike" not in harness.forbidden_loaded()
    finally:
        del sys.modules["lr2ppo_tpu_lookalike"]


@pytest.mark.parametrize("name", ["lr2ppo", "xlmr_mlm"])
def test_perfbench_reference_loads_nothing_of_the_program(name):
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {harness.ROOT!r})
        from perfbench.common.harness import load_module
        load_module("reference", {name!r})
        tops = {{m.split(".")[0] for m in sys.modules}}
        bad = tops & {set(harness.FORBIDDEN) | {PROGRAM}!r}
        assert not bad, bad
        """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_perfbench_cell_process_loads_no_jax(tmp_path):
    """A whole tiny run of each entry, then sys.modules, in one process."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {harness.ROOT!r})
        from perfbench.common import harness
        from perfbench.tests.tiny import run_tiny, tiny_job
        for cell in ("ppo-b256", "mlm-s512"):
            rc, line = run_tiny(tiny_job(cell, {str(tmp_path)!r}))
            assert rc == 0 and line["correct"], (cell, rc)
        assert not harness.forbidden_loaded(), harness.forbidden_loaded()
        """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
