"""A later PR grows the benchmark by adding files only: a copy of the
benchmark gains a configuration, a traffic mix, a metric and their entries
in BENCHMARK.json, and the harness, unedited, runs the new cell and reports
the new metric."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from perfbench.common import harness
from perfbench.tests.tiny import TINY_MODEL, TINY_STORE


def test_perfbench_new_cell_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(open(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")).read())
    base = json.loads((root / "perfbench/configs/lr2ppo-movienet.json")
                      .read_text())
    base["model"].update(TINY_MODEL)
    (root / "perfbench/configs/toy.json").write_text(json.dumps(base))
    shutil.copy(root / "perfbench/flops/lr2ppo-movienet.py",
                root / "perfbench/flops/toy.py")
    mix = json.loads((root / "perfbench/traffic/ppo-b256.json").read_text())
    mix.update(batch_size=8, item_dtype="float32", store=TINY_STORE,
               warm_sweeps=2, trace_sweeps=1,
               argv=mix["argv"] + ["--num_workers", "2"],
               limits={k: 1e9 for k in mix["limits"]})
    (root / "perfbench/traffic/toy-mix.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/toy.put_ms.py").write_text(textwrap.dedent(
        '''
        """toy.put_ms: the mean host ms of a traced batch."""


        def read(obs, job):
            return sum(obs[0]["host_batch_ms"]) / len(obs[0]["host_batch_ms"])
        '''))
    spec["configs"].append({"name": "toy", "source": "a test",
                            "file": "perfbench/configs/toy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy-cell", "config": "toy",
                              "traffic": "toy-mix", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_items_per_s":
            m["workloads"].append("toy-cell")
    spec["per_layer"].append({
        "name": "toy.put_ms", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "host data",
        "moves": "train_items_per_s", "workloads": ["toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    script = textwrap.dedent(f'''
        import dataclasses, io, json, sys, time
        sys.path[:0] = [{str(root)!r}, {harness.ROOT!r}]
        from perfbench.common import harness
        assert harness.ROOT == {str(root)!r}, harness.ROOT
        for trace in (False, True):
            job = harness.load_job("toy-cell", 5, 0.2, trace)
            job = dataclasses.replace(job, device="cpu", tmp={str(tmp_path)!r})
            out = io.StringIO()
            assert harness.run_cell(job, time.time(), out=out) == 0
            print(out.getvalue().strip().splitlines()[-1])
        ''')
    res = subprocess.run([sys.executable, "-c", script], cwd=str(root),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()
             if x.startswith("{")]
    untraced, traced = lines[-2], lines[-1]
    assert untraced["correct"] and "train_items_per_s" in untraced["metrics"]
    assert traced["metrics"]["toy.put_ms"]["value"] > 0
