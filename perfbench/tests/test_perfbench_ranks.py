"""The runner for cells on several chips, at 2 gloo ranks on the CPU: one
spawned process a rank, the parent judging the ranks' global batch against
the reference and printing the line."""

from perfbench.tests.tiny import run_tiny, tiny_job


def test_perfbench_two_gloo_ranks(tmp_path):
    job = tiny_job("ppo-b256", str(tmp_path), world=2)
    rc, line = run_tiny(job)
    assert rc == 0 and line["correct"] is True
    assert line["device"]["count"] == 2
    # two ranks of 8 items, two rollouts a sweep
    assert line["attempted"] % 16 == 0 and line["attempted"] > 0
