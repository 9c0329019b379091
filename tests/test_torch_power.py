# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""``python -m nds_tpu_torch.power --device cpu`` writes the time log and
the JSON summaries; without a GPU and without ``--device cpu`` it refuses
to run."""

import csv
import glob
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stream_and_data(tmp_path_factory):
    from tools.coverage_sweep import ensure_data
    from nds_tpu_torch.queries import generate_query_streams
    d = str(tmp_path_factory.mktemp("stream"))
    generate_query_streams(d, streams=1, rngseed=19620718, scale=0.01)
    return ensure_data(), os.path.join(d, "query_0.sql")


def _run(args, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "nds_tpu_torch.power"]
                          + args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_power_cli_writes_time_log_and_summaries(stream_and_data, tmp_path):
    data, stream = stream_and_data
    tlog = tmp_path / "time.csv"
    js = tmp_path / "json"
    res = _run([data, stream, str(tlog), "--input_format", "raw",
                "--device", "cpu", "--json_summary_folder", str(js),
                "--sub_queries", "query3,query96,query42",
                "--trace-dir", str(tmp_path / "traces"),
                "--profile", str(tmp_path / "prof")])
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    with open(tlog) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["application_id", "query", "time/milliseconds",
                       "compile/milliseconds"]
    names = [r[1] for r in rows[1:]]
    assert [n for n in names if n.startswith("query")] == \
        ["query3", "query96", "query42"]
    assert sum(n.startswith("CreateTempView") for n in names) == 24
    assert "Power Test Time" in names and "Total Time" in names
    files = sorted(glob.glob(str(js / "*.json")))
    assert len(files) == 3
    syncs = []
    for fn in files:
        with open(fn) as f:
            s = json.load(f)
        assert s["queryStatus"] == ["Completed"]
        assert s["device"] == "cpu"
        syncs.append(s["hostSyncs"])
        assert s["syncWaitMs"] >= 0 and s["fetchBytes"] > 0
        # the CPU tensors take the kernels' plain versions: no launches
        assert set(s["kernelLaunches"]) == {
            "segment_sum_i64", "segment_sum_f64", "segment_minmax_f64"}
        assert not any(s["kernelLaunches"].values())
        assert "trace" in s
        # on the CPU the profile has no device kernels
        assert s["profile"]["deviceKernelMs"] == 0
    assert max(syncs) >= 1                 # group-bys resolve their count
    assert len(glob.glob(str(tmp_path / "traces" / "*.trace.json"))) == 3
    assert len(glob.glob(str(tmp_path / "prof" / "*.json"))) == 3


def test_power_cli_defaults_to_cuda_and_refuses_without_a_gpu(
        stream_and_data, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    data, stream = stream_and_data
    res = _run([data, stream, str(tmp_path / "t.csv"), "--input_format",
                "raw", "--sub_queries", "query3"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
