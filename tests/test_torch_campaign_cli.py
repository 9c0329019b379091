# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""``python -m nds_tpu_torch.tools.campaign`` over a fake bench command,
as the reference's ``tests/test_campaign.py`` drives ``tools/campaign.py``:
the dry run and the presets, a campaign run and its rerun (every arm
skipped), a resume under other knobs refused (exit 2, the other arms still
run), a failed arm classified while the rest run, the report with its
named deltas (encoded against raw wire: ms and host-to-device bytes; a
shard delta only for an arm that ran at its shard count), the
gate of every arm against a baseline, ``--emit-perf`` to a temporary path,
the refused audits, and the new knobs in the fingerprint."""

import json
import os
import subprocess
import sys

import pytest

from nds_tpu_torch.obs import campaign as C
from nds_tpu_torch.obs import ledger as L
from nds_tpu_torch.tools import campaign as T
from nds_tpu_torch.tools import trace_report as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the fake bench: a stamped ledger of two statements whose wall, upload
# bytes, prefetch stall and shard count follow the arm's knobs (as on two
# cards: more than 2 shards build unsharded); NDS_FAKE_MODE=fail
# exits 3 before touching the ledger. Each call appends the arm's name to
# NDS_FAKE_CALLS.
_STUB = """\
import os, sys
sys.path.insert(0, {repo!r})
from nds_tpu_torch.obs import campaign as C, ledger as L
with open(os.environ["NDS_FAKE_CALLS"], "a") as f:
    f.write(os.environ.get("NDS_CAMPAIGN_ARM", "?") + "\\n")
if os.environ.get("NDS_FAKE_MODE") == "fail":
    sys.exit(3)
raw = os.environ.get("NDS_TPU_ENCODED") == "0"
inline = os.environ.get("NDS_TPU_PREFETCH_DEPTH") == "0"
# two cards: a scan asked for more shards builds unsharded
shards = int(os.environ.get("NDS_TPU_STREAM_SHARDS", "1"))
shards = shards if shards <= 2 else 1
led = L.Ledger(os.environ["NDS_BENCH_RESULTS_JSONL"],
               stamp=C.campaign_stamp(), driver="bench", scale="1",
               platform="torch-cuda")
for name, ms in (("query3", 100.0), ("query37", 200.0)):
    led.query(name, ms=ms * (1.4 if raw else 1.2 if inline else 1.0),
              hostSyncs=2, evidence={{
                  "bytesH2d": 4000 if raw else 1000, "shards": shards,
                  "prefetchStallMs": 0.0 if inline else 3.0}})
led.close("completed", queries=2)
"""


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in C.FINGERPRINT_KNOBS + ("NDS_CAMPAIGN_ARM", "NDS_FAKE_MODE",
                                    "NDS_BENCH_RESULTS_JSONL"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def stub(tmp_path, monkeypatch):
    p = tmp_path / "fake_bench.py"
    p.write_text(_STUB.format(repo=REPO))
    calls = tmp_path / "calls.txt"
    monkeypatch.setenv("NDS_FAKE_CALLS", str(calls))
    return f"{sys.executable} {p}", calls


def _matrix(tmp_path, *arms):
    path = tmp_path / "arms.json"
    path.write_text(json.dumps({
        "v": C.CAMPAIGN_VERSION, "env": {"NDS_BENCH_SCALE": "1"},
        "arms": [{"name": n, "env": e} for n, e in arms]}))
    return str(path)


THREE = (("base", {}), ("encoded-off", {"NDS_TPU_ENCODED": "0"}),
         ("prefetch-off", {"NDS_TPU_PREFETCH_DEPTH": "0"}))


def _cli(*argv):
    """The CLI in a fresh process (it installs signal handlers)."""
    return subprocess.run([sys.executable, "-m",
                           "nds_tpu_torch.tools.campaign", *argv],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=240)


def _calls(path):
    return path.read_text().split() if path.exists() else []


def test_list_presets_and_dry_run(tmp_path, capsys):
    assert T.main(["--list-presets"]) == 0
    out = capsys.readouterr().out
    assert "sf10-full: 9 arms" in out and "smoke: 3 arms" in out
    assert out.count("no pallas-off arm") == 2
    d = str(tmp_path / "camp")
    assert T.main(["--preset", "sf10-full", "--dir", d, "--dry-run"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"# campaign dry-run: 9 arms -> {d}"
    arms = [ln.split()[1] for ln in out if ln.startswith("arm ")]
    assert arms == ["base", "prefetch-off", "store-cold", "encoded-off",
                    "replay-off", "shards-1", "shards-2", "shards-4",
                    "shards-8"]
    assert f"NDS_TPU_CHUNK_STORE={d}/chunk_store" in out[2]
    cold = out[out.index("arm store-cold") + 1]
    assert "NDS_TPU_CHUNK_STORE=<unset>" in cold
    assert f"  ledger:      {d}/encoded-off/ledger.jsonl" in out
    assert not os.path.exists(d)              # a dry run runs nothing
    assert T.main(["--preset", "nope", "--dry-run"]) == 2


def test_new_knobs_in_the_fingerprint():
    for knob in ("NDS_TPU_PREFETCH_DEPTH", "NDS_TPU_STREAM_SHARDS",
                 "NDS_TPU_ENCODED"):
        assert knob in C.FINGERPRINT_KNOBS
        assert f"{knob}=<unset>" in C.env_fingerprint({})
        assert f"{knob}=0" in C.env_fingerprint({knob: "0"})
    arms = C.expand_arms(C.PRESETS["sf10-full"], "/x")
    prints = {C.arm_fingerprint(a, {}) for a in arms}
    assert len(prints) == len(arms)           # every arm its own experiment


def test_run_then_rerun_skips_every_arm(tmp_path, stub):
    cmd, calls = stub
    d = str(tmp_path / "camp")
    m = _matrix(tmp_path, *THREE)
    res = _cli("--matrix", m, "--dir", d, "--bench-cmd", cmd)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "# campaign arms: 3/3 arms complete, 0 failed" in res.stdout
    assert _calls(calls) == ["base", "encoded-off", "prefetch-off"]
    manifest = C.load_manifest(d)
    assert [a["status"] for a in manifest["arms"]] == ["completed"] * 3
    res = _cli("--matrix", m, "--dir", d, "--bench-cmd", cmd)
    assert res.returncode == 0, res.stderr[-3000:]
    assert _calls(calls) == ["base", "encoded-off", "prefetch-off"]
    assert res.stderr.count("already completed") == 3
    assert [a["status"] for a in C.load_manifest(d)["arms"]] == \
        ["done"] * 3


def test_resume_under_other_knobs_refused(tmp_path, stub):
    cmd, calls = stub
    d = str(tmp_path / "camp")
    res = _cli("--matrix", _matrix(tmp_path, *THREE[:2]), "--dir", d,
               "--bench-cmd", cmd)
    assert res.returncode == 0, res.stderr[-3000:]
    # the same arm names, base now under another prefetch depth, one more
    # arm behind it
    moved = _matrix(tmp_path, ("base", {"NDS_TPU_PREFETCH_DEPTH": "4"}),
                    THREE[1], THREE[2])
    res = _cli("--matrix", moved, "--dir", d, "--bench-cmd", cmd)
    assert res.returncode == 2
    assert "CampaignResumeError" in res.stderr
    assert "REFUSED resume" in res.stderr
    assert _calls(calls) == ["base", "encoded-off", "prefetch-off"]
    recs = {a["name"]: a for a in C.load_manifest(d)["arms"]}
    assert recs["base"]["status"] == "failed"
    assert recs["base"]["error"].startswith(
        os.path.join(d, "base", "ledger.jsonl") + ": recorded env "
        "fingerprint does not match")
    assert "NDS_TPU_PREFETCH_DEPTH=<unset>" in recs["base"]["error"]
    assert "NDS_TPU_PREFETCH_DEPTH=4" in recs["base"]["fingerprint"]
    assert recs["encoded-off"]["status"] == "done"
    assert recs["prefetch-off"]["status"] == "completed"


def test_failed_arm_classified_and_the_rest_run(tmp_path, stub):
    cmd, calls = stub
    d = str(tmp_path / "camp")
    res = _cli("--matrix", _matrix(tmp_path, THREE[0],
                                   ("broken", {"NDS_FAKE_MODE": "fail"}),
                                   THREE[2]),
               "--dir", d, "--bench-cmd", cmd)
    assert res.returncode == 1
    assert _calls(calls) == ["base", "broken", "prefetch-off"]
    recs = {a["name"]: a for a in C.load_manifest(d)["arms"]}
    assert recs["broken"]["status"] == "failed" and recs["broken"]["rc"] == 3
    assert recs["broken"]["classified"]["seam"] == "bench-child"
    assert recs["prefetch-off"]["status"] == "completed"
    assert "2/3 arms complete, 1 failed" in res.stdout


@pytest.fixture
def campaign(tmp_path, stub):
    """(campaign dir, matrix) of a finished three-arm campaign."""
    cmd, _calls = stub
    d = str(tmp_path / "camp")
    m = _matrix(tmp_path, *THREE)
    res = _cli("--matrix", m, "--dir", d, "--bench-cmd", cmd)
    assert res.returncode == 0, res.stderr[-3000:]
    return d, m


def test_report_rows_and_named_deltas(campaign, capsys):
    d, m = campaign
    assert T.main(["--matrix", m, "--dir", d, "--report"]) == 0
    out = capsys.readouterr().out
    with open(os.path.join(d, "report.md")) as f:
        assert f.read() == out
    lines = out.splitlines()
    # the static cost model prices both statements: its walls against the
    # arm's measured ms (query3 and query37: 100 and 200 ms, x1.4 raw,
    # x1.2 inline)
    walls = TR.static_walls(("query3", "query37"))
    explained = walls["query3"][0] + walls["query37"][0]
    for arm, f in (("base", 1.0), ("encoded-off", 1.4),
                   ("prefetch-off", 1.2)):
        assert any(ln.startswith(f"| {arm} | 2 |") for ln in lines), arm
        row = next(ln for ln in lines if ln.startswith(f"| {arm} | ")
                   and ln.count("|") == 8)
        pct, unexplained = (float(c) for c in
                            row.strip("|").split("|")[-2:])
        assert pct == pytest.approx(explained / (300 * f) * 100, abs=0.06)
        assert unexplained == pytest.approx(max(300 * f - explained, 0),
                                            abs=0.06)
    assert "| base | 2 | 141.4 | 1.000 |" in out
    assert ("# encoded-vs-raw wire delta: encoded-off runs x1.400 vs base "
            "over 2 common queries; host-to-device bytes 2000 encoded vs "
            "8000 raw (x4.000)") in out
    assert "# prefetch overlap delta: prefetch-off runs x1.200 vs base" in out
    assert "# prefetch stall: 6 ms waited with the ring (base) vs 0 ms" in out
    assert "perf_audit" in out


def test_shard_delta_only_for_arms_that_ran_sharded(tmp_path, stub,
                                                   capsys):
    cmd, _calls = stub
    d = str(tmp_path / "camp")
    m = _matrix(tmp_path, ("base", {}),
                *((f"shards-{n}", {"NDS_TPU_STREAM_SHARDS": str(n)})
                  for n in (1, 2, 4)))
    res = _cli("--matrix", m, "--dir", d, "--bench-cmd", cmd)
    assert res.returncode == 0, res.stderr[-3000:]
    assert T.main(["--matrix", m, "--dir", d, "--report"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("# shard scaling: ")]
    assert lines == [
        "# shard scaling: shards-1 runs x1.000 vs base (collective GB/s "
        "per arm above)",
        "# shard scaling: shards-2 runs x1.000 vs base (collective GB/s "
        "per arm above)",
        "# shard scaling: shards-4 ran its streamed scans at 1 shard(s), "
        "not 4 (too few cards): no delta"]


def test_gate_each_arm_against_a_baseline(campaign, tmp_path, capsys):
    d, m = campaign
    base = os.path.join(d, "base", "ledger.jsonl")
    assert T.main(["--matrix", m, "--dir", d, "--report", "--gate",
                   base]) == 1
    out = capsys.readouterr().out
    verdicts = {}
    for block in out.split("## gate: ")[1:]:
        verdicts[block.split()[0]] = "# gate: no regressions" in block
    # the raw wire uploads 4x the bytes (the gate names the lost win),
    # and the inline ring's 1.2x passes the 1.10 geomean threshold
    assert verdicts == {"base": True, "encoded-off": False,
                        "prefetch-off": False}
    assert "h2d upload 1000 -> 4000 bytes" in out
    # a baseline of walls alone, one statement more than the arms ran
    times = tmp_path / "baseline.json"
    times.write_text(json.dumps({"times": {"query3": 100.0, "query37": 200.0,
                                           "query98": 50.0}}))
    assert T.main(["--matrix", m, "--dir", d, "--report", "--gate",
                   str(times), "--threshold", "1.6"]) == 1
    assert T.main(["--matrix", m, "--dir", d, "--report", "--gate",
                   str(times), "--threshold", "1.6", "--allow-missing"]) == 0


def test_emit_perf_to_a_given_path(campaign, tmp_path, capsys):
    d, m = campaign
    out = tmp_path / "T.md"
    assert T.main(["--matrix", m, "--dir", d, "--report",
                   "--emit-perf", str(out)]) == 0
    text = out.read_text()
    assert "query3" in text and "query37" in text
    assert f"-> {out}" in capsys.readouterr().out
    data = L.load_ledger(os.path.join(d, "base", "ledger.jsonl"))
    assert data.meta["arm"] == "base"


@pytest.mark.parametrize("flag", ["--audit-ab", "--audit-perf"])
def test_audits_refused(flag, tmp_path, capsys):
    """``--audit-ab`` is still refused, naming what it lacks;
    ``--audit-perf`` now runs: the arm's A/B ledger recorded under the
    arm's own knobs (here the raw wire) and held against the static cost
    model, exit 0."""
    if flag == "--audit-ab":
        assert T.main(["--preset", "smoke", flag]) == 2
        err = capsys.readouterr().err
        assert "Queue 1" in err and "bench_compare --audit-ab" in err
        return
    d = str(tmp_path / "camp")
    m = _matrix(tmp_path, ("encoded-off", {"NDS_TPU_ENCODED": "0"}))
    res = _cli("--matrix", m, "--dir", d, "--report", flag,
               "--audit-device", "cpu")
    assert res.returncode == 0, (res.stdout + res.stderr)[-3000:]
    assert "## arm encoded-off: --record-ab" in res.stdout
    assert "matches the perf_audit static cost model" in res.stdout
    data = L.load_ledger(os.path.join(d, "encoded-off", "ab.jsonl"))
    assert data.meta["encoded"] is False and data.meta["arm"] == \
        "encoded-off"
    assert len(data.queries) == 17
