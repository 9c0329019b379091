# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Campaign orchestration: a declarative arm matrix of bench runs.

* **Arm matrix** — a campaign is an ordered list of :class:`Arm`\\ s
  (name + env overlay), expanded from a matrix dict (or a JSON file of
  one) by :func:`expand_arms`. Each arm runs ``python -m
  nds_tpu_torch.bench`` with its overlay applied and its own
  ``NDS_BENCH_RESULTS_JSONL`` ledger under one campaign directory with a
  schema-versioned ``manifest.json``.
* **Env fingerprint** — :func:`env_fingerprint` canonicalizes the knobs
  that change what a run measures (:data:`FINGERPRINT_KNOBS`). The bench
  stamps it (plus the arm name, :func:`campaign_stamp`) into every
  ledger record, and :func:`check_resume_fingerprint` refuses to resume
  a ledger recorded under different knobs
  (:class:`CampaignResumeError` names both fingerprints).
* **Kill-proof resume** — an arm whose ledger carries a terminal
  ``completed`` record is skipped; a partial arm resumes from its own
  ledger (the bench's ``load_resume``); the manifest is rewritten
  atomically after every arm.
* **Classified arm failures** — a failed arm (nonzero bench exit, spawn
  failure, fingerprint mismatch, corrupt ledger) is classified through
  the ``bench-child`` seam (engine/faults.py) and recorded in the
  manifest; the remaining arms still run.

Standard library only: the bench parent imports it without torch. The
driver is single-threaded: all run state is local to
:func:`run_campaign`.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field

from nds_tpu_torch.engine import faults as _F
from nds_tpu_torch.obs import ledger as _L

CAMPAIGN_VERSION = 1
# the repository root: the bench runs as ``python -m nds_tpu_torch.bench``
# from there
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the knobs that change WHAT a run measures, in canonical order. An unset
# knob fingerprints as an explicit sentinel, so "unset" and "set to the
# default's value" differ (defaults can move between commits).
FINGERPRINT_KNOBS = (
    "NDS_BENCH_SCALE",               # scale factor (different data)
    "NDS_TPU_STREAM_BYTES",          # streaming threshold of the session
    "NDS_TPU_STATEMENT_DEADLINE_S",  # statement watchdog (helper thread)
    "NDS_TPU_FAULT",                 # injected fault
    "NDS_TPU_CHUNK_STORE",           # chunk store root (cold/warm arms)
    "NDS_TPU_REPLAY",                # whole-statement replay policy
    "NDS_TPU_REPLAY_SYNC_THR",       # replay's host-sync threshold
    "NDS_TPU_CONCURRENT_QUERIES",    # device admission slots
    "NDS_TPU_PREFETCH_DEPTH",        # prefetch ring depth: 0 = inline
    "NDS_TPU_STREAM_SHARDS",         # streamed shard count: 1/2/4/8
    "NDS_TPU_ENCODED",               # encoded upload: 0 = raw wire
)

_UNSET = "<unset>"


class CampaignError(ValueError):
    """A campaign input that cannot be trusted: unknown manifest schema
    version, malformed arm matrix, duplicate arm names. Loud by design —
    a misread matrix would burn hours of unattended device time on the
    wrong experiment."""


class CampaignResumeError(CampaignError):
    """A ledger recorded under DIFFERENT knobs than the arm trying to
    resume it: resuming would mix two experiments into one artifact.
    The message names both fingerprints so the operator can see exactly
    which knob moved."""


def env_fingerprint(env=None) -> str:
    """Canonical fingerprint of the arm-relevant knobs in ``env``
    (default: this process's environment). Deterministic — fixed knob
    order, explicit unset sentinel — so equality means "same
    experiment" and nothing else."""
    env = os.environ if env is None else env
    parts = []
    for k in FINGERPRINT_KNOBS:
        v = env.get(k)
        parts.append(f"{k}={_UNSET if v is None else v}")
    return ";".join(parts)


def campaign_stamp(env=None) -> dict:
    """The provenance stamp the bench merges into every ledger record:
    the env fingerprint always, plus the campaign arm name when the
    driver set ``NDS_CAMPAIGN_ARM``. Stamping the fingerprint even
    OUTSIDE a campaign means a later manual rerun against the same
    ledger still gets the mixed-arm refusal."""
    env = os.environ if env is None else env
    stamp = {"envFingerprint": env_fingerprint(env)}
    arm = env.get("NDS_CAMPAIGN_ARM")
    if arm:
        stamp["arm"] = arm
    return stamp


def check_resume_fingerprint(recorded, current, path="") -> None:
    """Refuse a resume whose recorded fingerprint mismatches the current
    one. A ledger with NO recorded fingerprint (pre-campaign artifact)
    resumes freely — the refusal protects stamped artifacts, it does not
    orphan legacy ones."""
    if recorded and recorded != current:
        raise CampaignResumeError(
            f"{path or 'ledger'}: recorded env fingerprint does not match "
            "the current environment —\n"
            f"  recorded: {recorded}\n"
            f"  current:  {current}\n"
            "refusing to resume (the results would mix two arms into one "
            "artifact); rerun under the recorded knobs or point this arm "
            "at a fresh ledger")


# ---------------------------------------------------------------------------
# arm model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Arm:
    """One campaign arm: a name (also the artifact subdirectory) and an
    env overlay applied on top of the inherited environment. An overlay
    value of ``""`` REMOVES the variable from the child env (e.g.
    ``NDS_TPU_CHUNK_STORE: ""`` is the cold-store arm)."""

    name: str
    env: dict = field(default_factory=dict)


# built-in arm matrices (the reference's, over the port's arms). ``env``
# is the campaign-level overlay every arm inherits; an arm's own overlay
# wins. ``{dir}`` in a value expands to the campaign directory, so the warm
# chunk store lands inside the campaign's own artifact tree. The
# reference's ``pallas-off`` arm has no counterpart: a CUDA tensor always
# launches its hand-written kernel, and no setting runs the plain version
# on the card.
_NO_PLAIN_ARM = ("no pallas-off arm: on cuda every kernel wrapper launches "
                 "its kernel, and nothing runs the plain version there")
PRESETS = {
    "sf10-full": {
        "description": "every landed mechanism priced in one unattended "
                       "SF10 campaign; a shards-N arm prices scaling only "
                       "where the visible cards hold N shards, else it "
                       "runs unsharded and the report says so ("
                       + _NO_PLAIN_ARM + ")",
        "env": {"NDS_BENCH_SCALE": "10",
                "NDS_TPU_CHUNK_STORE": "{dir}/chunk_store"},
        "arms": [
            # base runs FIRST: it warms the shared chunk store the later
            # default-knob arms reuse (store-cold opts out)
            {"name": "base", "env": {}},
            {"name": "prefetch-off", "env": {"NDS_TPU_PREFETCH_DEPTH": "0"}},
            {"name": "store-cold", "env": {"NDS_TPU_CHUNK_STORE": ""}},
            {"name": "encoded-off", "env": {"NDS_TPU_ENCODED": "0"}},
            {"name": "replay-off", "env": {"NDS_TPU_REPLAY": "off"}},
            {"name": "shards-1", "env": {"NDS_TPU_STREAM_SHARDS": "1"}},
            {"name": "shards-2", "env": {"NDS_TPU_STREAM_SHARDS": "2"}},
            {"name": "shards-4", "env": {"NDS_TPU_STREAM_SHARDS": "4"}},
            {"name": "shards-8", "env": {"NDS_TPU_STREAM_SHARDS": "8"}},
        ],
    },
    "smoke": {
        "description": "three-arm bench-scale shakeout of the campaign "
                       "tooling itself, minutes not hours ("
                       + _NO_PLAIN_ARM + ")",
        "env": {"NDS_BENCH_SCALE": "0.05"},
        "arms": [
            {"name": "base", "env": {}},
            {"name": "encoded-off", "env": {"NDS_TPU_ENCODED": "0"}},
            {"name": "prefetch-off", "env": {"NDS_TPU_PREFETCH_DEPTH": "0"}},
        ],
    },
}


def expand_arms(matrix: dict, campaign_dir: str) -> list:
    """Expand one matrix dict (a :data:`PRESETS` entry, or a loaded JSON
    file of ``{"env": {...}, "arms": [{"name": ..., "env": {...}}, ...]}``)
    into the ordered :class:`Arm` list. Validates loudly: version
    drift, missing/duplicate/unsafe arm names. ``{dir}`` in any env
    value expands to the campaign directory."""
    if not isinstance(matrix, dict) or not matrix.get("arms"):
        raise CampaignError("arm matrix must be an object with a "
                            "non-empty 'arms' list")
    v = matrix.get("v", CAMPAIGN_VERSION)
    if v != CAMPAIGN_VERSION:
        raise CampaignError(
            f"arm matrix schema version {v!r} is not the supported "
            f"version {CAMPAIGN_VERSION} — refusing to guess at unknown "
            "arm semantics")
    base = matrix.get("env") or {}
    arms = []
    seen = set()
    for spec in matrix["arms"]:
        name = (spec or {}).get("name")
        if not name or not isinstance(name, str):
            raise CampaignError("every arm needs a non-empty 'name'")
        if os.sep in name or name.startswith("."):
            raise CampaignError(f"arm name {name!r} is not a safe "
                                "artifact directory name")
        if name in seen:
            raise CampaignError(f"duplicate arm name {name!r}")
        seen.add(name)
        overlay = dict(base)
        overlay.update(spec.get("env") or {})
        overlay = {k: str(v).replace("{dir}", campaign_dir)
                   for k, v in overlay.items()}
        arms.append(Arm(name, overlay))
    return arms


def arm_env(arm: Arm, base_env=None) -> dict:
    """The effective environment an arm runs under: the inherited env
    with the overlay applied (``""`` removes the knob)."""
    env = dict(os.environ if base_env is None else base_env)
    for k, v in arm.env.items():
        if v == "":
            env.pop(k, None)
        else:
            env[k] = v
    return env


def arm_fingerprint(arm: Arm, base_env=None) -> str:
    return env_fingerprint(arm_env(arm, base_env))


def arm_paths(campaign_dir: str, name: str) -> dict:
    """Per-arm artifact layout under the campaign directory."""
    d = os.path.join(campaign_dir, name)
    return {"dir": d,
            "ledger": os.path.join(d, "ledger.jsonl"),
            "traces": os.path.join(d, "traces"),
            "metrics": os.path.join(d, "metrics.json"),
            "log": os.path.join(d, "bench.log")}


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


def manifest_path(campaign_dir: str) -> str:
    return os.path.join(campaign_dir, "manifest.json")


def write_manifest(campaign_dir: str, manifest: dict) -> None:
    """Atomic write (tmp + rename): a kill mid-write leaves the previous
    manifest intact, never a torn one — resume reads either a complete
    old state or a complete new one."""
    manifest["v"] = CAMPAIGN_VERSION
    path = manifest_path(campaign_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_manifest(campaign_dir: str):
    """The campaign manifest, or None when the directory has none yet.
    An unknown schema version refuses loudly — same discipline as the
    ledger loader."""
    path = manifest_path(campaign_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        try:
            doc = json.load(f)
        except ValueError as exc:
            raise CampaignError(f"{path}: unreadable manifest ({exc})")
    v = doc.get("v") if isinstance(doc, dict) else None
    if v != CAMPAIGN_VERSION:
        raise CampaignError(
            f"{path}: manifest schema version {v!r} is not the supported "
            f"version {CAMPAIGN_VERSION} — refusing to misread a "
            "campaign state (upgrade the reader, or start a fresh "
            "campaign directory)")
    return doc


def new_manifest(arms, campaign_dir: str, preset=None) -> dict:
    return {
        "v": CAMPAIGN_VERSION,
        "preset": preset,
        "dir": os.path.abspath(campaign_dir),
        "status": "running",
        "startedAt": round(time.time(), 3),
        "arms": [{"name": a.name, "env": dict(a.env),
                  "fingerprint": arm_fingerprint(a),
                  "ledger": os.path.join(a.name, "ledger.jsonl"),
                  "status": "pending"} for a in arms],
    }


# ---------------------------------------------------------------------------
# per-arm resume admission
# ---------------------------------------------------------------------------


def arm_status(arm: Arm, campaign_dir: str, base_env=None):
    """Resume admission for one arm, off its own ledger:

    ``("pending", None)``  no ledger yet — run from scratch;
    ``("partial", None)``  ledger without a clean terminal record — the
    arm resumes (the bench's ``load_resume`` skips measured queries);
    ``("done", None)``     clean terminal ``completed`` record — skip;
    ``("corrupt", why)``   unreadable ledger — the arm is classified
    failed, never silently re-run over a poisoned artifact.

    Raises :class:`CampaignResumeError` when the ledger's recorded
    fingerprint mismatches this arm's effective knobs."""
    paths = arm_paths(campaign_dir, arm.name)
    ledger = paths["ledger"]
    if not os.path.exists(ledger) or os.path.getsize(ledger) == 0:
        return "pending", None
    try:
        data = _L.load_ledger(ledger)
    except _L.LedgerError as exc:
        return "corrupt", str(exc)
    check_resume_fingerprint(data.meta.get("envFingerprint"),
                             arm_fingerprint(arm, base_env), ledger)
    if data.end is not None and data.end.get("status") == "completed":
        return "done", None
    return "partial", None


def classify_arm_failure(arm_name: str, detail: str) -> dict:
    """The fault-matrix ladder applied to one failed arm: the
    ``bench-child`` seam's registered classification and recovery
    policy, plus whatever fault events the attempt left in the ring —
    drained HERE so the evidence lands in the manifest instead of dying
    thread-local. The campaign-level recovery is the seam's own:
    transient — the next rerun of the same command retries the arm off
    its ledger; the remaining arms run regardless."""
    seam = _F.SEAMS["bench-child"]
    events = [_F.fault_event_json(e) for e in _F.drain_fault_events()]
    out = {"seam": seam.name, "class": seam.classify,
           "recovery": seam.recovery, "detail": str(detail)[:300]}
    if events:
        out["faultEvents"] = events
    return out


# ---------------------------------------------------------------------------
# the unattended driver
# ---------------------------------------------------------------------------


def default_bench_cmd() -> list:
    """The bench entry every arm runs (from the repository root)."""
    return [sys.executable, "-m", "nds_tpu_torch.bench"]


def run_campaign(arms, campaign_dir, bench_cmd=None, env=None,
                 preset=None, out=None):
    """Run (or resume) every arm in order; returns the final manifest.

    Kill-proof by construction: the manifest is atomically rewritten
    after every arm transition, each arm's evidence is its own ledger
    (flushed per record), and rerunning the same
    command skips clean-completed arms and resumes the partial one. A
    SIGTERM/SIGINT terminates the in-flight bench child (whose own
    handler finalizes its ledger), finalizes the manifest as
    ``aborted``, and exits — the bench's ``finalize()`` discipline one
    layer up. Arm failures are classified (``bench-child`` seam) and
    never abort the remaining arms."""
    out = sys.stderr if out is None else out
    # the arms run from the repository root: their artifact paths must
    # not depend on this process's directory
    campaign_dir = os.path.abspath(campaign_dir)
    os.makedirs(campaign_dir, exist_ok=True)
    load_manifest(campaign_dir)          # version refusal before overwrite
    base_env = dict(os.environ if env is None else env)
    manifest = new_manifest(arms, campaign_dir, preset=preset)
    write_manifest(campaign_dir, manifest)
    cmd = list(bench_cmd) if bench_cmd else default_bench_cmd()
    state = {"child": None, "finalized": False}

    def finalize(status):
        if state["finalized"]:
            return
        state["finalized"] = True
        manifest["status"] = status
        manifest["endedAt"] = round(time.time(), 3)
        write_manifest(campaign_dir, manifest)

    def on_signal(signum, frame):
        # external kill mid-campaign: stop the in-flight arm's bench
        # run with SIGTERM (its own handler flushes the partial geomean
        # + terminal ledger record), label the arm, finalize the
        # manifest — the campaign artifact stays self-describing
        child = state["child"]
        if child is not None and child.poll() is None:
            child.terminate()
            try:
                child.wait(timeout=30)
            except subprocess.TimeoutExpired:
                child.kill()
        for rec in manifest["arms"]:
            if rec["status"] == "running":
                rec["status"] = "aborted"
                rec["error"] = "signal"
        finalize("aborted")
        os._exit(1)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    for arm, rec in zip(arms, manifest["arms"]):
        paths = arm_paths(campaign_dir, arm.name)
        try:
            status, why = arm_status(arm, campaign_dir, base_env)
        except CampaignResumeError as exc:
            rec["status"] = "failed"
            rec["error"] = str(exc)[:500]
            rec["classified"] = classify_arm_failure(
                arm.name, "fingerprint-mismatch")
            print(f"# arm {arm.name}: REFUSED resume "
                  "(fingerprint mismatch); arm marked failed, campaign "
                  "continues", file=out)
            write_manifest(campaign_dir, manifest)
            continue
        if status == "done":
            rec["status"] = "done"
            print(f"# arm {arm.name}: already completed (clean terminal "
                  "record); skipped", file=out)
            write_manifest(campaign_dir, manifest)
            continue
        if status == "corrupt":
            rec["status"] = "failed"
            rec["error"] = f"corrupt ledger: {why}"[:500]
            rec["classified"] = classify_arm_failure(arm.name,
                                                     "corrupt ledger")
            print(f"# arm {arm.name}: corrupt ledger ({why}); arm marked "
                  "failed, campaign continues", file=out)
            write_manifest(campaign_dir, manifest)
            continue
        if status == "partial":
            print(f"# arm {arm.name}: resuming off its ledger", file=out)
        os.makedirs(paths["dir"], exist_ok=True)
        child_env = arm_env(arm, base_env)
        child_env["NDS_CAMPAIGN_ARM"] = arm.name
        child_env["NDS_BENCH_RESULTS_JSONL"] = paths["ledger"]
        child_env["NDS_BENCH_TRACE_DIR"] = paths["traces"]
        # per-arm live status file (atomic snapshot on the heartbeat
        # cadence)
        child_env["NDS_TPU_METRICS_FILE"] = paths["metrics"]
        rec["status"] = "running"
        write_manifest(campaign_dir, manifest)
        t0 = time.time()
        print(f"# arm {arm.name}: running {' '.join(cmd)}", file=out)
        rc = None
        try:
            # the arm spawn is the same bench-child seam as
            # ChildServer.start: injectable, classified, never fatal to
            # the arms behind it
            _F.fault_point("bench-child", detail=arm.name)
            with open(paths["log"], "ab") as logf:
                state["child"] = subprocess.Popen(
                    cmd, env=child_env, cwd=_REPO, stdout=logf,
                    stderr=subprocess.STDOUT)
                rc = state["child"].wait()
        except (_F.FaultError, OSError) as exc:
            _F.record_fault_event("bench-child", "degrade",
                                 detail=f"arm {arm.name}: {exc}"[:200])
            rec["status"] = "failed"
            rec["error"] = f"{type(exc).__name__}: {exc}"[:300]
            rec["classified"] = classify_arm_failure(arm.name, str(exc))
            print(f"# arm {arm.name}: spawn failed ({exc}); classified, "
                  "campaign continues", file=out)
            write_manifest(campaign_dir, manifest)
            continue
        finally:
            state["child"] = None
        rec["wallS"] = round(time.time() - t0, 1)
        if rc == 0:
            rec["status"] = "completed"
            print(f"# arm {arm.name}: completed in {rec['wallS']}s",
                  file=out)
        else:
            _F.record_fault_event("bench-child", "degrade",
                                  detail=f"arm {arm.name}: bench exit {rc}")
            rec["status"] = "failed"
            rec["rc"] = rc
            rec["error"] = f"bench exit {rc}"
            rec["classified"] = classify_arm_failure(arm.name,
                                                     f"bench exit {rc}")
            print(f"# arm {arm.name}: bench exit {rc}; classified "
                  f"({rec['classified']['class']}), campaign continues",
                  file=out)
        write_manifest(campaign_dir, manifest)
    ok = sum(1 for r in manifest["arms"] if r["status"] in
             ("completed", "done"))
    manifest["completedArms"] = ok
    manifest["failedArms"] = len(manifest["arms"]) - ok
    finalize("completed")
    return manifest
