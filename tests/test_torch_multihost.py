# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Multihost federation of the port (``nds_tpu_torch/parallel/multihost.py``)
on the CPU: the counterparts of ``tests/test_multihost.py``.

A real two-process gloo federation on localhost runs
``python -m nds_tpu_torch.tools.multihost_worker`` twice, four shards a
process sharing its CPU, so the session mesh spans 8 shards: its meshed
statements (an aggregation and a repartition join of two row-sharded
tables), the exchange join's pairs driven directly and a streamed template
sharded over each process's own shards give the rows of one process run
without a mesh, bit for bit, and the JAX reference's rows on the same
tables (exact kinds bit for bit, doubles within rel 1e-5; the pair count
against the keys' counts). Then the plumbing: disabled without the
environment, the environment contract reaching ``init_process_group``,
idempotence, the host split equal to the reference's, the ``peer`` fault
seam failing fast with a classified error, and a mesh over processes
holding only its own shards."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu_torch.engine import faults as F
from nds_tpu_torch.parallel import multihost as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def federation():
    """Process 0's JSON line of a two-process run of the worker."""
    port = _free_port()
    procs = []
    for i in range(2):
        env = dict(os.environ, NDS_TPU_MULTIHOST="1",
                   NDS_COORDINATOR=f"localhost:{port}",
                   NDS_NUM_PROCESSES="2", NDS_PROCESS_ID=str(i),
                   NDS_MULTIHOST_WATCHDOG_S="150")
        env.pop("NDS_TPU_FAULT", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nds_tpu_torch.tools.multihost_worker",
             "--device", "cpu"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{err[-3000:]}"
    lines = [ln for _rc, out, _err in outs for ln in out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, "process 0 reported no result"
    return json.loads(lines[0])


def test_worker_defaults_to_cuda_and_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    env = dict(os.environ, NDS_TPU_MULTIHOST="1",
               NDS_COORDINATOR=f"localhost:{_free_port()}",
               NDS_NUM_PROCESSES="1", NDS_PROCESS_ID="0")
    res = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.tools.multihost_worker"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]


def test_federation_spans_both_processes(federation):
    got = federation
    assert (got["world"], got["mesh"], got["shards"]) == (2, 8, 4)
    assert got["backend"] == "gloo"
    # the statements' collectives crossed the processes
    assert got["collectives"]["a2a"] > 0
    assert got["collectives"]["all_gather"] > 0
    assert got["exchangeJoins"] == 2
    # FETCH_SQL's two sides hand over just their matched rows; JOIN_SQL's
    # pairs outnumber its sides' rows, so they gather whole
    assert got["fetches"] == 2


@pytest.mark.parametrize("arm", ["rows", "pairs", "streamRows"])
def test_federated_arm_matches_one_process(federation, arm):
    """Each arm against the same arm run here, in one process without a
    mesh (and the pair count against the keys)."""
    from nds_tpu_torch.tools import multihost_worker as W
    want = W.expected("cpu")
    assert federation[arm] == want[arm]
    assert federation["expected"][arm] == want[arm]
    if arm == "pairs":
        keys = W.exchange_keys()
        assert want["pairs"] == sum(int(c) ** 2 for c in np.bincount(keys))


@pytest.fixture(scope="module")
def reference_rows():
    """The worker's statements through the JAX reference on the same
    tables: the aggregation and the join resident, the streamed template
    over the reference's chunked table at the worker's chunk length."""
    from nds_tpu.engine.session import Session as RefSession
    from nds_tpu.engine.table import ChunkedTable as RefChunked
    from nds_tpu_torch.tools import multihost_worker as W
    ref = RefSession()
    for name, t in W.make_tables().items():
        ref.create_temp_view(name, t)
    streamed = RefSession()
    streamed.create_temp_view("f", RefChunked(
        W.make_stream_table(), chunk_rows=W.STREAM_CHUNK_ROWS), base=True)
    return {"rows": [ref.sql(q).collect() for q in W.STATEMENTS],
            "streamRows": streamed.sql(W.STREAM_SQL).collect()}


@pytest.mark.parametrize("arm,case", [("rows", 0), ("rows", 1), ("rows", 2),
                                      ("streamRows", None)])
def test_federated_arm_matches_reference(federation, reference_rows, arm,
                                         case):
    """The federation's statements against the JAX reference's rows:
    exact kinds bit for bit, doubles within rel 1e-5, row order exact."""
    from tests.test_torch_mesh import rows_agree
    got, want = federation[arm], reference_rows[arm]
    if case is not None:
        got, want = got[case], want[case]
    assert len(want) > 0
    why = rows_agree(got, want)
    assert why is None, why


def test_federated_stream_is_sharded_and_compiled(federation):
    ev = federation["streamEvent"]
    assert ev == {"path": "compiled", "shards": 2, "chunks": 4}
    assert federation["ok"] is True


# ---------------------------------------------------------------------------
# the plumbing
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(M, "_initialized", False)
    for var in ("NDS_TPU_MULTIHOST", "NDS_COORDINATOR", "NDS_NUM_PROCESSES",
                "NDS_PROCESS_ID", "NDS_TPU_FAULT"):
        monkeypatch.delenv(var, raising=False)
    F.reset_fault_counts()
    yield
    F.reset_fault_counts()


def test_disabled_without_env(fresh):
    assert M.maybe_initialize() is False
    assert M.process_info() == (0, 1)


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda", "nccl")])
def test_initialize_passes_env_contract(fresh, monkeypatch, device,
                                        backend):
    calls = []
    monkeypatch.setenv("NDS_TPU_MULTIHOST", "1")
    monkeypatch.setenv("NDS_COORDINATOR", "10.0.0.2:8476")
    monkeypatch.setenv("NDS_NUM_PROCESSES", "4")
    monkeypatch.setenv("NDS_PROCESS_ID", "3")
    import torch.distributed as dist
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    assert M.maybe_initialize(device) is True
    assert calls == [{"backend": backend,
                      "init_method": "tcp://10.0.0.2:8476",
                      "world_size": 4, "rank": 3}]
    # idempotent: a second call does not attach again
    assert M.maybe_initialize(device) is True
    assert len(calls) == 1


def test_without_coordinator_the_group_reads_torch_env(fresh, monkeypatch):
    calls = []
    monkeypatch.setenv("NDS_TPU_MULTIHOST", "1")
    import torch.distributed as dist
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    assert M.maybe_initialize() is True
    assert calls == [{"backend": "gloo", "init_method": "env://"}]


@pytest.mark.parametrize("n", [0, 1, 7, 103, 4096])
@pytest.mark.parametrize("count", [1, 2, 3, 4, 8])
def test_host_shard_range_equals_reference(n, count):
    from nds_tpu.parallel import multihost as RM
    spans = [M.host_shard_range(n, i, count) for i in range(count)]
    assert spans == [RM.host_shard_range(n, i, count) for i in range(count)]
    covered = [r for s, e in spans for r in range(s, e)]
    assert covered == list(range(n))


def test_injected_peer_fault_fails_fast_classified(fresh, monkeypatch):
    """``NDS_TPU_FAULT=peer``: the attach raises the classified error at
    once, records a fatal fault event, and never reaches the group."""
    import torch.distributed as dist
    monkeypatch.setenv("NDS_TPU_MULTIHOST", "1")
    monkeypatch.setenv("NDS_TPU_FAULT", "peer:error:1")
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: called.append(kw))
    F.drain_fault_events()
    with pytest.raises(F.FaultError) as info:
        M.maybe_initialize()
    assert info.value.seam == "peer" and not called
    assert [(e.seam, e.action) for e in F.drain_fault_events()] == \
        [("peer", "fatal")]
    assert M._initialized is False


def test_failed_attach_is_classified_and_stops_the_session(fresh,
                                                           monkeypatch):
    """A real attach failure (a dead coordinator) surfaces as the peer
    seam's FaultError from Session construction."""
    import torch.distributed as dist

    from nds_tpu_torch.engine.session import Session

    def refuse(**kw):
        raise RuntimeError("connection refused")

    monkeypatch.setenv("NDS_TPU_MULTIHOST", "1")
    monkeypatch.setenv("NDS_COORDINATOR", "localhost:1")
    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(F.FaultError, match="connection refused") as info:
        Session(device="cpu")
    assert info.value.seam == "peer"


def test_mesh_over_processes_holds_its_own_shards(monkeypatch):
    """Rank 1 of 2 with mesh 8 holds global shards 4 to 7, in order; a
    mesh that does not divide over the processes is refused."""
    from nds_tpu_torch.engine.session import Session
    from nds_tpu_torch.parallel import exchange as X
    monkeypatch.setattr(M, "process_info", lambda: (1, 2))
    with X.sharing_devices():
        s = Session({"mesh_shape": 8, "broadcast_bytes": 8}, device="cpu")
        assert (s.mesh.size, len(s.mesh.devices), s.mesh.first) == (8, 4, 4)
        s.create_temp_view("t", pa.table({"k": pa.array(np.arange(100),
                                                        pa.int64())}))
        parts = s.catalog["t"].parts
        assert [p.nrows for p in parts] == [16, 16, 4, 0]
        assert torch.equal(parts[0]["k"].data, torch.arange(64, 80))
        assert X.split_rows(torch.arange(16), s.mesh).parts[3].tolist() \
            == [14, 15]
        monkeypatch.setattr(M, "process_info", lambda: (0, 3))
        with pytest.raises(ValueError, match="does not divide"):
            Session({"mesh_shape": 4}, device="cpu")
