# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Static cost model: every statement's data movement, priced before it runs
(the port's copy of the reference's ``analysis/perf_audit.py``, at the
H100's rates).

Composing the execution and memory walks (:mod:`exec_audit`,
:mod:`mem_audit`: one decomposition, no AST logic of its own), it derives
for every statement:

1. **Host-to-device bytes** — what the streamed scans upload. The compiled
   drive pads every chunk to one capacity and ships a validity byte per
   column (``ChunkedTable.host_chunks``, ``engine/table.py``), so the
   upload is a closed form::

       bytes_h2d = n_chunks x chunk_cap x sum(width_data + 1)

   over the pruned columns at their wire widths (the narrow codes of
   ``ChunkedTable._wire_plan``; plain widths under ``NDS_TPU_ENCODED=0``).
   It is exact whenever the model knows the real rows and wire widths
   (:func:`wire_column_widths`; ``nds_tpu_torch.tools.perf_audit_diff``
   holds it equal to ``StreamEvent.bytes_h2d``), an upper bound against
   the SF10 catalog widths. The eager drive uploads the same padded
   chunks as the graph drive, and a warm run the same bytes again (the
   chunk store keeps the encoding, not the device buffers); the eager
   chunk loop uploads unencoded bucket-padded chunks with validity only on
   null-bearing columns: a [min, max] band.

2. **Device-memory traffic by stage** — scan, filter, partition, probe,
   exchange, accumulate: the roofline's denominator. On the card the port
   always runs K4 where the shared eligibility rule lowers a conjunct
   (``exec_audit``'s ``kernel_scan_chunk > 0``), so the filter and the
   partition hash ride the one K4 pass there (the reference's
   fused-kernel arm). A model, not an equality.

3. **Collective bytes** — from the exchange's shapes: the per-chunk
   hash-exchange moves ``S x cap_ex x (sum(width_data + 1) + 5)`` bytes,
   the one cross-shard reduce ``20 x P``; outer-build bitmaps ride the
   reduce, priced 0 (a lower bound, flagged inexact).

4. **The K4/K5 launch band** — ``[K4 a chunk x chunks, (K4 + K5 a
   dispatch x P) x chunks]`` that ``StreamEvent``'s launches must fit.

5. **A roofline wall** — the largest of the three byte totals over its
   link's rate (:func:`roofline_gbs`: the H100's PCIe Gen5 x16, HBM3 and
   NVLink rates, or ``NDS_TPU_ROOFLINE_*_GBS``), with a bottleneck tag
   (``h2d-bound``, ``hbm-bound``, ``ici-bound``; ``sync-bound`` when a
   scan takes the eager loop). It is a lower bound on the wall: measured
   less static is the ``unexplained ms`` of ``tools.trace_report``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

from nds_tpu_torch.analysis import Finding
from nds_tpu_torch.analysis.exec_audit import (CLASS_COMPILED, CLASS_DEVICE,
                                               CLASS_EAGER, CLASS_UNKNOWN,
                                               ExecAuditor, ExecReport,
                                               ScanVerdict, _AUDIT_SEED)
from nds_tpu_torch.analysis.mem_audit import (MemAuditor, MemModel,
                                              ScanBound, _bucket)
from nds_tpu_torch.queries import (TEMPLATE_DIR, instantiate_template,
                                   list_templates, load_template)
# the card's link rates (the H100's PCIe Gen5 x16, HBM3 and NVLink 4; the
# NDS_TPU_ROOFLINE_*_GBS knobs override them): one definition, shared with
# the measured roofline columns of the trace report
from nds_tpu_torch.tools.trace_report import roofline_gbs

# the four static bottleneck tags (the corpus histogram at the H100's
# rates is pinned by tests/test_torch_perf_audit.py)
BOUND_H2D = "h2d-bound"
BOUND_HBM = "hbm-bound"
BOUND_ICI = "ici-bound"
BOUND_SYNC = "sync-bound"

# HBM stage names, pipeline order (DESIGN.md "Static cost model")
STAGES = ("scan", "filter", "partition", "probe", "exchange", "accumulate")


# ---------------------------------------------------------------------------
# report types
# ---------------------------------------------------------------------------


@dataclass
class ScanCost:
    """The priced data movement of one streamed scan."""

    alias: str
    table: str
    compiled: bool             # chunk pipeline (True) or eager loop
    rows: int                  # streamed row bound the chunks slice
    chunks: int                # ceil(rows / chunk_rows)
    chunk_cap: int             # uniform padded capacity per chunk
    n_cols: int = 0            # pruned column count on the wire
    width: int = 0             # wire bytes/row incl. validity (pruned)
    priced: bool = True        # False = unknown table, default width
    bytes_h2d: int = 0         # upload prediction (compiled: exact form)
    bytes_h2d_min: int = 0     # lower edge (eager band; == bytes_h2d
    #                            when the prediction is a point)
    h2d_exact: bool = False    # True only when rows AND wire widths are
    #                            the real ones (harness-supplied)
    partitions: int = 1        # grace partition count (mem model choice)
    shards: int = 1            # mesh shard count
    exchange: bool = False     # per-chunk hash-exchange pass active
    cap_ex: int = 0            # exchange bucket capacity per (shard,dest)
    bytes_ici: int = 0         # collective wire bytes (exchange + reduce)
    ici_exact: bool = False    # False when outer-build bitmaps ride the
    #                            reduce (priced 0: lower bound) or widths
    #                            are the static stand-ins
    kernel_min: int = 0        # fused-kernel launch band the measured
    kernel_max: int = 0        # StreamEvent.kernel_launches must fit
    stages: dict = field(default_factory=dict)  # stage -> HBM bytes

    @property
    def bytes_hbm(self) -> int:
        return sum(self.stages.values())

    def to_dict(self) -> dict:
        return {
            "alias": self.alias, "table": self.table,
            "compiled": self.compiled, "rows": int(self.rows),
            "chunks": int(self.chunks), "chunk_cap": int(self.chunk_cap),
            "n_cols": int(self.n_cols), "width": int(self.width),
            "priced": self.priced,
            "bytes_h2d": int(self.bytes_h2d),
            "bytes_h2d_min": int(self.bytes_h2d_min),
            "h2d_exact": self.h2d_exact,
            "partitions": int(self.partitions), "shards": int(self.shards),
            "exchange": self.exchange, "cap_ex": int(self.cap_ex),
            "bytes_ici": int(self.bytes_ici), "ici_exact": self.ici_exact,
            "kernel_min": int(self.kernel_min),
            "kernel_max": int(self.kernel_max),
            "stages": {k: int(v) for k, v in self.stages.items()},
            "bytes_hbm": int(self.bytes_hbm),
        }


@dataclass
class PerfReport:
    """Byte totals + roofline wall of one template statement."""

    file: str
    query: str
    classification: str        # exec_audit's routing classification
    bytes_h2d: int = 0
    bytes_h2d_min: int = 0
    h2d_exact: bool = False
    bytes_hbm: int = 0
    bytes_ici: int = 0
    ici_exact: bool = False
    wall_h2d_ms: float = 0.0
    wall_hbm_ms: float = 0.0
    wall_ici_ms: float = 0.0
    roofline_ms: float = 0.0   # max of the three walls: the static
    #                            lower bound on the statement's wall
    bound: str = BOUND_SYNC    # ranked bottleneck tag
    scans: tuple = ()          # ScanCosts, exec/mem walk order
    stages: dict = field(default_factory=dict)  # aggregated stage bytes
    detail: str = ""

    def to_dict(self) -> dict:
        return {
            "file": self.file, "query": self.query,
            "classification": self.classification,
            "bytes_h2d": int(self.bytes_h2d),
            "bytes_h2d_min": int(self.bytes_h2d_min),
            "h2d_exact": self.h2d_exact,
            "bytes_hbm": int(self.bytes_hbm),
            "bytes_ici": int(self.bytes_ici),
            "ici_exact": self.ici_exact,
            "wall_h2d_ms": round(self.wall_h2d_ms, 6),
            "wall_hbm_ms": round(self.wall_hbm_ms, 6),
            "wall_ici_ms": round(self.wall_ici_ms, 6),
            "roofline_ms": round(self.roofline_ms, 6),
            "bound": self.bound,
            "scans": [s.to_dict() for s in self.scans],
            "stages": {k: int(v) for k, v in self.stages.items()},
            "detail": self.detail,
        }


# ---------------------------------------------------------------------------
# live wire widths (the harness's exactness hook)
# ---------------------------------------------------------------------------


def wire_column_widths(table, canonical_types: dict | None = None) -> dict:
    """``{lowercase column -> wire bytes a row, validity included}`` of the
    padded chunks the port uploads for ``table`` (a ``ChunkedTable``, or
    an arrow table with its ``canonical_types``): the width of each
    column's array in ``ChunkedTable._wire_plan`` (int32 string codes, the
    narrow FOR/dict codes the data proves, else the plain lowering; plain
    under ``NDS_TPU_ENCODED=0``, read now), plus the validity byte every
    padded chunk ships. The harnesses feed these to :class:`PerfAuditor`
    as ``wire_cols``, which makes the upload and collective predictions
    equalities."""
    if not hasattr(table, "_wire_plan"):
        from nds_tpu_torch.engine.table import ChunkedTable
        table = ChunkedTable(table, canonical_types)
    plan = table._wire_plan()
    return {name.lower(): int(plan[name].data.dtype.itemsize) + 1
            for name in table.column_names}


# ---------------------------------------------------------------------------
# the auditor
# ---------------------------------------------------------------------------


class PerfAuditor:
    """Host-only static cost model over the planner's decomposition.

    Composes :class:`ExecAuditor` (routing, shards, collective and kernel
    budgets) and :class:`MemAuditor` (row bounds, partition plan, widths):
    one decomposition, three interpretations. ``wire_cols`` maps a table
    to its real wire widths a column (:func:`wire_column_widths`), which
    makes the byte predictions equalities; without it the model prices the
    static widths and every prediction is an upper bound. The settings
    (partitions, shards, chunk rows, capacity) are the calling
    statement's (``ops.setting``), the link rates
    (:func:`roofline_gbs`) frozen at construction."""

    def __init__(self, streamed=None, model: MemModel | None = None,
                 base_tables=None, catalog: dict | None = None,
                 wire_cols: dict | None = None):
        self.model = model or MemModel()
        self.mem = MemAuditor(streamed=streamed, model=self.model,
                              base_tables=base_tables)
        self.exec = ExecAuditor(catalog=catalog, streamed=streamed,
                                base_tables=base_tables,
                                mem_model=self.model)
        self.streamed = self.mem.streamed
        self.wire_cols = {t.lower(): {c.lower(): int(w)
                                      for c, w in cols.items()}
                          for t, cols in (wire_cols or {}).items()}
        self.rates = roofline_gbs()

    # -- entry point --------------------------------------------------------

    def audit_sql(self, sql: str, file: str = "<sql>",
                  query: str = "<sql>") -> PerfReport:
        """Price one SQL statement's data movement."""
        er = self.exec.audit_sql(sql, file=file, query=query)
        mr = self.mem.audit_sql(sql, file=file, query=query)
        if er.classification == CLASS_UNKNOWN:
            return PerfReport(file, query, er.classification,
                              detail=er.detail or mr.detail)
        costs = self._scan_costs(er, mr, self.mem.needed)
        return self._assemble(file, query, er, mr, costs)

    # -- per-scan pricing ---------------------------------------------------

    def _scan_costs(self, er: ExecReport, mr, needed) -> list:
        """Pair the exec verdicts with the mem bounds (both walk the
        same decomposition; pair by index, falling back to table-name
        matching) and price each streamed scan. EVERY pipeline of the
        statement — expression-subquery pipelines included — prunes at
        the STATEMENT-level needed set: the planner computes pruning
        once per statement, so the ab12-class scalar-subquery chain
        uploads the same columns in both of its store_sales pipelines
        (the differential harness pins this byte-exactly)."""
        bounds = list(mr.scans)
        pairs = []
        for i, sv in enumerate(er.scans):
            sb = None
            if i < len(bounds) and bounds[i] is not None \
                    and bounds[i].table == sv.table:
                sb = bounds[i]
                bounds[i] = None
            else:
                for j, b in enumerate(bounds):
                    if b is not None and b.table == sv.table:
                        sb = b
                        bounds[j] = None
                        break
            pairs.append((sv, sb))
        return [self._scan_cost(sv, sb, needed) for sv, sb in pairs]

    def _pruned_widths(self, table: str, needed):
        """``(cols, exact, priced)``: the pruned wire width per column.
        ``cols`` applies the planner's proper-subset pruning rule to the
        table's ACTUAL columns (the ``wire_cols`` override when the
        harness supplies real widths, the static encoded/plain catalog
        widths otherwise)."""
        exact = False
        cols = self.wire_cols.get(table)
        if cols is not None:
            exact = True
        else:
            cols = (self.model.enc_widths if self.model.encoded
                    else self.model.widths).get(table, {})
        if not cols:
            return {"?": 9}, False, False   # unknown table: one wide col
        if needed is not None:
            kept = {c: w for c, w in cols.items() if c in needed}
            if kept and len(kept) < len(cols):
                cols = kept
        return dict(cols), exact, True

    def _plain_width(self, table: str, needed):
        """``(width, n_cols)`` of the UNENCODED pruned row — what the
        eager chunk loop uploads (``from_arrow``: no narrow codecs,
        bucket-padded per chunk)."""
        cols = self.model.widths.get(table, {})
        if not cols:
            return 9, 1
        if needed is not None:
            kept = {c: w for c, w in cols.items() if c in needed}
            if kept and len(kept) < len(cols):
                cols = kept
        return sum(cols.values()), len(cols)

    def _scan_cost(self, sv: ScanVerdict, sb: ScanBound | None,
                   needed) -> ScanCost:
        model = self.model
        rows = sb.rows if sb is not None \
            else (model.table_rows(sv.table) or 1)
        n_chunks = max(1, math.ceil(rows / model.chunk_rows))
        cap = model.chunk_cap()
        P = max(1, sb.partitions if sb is not None else 1)
        S = max(1, sv.shards)
        cols, exact_w, priced = self._pruned_widths(sv.table, needed)
        width = sum(cols.values())
        n_cols = len(cols)
        cost = ScanCost(sv.alias, sv.table, sv.compiled, rows, n_chunks,
                        cap, n_cols=n_cols, width=width, priced=priced,
                        partitions=P, shards=S)

        chunk_bytes = cap * width
        if sv.compiled:
            # the closed form: every chunk at ONE capacity, every column
            # data + validity — identical cold/warm (the chunk store
            # caches the encoding, not the buffers) and prefetch-
            # invariant (the ring changes WHEN bytes move, not how many)
            cost.bytes_h2d = cost.bytes_h2d_min = n_chunks * chunk_bytes
            cost.h2d_exact = exact_w
        else:
            # eager loop: unencoded chunks, each bucket-padded to its own
            # length, validity only where nulls exist -> a [min,max] band
            pw, pn = self._plain_width(sv.table, needed)
            last = rows - (n_chunks - 1) * model.chunk_rows
            padded = (n_chunks - 1) * _bucket(model.chunk_rows) \
                + _bucket(max(last, 1))
            cost.bytes_h2d = padded * pw
            cost.bytes_h2d_min = padded * max(pw - pn, 1)

        # -- ICI: exchange (per chunk) + the one cross-shard reduce ------
        if sv.compiled and S > 1:
            # a sharded partitioned graph always takes the exchange pass
            exch = P > 1 and sv.a2a_chunk > 0
            reduce_bytes = 20 * P          # all_gather counts (8P) +
            #                                psum flags (4P) + hist (8P)
            n_builds = max(0, sv.coll_final - 3)
            if exch:
                cost.exchange = True
                cost.cap_ex = _bucket(max((cap // S) // S, 1)
                                      * model.skew)
                exch_bytes = S * cost.cap_ex * (width + 5)
                cost.bytes_ici = n_chunks * exch_bytes + reduce_bytes
            else:
                cost.bytes_ici = reduce_bytes
            # outer-build bitmap psums ride the reduce; their padded
            # length is the build side's device table length, which the
            # composed walk does not surface — priced 0 (lower bound)
            cost.ici_exact = exact_w and n_builds == 0

        # -- K4/K5 launch band: each shard runs its own K4 pass and its
        # partitions' probes on its slice of every chunk
        if sv.compiled:
            cost.kernel_min = sv.kernel_scan_chunk * n_chunks * S
            cost.kernel_max = (sv.kernel_scan_chunk
                               + sv.kernel_probe_chunk * P) * n_chunks * S

        # -- HBM stage model (roofline denominator) ----------------------
        stages = dict.fromkeys(STAGES, 0)
        if sv.compiled:
            fused = sv.kernel_scan_chunk > 0
            stages["scan"] = n_chunks * chunk_bytes
            # mask + compact re-read per chunk, folded into the one K4
            # pass where the spec lowers a conjunct
            stages["filter"] = 0 if fused else n_chunks * chunk_bytes
            if P > 1:
                # the routing hash pass re-reads the chunk (with K4: the
                # hash rides the same pass)
                stages["partition"] = 0 if fused \
                    else n_chunks * chunk_bytes
                # every extra per-partition dispatch re-reads the chunk
                stages["probe"] = (P - 1) * n_chunks * chunk_bytes
            if cost.exchange:
                # pack write + exchanged read around the all-to-all
                stages["exchange"] = 2 * n_chunks * S * cost.cap_ex \
                    * (width + 5)
            if sb is not None:
                acc = sb.part_bytes * P if (sb.part_bytes is not None
                                            and P > 1) else sb.acc_bytes
                stages["accumulate"] = int(acc or 0)
        else:
            # eager loop: each uploaded chunk is read once; survivors
            # concatenate on host (no device accumulator to price)
            stages["scan"] = cost.bytes_h2d
        cost.stages = {k: v for k, v in stages.items() if v}
        return cost

    # -- statement assembly -------------------------------------------------

    def _assemble(self, file, query, er: ExecReport, mr,
                  costs: list) -> PerfReport:
        rep = PerfReport(file, query, er.classification)
        rep.scans = tuple(costs)
        rep.bytes_h2d = sum(c.bytes_h2d for c in costs)
        rep.bytes_h2d_min = sum(c.bytes_h2d_min for c in costs)
        rep.h2d_exact = bool(costs) and all(c.h2d_exact for c in costs)
        rep.bytes_ici = sum(c.bytes_ici for c in costs)
        rep.ici_exact = all(c.ici_exact for c in costs
                            if c.bytes_ici) if any(c.bytes_ici
                                                   for c in costs) else False
        stages: dict = {}
        for c in costs:
            for k, v in c.stages.items():
                stages[k] = stages.get(k, 0) + v
        if er.classification == CLASS_DEVICE:
            # device-resident statement: one pass over the resident peak
            # is the floor of its HBM traffic
            stages["scan"] = stages.get("scan", 0) + int(mr.peak_bytes)
        rep.stages = stages
        rep.bytes_hbm = sum(stages.values())
        # walls: bytes / (GB/s x 1e9) in ms == bytes / rate / 1e6
        rep.wall_h2d_ms = rep.bytes_h2d / self.rates["h2d"] / 1e6
        rep.wall_hbm_ms = rep.bytes_hbm / self.rates["hbm"] / 1e6
        rep.wall_ici_ms = rep.bytes_ici / self.rates["ici"] / 1e6
        rep.roofline_ms = max(rep.wall_h2d_ms, rep.wall_hbm_ms,
                              rep.wall_ici_ms)
        rep.bound = self._bound_tag(er, rep)
        return rep

    @staticmethod
    def _bound_tag(er: ExecReport, rep: PerfReport) -> str:
        """Ranked static bottleneck: ``sync-bound`` when exec_audit has
        no finite statement sync bound (the eager loop's O(chunks) host
        reads dominate any byte wall — routing is the bottleneck, not a
        link), else the slowest wall, ties resolved in pipeline order
        (h2d feeds HBM feeds ICI)."""
        if er.classification == CLASS_EAGER or er.sync_bound is None:
            return BOUND_SYNC
        walls = ((rep.wall_h2d_ms, BOUND_H2D),
                 (rep.wall_hbm_ms, BOUND_HBM),
                 (rep.wall_ici_ms, BOUND_ICI))
        best, tag = 0.0, BOUND_SYNC
        for w, t in walls:
            if w > best:
                best, tag = w, t
        return tag


# ---------------------------------------------------------------------------
# corpus driver + lint-gate findings
# ---------------------------------------------------------------------------


def audit_perf_template_text(text: str, file: str,
                             auditor: PerfAuditor | None = None) -> list:
    """Instantiate one template (pinned seed, shared with the other
    auditors) and price each statement; returns PerfReports."""
    import numpy as np
    auditor = auditor or PerfAuditor()
    sql = instantiate_template(text, np.random.default_rng(_AUDIT_SEED))
    stmts = [s for s in sql.split(";") if s.strip()]
    base = os.path.basename(file)
    out = []
    for i, stmt in enumerate(stmts):
        qname = base[:-4] if base.endswith(".tpl") else base
        if len(stmts) > 1:
            qname = f"{qname}_part{i + 1}"
        out.append(auditor.audit_sql(stmt, file=base, query=qname))
    return out


def audit_perf_corpus(template_dir: str | None = None,
                      streamed=None) -> list:
    """PerfReports for every template in templates.lst order."""
    template_dir = template_dir or TEMPLATE_DIR
    auditor = PerfAuditor(streamed=streamed)
    reports: list = []
    for name in list_templates(template_dir):
        reports.extend(audit_perf_template_text(
            load_template(name, template_dir), name, auditor))
    return reports


def reports_to_findings(reports) -> list:
    """Lint-gate findings from perf reports. The byte totals themselves
    are a report (``--perf-report``), not findings; the gate catches the
    two ways the cost model can silently stop modeling:

    * ``cost-model-gap`` — a compiled streamed scan priced at the
      unknown-table default width: the model cannot see the table's
      columns, so every byte prediction for the statement is fiction;
    * ``roofline-degenerate`` — a compiled-stream statement whose
      roofline wall is zero: nothing was priced at all, which means the
      composed walk and the routing drifted apart.
    """
    findings = []
    for r in reports:
        for s in r.scans:
            if s.compiled and not s.priced:
                findings.append(Finding(
                    r.file, r.query, "cost-model-gap", "error",
                    f"streamed scan {s.table!r} priced at the unknown-"
                    "table default width: the static cost model cannot "
                    "see its columns, so the statement's byte "
                    "predictions are unfounded"))
        if r.classification == CLASS_COMPILED and r.roofline_ms <= 0:
            findings.append(Finding(
                r.file, r.query, "roofline-degenerate", "error",
                "compiled-stream statement with a zero roofline wall: "
                "the cost model priced no data movement (model drift "
                "against the exec/mem decomposition)"))
    return findings


def perf_audit_findings(template_dir: str | None = None) -> list:
    """The lint pass entry point (``nds_tpu_torch.tools.lint``)."""
    return reports_to_findings(audit_perf_corpus(template_dir))


def bottleneck_counts(reports) -> dict:
    """``tag -> statement count`` histogram of the static bottleneck
    tags (the pinned corpus cost story)."""
    counts: dict = {}
    for r in reports:
        counts[r.bound] = counts.get(r.bound, 0) + 1
    return counts


def corpus_walls(template_dir: str | None = None) -> dict:
    """``query -> (roofline_ms, bound)`` for the whole corpus."""
    return {r.query: (r.roofline_ms, r.bound)
            for r in audit_perf_corpus(template_dir)}


def statement_walls(names, template_dir: str | None = None) -> dict:
    """``query -> (roofline_ms, bound)`` of the corpus statements among
    ``names`` (``queryN`` or ``queryN_partK``; other names are skipped),
    pricing only their templates: the static denominator
    ``nds_tpu_torch.tools.trace_report`` renders beside the measured
    roofline columns."""
    template_dir = template_dir or TEMPLATE_DIR
    known = set(list_templates(template_dir))
    wanted = set(names)
    templates = sorted({f"{n.split('_part')[0]}.tpl" for n in wanted}
                       & known)
    auditor = PerfAuditor()
    out = {}
    for name in templates:
        for r in audit_perf_template_text(load_template(name, template_dir),
                                          name, auditor):
            if r.query in wanted:
                out[r.query] = (r.roofline_ms, r.bound)
    return out


def _mb(n: int) -> str:
    return f"{n / 1e6:,.1f}"


def format_perf_report(reports) -> str:
    """The per-template cost table (``--perf-report``):
    predicted byte totals, the roofline wall and the bottleneck tag —
    what a measured campaign number is compared against."""
    rates = roofline_gbs()
    lines = ["# perf-audit: per-statement static cost model",
             "# rates GB/s: "
             + ", ".join(f"{k}={rates[k]:g}" for k in ("h2d", "hbm",
                                                       "ici")),
             f"{'template':<18} {'class':<16} {'h2d-MB':>10} "
             f"{'hbm-MB':>10} {'ici-MB':>9} {'roof-ms':>9}  bound"]
    for r in reports:
        lines.append(
            f"{r.query:<18} {r.classification:<16} "
            f"{_mb(r.bytes_h2d):>10} {_mb(r.bytes_hbm):>10} "
            f"{_mb(r.bytes_ici):>9} {r.roofline_ms:>9.2f}  {r.bound}")
    counts = bottleneck_counts(reports)
    summary = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
    lines.append(f"# {len(reports)} statements — {summary}")
    return "\n".join(lines)
