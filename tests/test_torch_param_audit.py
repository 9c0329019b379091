# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The port's parameterization and execution auditors against the
reference's, on the CPU: the shared bindability rule (type tags, safe
domains, operand values, comparand slots, skeleton keys, the drift
switch) case by case; ``ParamAuditor`` over the 103-statement corpus,
statement by statement (class, literal count, bindable slots, signature,
fold reasons, the whole report), with the corpus counts pinned (63
bindable slots in 7 statements); and ``ExecAuditor``'s classification,
sync bounds and scan verdicts statement by statement (the reference under
``NDS_TPU_PALLAS=interpret``, where it predicts the fused kernels the port
always lowers). Every compared value is exact (bit for bit)."""

import os
from decimal import Decimal

import numpy as np
import pytest

from nds_tpu.analysis import exec_audit as REA
from nds_tpu.analysis import param_audit as RPA
from nds_tpu.sql import parser as RP
from nds_tpu_torch.analysis import exec_audit as PEA
from nds_tpu_torch.analysis import param_audit as PPA
from nds_tpu_torch.queries import (instantiate_template, list_templates,
                                   load_template)
from nds_tpu_torch.sql import parser as PP

_VALUES = (0, 1, -7, 100, 1 << 62, -(1 << 62), (1 << 62) + 1, 2.5, -0.0,
           float("inf"), float("nan"), Decimal("0.01"), Decimal("99999.98"),
           Decimal("-3.125"), Decimal("1E+3"), Decimal("46116860184273879.03"),
           Decimal("46116860184273879.04"), "x", None, True)


@pytest.mark.parametrize("value", _VALUES, ids=repr)
def test_typetag_domain_and_operand_match_reference(value):
    tag = PPA.literal_typetag(value)
    assert tag == RPA.literal_typetag(value)
    if tag is None:
        return
    assert PPA.safe_domain(tag) == RPA.safe_domain(tag)
    assert PPA.domain_contains(tag, value) == \
        RPA.domain_contains(tag, value)
    if PPA.domain_contains(tag, value):
        got = PPA.slot_param_value(value, tag)
        assert got == RPA.slot_param_value(value, tag)
        assert type(got) is type(RPA.slot_param_value(value, tag))


_CONJUNCTS = (
    "ss_quantity > 5",
    "5 <= ss_quantity",
    "ss_quantity between 1 and 20",
    "ss_ext_sales_price between 100.00 and 5000.25",
    "not (ss_quantity = 3)",
    "ss_quantity = 3 or ss_list_price < 2.5e0",
    "ss_quantity + 1 > 5",
    "ss_item_sk in (1, 2, 3)",
    "ss_quantity not between 1 and 20",
    "ss_sold_date_sk between 2451545 and 2451575 and ss_quantity <> -4",
    "ss_quantity > (select 5)",
    "ss_hdemo_sk = 5 and ss_sales_price between 0.01 and 99999.99",
    "ss_quantity > 4611686018427387905",
)


def _conjunct(parse, text):
    return parse(f"select 1 from store_sales where {text}").body.where


@pytest.mark.parametrize("drift", (False, True))
@pytest.mark.parametrize("text", _CONJUNCTS)
def test_bind_slots_and_skeleton_key_match_reference(text, drift):
    rc, pc = _conjunct(RP.parse, text), _conjunct(PP.parse, text)
    for owned in (True, False):
        for sub in (False, True):
            rs = RPA.conjunct_bind_slots(rc, owned, sub, drift=drift)
            ps = PPA.conjunct_bind_slots(pc, owned, sub, drift=drift)
            assert [(p, n.value, t) for p, n, t in ps] == \
                [(p, n.value, t) for p, n, t in rs]
    rs = RPA.conjunct_bind_slots(rc, True, False, drift=drift)
    ps = PPA.conjunct_bind_slots(pc, True, False, drift=drift)
    assert PPA.skeleton_conjunct_key(pc, ps) == \
        RPA.skeleton_conjunct_key(rc, rs)
    # the swap is temporary: the values are back and the key is the value's
    assert PP.expr_key(pc) == RP.expr_key(rc)


def test_skeleton_key_is_value_free_and_type_pinned():
    def key(text):
        c = _conjunct(PP.parse, text)
        return PPA.skeleton_conjunct_key(
            c, PPA.conjunct_bind_slots(c, True, False))
    assert key("ss_quantity > 5") == key("ss_quantity > 90")
    assert key("ss_price between 1.00 and 2.00") == \
        key("ss_price between 7.50 and 9.25")
    # a decimal's scale and an int vs a decimal are different skeletons
    assert key("ss_price between 1.00 and 2.00") != \
        key("ss_price between 1.0 and 2.00")
    assert key("ss_quantity > 5") != key("ss_quantity > 5.0")
    # IN-list members stay in the key
    assert key("ss_item_sk in (1, 2)") != key("ss_item_sk in (1, 3)")


def test_drift_switch_matches_reference(monkeypatch):
    for v in (None, "0", "1"):
        if v is None:
            monkeypatch.delenv("NDS_TPU_PARAM_DRIFT", raising=False)
        else:
            monkeypatch.setenv("NDS_TPU_PARAM_DRIFT", v)
        assert PPA.drift_active() == RPA.drift_active()


@pytest.fixture(scope="module")
def param_reports():
    return (RPA.audit_param_corpus(), PPA.audit_param_corpus())


@pytest.fixture(scope="module")
def exec_reports():
    old = os.environ.get("NDS_TPU_PALLAS")
    os.environ["NDS_TPU_PALLAS"] = "interpret"
    try:
        ref = REA.audit_exec_corpus()
    finally:
        if old is None:
            os.environ.pop("NDS_TPU_PALLAS")
        else:
            os.environ["NDS_TPU_PALLAS"] = old
    return ref, PEA.audit_exec_corpus()


_N_STATEMENTS = 103


@pytest.mark.parametrize("i", range(_N_STATEMENTS))
def test_param_report_matches_reference(param_reports, i):
    ref, port = param_reports
    assert len(ref) == len(port) == _N_STATEMENTS
    r, p = ref[i], port[i]
    assert (p.query, p.classification, p.n_literals, p.n_bindable,
            p.signature(), dict(p.folds)) == \
        (r.query, r.classification, r.n_literals, r.n_bindable,
         r.signature(), dict(r.folds))
    assert p.to_dict() == r.to_dict()


def test_param_corpus_counts_pinned(param_reports):
    ref, port = param_reports
    counts = PPA.bindability_counts(port)
    assert counts == RPA.bindability_counts(ref)
    assert counts[PPA.VERDICT_BINDABLE] == 63
    assert counts["statements-with-bindable"] == 7
    assert {r.query: r.n_bindable for r in port if r.n_bindable} == {
        "query9": 10, "query28": 30, "query37": 2, "query44": 4,
        "query48": 6, "query49": 9, "query82": 2}
    assert PPA.reports_to_findings(port) == []
    assert PPA.format_param_report(port) == RPA.format_param_report(ref)


def test_slot_spans_address_the_literals(param_reports):
    """Every bindable slot's span holds its literal's token, and
    substituting the slots' own values gives the text back."""
    _ref, port = param_reports
    auditor = PPA.ParamAuditor()
    for r in port:
        if not r.n_bindable:
            continue
        name = r.query.split("_part")[0]
        sql = instantiate_template(load_template(f"{name}.tpl"),
                                   np.random.default_rng(PPA._AUDIT_SEED))
        rep = auditor.audit_sql(sql, query=r.query)
        for s in rep.slots:
            a, b = s.span
            assert PPA.format_slot_value(s.value, s.typetag) == sql[a:b]
        assert PPA.substitute_slots(sql, rep.slots,
                                    [s.value for s in rep.slots]) == sql
        # distinct values: equal OR branches would hoist into one conjunct
        # (the planner's factoring), a different skeleton
        vals = [7 + k for k in range(len(rep.slots))]
        other = PPA.substitute_slots(sql, rep.slots, vals)
        assert [s.value for s in auditor.audit_sql(other).slots] == vals


@pytest.mark.parametrize("i", range(_N_STATEMENTS))
def test_exec_report_matches_reference(exec_reports, i):
    ref, port = exec_reports
    assert len(ref) == len(port) == _N_STATEMENTS
    r, p = ref[i], port[i]
    assert (p.query, p.classification, p.reasons, p.sync_bound,
            p.per_chunk, p.first_sight) == \
        (r.query, r.classification, r.reasons, r.sync_bound, r.per_chunk,
         r.first_sight)
    assert p.to_dict() == r.to_dict()


def test_exec_corpus_classes_and_gate(exec_reports):
    ref, port = exec_reports
    classes = {}
    for r in port:
        classes[r.classification] = classes.get(r.classification, 0) + 1
    assert classes == {"compiled-stream": 96, "device-resident": 7}
    assert PEA.reports_to_findings(port) == []
    assert PEA.format_stream_report(port) == REA.format_stream_report(ref)
    assert len(list_templates()) == 99
