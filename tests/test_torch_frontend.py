# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""The torch port's own copy of the front end matches the reference, and
the port imports neither JAX nor the reference package."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nds_tpu_torch")


def _statements(gen_streams, gen_sql, strip, tmp):
    gen_streams(tmp, streams=1, rngseed=19620718, scale=0.01)
    queries = gen_sql(os.path.join(tmp, "query_0.sql"))
    return {k: strip(v) for k, v in queries.items()}


@pytest.fixture(scope="module")
def both_streams(tmp_path_factory):
    from nds_tpu.power import gen_sql_from_stream, strip_stream_markers
    from nds_tpu.queries import generate_query_streams
    from nds_tpu_torch import power as tp
    from nds_tpu_torch.queries import generate_query_streams as tgen
    ref = _statements(generate_query_streams, gen_sql_from_stream,
                      strip_stream_markers, str(tmp_path_factory.mktemp("r")))
    port = _statements(tgen, tp.gen_sql_from_stream, tp.strip_stream_markers,
                       str(tmp_path_factory.mktemp("p")))
    return ref, port


def test_stream_has_103_identical_statements(both_streams):
    ref, port = both_streams
    assert len(ref) == 103
    assert ref == port


def test_parser_matches_reference_on_all_statements(both_streams):
    from nds_tpu.sql.parser import expr_key as ref_key
    from nds_tpu.sql.parser import parse as ref_parse
    from nds_tpu_torch.sql.parser import expr_key as port_key
    from nds_tpu_torch.sql.parser import parse as port_parse
    ref, _ = both_streams
    for name, sql in ref.items():
        a, b = ref_parse(sql), port_parse(sql)
        assert type(a).__name__ == type(b).__name__, name
        assert repr(a) == repr(b), name
        if hasattr(a, "body"):
            assert ref_key(a.body) == port_key(b.body), name


def test_templates_are_byte_identical():
    ref_dir = os.path.join(REPO, "nds_tpu", "queries", "templates")
    port_dir = os.path.join(PORT, "queries", "templates")
    names = sorted(os.listdir(ref_dir))
    assert len(names) == 102
    assert names == sorted(os.listdir(port_dir))
    for n in names:
        with open(os.path.join(ref_dir, n), "rb") as f:
            a = f.read()
        with open(os.path.join(port_dir, n), "rb") as f:
            b = f.read()
        assert a == b, n


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_neither_jax_nor_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "nds_tpu"), (path, m)


def test_port_schema_and_types_match_reference():
    from nds_tpu import types as rt
    from nds_tpu.schema import get_schemas as ref_schemas
    from nds_tpu_torch import types as pt
    from nds_tpu_torch.schema import get_schemas as port_schemas
    for dec in (True, False):
        a, b = ref_schemas(use_decimal=dec), port_schemas(use_decimal=dec)
        assert list(a) == list(b)
        for t in a:
            fa = [(f.name, str(f.type)) for f in a[t]]
            fb = [(f.name, str(f.type)) for f in b[t]]
            assert fa == fb, t
            for f in a[t]:
                assert rt.device_kind(str(f.type)) == pt.device_kind(
                    str(f.type))
