# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Query corpus + stream generation (the dsqgen role).

The reference drives the TPC-DS toolkit's ``dsqgen`` over user-supplied query
templates to emit permuted 99-query streams (ref: nds/nds_gen_query_stream.py:
42-89). This package is the TPU build's native equivalent: the 99 query
templates ship in ``templates/`` as Spark-dialect SQL with parameter
placeholders, and :func:`generate_query_streams` instantiates them into
stream files in the exact dsqgen output format the downstream drivers parse
(``-- start query N in stream S using template queryX.tpl`` markers;
consumed by gen_sql_from_stream, ref: nds/nds_power.py:50-77).

Template parameter syntax (one directive per line, before the SQL):

    --@ NAME = uniform(1998, 2002)        random integer, inclusive
    --@ NAME = pick('a', 'b', 'c')        one literal from the list
    --@ NAME = pool(category)             one value from a named data pool
    --@ NAME = sample(5, state)           5 distinct pool values -> [NAME.1..5]
    --@ NAME = sample(3, 1, 100)          3 distinct ints in range
    --@ NAME = date(1998-01-01, 2002-12-31)  random calendar date
    --@ NAME = expr([OTHER] + 30)         arithmetic on earlier params

Placeholders ``[NAME]`` / ``[NAME.i]`` substitute as raw text; templates
carry their own quotes. The pools mirror the native generator's value
vocabularies (native/ndsgen/ndsgen.cc POOL tables) so instantiated
predicates always hit real data.
"""

from __future__ import annotations

import datetime
import os
import re

import numpy as np

TEMPLATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "templates")

# Queries whose template holds two statements and is split into _part1/_part2
# downstream (ref: nds/nds_gen_query_stream.py:75-89).
SPECIAL_SPLIT = (14, 23, 24, 39)

# value pools aligned with native/ndsgen/ndsgen.cc
POOLS = {
    "category": ["Women", "Men", "Children", "Sports", "Music", "Books",
                 "Home", "Electronics", "Jewelry", "Shoes"],
    "state": ["AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "FL", "GA",
              "HI", "ID", "IL", "IN", "IA", "KS", "KY", "LA", "ME", "MD",
              "MA", "MI", "MN", "MS", "MO", "MT", "NE", "NV", "NH", "NJ",
              "NM", "NY", "NC", "ND", "OH", "OK", "OR", "PA", "RI", "SC",
              "SD", "TN", "TX", "UT", "VT", "VA", "WA", "WV", "WI", "WY"],
    "county": ["Williamson County", "Walker County", "Ziebach County",
               "Daviess County", "Barrow County", "Franklin Parish",
               "Luce County", "Richland County", "Furnas County",
               "Maverick County", "Huron County", "Kittitas County",
               "Mobile County", "Fairfield County", "Jackson County",
               "Dauphin County", "San Miguel County", "Pennington County",
               "Bronx County", "Orange County", "Perry County",
               "Halifax County", "Dona Ana County", "Gogebic County",
               "Lea County", "Mesa County", "Wadena County",
               "Pipestone County"],
    "city": ["Midway", "Fairview", "Oak Grove", "Five Points", "Oakland",
             "Riverside", "Salem", "Georgetown", "Franklin", "New Hope",
             "Bunker Hill", "Hopewell", "Antioch", "Concord", "Clifton",
             "Marion", "Springfield", "Greenville", "Bridgeport", "Oakdale",
             "Glendale", "Lakeview", "Centerville", "Mount Olive", "Union",
             "Glenwood", "Pleasant Hill", "Liberty", "Sulphur Springs",
             "Pine Grove", "Waterloo", "Edgewood", "Friendship", "Greenwood",
             "Deerfield", "Shiloh", "Mountain View", "Lakewood", "Summit",
             "Plainview", "Pleasant Valley", "Woodville", "White Oak",
             "Oakwood", "Harmony", "Highland Park", "Kingston", "Red Hill",
             "Enterprise", "Arlington", "Lebanon", "Clinton", "Spring Hill",
             "Buena Vista", "Newport", "Florence", "Jamestown", "Ashland",
             "Wildwood", "Macedonia"],
    "education": ["Primary", "Secondary", "College", "2 yr Degree",
                  "4 yr Degree", "Advanced Degree", "Unknown"],
    "marital": ["M", "S", "D", "W", "U"],
    "gender": ["M", "F"],
    "credit": ["Low Risk", "Good", "High Risk", "Unknown"],
    "buy_potential": [">10000", "5001-10000", "1001-5000", "501-1000",
                      "0-500", "Unknown"],
    "color": ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
              "black", "blanched", "blue", "blush", "brown", "burlywood",
              "burnished", "chartreuse", "chiffon", "chocolate", "coral",
              "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
              "dim", "dodger", "drab", "firebrick", "floral", "forest",
              "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
              "honeydew", "hot", "indian", "ivory", "khaki", "lace",
              "lavender", "lawn", "lemon", "light", "lime", "linen",
              "magenta", "maroon", "medium", "metallic", "midnight", "mint",
              "misty", "moccasin", "navajo", "navy", "olive", "orange",
              "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
              "powder", "puff", "purple", "red", "rose", "rosy", "royal",
              "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
              "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
              "tomato", "turquoise", "violet", "wheat", "white", "yellow"],
    "units": ["Each", "Dozen", "Case", "Pallet", "Gross", "Box", "Bundle",
              "Tsp", "Oz", "Lb", "Ton", "Dram", "Cup", "Gram", "Pound",
              "Ounce", "Unknown", "Carton", "Bunch", "N/A"],
    "size": ["small", "medium", "large", "extra large", "economy", "N/A",
             "petite"],
    "ship_mode_type": ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR",
                       "TWO DAY"],
}

def active_states(scale: float | None) -> int:
    """Scale-banded state-vocabulary size, kept in sync with the native
    generator (native/ndsgen/ndsgen.cc states_active) so state predicates
    sample values the data actually contains — the role the toolkit's
    scale-banded fips_county distribution plays for dsdgen+dsqgen."""
    if scale is None:
        return len(POOLS["state"])
    sf = float(scale)
    if sf < 1.0:
        return 8
    if sf < 100.0:
        return 16
    if sf < 1000.0:
        return 32
    return 50


_DEFINE_RE = re.compile(r"^--@\s*(\w+)\s*=\s*(.+?)\s*$", re.MULTILINE)
_CALL_RE = re.compile(r"^(\w+)\((.*)\)$", re.DOTALL)
_PLACEHOLDER_RE = re.compile(r"\[(\w+)(?:\.(\d+))\]|\[(\w+)\]")


def _parse_args(argstr: str):
    """Split a define call's arguments, honouring quoted strings."""
    args, cur, depth, quote = [], "", 0, None
    for ch in argstr:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == "(":
            depth += 1
            cur += ch
        elif ch == ")":
            depth -= 1
            cur += ch
        elif ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        args.append(cur.strip())
    return args


def _literal(tok: str):
    if tok and tok[0] in "'\"":
        return tok[1:-1]
    return int(tok)


def _eval_define(expr: str, rng: np.random.Generator, env: dict,
                 pools: dict | None = None):
    pools = POOLS if pools is None else pools
    m = _CALL_RE.match(expr.strip())
    if not m:
        raise ValueError(f"bad template define: {expr}")
    fn, argstr = m.group(1), m.group(2)
    args = _parse_args(argstr)
    if fn == "uniform":
        lo, hi = int(args[0]), int(args[1])
        return int(rng.integers(lo, hi + 1))
    if fn == "pick":
        vals = [_literal(a) for a in args]
        return vals[int(rng.integers(0, len(vals)))]
    if fn == "pool":
        pool = pools[args[0]]
        return pool[int(rng.integers(0, len(pool)))]
    if fn == "sample":
        k = int(args[0])
        if len(args) == 2:          # sample(k, poolname)
            pool = pools[args[1]]
            idx = rng.choice(len(pool), size=min(k, len(pool)), replace=False)
            return [pool[int(i)] for i in idx]
        lo, hi = int(args[1]), int(args[2])   # sample(k, lo, hi)
        vals = rng.choice(np.arange(lo, hi + 1), size=k, replace=False)
        return [int(v) for v in vals]
    if fn == "date":
        lo = datetime.date.fromisoformat(args[0])
        hi = datetime.date.fromisoformat(args[1])
        span = (hi - lo).days
        return str(lo + datetime.timedelta(days=int(rng.integers(0, span + 1))))
    if fn == "expr":
        text = argstr
        for name, val in env.items():
            text = text.replace(f"[{name}]", str(val))
        return eval(text, {"__builtins__": {}}, {})  # arithmetic only
    raise ValueError(f"unknown template function: {fn}")


def instantiate_template(text: str, rng: np.random.Generator,
                         scale: float | None = None) -> str:
    """Resolve the --@ defines and substitute placeholders; returns bare SQL
    (no defines, no stream markers). ``scale`` bands the state pool to the
    vocabulary the generator emits at that scale factor."""
    pools = dict(POOLS)
    k = active_states(scale)
    for geo in ("state", "city", "county"):   # banded with the generator
        pools[geo] = POOLS[geo][:min(k, len(POOLS[geo]))]
    env: dict = {}
    for m in _DEFINE_RE.finditer(text):
        env[m.group(1)] = _eval_define(m.group(2), rng, env, pools)
    sql = _DEFINE_RE.sub("", text)

    def repl(m: re.Match) -> str:
        if m.group(1) is not None:       # [NAME.i]
            return str(env[m.group(1)][int(m.group(2)) - 1])
        return str(env[m.group(3)])

    out = _PLACEHOLDER_RE.sub(repl, sql)
    return out.strip("\n")


def list_templates(template_dir: str | None = None) -> list:
    """templates.lst order (ref: the toolkit's templates.lst consumed at
    nds/nds_gen_query_stream.py:64)."""
    lst = os.path.join(template_dir or TEMPLATE_DIR, "templates.lst")
    with open(lst) as f:
        return [ln.strip() for ln in f if ln.strip()]


def load_template(name: str, template_dir: str | None = None) -> str:
    with open(os.path.join(template_dir or TEMPLATE_DIR, name)) as f:
        return f.read()


def _stream_text(order, stream_id: int, rng: np.random.Generator,
                 template_dir: str | None = None,
                 scale: float | None = None) -> str:
    parts = []
    for pos, tpl_name in enumerate(order):
        sql = instantiate_template(load_template(tpl_name, template_dir), rng,
                                   scale)
        head = (f"-- start query {pos + 1} in stream {stream_id} "
                f"using template {tpl_name}")
        tail = (f"-- end query {pos + 1} in stream {stream_id} "
                f"using template {tpl_name}")
        if not sql.rstrip().endswith(";"):
            sql = sql.rstrip() + "\n;"
        parts.append(f"{head}\n{sql}\n{tail}\n\n")
    return "".join(parts)


def generate_query_streams(output_dir: str, streams: int | None = None,
                           template: str | None = None,
                           rngseed: int | None = None,
                           templates: list | None = None,
                           template_dir: str | None = None,
                           scale: float | None = None) -> list:
    """Write ``query_<i>.sql`` stream files (or a single named query file).

    Mirrors dsqgen semantics: ``streams`` permuted full streams, or one
    ``template`` instantiated as stream 0 (ref: nds/nds_gen_query_stream.py:
    42-89 incl. the _part1/_part2 rename for the 4 split queries).
    """
    os.makedirs(output_dir, exist_ok=True)
    seed = 19620718 if rngseed is None else int(rngseed)
    all_templates = templates if templates is not None else \
        list_templates(template_dir)
    written = []

    if template is not None:
        rng = np.random.default_rng(seed)
        text = _stream_text([template], 0, rng, template_dir, scale)
        qname = template[:-4]  # strip .tpl
        if any(str(q) in template for q in SPECIAL_SPLIT):
            part1, part2 = split_special_query(text)
            for suffix, body in (("_part1", part1), ("_part2", part2)):
                path = os.path.join(output_dir, f"{qname}{suffix}.sql")
                with open(path, "w") as f:
                    f.write(body)
                written.append(path)
        else:
            path = os.path.join(output_dir, f"{qname}.sql")
            with open(path, "w") as f:
                f.write(text)
            written.append(path)
        return written

    for s in range(int(streams)):
        rng = np.random.default_rng((seed, s))
        order = list(all_templates)
        # stream 0 runs the canonical template order; others are permutations
        if s > 0:
            order = [order[i] for i in rng.permutation(len(order))]
        path = os.path.join(output_dir, f"query_{s}.sql")
        with open(path, "w") as f:
            f.write(_stream_text(order, s, rng, template_dir, scale))
        written.append(path)
    return written


def split_special_query(q: str):
    """Split a two-statement query text into its _part1/_part2 texts
    (same contract as ref: nds/nds_gen_query_stream.py:91-103)."""
    split_q = q.split(";")
    part_1 = split_q[0].replace(".tpl", "_part1.tpl") + ";"
    head = split_q[0].split("\n")[0]
    part_2 = head.replace(".tpl", "_part2.tpl") + "\n" + split_q[1] + ";"
    return part_1, part_2


def supported_queries() -> list:
    """Template names the current planner is known to execute (the coverage
    ratchet; grows as SQL features land)."""
    lst = os.path.join(TEMPLATE_DIR, "supported.lst")
    if not os.path.exists(lst):
        return []
    with open(lst) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


SUPPORTED_QUERIES = supported_queries()
