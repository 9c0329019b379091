# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Self-validation: the decimal Power Run against the ``--floats`` Power
Run through ``nds_tpu_torch.validate`` (the port of the reference's
``tools/self_validate.py``).

The benchmark's acceptance gate compares a baseline run with an
accelerated one. With no other engine at hand, the same gate runs
against the port's two numeric paths: exact int64 fixed-point decimals
and float64 (the reference's own ``--floats`` escape hatch). A
difference beyond the float epsilon is a bug in one numeric path. Each
statement's verdict is the ``queryValidationStatus`` the validator writes
into the floats run's summary (``Pass`` or ``Fail``).

Run: ``python -m nds_tpu_torch.tools.self_validate [--scale 0.01]
[--templates query3.tpl,...] [--root DIR] [--device cpu]``. Data comes
from ``native/ndsgen`` at the scale, the stream from the port's generator
(seed 7). Exits 1 on a mismatch and keeps the outputs under the root;
removes them on a match. The device defaults to cuda (each Power Run
refuses to run without a GPU unless given ``--device cpu``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_TEMPLATES = ["query3.tpl", "query6.tpl", "query7.tpl", "query42.tpl",
                     "query43.tpl", "query52.tpl", "query55.tpl", "query96.tpl"]


def verdicts(summary_dir: str) -> dict:
    """{statement: its queryValidationStatus} from a summary folder."""
    out = {}
    for path in sorted(glob.glob(os.path.join(summary_dir, "*.json"))):
        with open(path) as f:
            js = json.load(f)
        out[js["query"]] = (js.get("queryValidationStatus") or ["?"])[-1]
    return out


def run(templates, scale, root, device="cuda", log=print):
    """Both Power Runs and the validation under ``root`` (made anew);
    returns (validator exit code, {statement: verdict})."""
    from nds_tpu_torch.queries import generate_query_streams
    from nds_tpu_torch.throughput import child_env
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    env = child_env()
    data = os.path.join(root, "raw")
    os.makedirs(data)
    subprocess.run([os.path.join(REPO, "native", "ndsgen", "ndsgen"),
                    "-scale", scale, "-dir", data], check=True,
                   capture_output=True)
    stream_dir = os.path.join(root, "streams")
    generate_query_streams(stream_dir, streams=1, rngseed=7,
                           templates=templates, scale=float(scale))
    stream = os.path.join(stream_dir, "query_0.sql")
    for name, extra in (("decimal", []), ("floats", ["--floats"])):
        log(f"== power run ({name})")
        subprocess.run(
            [sys.executable, "-m", "nds_tpu_torch.power", data, stream,
             os.path.join(root, f"time_{name}.csv"), "--input_format",
             "csv", "--output_prefix", os.path.join(root, f"out_{name}"),
             "--json_summary_folder", os.path.join(root, f"js_{name}"),
             "--device", device] + extra,
            check=True, env=env)
    log("== validate")
    r = subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.validate",
         os.path.join(root, "out_decimal"), os.path.join(root, "out_floats"),
         stream, "--ignore_ordering", "--floats", "--epsilon", "0.0001",
         "--json_summary_folder", os.path.join(root, "js_floats")],
        env=env, capture_output=True, text=True)
    log(r.stdout.rstrip())
    return r.returncode, verdicts(os.path.join(root, "js_floats"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the decimal Power Run against the floats one, "
        "through the validator")
    ap.add_argument("--scale", default="0.01")
    ap.add_argument("--templates",
                    help="comma list of template names (default: 8 "
                    "aggregation-heavy)")
    ap.add_argument("--root", help="work directory (default: "
                    "<tmp>/nds_self_validate)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    templates = (args.templates.split(",") if args.templates
                 else DEFAULT_TEMPLATES)
    root = os.path.abspath(args.root or os.path.join(tempfile.gettempdir(),
                                                     "nds_self_validate"))
    rc, per = run(templates, args.scale, root, args.device,
                  log=lambda line: print(line, flush=True))
    print(json.dumps({"verdicts": per}))
    if rc == 0:
        print("SELF VALIDATION: OK")
        shutil.rmtree(root)
        return 0
    print("SELF VALIDATION: MISMATCH (outputs kept at", root, ")")
    return 1


if __name__ == "__main__":
    sys.exit(main())
