# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Command-line tools over the port's evidence (``bench_compare``)."""
