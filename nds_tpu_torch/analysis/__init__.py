# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Host-side rules the streamed path shares with its static models: the
fused-scan eligibility rule and the survivor-bound proof."""
