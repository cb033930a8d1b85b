"""Per-phase timing — twin of haploconduct_tpu/utils/log.py:PhaseTimer.

RunLogger has no jax in it and is the reference's. PhaseTimer differs only
in its trace annotation: with `annotate=True` each span opens a
torch.profiler.record_function, so phases show up as named host spans in
a torch.profiler trace captured around the run (run_stage's profile_dir).
"""

from __future__ import annotations

import time

from haploconduct_tpu.utils import log as _ref
from haploconduct_tpu.utils.log import RunLogger  # noqa: F401


class PhaseTimer(_ref.PhaseTimer):
    """Per-phase wall-clock accumulator; `with timer("verify"): ...`."""

    class _Span(_ref.PhaseTimer._Span):
        def __enter__(self):
            if self.timer.annotate:
                import torch.profiler

                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            self.t0 = time.perf_counter()
            return self
