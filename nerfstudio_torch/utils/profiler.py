"""Profiling (counterpart of ``nerfstudio_tpu/utils/profiler.py``; reference
nerfstudio/utils/profiler.py).

Two levels, as the reference's:
  * "basic": ``@time_function`` records running-average wall times once
    ``enable_profiler()`` has been called, printed at exit by
    ``flush_profiler`` (reference :60-130);
  * ``PytorchProfiler``: a ``torch.profiler`` trace around chosen steps,
    written as a chrome trace (reference :133-178).

Nothing in the package turns either on, as in the JAX package: the
trainer's ``train_iteration`` carries ``@time_function`` and costs one
flag test per step while the profiler is off."""

from __future__ import annotations

import atexit
import functools
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

_PROFILER_ENABLED = False
_STATS: Dict[str, list] = defaultdict(lambda: [0.0, 0])


def enable_profiler() -> None:
    global _PROFILER_ENABLED
    _PROFILER_ENABLED = True


def time_function(fn):
    """Decorator recording the running-average host wall time of ``fn``
    (reference :60-96). A CUDA call returns before the card finishes, so
    this times what the host waits for, as the reference's does."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _PROFILER_ENABLED:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        s = _STATS[fn.__qualname__]
        s[0] += dt
        s[1] += 1
        return out

    return wrapped


def flush_profiler() -> None:
    """Print the stats sorted by total time (reference :118-130)."""
    if not _STATS:
        return
    print("\n[profiler] avg times:")
    for name, (total, count) in sorted(_STATS.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {total / max(count, 1) * 1e3:.2f} ms x {count}")


atexit.register(flush_profiler)


class PytorchProfiler:
    """A ``torch.profiler`` trace from the first to the last of
    ``trace_steps`` (reference PytorchProfiler :133-178), written to
    ``output_dir/profiler_traces/trace_<first>-<last>.json``, which
    chrome://tracing and Perfetto read. CUDA activity is traced where a card
    is present."""

    def __init__(self, output_dir: Path, trace_steps=(12, 17)):
        self.output_dir = Path(output_dir) / "profiler_traces"
        self.first, self.last = min(trace_steps), max(trace_steps)
        self._prof = None

    def step_start(self, step: int) -> None:
        import torch

        if step == self.first and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()

    def step_end(self, step: int) -> None:
        if self._prof is not None and step == self.last:
            self._prof.__exit__(None, None, None)
            self.output_dir.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.output_dir / f"trace_{self.first}-{self.last}.json"))
            self._prof = None
