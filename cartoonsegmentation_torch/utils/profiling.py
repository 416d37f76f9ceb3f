"""Per-stage wall-clock timing and a profiler trace (port of
``cartoonsegmentation_tpu/utils/profiling.py``: ``StageTimer`` and
``trace``).

CUDA work is asynchronous, so a stage that ran kernels calls
``torch.cuda.synchronize()`` before its timer closes; otherwise the
device time of one stage is billed to whichever later stage first
waits on the card. Pass the pipeline's device to ``time``.

``trace(log_dir)`` records a ``torch.profiler`` trace (CPU ops, and the
card's kernels when CUDA is present) of its block into
``log_dir/trace.json`` (Chrome trace format; chrome://tracing or
Perfetto open it). A trace taken with CUDA that holds no kernel event
raises after the file is written: the profiler's device tracing can
come back empty, and an empty trace must not pass for a profile.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def reset(self) -> None:
        self.seconds.clear()
        self.counts.clear()

    def add(self, stage: str, seconds: float) -> None:
        """Accumulate seconds measured elsewhere (e.g. in a worker
        thread)."""
        self.seconds[stage] = self.seconds.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1

    @contextlib.contextmanager
    def time(self, stage: str,
             device: Optional[torch.device] = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and device.type == 'cuda':
                torch.cuda.synchronize(device)
            self.add(stage, time.perf_counter() - t0)

    def report(self) -> str:
        if not self.seconds:
            return '(no stages timed)'
        total = sum(self.seconds.values())
        width = max(len(s) for s in self.seconds)
        lines = [f'{"stage".ljust(width)}    seconds   calls   share']
        for stage, sec in self.seconds.items():
            n = self.counts[stage]
            share = 100.0 * sec / total if total else 0.0
            lines.append(f'{stage.ljust(width)}  {sec:9.3f}  {n:6d}  '
                         f'{share:5.1f}%')
        lines.append(f'{"TOTAL".ljust(width)}  {total:9.3f}')
        return '\n'.join(lines)


class TraceSummary:
    """What ``trace`` recorded: the file, its CUDA kernel events and its
    other events; filled in when the block ends."""

    def __init__(self, path: str, cuda: bool):
        self.path, self.cuda = path, cuda
        self.kernel_events = 0
        self.other_events = 0

    def __str__(self) -> str:
        kind = f'{self.kernel_events} CUDA kernel events' if self.cuda \
            else 'CPU only (no CUDA device traced)'
        return (f'trace {self.path}: {kind}, {self.other_events} other '
                f'events')


def trace_events(path: str) -> tuple:
    """(CUDA kernel events, other events) of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f).get('traceEvents', [])
    kernels = sum(1 for e in events if e.get('cat') == 'kernel')
    return kernels, len(events) - kernels


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None
          ) -> Iterator[Optional[TraceSummary]]:
    """torch.profiler trace of the block into ``log_dir/trace.json``
    (nothing when ``log_dir`` is empty); yields a ``TraceSummary``,
    printed and filled in at the end. CUDA is traced when the block's
    ``device`` is a CUDA one (by default: when CUDA is present). Raises
    RuntimeError when CUDA was traced and no kernel event came back."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available() if device is None \
        else torch.device(device).type == 'cuda'
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    summary = TraceSummary(os.path.join(log_dir, 'trace.json'), cuda)
    with profile(activities=acts) as prof:
        yield summary
        if cuda and torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(summary.path)
    summary.kernel_events, summary.other_events = trace_events(summary.path)
    print(summary, flush=True)
    if cuda and summary.kernel_events == 0:
        raise RuntimeError(f'{summary.path}: the profiler recorded no CUDA '
                           f'kernel event (an empty device trace)')
