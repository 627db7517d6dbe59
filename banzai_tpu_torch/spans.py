"""Host spans and device marks of the block scheduler.

A span times one host step of a ``compress`` call on the thread that runs
it.  It adds its wall time (``time.perf_counter``) to
``EncodeStats.host_ms[name]``, in ms; a span opened with ``cpu=True``
also adds the thread's CPU time (``time.thread_time``) to
``EncodeStats.cpu_ms[name]``, and their difference is the time the thread
spent off the CPU: blocked, or waiting for the interpreter lock.  The CPU
clock is a system call on some hosts, so only the spans whose CPU time a
reading needs ask for it.  While a ``torch.profiler`` records, a span
also opens a profiler range named ``name`` whose inputs are the call's id
and the batch index (-1 outside a batch), so the spans of one call share
an identifier in the trace: its ``Concrete Inputs`` under
``record_shapes=True``.  (``record_function``'s string argument shows as
an empty string there.)  The profiler records the scheduler's threads
only with ``_ExperimentalConfig(profile_all_threads=True)``.  The range is
gated by the process-wide ``torch.autograd.profiler._is_profiler_enabled``:
``torch.autograd._profiler_enabled()`` is per thread and reads False on
the scheduler's threads even then, and an ungated range costs several
microseconds a span with no profiler running.

A mark is a timing ``torch.cuda.Event`` recorded on a batch's compute
stream (``Timeline``); the drain turns a batch's marks into
``EncodeStats.device_ms``.

Each scheduler thread binds its call's ``Recorder`` (``Recorder.bind``),
and the device thread its batch's ``Timeline`` too, so the code under
``block.encode_batch_rows`` reaches them through ``span``, ``read_int``
and ``mark`` with no argument.  A bound thread's spans add to sums of its
own (``Binding``), with no lock; each ``bind``, and the ``flush`` at the
thread's end, add them to the stats.  A thread that is not the call's
own, such as the caller's, holds a ``Binding`` of its own and flushes it
itself.  A recorder without stats (the caller passed none) records
nothing: its spans only open the profiler's ranges, and only while it
records.  On a thread with nothing bound all three do nothing but their
work.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

_CALL_IDS = itertools.count(1)
_LOCAL = threading.local()      # .b: this thread's Binding
_NULL = nullcontext()
_wall = time.perf_counter
_cpu = time.thread_time


class Binding:
    """A thread's binding to a call's recorder: its batch index, its
    timeline, and its span sums not yet in the stats (None for a recorder
    without stats)."""

    __slots__ = ("rec", "batch", "timeline", "host", "cpu")

    def __init__(self, rec: "Recorder"):
        self.rec = rec
        self.batch, self.timeline = -1, None
        recording = rec.stats is not None
        self.host = {} if recording else None
        self.cpu = {} if recording else None

    def flush(self) -> None:
        """Add the span sums to the stats, under the recorder's lock."""
        if not (self.host or self.cpu):
            return
        stats = self.rec.stats
        with self.rec.lock:
            for sums, more in ((stats.host_ms, self.host),
                               (stats.cpu_ms, self.cpu)):
                for name, ms in more.items():
                    sums[name] = sums.get(name, 0.0) + ms
        self.host.clear()
        self.cpu.clear()


class Recorder:
    """Where the spans of one scheduler call go: ``stats.host_ms`` and
    ``stats.cpu_ms`` (nowhere when ``stats`` is None), with a call id of
    its own."""

    def __init__(self, stats):
        self.stats = stats
        self.call = next(_CALL_IDS)
        self.lock = threading.Lock()    # the call's threads share the stats

    def bind(self, batch: int = -1, timeline: "Timeline | None" = None):
        """Send this thread's spans to this call's batch ``batch``, and
        its marks to ``timeline`` (None: no marks), once the spans so far
        are in the stats."""
        b = getattr(_LOCAL, "b", None)
        if b is not None:
            b.flush()
        if b is None or b.rec is not self:
            b = _LOCAL.b = Binding(self)
        b.batch, b.timeline = batch, timeline


def flush() -> None:
    """Add this thread's span sums to the stats (``Binding.flush``)."""
    b = getattr(_LOCAL, "b", None)
    if b is not None:
        b.flush()


class Span:
    """Context manager of one span, whose sums go to the binding ``b``;
    ``ms`` holds its wall time once it has closed.  The CPU interval lies
    inside the wall interval."""

    __slots__ = ("b", "name", "cpu", "handle", "t0", "c0", "ms")

    def __init__(self, b: Binding, name: str, cpu: bool = False):
        self.b, self.name, self.cpu = b, name, cpu

    def __enter__(self) -> "Span":
        self.handle = None
        if _profiler._is_profiler_enabled:
            self.handle = torch.autograd._record_function_with_args_enter(
                self.name, self.b.rec.call, self.b.batch)
        self.t0 = _wall()
        if self.cpu:
            self.c0 = _cpu()
        return self

    def __exit__(self, *exc) -> None:
        c = _cpu() if self.cpu else 0.0
        t = _wall()
        if self.handle is not None:
            torch.autograd._record_function_with_args_exit(self.handle)
        self.ms = ms = 1e3 * (t - self.t0)
        host = self.b.host
        if host is None:
            return
        name = self.name
        host[name] = host.get(name, 0.0) + ms
        if self.cpu:
            cpu = self.b.cpu
            cpu[name] = cpu.get(name, 0.0) + 1e3 * (c - self.c0)


def span(name: str, cpu: bool = False):
    """A span of the call and batch bound to this thread (``cpu``: read
    the thread's CPU clock too); a no-op on a thread with none, and for a
    recorder without stats while no profiler records."""
    b = getattr(_LOCAL, "b", None)
    if b is None or (b.host is None and not _profiler._is_profiler_enabled):
        return _NULL
    return Span(b, name, cpu)


def read_int(t: torch.Tensor) -> int:
    """``int(t)``, timed as a span named ``sync``: the host waits for the
    device there.  With no profiler recording it is a plain call, so a
    read in a loop costs two clock reads where a span costs an object and
    two calls more."""
    b = getattr(_LOCAL, "b", None)
    if b is None or b.host is None or _profiler._is_profiler_enabled:
        with span("sync"):
            return int(t)
    t0 = _wall()
    v = int(t)
    ms = 1e3 * (_wall() - t0)
    host = b.host
    host["sync"] = host.get("sync", 0.0) + ms
    return v


class Timeline:
    """The marks of one batch on its compute stream, in order: (name,
    timing event) pairs.  Events come from ``free``, a list of the
    device's spare events, and go back to it (``recycle``): recording a
    used event skips creating one, and naming the stream skips looking
    up the current one."""

    __slots__ = ("stream", "free", "marks")

    def __init__(self, stream, free: list):
        self.stream, self.free, self.marks = stream, free, []

    def mark(self, name: str | None) -> None:
        try:
            ev = self.free.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.marks.append((name, ev))

    @property
    def start(self):
        return self.marks[0][1]

    @property
    def end(self):
        return self.marks[-1][1]

    def stage_ms(self) -> dict:
        """{name: ms from the mark before} of every named mark but the
        first, once the last event has completed; the time before a mark
        named None goes to no name."""
        return {name: e0.elapsed_time(e1)
                for (_n, e0), (name, e1) in zip(self.marks, self.marks[1:])
                if name is not None}

    def recycle(self, keep_end: bool, prev=None) -> None:
        """Give back the events of the completed batch, and ``prev``, the
        end of the batch before it, if given; with ``keep_end``, all but
        the last, which ends the batch and which the next batch on the
        stream will read."""
        marks = self.marks[:-1] if keep_end else self.marks
        self.free.extend(ev for _n, ev in marks)
        if prev is not None:
            self.free.append(prev)


def mark(name: str | None) -> None:
    """Mark the bound timeline (``Timeline.mark``); nothing on a thread
    with none."""
    b = getattr(_LOCAL, "b", None)
    if b is not None and b.timeline is not None:
        b.timeline.mark(name)
