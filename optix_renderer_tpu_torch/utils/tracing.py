"""Spans and counters of the port, kept in memory for the benchmark's readers.

A span is a timed region of one request: `with tracing.span(name, **attrs)`.
Its record holds the request's id (shared by every span of one `render()`
call), its own id, its parent's id (0 for none), its name, its start and end
on `time.perf_counter_ns()` and its attributes. Records go into one buffer
of `CAP` entries; a span past the cap is counted in `dropped` instead.
Each thread has its own stack of open spans.

The switch: tracing is on after `enable()`, or while `torch.profiler`
records. The outermost span of a thread (the root, `render`) reads it when
it opens, and every span of that request follows. Off costs one flag test
and a shared no-op context manager per span: no clock read, no record. While
the profiler records, each span also opens `torch.profiler.record_function`
under its name, so it sits in the profiler's chrome trace, on the profiler's
clock, beside the device's kernels and copies (`cli render --trace-out`).

`setup_span` is recorded whatever the switch says, with its subtree: it
marks work done once per scene or process (`scene.load`, `kernels.load`).

Counters: `count(name, n)` adds to a host integer, always (`launch.<kernel>`:
one where the kernel launches, nowhere else). `count_device(name, mask)`
adds a bool tensor's true entries (or an int32 tensor's counts), only while
the request is traced: one elementwise add into an int32 buffer of the
mask's shape, on the mask's device and with no wait. `fold_device()`, called
once the film readout has waited for the device, sums those buffers into the
host counters; until then `counter()` does not see them. `count_lanes(active)`
counts a scan-path bounce's lanes (`scan.lanes`) and live lanes
(`scan.lanes_live`) so.

A CUDA graph's capture (`with capturing(cap)`) runs no kernel, so what it
counts is kept in its `Capture` and counted again by `replayed(cap)` at each
replay: the host counts made while capturing (the kernels' launches), and
the live lanes, which the captured body casts into int32 buffers of the
graph's own, one per bounce, at every replay, traced or not.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

CAP = 1 << 18  # records kept in memory; later spans only add to `dropped`

dropped = 0  # spans not kept because the buffer was full

_enabled = False
_records: list = []
_counts: dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count(1)  # request and span ids; 0 means none


class Record(NamedTuple):
    request: int
    id: int
    parent: int  # 0: no parent
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


class _Thread(threading.local):
    def __init__(self):
        self.stack = []  # ids of this thread's open, recorded spans
        self.request = 0  # the open request's id, 0 when none is open
        self.on = False  # whether the open request is recorded
        self.device = {}  # (counter name, device, mask shape) -> _DeviceCount
        self.capture = None  # the Capture of the graph this thread captures, if any


_t = _Thread()


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


class _Noop:
    """The span of a request that is not traced."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "attrs", "always", "saved", "request", "id", "parent", "rf",
                 "start")

    def __init__(self, name: str, attrs: dict, always: bool):
        self.name, self.attrs, self.always = name, attrs, always

    def set(self, **attrs) -> None:
        """Add attributes known only after the span opened."""
        self.attrs.update(attrs)

    def __enter__(self):
        t = _t
        self.saved = (t.request, t.on)
        if not t.request:  # the root: a new request, which reads the switch
            t.request, t.on = next(_ids), _enabled or _profiling()
        self.id = 0
        if not (t.on or self.always):
            return self
        t.on = True  # a set-up span records its subtree
        self.request, self.id = t.request, next(_ids)
        self.parent = t.stack[-1] if t.stack else 0
        t.stack.append(self.id)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = _t
        if self.id:
            end = time.perf_counter_ns()
            if self.rf is not None:
                self.rf.__exit__(*exc)
            t.stack.pop()
            _store(Record(self.request, self.id, self.parent, self.name, self.start, end,
                          self.attrs))
        t.request, t.on = self.saved
        return False


def _store(rec: Record) -> None:
    global dropped
    with _lock:
        if len(_records) < CAP:
            _records.append(rec)
        else:
            dropped += 1


def span(name: str, **attrs):
    """A span of the current request (or the root of a new one); a context
    manager whose `set(**attrs)` adds attributes."""
    t = _t
    if t.request and not t.on:
        return _NOOP
    return _Span(name, attrs, False)


def setup_span(name: str, **attrs):
    """A span recorded whatever the switch says, with every span inside it:
    for work done once per scene or process."""
    return _Span(name, attrs, True)


def traced(name: str, *, setup: bool = False):
    """A decorator: each call of the function is a span `name` (a
    `setup_span` with `setup=True`)."""
    opener = setup_span if setup else span

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with opener(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def recording() -> bool:
    """Whether this thread's open request is traced."""
    return _t.on


def enable(on: bool = True) -> None:
    """Trace every request from its root on (`enable(False)`: only while
    the profiler records)."""
    global _enabled
    _enabled = bool(on)


def records() -> list:
    """The records kept so far, oldest first (by end), without clearing them."""
    with _lock:
        return list(_records)


def clear() -> None:
    """Forget the records kept and the count of those dropped."""
    global dropped
    with _lock:
        _records.clear()
        dropped = 0


def self_ns(recs) -> dict[int, int]:
    """{span id: its duration minus the part of it its children cover}."""
    kids: dict[int, list] = {}
    for r in recs:
        kids.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = {}
    for r in recs:
        covered, edge = 0, r.start_ns
        for s, e in sorted(kids.get(r.id, ())):
            s, e = max(s, edge), min(e, r.end_ns)
            if e > s:
                covered += e - s
                edge = e
        out[r.id] = r.end_ns - r.start_ns - covered
    return out


def count(name: str, n: int = 1) -> None:
    """Add `n` to the host counter `name` (while this thread captures a
    graph, to its `Capture`, counted at each replay)."""
    cap = _t.capture
    if cap is not None:
        cap.counts[name] = cap.counts.get(name, 0) + n
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    with _lock:
        return _counts.get(name, 0)


def counters(prefix: str = "") -> dict[str, int]:
    """The host counters whose names start with `prefix`."""
    with _lock:
        return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Set the host counters whose names start with `prefix` to 0."""
    with _lock:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


class _DeviceCount:
    """One counter's int32 buffer for masks of one shape on one device: each
    entry counts the calls in which that mask entry was true. `folded` is the
    part of its sum that the host counter holds."""

    __slots__ = ("buf", "folded", "pending")

    def __init__(self, mask: torch.Tensor):
        # the first call's add: one launch, as every later one; a copy even
        # of an int32 tensor, whose owner may write it again
        self.buf = mask.to(torch.int32, copy=True)
        self.folded, self.pending = 0, True


def count_device(name: str, mask: torch.Tensor) -> None:
    """Add the number of true entries of the bool tensor `mask` (or the sum
    of the int32 tensor of counts `mask`) to the counter `name`, if this
    thread's request is traced: one elementwise kernel on the mask's device
    and no wait, read at the next `fold_device()`."""
    t = _t
    if not t.on:
        return
    if mask.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"count_device counts a bool or int32 tensor, got {mask.dtype}")
    key = (name, mask.device, mask.shape)
    dc = t.device.get(key)
    if dc is None:
        t.device[key] = _DeviceCount(mask)
    else:
        dc.buf.add_(mask)
        dc.pending = True


def fold_device() -> None:
    """Move this thread's device counts into the host counters: one sum and
    copy of each buffer added to since the last fold, cheap once the device
    has been synchronized."""
    for (name, *_), dc in _t.device.items():
        if dc.pending:
            value = int(dc.buf.sum())
            count(name, value - dc.folded)
            dc.folded, dc.pending = value, False


def count_lanes(active: torch.Tensor) -> None:
    """Count a scan-path bounce's lanes, `active` [N] bool: N into
    `scan.lanes` and the true entries into `scan.lanes_live` in a traced
    request; while a graph is captured, always into its `Capture`."""
    cap = _t.capture
    if cap is not None:
        cap.lanes.append(active.to(torch.int32))  # the graph's own, written by each replay
        cap.n_lanes += active.shape[0]
    elif _t.on:
        count("scan.lanes", active.shape[0])
        count_device("scan.lanes_live", active)


class Capture:
    """What the body of one CUDA graph counted while it was captured."""

    __slots__ = ("counts", "lanes", "n_lanes")

    def __init__(self):
        self.counts = {}  # host counts (launch.<kernel>: the graph's launches)
        self.lanes = []  # int32 [N] per bounce counted: its live lanes in the last replay
        self.n_lanes = 0  # the lanes those bounces counted, per replay


@contextlib.contextmanager
def capturing(cap: Capture):
    """Within it, this thread's counts go to `cap` (see `Capture`)."""
    saved, _t.capture = _t.capture, cap
    try:
        yield cap
    finally:
        _t.capture = saved


def replayed(cap: Capture) -> None:
    """Count one replay of the graph whose capture is `cap`: its host counts
    always; in a traced request its lanes, each bounce's live lanes by one
    `count_device`, as the eager bounce counts them (enqueued after the
    replay, so that each add reads what the replay wrote)."""
    for name, n in cap.counts.items():
        count(name, n)
    if _t.on and cap.lanes:
        count("scan.lanes", cap.n_lanes)
        for buf in cap.lanes:
            count_device("scan.lanes_live", buf)
