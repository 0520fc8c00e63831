"""Stage spans of the port, on the profiler's clock and the program's own.

:func:`span` names a stage where its work happens.  It has three
behaviours:

* off (no ``torch.profiler`` run, no :func:`recording` open): one check
  of two flags, and nothing else;
* under ``torch.profiler``: a ``record_function`` range, on the clock of
  the card's kernels, so a trace places the stage beside them;
* under :func:`recording`: a :class:`Span` appended to the recorder's
  list on ``time.perf_counter_ns()``, with the enclosing span and the
  call number.

A span adds no kernel and no host-device synchronisation.  The only
switches are a caller opening :func:`recording` or ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_recorder: Optional["Recorder"] = None


def _profiling() -> bool:
    """Whether a ``torch.profiler`` run is on: the autograd profiler's
    Python flag (~0.05 us), read instead of entering ``record_function``
    (~17 us with the profiler off)."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """One closed span of a :class:`Recorder` (times in ns)."""

    name: str
    parent: Optional[str]   # the enclosing span of the same thread
    call: int               # the recorder's call at the span's start
    t0_ns: int
    t1_ns: int


class Recorder:
    """The spans closed while it was open, kept in memory.  A span opened
    with ``new_call=True`` starts the next call (1, 2, ...); spans before
    the first belong to call 0."""

    def __init__(self, clock: Callable[[], int] = time.perf_counter_ns):
        self.clock = clock
        self.spans: List[Span] = []
        self.calls = 0
        self._local = threading.local()

    def _stack(self) -> List[str]:
        """The open spans of the calling thread, outermost first."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def per_call(self, call: Optional[int] = None
                 ) -> Dict[str, Dict[str, float]]:
        """Per span name: ``count``, ``host_ms`` (the spans' durations)
        and ``self_ms`` (less their child spans' durations), of ``call``
        alone, or else the mean per call over calls 1 to ``calls``."""
        spans = [s for s in self.spans
                 if (s.call == call if call is not None else s.call > 0)]
        n = 1 if call is not None else max(self.calls, 1)
        count: Dict[str, int] = defaultdict(int)
        host: Dict[str, int] = defaultdict(int)
        child: Dict[str, int] = defaultdict(int)
        for s in spans:
            count[s.name] += 1
            host[s.name] += s.t1_ns - s.t0_ns
            if s.parent is not None:
                child[s.parent] += s.t1_ns - s.t0_ns
        return {k: {"count": count[k] / n, "host_ms": host[k] / 1e6 / n,
                    "self_ms": (host[k] - child[k]) / 1e6 / n}
                for k in count}


class _Span:
    __slots__ = ("name", "new_call", "rec", "range", "call", "t0")

    def __init__(self, name: str, new_call: bool, rec: Optional[Recorder]):
        self.name, self.new_call, self.rec = name, new_call, rec
        self.range = None

    def __enter__(self):
        if _profiling():
            self.range = record_function(self.name)
            self.range.__enter__()
        rec = self.rec
        if rec is not None:
            if self.new_call:
                rec.calls += 1
            self.call = rec.calls
            rec._stack().append(self.name)
            self.t0 = rec.clock()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            t1 = rec.clock()
            st = rec._stack()
            st.pop()
            rec.spans.append(Span(self.name, st[-1] if st else None,
                                  self.call, self.t0, t1))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, new_call: bool = False):
    """A context manager naming the enclosed stage ``name`` (see the
    module's docstring); ``new_call`` starts the recorder's next call."""
    rec = _recorder
    if rec is None and not _profiling():
        return _OFF
    return _Span(name, new_call, rec)


@contextlib.contextmanager
def recording(clock: Callable[[], int] = time.perf_counter_ns
              ) -> Iterator[Recorder]:
    """Record every span closed inside the block into the yielded
    :class:`Recorder`.  One recorder is open at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recorder is already open")
    rec = _recorder = Recorder(clock)
    try:
        yield rec
    finally:
        _recorder = None
