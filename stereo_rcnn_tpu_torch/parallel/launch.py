"""Start one process per rank, as ``torchrun`` does on one host.

:func:`spawn` starts ``n`` processes with the ``spawn`` start method (a
fresh interpreter each: ``fork`` after torch has started threads can
hang), each with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set for
:func:`~stereo_rcnn_tpu_torch.parallel.mesh.make_mesh`, and waits for
them.  Called from the main thread, it passes a SIGTERM on to every
rank.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import signal
import socket
import sys
import threading
import time
from typing import Callable, List

# Seconds the other ranks get to finish once one has exited non-zero.
GRACE_S = 60.0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn: Callable, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    rc = fn(*args)
    sys.stdout.flush()
    sys.exit(rc or 0)


def spawn(fn: Callable, n: int, *args, timeout: float | None = None
          ) -> List[int]:
    """Run ``fn(*args)`` in ``n`` rank processes; returns their exit codes
    in rank order (``fn``'s return value or ``SystemExit`` code; 1 for an
    exception, whose traceback the rank prints).  ``fn`` and ``args`` must
    pickle.  Once a rank has exited non-zero, the others get
    :data:`GRACE_S` seconds to finish (a rank waiting in a collective for
    a crashed one would wait out the backend's timeout); a rank still
    running then, or after ``timeout`` seconds, is killed (-9)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, fn, args))
             for r in range(n)]

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                os.kill(p.pid, signum)

    # Only the main thread may handle signals.
    main = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, forward) if main else None
    deadline = None if timeout is None else time.monotonic() + timeout
    grace_end = None
    try:
        for p in procs:
            p.start()
        pending = list(procs)
        while pending:
            if grace_end is None and any(p.exitcode not in (None, 0)
                                         for p in procs):
                grace_end = time.monotonic() + GRACE_S
            ends = [t for t in (deadline, grace_end) if t is not None]
            left = None if not ends else max(0.0, min(ends) - time.monotonic())
            if not multiprocessing.connection.wait(
                    [p.sentinel for p in pending], left):
                break
            pending = [p for p in pending if p.exitcode is None]
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.exitcode is None:
                p.kill()
            p.join()
        if main:
            signal.signal(signal.SIGTERM, previous)
    return [p.exitcode for p in procs]
