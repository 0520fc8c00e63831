"""Per-call constants, built once on the device that uses them.

A tensor that a call builds on the host and copies to the card makes the
host wait: a copy from pageable memory synchronises the stream, so the host
waits out all the work queued before it (offline, the whole backbone) and
then issues the rest onto an empty queue.  The anchors, the box-delta
stds, the mean dimensions, the default content extent, a pipeline's
calibration batch and the RoIAlign kernels' level tables have the same
value on every call, so :func:`constant` builds each once per key and
device and hands out the same tensor on every later call.

A key is the content (a tuple of numbers, :func:`content_key`, or a frozen
config), the shape it depends on, and ``str(device)``.  Nothing else
decides: no flag, no model name.  Two guards:

* a tensor built while a tracer runs (``torch.export``,
  ``torch.compile``: a fake or meta tensor) is handed out but not kept;
* a cached tensor is shared, so no caller may write into it: a lookup
  raises if its ``_version`` moved since it was built.

:func:`counts` reads the builds and the hits of each kind.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

_CACHE: Dict[tuple, Tuple[torch.Tensor, int]] = {}
_BUILDS: Counter = Counter()
_HITS: Counter = Counter()


class Counts(NamedTuple):
    builds: int     # tensors built and kept
    hits: int       # lookups answered by a kept tensor


def content_key(values) -> tuple:
    """``(shape, numbers)`` of a number, a sequence of them or rows of
    them: a key that tells apart any two contents."""
    a = np.asarray(values, dtype=np.float64)
    return a.shape, tuple(a.ravel().tolist())


def constant(kind: str, key, build: Callable[[], torch.Tensor],
             device) -> torch.Tensor:
    """``build()`` (a tensor on the host) moved to ``device``, made once per
    ``(kind, key, str(device))``; later calls get the same tensor."""
    full = (kind, key, str(device))
    kept = _CACHE.get(full)
    if kept is not None:
        t, version = kept
        if t._version != version:
            raise RuntimeError(f"a cached {kind} constant was written in "
                               "place; callers must not modify it")
        _HITS[kind] += 1
        return t
    t = build().to(device)
    if type(t) is torch.Tensor and not t.is_meta:
        _CACHE[full] = (t, t._version)
        _BUILDS[kind] += 1
    return t


def table(kind: str, values, device) -> torch.Tensor:
    """The float32 tensor of ``values`` (a sequence of numbers or rows of
    them) on ``device``, made once per content and device."""
    return constant(kind, content_key(values),
                    lambda: torch.tensor(values, dtype=torch.float32),
                    device)


def counts() -> Dict[str, Counts]:
    """Builds and hits of each kind since the process started."""
    return {k: Counts(_BUILDS[k], _HITS[k]) for k in sorted(
        set(_BUILDS) | set(_HITS))}


def clear() -> None:
    """Drop every kept tensor (the counts stay)."""
    _CACHE.clear()
