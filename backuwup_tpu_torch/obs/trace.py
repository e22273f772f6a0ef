"""Hierarchical spans with Dapper-style trace/span ids.

Counterpart of ``backuwup_tpu/obs/trace.py`` without its
``jax_profiler`` hook (the port's device profiling is a later slice).

Subsumes :mod:`backuwup_tpu_torch.utils.tracing` (which remains as thin
wrappers over this module): the flat ``{name: (calls, total_s)}``
aggregate table and its ``BKW_TRACE`` gate keep their exact semantics,
while every span now additionally

* carries a **trace id** (64-bit hex) inherited from the enclosing span
  via a contextvar — ``asyncio.create_task`` copies the context, so the
  send tasks a backup spawns share the backup's trace id for free;
* observes its duration into the ``bkw_span_seconds{name}`` histogram
  (always on — the registry is how /metrics sees per-stage times);
* journals a ``span`` line (trace id, span id, parent id, duration)
  when a journal is installed (obs/journal.py).

Cross-process propagation (the Dapper model, PAPERS.md): the current
trace id rides as an *optional, unauthenticated* ``trace_id`` field on
p2p ``EncapsulatedMsg`` envelopes and client<->server JSON posts; the
receiving side re-enters it with :func:`bind`, so one backup's
pack -> seal -> transfer -> ack -> audit chain is joinable across peers
by grepping journals for one id.  Ids are observability metadata only:
they are outside the signed body and MUST never drive control flow.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import random
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

from . import journal as _journal
from . import metrics as _metrics

_SPAN_SECONDS = _metrics.histogram(
    "bkw_span_seconds", "Wall-clock duration of named trace spans",
    labelnames=("name",))

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{1,32}$")


@dataclass(frozen=True)
class SpanContext:
    """What the current task carries: the trace it belongs to and the
    innermost open span (None right after a cross-process bind)."""

    trace_id: str
    span_id: Optional[str] = None


_ctx: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("bkw_trace_ctx", default=None)

# Span/trace ids come from one process-local PRNG (an os.urandom syscall
# per pipeline-segment span would be measurable); the lock keeps draws
# unique under the packer/seal/loop thread mix.
_id_lock = threading.Lock()
_id_rng = random.Random(int.from_bytes(os.urandom(8), "little"))


def _gen_hex(bits: int) -> str:
    with _id_lock:
        return f"{_id_rng.getrandbits(bits):0{bits // 4}x}"


def new_trace_id() -> str:
    return _gen_hex(64)


def new_span_id() -> str:
    return _gen_hex(32)


def clean_trace_id(value) -> Optional[str]:
    """Validate a wire-carried trace id (unauthenticated input): lowercase
    hex up to 32 chars, else None."""
    if not isinstance(value, str) or not _TRACE_ID_RE.match(value):
        return None
    return value


def current() -> Optional[SpanContext]:
    return _ctx.get()


def current_trace_id() -> Optional[str]:
    ctx = _ctx.get()
    return ctx.trace_id if ctx is not None else None


def current_span_id() -> Optional[str]:
    ctx = _ctx.get()
    return ctx.span_id if ctx is not None else None


@contextlib.contextmanager
def bind(trace_id: Optional[str]) -> Iterator[None]:
    """Adopt an incoming trace id (wire propagation); no-op on None, so
    receivers can bind unconditionally."""
    tid = clean_trace_id(trace_id)
    if tid is None:
        yield
        return
    token = _ctx.set(SpanContext(trace_id=tid))
    try:
        yield
    finally:
        _reset(token)


def _reset(token) -> None:
    # A coroutine closed by GC (e.g. an aborted aiohttp handler) runs its
    # finally blocks in whatever context the collector happened to be in;
    # ContextVar.reset then raises "created in a different Context".  The
    # binding dies with the coroutine either way, so swallow it.
    try:
        _ctx.reset(token)
    except ValueError:
        pass


# --- the flat aggregate table (exact utils/tracing.py semantics) ------------

_lock = threading.Lock()
_spans: Dict[str, Tuple[int, float]] = {}
_enabled = os.environ.get("BKW_TRACE", "0") == "1"


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def span(name: str) -> Iterator[SpanContext]:
    """One named span: times the block, propagates the trace id to
    everything started inside it, feeds the ``bkw_span_seconds``
    histogram, journals the close, and (only when ``BKW_TRACE``/
    :func:`enable` is on) accumulates into the flat report table."""
    parent = _ctx.get()
    trace_id = parent.trace_id if parent is not None else new_trace_id()
    ctx = SpanContext(trace_id=trace_id, span_id=new_span_id())
    token = _ctx.set(ctx)
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        dt = time.perf_counter() - t0
        _reset(token)
        if _enabled:
            with _lock:
                calls, total = _spans.get(name, (0, 0.0))
                _spans[name] = (calls + 1, total + dt)
        _SPAN_SECONDS.observe(dt, name=name)
        _journal.emit(
            "span", name=name, trace_id=trace_id, span_id=ctx.span_id,
            parent_id=(parent.span_id if parent is not None else None),
            dur_s=round(dt, 6))


def traced(name: str = None):
    """Decorator form of :func:`span`."""

    def deco(fn):
        label = name or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with span(label):
                return fn(*args, **kw)

        return wrapper

    return deco


def report() -> Dict[str, Tuple[int, float]]:
    with _lock:
        return dict(_spans)


def reset() -> None:
    with _lock:
        _spans.clear()


def format_report() -> str:
    rows = sorted(report().items(), key=lambda kv: -kv[1][1])
    if not rows:
        return "no spans recorded (BKW_TRACE=1 to enable)"
    width = max(len(k) for k, _ in rows)
    out = []
    for name, (calls, total) in rows:
        out.append(f"{name:<{width}}  {calls:>6}x  {total * 1e3:>10.1f} ms")
    return "\n".join(out)
