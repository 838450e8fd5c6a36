"""Causal trace contexts: the part of ``parallel_heat_tpu/utils/tracing.py``
that :class:`utils.telemetry.Telemetry` stamps on every event envelope.

A :class:`TraceContext` (``trace_id`` / ``span_id`` / ``parent_span_id``)
names one node of a causal chain; a sink built without one inherits the
context a parent process left in the environment
(:meth:`TraceContext.from_env`). The span model and the Chrome-trace
renderer of the JAX module are not ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

# Environment inheritance (daemon -> worker subprocess). The variables
# carry the PARENT context: the spawned process derives its own child
# span under it (TraceContext.from_env(...).child(...)).
ENV_TRACE_ID = "HEATTRACE_TRACE_ID"
ENV_SPAN_ID = "HEATTRACE_SPAN_ID"
ENV_PARENT_SPAN_ID = "HEATTRACE_PARENT_SPAN_ID"

_trace_seq = itertools.count()


def new_trace_id(clock=time.time) -> str:
    """Collision-free without randomness: wall milliseconds, the pid and
    an in-process counter, so ids are replayable in tests."""
    return (f"t{int(clock() * 1000):013d}-{os.getpid()}"
            f"-{next(_trace_seq)}")


@dataclass(frozen=True)
class TraceContext:
    """One node of the causal chain: ``span_id`` is THIS span,
    ``parent_span_id`` links upward, ``trace_id`` names the whole
    tree. Immutable; :meth:`child` derives the next hop."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None

    def child(self, span_id: str) -> "TraceContext":
        return TraceContext(self.trace_id, span_id, self.span_id)

    # -- dict round trip (JobSpec.trace, telemetry envelope) -------------

    def to_dict(self) -> dict:
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_span_id is not None:
            d["parent_span_id"] = self.parent_span_id
        return d

    @classmethod
    def from_dict(cls, d) -> Optional["TraceContext"]:
        """None on anything that is not a well-formed context — specs
        and envelopes from older writers simply have no trace."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not (isinstance(tid, str) and isinstance(sid, str)):
            return None
        par = d.get("parent_span_id")
        return cls(tid, sid, par if isinstance(par, str) else None)

    # -- env round trip (daemon -> worker subprocess) --------------------

    def to_env(self) -> Dict[str, str]:
        env = {ENV_TRACE_ID: self.trace_id, ENV_SPAN_ID: self.span_id}
        if self.parent_span_id is not None:
            env[ENV_PARENT_SPAN_ID] = self.parent_span_id
        return env

    @classmethod
    def from_env(cls, environ=None) -> Optional["TraceContext"]:
        environ = os.environ if environ is None else environ
        tid = environ.get(ENV_TRACE_ID)
        sid = environ.get(ENV_SPAN_ID)
        if not tid or not sid:
            return None
        return cls(tid, sid, environ.get(ENV_PARENT_SPAN_ID) or None)
