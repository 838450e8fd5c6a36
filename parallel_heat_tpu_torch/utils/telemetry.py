"""Run telemetry: a JSONL event stream and a liveness heartbeat, the port
of ``parallel_heat_tpu/utils/telemetry.py`` with its event schema
(``SCHEMA_VERSION`` 2: the same envelope, event names and fields), so
that ``tools/metrics_report.py`` reads either package's files.

:class:`Telemetry` appends one JSON object a line (a resumed run continues
the same file). Every event carries the envelope ``schema``, ``event``,
``t_wall`` (unix seconds), ``t_mono`` (monotonic seconds),
``process_index``/``process_count``, ``hostname``, and ``job_id`` and the
trace triple ``trace_id``/``span_id``/``parent_span_id`` where set
(``utils/tracing.py``). The events this package emits:

- ``run_header``: the config, ``solver.explain``'s resolved path, the
  torch version, the platform (``"gpu"`` or ``"cpu"``), the card's name
  (``device_kind``) and the device count; one a sink;
- ``chunk``: a stream chunk's absolute ``step``, ``steps``, ``wall_s``,
  rates (``utils.profiling.StepStats``), ``residual``/``converged`` in
  converge mode, the guard's ``finite``, and the stream's timing fields
  ``gap_s``, ``dispatch_s``, ``drain_wait_s``, ``observe_s``;
- ``diagnostics``: grid-stats samples (``solver.grid_stats``), with
  ``member`` in an ensemble; ``vcycle``: an implicit run's V-cycle sample;
- the ensemble's ``ensemble_window``, ``member_converged``,
  ``ensemble_compaction`` and ``member_end``;
- ``run_end``, emitted by the CLI.

Multi-process runs shard the JSONL and the heartbeat per process
(:func:`shard_path`, ``.pN`` suffix). Telemetry observes and never takes
part: no config field changes, and a run with a sink is bitwise the run
without. A sink that hits an I/O error warns once and goes quiet.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
import warnings
from typing import Optional

from parallel_heat_tpu_torch.utils.tracing import TraceContext

# Schema 2 (heattrace): the envelope gained `hostname` (fleet joins —
# a rank is a host, and straggler attribution must name one) and, when
# set, `job_id` (heatd workers stamp it so a run joins its job by
# content, not path convention) and the causal trace triple
# `trace_id`/`span_id`/`parent_span_id` (utils/tracing.py). Consumers
# ignore unknown envelope fields by contract, so v1 readers keep
# working.
SCHEMA_VERSION = 2

# Bounded writer queue (async_io mode): deep enough that bursts of
# events never block the run loop,
# bounded so a wedged filesystem exerts backpressure instead of
# growing an unbounded heap of pending events.
_ASYNC_QUEUE_DEPTH = 1024
# Events that must reach the heartbeat immediately, throttle or not:
# an external probe reading a terminal state must never see a stale
# mid-run heartbeat for up to min_interval afterwards.
_FORCE_HEARTBEAT_EVENTS = ("run_end", "permanent_failure", "signal")


def _process_info():
    """(process_index, process_count) from ``torch.distributed`` when its
    process group is initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


def shard_path(path: str, process_index: int, process_count: int) -> str:
    """Per-process sink path: ``runs/m.jsonl`` -> ``runs/m.p3.jsonl``
    when ``process_count > 1`` (unchanged for single-process runs).

    Multi-host runs must never interleave appends into one file — JSONL
    has no record framing beyond the newline, so concurrent writers
    from different hosts tear each other's lines. Each process writes
    its own shard; ``tools/metrics_report.py`` accepts a glob
    (``runs/m*.jsonl``) and merges shards by ``t_mono``.
    """
    if process_count <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{process_index}{ext}"


class Telemetry:
    """Append-only JSONL event sink + optional heartbeat file.

    ``path`` may be None for a heartbeat-only sink. The heartbeat file
    is rewritten atomically (tmp + rename) at most every
    ``heartbeat_interval_s`` seconds (the throttle ``min_interval``,
    default 1 s — short chunks must not pay a write+rename per
    boundary; terminal events and :meth:`close` force a final rewrite
    so probes never read a stale end state), so an external probe can
    ``stat``/read it without ever seeing a torn write::

        {"t_wall": ..., "t_mono": ..., "pid": ..., "step": ...,
         "events": ..., "last_event": ..., "interval_s": ...}

    ``async_io=True`` moves all file I/O (JSONL append + heartbeat
    rename) to a bounded-queue background writer thread: ``emit``
    stamps the envelope on the caller's clock and returns after an
    enqueue, so the run loop never blocks on the filesystem (a full
    queue — a wedged disk — exerts backpressure rather than dropping
    events). Event order is the emit order either way. The default
    stays synchronous: same-thread writes are simpler to reason about
    for tests and short tools; the CLI and the pipelined stream opt
    in.

    Use as a context manager or call :meth:`close`; either drains the
    writer (async mode), rewrites a final heartbeat, and closes the
    stream (events are flushed per line regardless, so a SIGKILL loses
    at most the lines still queued).
    """

    def __init__(self, path=None, heartbeat=None,
                 heartbeat_interval_s: float = 1.0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 async_io: bool = False,
                 trace: Optional[TraceContext] = None,
                 job_id: Optional[str] = None):
        # Causal trace context (utils/tracing.py): explicit argument,
        # else inherited from the environment — a daemon-spawned
        # worker's sink joins its submit's trace without the worker
        # threading a context through every call site. None = the
        # envelope simply carries no trace triple.
        self.trace = trace if trace is not None \
            else TraceContext.from_env()
        self.job_id = job_id
        try:
            self.hostname = socket.gethostname()
        except OSError:  # pragma: no cover — observation-only
            self.hostname = None
        if process_index is None or process_count is None:
            pi, pc = _process_info()
            process_index = pi if process_index is None else process_index
            process_count = pc if process_count is None else process_count
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        # Multi-process runs shard both sinks per process (JSONL appends
        # from several hosts would tear each other's lines; concurrent
        # heartbeat renames would flap between processes' views).
        if path is not None:
            path = shard_path(str(path), self.process_index,
                              self.process_count)
        if heartbeat is not None:
            heartbeat = shard_path(str(heartbeat), self.process_index,
                                   self.process_count)
        self.path = path
        self.heartbeat_path = heartbeat
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        for p in (self.path, self.heartbeat_path):
            # `--metrics runs/plate.jsonl` must not require a
            # pre-existing runs/.
            if p is not None and os.path.dirname(p):
                os.makedirs(os.path.dirname(p), exist_ok=True)
        self._f = open(self.path, "a") if self.path is not None else None
        self._dead = False
        self._header_done = False
        self._events = 0
        self._last_event: Optional[str] = None
        self._last_step: Optional[int] = None
        self._last_residual: Optional[float] = None
        self._last_heartbeat_mono: Optional[float] = None
        self._events_at_heartbeat = 0
        # One lock around the write+state path: the writer thread (and
        # any caller's worker thread) writes while the run loop emits
        # from the main thread — interleaved JSONL lines must never
        # tear each other.
        self._io_lock = threading.RLock()
        self._queue: Optional[queue.Queue] = None
        self._writer: Optional[threading.Thread] = None
        if async_io:
            self._queue = queue.Queue(maxsize=_ASYNC_QUEUE_DEPTH)
            self._writer = threading.Thread(
                target=self._writer_loop, name="telemetry-writer",
                daemon=True)
            self._writer.start()
        # Absolute-step offset for chunk events: solve_stream counts
        # steps from its own start; a driver that restarts streams sets
        # this to each segment's base so events carry absolute steps.
        self.step_offset = 0

    # -- core ------------------------------------------------------------

    def emit(self, event: str, **fields) -> None:
        """Write one event line (enqueue it in ``async_io`` mode — the
        envelope is stamped here, on the caller's clock). Never raises:
        telemetry is an observer, and an observer's disk-full must not
        kill the run — the sink warns once and goes quiet instead."""
        if self._dead:
            return
        rec = {"schema": SCHEMA_VERSION, "event": event,
               "t_wall": time.time(), "t_mono": time.monotonic(),
               "process_index": self.process_index,
               "process_count": self.process_count,
               "hostname": self.hostname}
        if self.job_id is not None:
            rec["job_id"] = self.job_id
        if self.trace is not None:
            rec.update(self.trace.to_dict())
        rec.update(fields)
        if self._queue is not None:
            # Blocking put: a full queue (wedged filesystem) slows the
            # run instead of silently dropping lifecycle events.
            self._queue.put(rec)
            return
        self._write_record(rec)

    def _writer_loop(self) -> None:
        q = self._queue
        while True:
            rec = q.get()
            if rec is None:  # close() sentinel
                q.task_done()
                return
            try:
                self._write_record(rec)
            except Exception as e:  # noqa: BLE001 — a writer-thread
                # crash must never take the run down OR wedge close()
                with self._io_lock:
                    already = self._dead
                    self._dead = True
                if not already:
                    warnings.warn(
                        f"telemetry writer thread disabled after "
                        f"unexpected error: {e}", RuntimeWarning)
            finally:
                q.task_done()

    def _write_record(self, rec) -> None:
        """Serialize + append one record and update the heartbeat
        state. Runs on the writer thread in ``async_io`` mode, inline
        otherwise; the lock also serializes direct emits from other
        threads."""
        with self._io_lock:
            if self._dead:
                return
            event = rec["event"]
            try:
                if self._f is not None:
                    self._f.write(json.dumps(rec) + "\n")
                    self._f.flush()
            except (OSError, ValueError, TypeError) as e:
                self._dead = True
                warnings.warn(f"telemetry sink {self.path!r} disabled "
                              f"after write failure: {e}",
                              RuntimeWarning)
                return
            self._events += 1
            self._last_event = event
            if rec.get("step") is not None:
                self._last_step = rec["step"]
            if rec.get("residual") is not None:
                self._last_residual = rec["residual"]
            self._maybe_heartbeat(rec["t_mono"],
                                  force=event in _FORCE_HEARTBEAT_EVENTS)

    def _maybe_heartbeat(self, t_mono: float, force: bool = False) -> None:
        if self.heartbeat_path is None:
            return
        if (not force and self._last_heartbeat_mono is not None
                and t_mono - self._last_heartbeat_mono
                < self.heartbeat_interval_s):
            # Throttled (min_interval): short chunks must not pay a
            # write+fsync-rename per boundary; close()/terminal events
            # still publish the final state.
            return
        self.heartbeat()

    def heartbeat(self) -> None:
        """Atomically rewrite the heartbeat file (tmp + rename — a
        reader never sees a torn write). Safe to call directly from a
        long host-side wait."""
        with self._io_lock:
            if self.heartbeat_path is None or self._dead:
                return
            # `last_step`/`last_event`/`residual` make the heartbeat
            # self-sufficient: an external liveness probe (or
            # `tools/monitor.py --once`) can report progress without
            # parsing the JSONL at all. `step` is kept as a legacy
            # alias of `last_step`; `interval_s` tells probes how
            # stale a healthy heartbeat may legitimately be.
            doc = {"t_wall": time.time(), "t_mono": time.monotonic(),
                   "pid": os.getpid(), "events": self._events,
                   "last_event": self._last_event,
                   "step": self._last_step,
                   "last_step": self._last_step,
                   "residual": self._last_residual,
                   "interval_s": self.heartbeat_interval_s}
            tmp = f"{self.heartbeat_path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                os.replace(tmp, self.heartbeat_path)
            except OSError as e:
                # Disable ONLY the heartbeat: the JSONL stream is an
                # independent sink and must keep its terminal run_end
                # even when the probe file's filesystem goes away.
                self.heartbeat_path = None
                warnings.warn(f"telemetry heartbeat disabled after "
                              f"write failure: {e}", RuntimeWarning)
                return
            self._last_heartbeat_mono = doc["t_mono"]
            self._events_at_heartbeat = self._events

    # -- typed events ----------------------------------------------------

    def run_header(self, config, **extra) -> None:
        """Emit the run-header event: config, resolved execution path
        (``solver.explain``), topology, versions. Idempotent per sink."""
        if self._header_done or self._dead:
            return
        self._header_done = True
        import torch

        doc = {"config": json.loads(config.to_json()),
               # The ABSOLUTE step target: chunk events carry absolute
               # steps (step_offset), so a resumed run's progress reads
               # its target here, not from config.steps.
               "steps_total": self.step_offset + config.steps,
               "schema_version": SCHEMA_VERSION,
               "torch_version": torch.__version__}
        try:
            import numpy as np

            doc["numpy_version"] = np.__version__
            dev = torch.device(config.device)
            if dev.type == "cuda":
                doc["platform"] = "gpu"
                doc["device_kind"] = torch.cuda.get_device_name(dev)
                doc["device_count"] = torch.cuda.device_count()
            else:
                doc["platform"] = "cpu"
                doc["device_kind"] = "cpu"
                doc["device_count"] = 1
            # The envelope's process_index/process_count name the rank;
            # the runtime's own view rides under distinct names.
            pi, pc = _process_info()
            doc["runtime_process_index"] = pi
            doc["runtime_process_count"] = pc
            doc["mesh"] = (list(config.mesh_shape)
                           if config.mesh_shape is not None else None)
        except Exception as e:  # noqa: BLE001 — observation-only
            doc["topology_error"] = f"{type(e).__name__}: {e}"
        try:
            from parallel_heat_tpu_torch.solver import explain

            ex = explain(config)
            ex["shape"] = list(ex["shape"])
            if ex.get("mesh"):
                ex["mesh"] = list(ex["mesh"])
            if ex.get("block_shape"):
                ex["block_shape"] = list(ex["block_shape"])
            doc["explain"] = ex
        except Exception as e:  # noqa: BLE001 — a config explain can't
            # resolve must still produce a header, not kill the run
            doc["explain_error"] = f"{type(e).__name__}: {e}"
        doc.update(extra)
        self.emit("run_header", **doc)

    def chunk(self, *, step: int, steps: int, wall_s: float, cells: int,
              bytes_per_cell: int, residual=None, converged=None,
              finite=None, gap_s=None, dispatch_s=None,
              drain_wait_s=None, observe_s=None,
              exchange_s=None) -> None:
        """Emit one per-chunk progress event. ``step`` is stream-relative;
        ``step_offset`` is applied here; rates come from
        :class:`utils.profiling.StepStats` and are null when the chunk
        wall time is too small to divide by.

        The optional pipeline-timing fields (included only when the
        stream measured them): ``gap_s`` — device idle charged to this
        chunk (sync loop: host time between the previous chunk's
        completion and this dispatch, the observer and caller tax;
        pipelined loop: the measured starvation lower bound from the
        drain-time probe of the newest chunk's event); ``dispatch_s`` —
        host time enqueuing the chunk; ``drain_wait_s`` — host time
        blocked waiting for the chunk's event (the
        device-bound signal: ~0 everywhere means the host, not the
        device, is the bottleneck); ``observe_s`` — host time spent on
        this chunk's observers after completion. ``tools/
        metrics_report.py``'s pipeline section aggregates these.

        ``exchange_s`` — halo-exchange wall attributed to this chunk,
        when a producer measured it; ``metrics_report`` turns it into
        the ``exchange_share`` metric. ``solve_stream`` never measures
        it: the exchange runs inside the chunk."""
        from parallel_heat_tpu_torch.utils.profiling import StepStats

        if wall_s > 0:
            st = StepStats(cells=cells, steps=steps, elapsed_s=wall_s,
                           bytes_per_cell=bytes_per_cell)
            rates = {"steps_per_s": st.steps_per_s,
                     "mcells_steps_per_s": st.mcells_steps_per_s,
                     "hbm_gb_s": st.effective_hbm_gb_s}
        else:
            rates = {"steps_per_s": None, "mcells_steps_per_s": None,
                     "hbm_gb_s": None}
        timing = {k: v for k, v in (("gap_s", gap_s),
                                    ("dispatch_s", dispatch_s),
                                    ("drain_wait_s", drain_wait_s),
                                    ("observe_s", observe_s),
                                    ("exchange_s", exchange_s))
                  if v is not None}
        self.emit("chunk", step=self.step_offset + step, steps=steps,
                  wall_s=wall_s, cells=cells,
                  bytes_per_cell=bytes_per_cell, residual=residual,
                  converged=converged, finite=finite, **rates,
                  **timing)

    def diagnostics(self, *, step: int, **stats) -> None:
        """Emit one grid-diagnostics sample (``solver.grid_stats`` under
        ``HeatConfig.diag_interval``): min/max/heat/update_l2/
        update_linf plus ``steps_since`` (steps since the previous
        sample). ``step`` is stream-relative; ``step_offset`` is applied
        here, as in :meth:`chunk`."""
        self.emit("diagnostics", step=self.step_offset + step, **stats)

    def run_end(self, *, outcome: str, **fields) -> None:
        """Terminal event: ``outcome`` is ``complete`` /
        ``interrupted`` / ``permanent_failure``."""
        self.emit("run_end", outcome=outcome, **fields)

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Drain the writer (async mode), publish a final heartbeat,
        close the stream. Idempotent."""
        if self._writer is not None:
            # Sentinel + join: every queued record lands before the
            # file closes. The timeout is defensive — a wedged disk
            # must not hang process exit forever; the warn-once dead
            # path inside the worker normally guarantees progress.
            self._queue.put(None)
            self._writer.join(timeout=30.0)
            self._writer = None
            self._queue = None
        if (self.heartbeat_path is not None and not self._dead
                and self._events > self._events_at_heartbeat):
            # Events landed since the last (throttled) rewrite: the
            # probe file must reflect the final state.
            self.heartbeat()
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
