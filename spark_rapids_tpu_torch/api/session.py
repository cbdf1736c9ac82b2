"""TpuSparkSession: the port's entry point.

Ported from ``spark_rapids_tpu/api/session.py``: the conf, the data
sources (``create_dataframe``, ``range``, ``read.parquet``/``csv``/
``orc``), planning (``_plan_physical``: ``prune_columns`` ->
``plan_cpu`` -> ``TpuOverrides.apply``), partition draining on
``concurrentTpuTasks`` threads and the collect path, plus ``set_conf``,
``get_conf`` and the plan listeners.

The session runs on one device, ``cuda`` unless the caller asks for
``cpu`` (``resolve_device`` raises without a GPU, ``mem/device.
check_device`` without that card); every device exec of its plans and
every partition thread uses it.  On the card the session owns one copy
stream (``columnar/transfer.CopyStream``) for its plans' uploads.  As in
the reference, it sizes the device semaphore from ``concurrentTpuTasks``
(``mem/device.initialize``) and switches the span tracer from the
``obs.trace.*`` keys.  It accepts the reference's ``spark.rapids.tpu.*``
keys unchanged, so one conf dict drives both packages.

``sql()`` parses a query (sql/parser.py) against the temp views that
``register_view`` (or ``DataFrame.create_or_replace_temp_view``)
registered.  ``_execute_device`` hands the device batches over with no
download.  At start the session makes the process's spill catalog
(``mem/spill.init_catalog`` with the ``memory.device.batchStorageSize``,
``memory.host.spillStorageSize`` and ``memory.spill.dir`` keys), or
disables it under ``memory.spill.enabled=false``, as the reference does.

Every action goes through the session's query service
(``sched/service.QueryService``, built at init as the reference builds
it): ``collect()`` is ``submit().result()`` and ``collect_async`` /
``submit`` return the ``QueryFuture``.  The service digests the plan
(plan/digest.py), registers the query with the compile observatory and
the resource ledger under the tenant ``("(in-process)",
"digest:<16 hex>")``, admits it against ``sched.memoryBudget`` /
``sched.maxConcurrent``, arms its deadline, joins an identical flight
(``sched.dedup.enabled``) and runs it on a ``sched-q<id>`` thread under
its ``CancelToken`` (a collect from inside a running query runs inline
under its parent's).  There ``_execute_attributed`` wraps the query in
the observability envelope: under ``obs.profile.enabled`` (the default)
a ``QueryRun`` whose ``QueryProfile`` goes to the profile ring
(``last_query_profile``, ``query_profile``), the query listeners
(``register_query_listener``; the flight recorder of ``obs.recorder.dir``
is one) and the slow-query log (``obs.slowQueryMs``).  A query rejected
before admission, or a single-flight follower, gets a stub profile
through the same ring, listeners and log.  ``obs.http.enabled`` starts
the telemetry endpoint (``obs_server``) and ``obs.sentinel.enabled`` the
drift sentinel (``sentinel``).  ``sched.precompile.enabled`` starts the
precompile service (``precompile_service``, sched/precompile.py) on the
corpus of ``sched.precompile.corpusPath`` or ``obs.compile.corpusPath``.
Not ported yet: serving and the fleet (so the reference's replay of a
fleet store's shared corpus directory waits for them).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import pyarrow as pa

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.columnar.batch import resolve_device
from spark_rapids_tpu_torch.config import RapidsTpuConf
from spark_rapids_tpu_torch.exec.base import timed
from spark_rapids_tpu_torch.exec.cpu import concat_tables
from spark_rapids_tpu_torch.mem import device as devmgr
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.overrides import (OverrideResult, TpuOverrides,
                                                   assert_is_on_tpu)
from spark_rapids_tpu_torch.plan.planner import plan_cpu


class TpuSparkSession:
    # process-global query ids, shared across sessions as in the
    # reference: the compile observatory, the profile ring, the /queries
    # table and the recorder's bundles key on them
    _QUERY_IDS = itertools.count(1)

    def __init__(self, conf: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.device_name = devmgr.check_device(self.device)
        self.conf = cfg.configure(RapidsTpuConf(conf))
        devmgr.initialize(self.conf.get(cfg.CONCURRENT_TPU_TASKS))
        self.copy_stream = None
        if self.device.type == "cuda":
            from spark_rapids_tpu_torch.columnar.transfer import CopyStream
            self.copy_stream = CopyStream(self.device)
        from spark_rapids_tpu_torch.mem import spill
        if self.conf.get(cfg.MEM_SPILL_ENABLED):
            spill.init_catalog(
                self.conf.get(cfg.MEM_DEVICE_LIMIT),
                self.conf.get(cfg.MEM_HOST_SPILL_LIMIT),
                self.conf.get(cfg.MEM_SPILL_DIR) or None,
                device=self.device)
        else:
            spill.disable_catalog()
        from spark_rapids_tpu_torch.io import scan_cache
        scan_cache.configure(
            self.conf.get(cfg.SCAN_METADATA_CACHE_ENABLED),
            self.conf.get(cfg.SCAN_METADATA_CACHE_MAX_BYTES))
        from spark_rapids_tpu_torch.obs import trace as obs_trace
        obs_trace.configure(
            bool(self.conf.get(cfg.OBS_TRACE_ENABLED)),
            int(self.conf.get(cfg.OBS_TRACE_BUFFER_SPANS)))
        from spark_rapids_tpu_torch.obs import compile as obs_compile
        obs_compile.configure(
            bool(self.conf.get(cfg.OBS_COMPILE_ENABLED)),
            ring_events=int(self.conf.get(cfg.OBS_COMPILE_RING_EVENTS)),
            storm_threshold=int(self.conf.get(
                cfg.OBS_COMPILE_STORM_THRESHOLD)),
            corpus_path=str(self.conf.get(
                cfg.OBS_COMPILE_CORPUS_PATH) or ""),
            corpus_replay=bool(self.conf.get(
                cfg.OBS_COMPILE_CORPUS_REPLAY)))
        from spark_rapids_tpu_torch.obs import accounting as obs_accounting
        obs_accounting.configure(
            bool(self.conf.get(cfg.OBS_ACCOUNTING_ENABLED)))
        self._plan_listeners: List = []
        self._query_listeners: List = []
        self._views: Dict[str, lp.LogicalPlan] = {}
        self._query_ids = TpuSparkSession._QUERY_IDS
        # per-query profiles: a bounded ring keyed by query id, plus the
        # most recently COMPLETED one
        self._profile_lock = threading.Lock()
        self._profiles: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()
        self._profile_ring = max(1, int(self.conf.get(
            cfg.SCHED_PROFILE_RING)))
        self._last_profile = None
        from spark_rapids_tpu_torch.sched.service import QueryService
        self._query_service = QueryService(self)
        from spark_rapids_tpu_torch.obs import recorder as obs_recorder
        self._recorder = None
        rec_dir = str(self.conf.get(cfg.OBS_RECORDER_DIR) or "")
        if rec_dir:
            # configuring REPLACES any previous session's recorder
            # (whose listener then stands down via _stale()); a session
            # with no recorder dir leaves an existing recorder alone, so
            # a helper session does not disarm a live sibling's recorder
            self._recorder = obs_recorder.configure(
                rec_dir,
                max_events=int(self.conf.get(
                    cfg.OBS_RECORDER_MAX_EVENTS)),
                config_snapshot=dict(self.conf._settings))
            self._query_listeners.append(self._recorder)
        if not self.conf.get(cfg.OBS_PROFILE_ENABLED) and (
                rec_dir or int(self.conf.get(cfg.OBS_SLOW_QUERY_MS))):
            # both features ride the QueryProfile assembly path; with
            # profiling off they would be silently inert
            import logging
            logging.getLogger("spark_rapids_tpu_torch.obs").warning(
                "obs.recorder.dir / obs.slowQueryMs are configured but "
                "obs.profile.enabled=false: flight-recorder bundles "
                "and the slow-query log require per-query profiles "
                "and will not fire")
        # the telemetry endpoint and the drift sentinel: both off by
        # default (no socket, no thread)
        self._obs_server = None
        if self.conf.get(cfg.OBS_HTTP_ENABLED):
            from spark_rapids_tpu_torch.obs.server import ObsHttpServer
            self._obs_server = ObsHttpServer(
                self, host=str(self.conf.get(cfg.OBS_HTTP_HOST)),
                port=int(self.conf.get(cfg.OBS_HTTP_PORT)))
        self._sentinel = None
        if self.conf.get(cfg.OBS_SENTINEL_ENABLED):
            from spark_rapids_tpu_torch.obs.sentinel import DriftSentinel
            self._sentinel = DriftSentinel(
                interval_ms=int(self.conf.get(
                    cfg.OBS_SENTINEL_INTERVAL_MS)),
                rules=str(self.conf.get(cfg.OBS_SENTINEL_RULES) or ""),
                jsonl_path=str(self.conf.get(
                    cfg.OBS_SENTINEL_PATH) or ""),
                jsonl_max_bytes=int(self.conf.get(
                    cfg.OBS_SLOW_QUERY_MAX_BYTES)))
            self._sentinel.start()
        # the precompile service: off by default; replays the corpus on
        # a daemon thread, yielding to live queries
        self._precompile_service = None
        if self.conf.get(cfg.SCHED_PRECOMPILE_ENABLED):
            from spark_rapids_tpu_torch.sched.precompile import \
                PrecompileService
            corpus = (str(self.conf.get(
                cfg.SCHED_PRECOMPILE_CORPUS_PATH) or "") or
                str(self.conf.get(cfg.OBS_COMPILE_CORPUS_PATH) or ""))
            self._precompile_service = PrecompileService(
                self, corpus,
                idle_wait_ms=int(self.conf.get(
                    cfg.SCHED_PRECOMPILE_IDLE_WAIT_MS)))
            self._precompile_service.start()

    # -- conf --------------------------------------------------------------
    def set_conf(self, key: str, value: Any) -> None:
        self.conf.set(key, value)

    def get_conf(self, key: str, default: Any = None) -> Any:
        return self.conf.get_raw(key, default)

    # -- data sources ------------------------------------------------------
    def create_dataframe(self, data, schema: Optional[Sequence[str]] = None,
                         num_partitions: int = 1) -> DataFrame:
        if isinstance(data, pa.Table):
            table = data
        elif hasattr(data, "to_dict") and hasattr(data, "columns"):
            table = pa.Table.from_pandas(data)  # pandas DataFrame
        elif isinstance(data, dict):
            table = pa.table(data)
        elif isinstance(data, list):
            if schema is None:
                raise ValueError("schema (column names) required for lists")
            cols = list(zip(*data)) if data else [[] for _ in schema]
            table = pa.table({n: list(c) for n, c in zip(schema, cols)})
        else:
            raise TypeError(f"cannot create DataFrame from {type(data)}")
        return DataFrame(lp.InMemoryScan(table, num_partitions), self)

    createDataFrame = create_dataframe

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: int = 1) -> DataFrame:
        if end is None:
            start, end = 0, start
        return DataFrame(lp.Range(start, end, step, num_partitions), self)

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    # -- SQL ---------------------------------------------------------------
    def sql(self, query: str) -> DataFrame:
        """Parse and plan a SQL query against the registered temp views."""
        from spark_rapids_tpu_torch.sql import parse_sql
        return DataFrame(parse_sql(query, self._views), self)

    def register_view(self, name: str, df: DataFrame) -> None:
        self._views[name.lower()] = df.plan

    def drop_view(self, name: str) -> None:
        self._views.pop(name.lower(), None)

    @property
    def catalog(self) -> Dict[str, lp.LogicalPlan]:
        return dict(self._views)

    # -- planning & execution ----------------------------------------------
    def _plan_physical(self, plan: lp.LogicalPlan) -> OverrideResult:
        if self.conf.get(cfg.COLUMN_PRUNING):
            from spark_rapids_tpu_torch.plan.optimizer import prune_columns
            plan = prune_columns(plan)
        cpu_plan = plan_cpu(plan, self.conf)
        result = TpuOverrides.apply(cpu_plan, self.conf, device=self.device)
        from spark_rapids_tpu_torch.columnar.transfer import \
            stamp_copy_stream
        stamp_copy_stream(result.plan, self.copy_stream)
        if self.conf.test_enabled:
            assert_is_on_tpu(result.plan, self.conf.test_allowed_non_tpu)
        for listener in self._plan_listeners:
            listener(result)
        return result

    def _drain_partitions(self, its) -> List:
        """Drain partition iterators, one task per partition on a thread
        pool sized by ``concurrentTpuTasks``; output keeps partition
        order.  Every exec carries the session's device, so the threads
        share it; none of them synchronizes the device."""
        n_tasks = int(self.conf.get(cfg.CONCURRENT_TPU_TASKS))
        if len(its) <= 1 or n_tasks <= 1:
            return [x for it in its for x in it]
        from concurrent.futures import ThreadPoolExecutor
        from spark_rapids_tpu_torch.sched import cancel as sched_cancel
        tok = sched_cancel.current()

        def drain(it):
            # task threads inherit the query's CancelToken explicitly
            # (pool threads don't propagate thread-locals)
            with sched_cancel.install(tok):
                return list(it)
        with ThreadPoolExecutor(max_workers=min(n_tasks, len(its)),
                                thread_name_prefix="tpu-task") as pool:
            parts = list(pool.map(drain, its))
        return [x for p in parts for x in p]

    # -- scheduler surface ---------------------------------------------------
    def _next_query_id(self) -> int:
        return next(self._query_ids)

    @property
    def scheduler(self):
        """The session's QueryService (sched/service.py): admission
        stats, controller, estimate book, the live query table."""
        return self._query_service

    def submit(self, df_or_plan, priority: int = 0,
               timeout_ms: Optional[int] = None,
               estimate_bytes: Optional[int] = None):
        """Submit a query for asynchronous execution; returns a
        QueryFuture (result/cancel/done, profile attached on
        completion).  Accepts a DataFrame or a logical plan.  Higher
        ``priority`` admits first; ``timeout_ms`` overrides
        ``sched.defaultTimeoutMs``; ``estimate_bytes`` overrides the
        admission working-set estimate."""
        plan = getattr(df_or_plan, "plan", df_or_plan)
        return self._query_service.submit(
            plan, priority=priority, timeout_ms=timeout_ms,
            estimate_bytes=estimate_bytes)

    def _execute(self, plan: lp.LogicalPlan) -> pa.Table:
        """The blocking action path: ``submit().result()`` through the
        query service, so admission, the deadline, cancellation and the
        per-query attribution apply to plain ``collect()`` too.  An
        interrupt of the blocking wait cancels the submitted query
        (cancel() is a no-op when the query itself raised: it has
        finished)."""
        fut = self._query_service.submit(plan)
        try:
            return fut.result()
        except BaseException:
            fut.cancel("blocking collect interrupted")
            raise

    def _execute_attributed(self, plan: lp.LogicalPlan,
                            query_id: Optional[int] = None,
                            sched_extra: Optional[Dict[str, Any]] = None,
                            plan_digest: Optional[str] = None):
        """Execute an action with the observability envelope: a
        QueryRun captures the wall phases, the per-query registry delta
        and the span window; the assembled QueryProfile lands in the
        profile ring / ``last_query_profile()`` and fans out to the
        query listeners (on success AND on failure).  Returns ``(table,
        profile)`` (profile None when profiling is off).  The query
        service calls it with the query's CancelToken installed on the
        thread."""
        run = None
        if self.conf.get(cfg.OBS_PROFILE_ENABLED):
            from spark_rapids_tpu_torch.obs.profile import QueryRun
            run = QueryRun(query_id if query_id is not None
                           else self._next_query_id(),
                           sched_extra=sched_extra,
                           plan_digest=plan_digest)
        try:
            result, table = self._execute_inner(plan, run)
        except BaseException as e:
            if run is not None:
                # run.planned was stashed right after planning, so a
                # failure profile still carries the plan tree and the
                # explain report whenever planning itself succeeded
                self._finish_query(run, run.planned, None, e)
            raise
        prof = None
        if run is not None:
            prof = self._finish_query(run, result, table, None)
        elif self.conf.get(cfg.OBS_TRACE_ENABLED):
            # tracing without profiling: the chromePath contract still
            # holds (the whole ring stands in for the query window)
            from spark_rapids_tpu_torch.obs import trace as obs_trace
            chrome = str(self.conf.get(cfg.OBS_TRACE_CHROME_PATH) or "")
            if chrome and obs_trace.is_enabled():
                with contextlib.suppress(OSError):
                    obs_trace.dump_chrome_trace(chrome)
        return table, prof

    def _finish_query(self, run, result, table,
                      error: Optional[BaseException]):
        from spark_rapids_tpu_torch.obs import listener as obs_listener
        from spark_rapids_tpu_torch.obs import trace as obs_trace
        prof = run.finish(result=result, table=table, error=error)
        self._ring_profile(prof)
        obs_listener.notify(self._query_listeners, prof, error)
        self._maybe_log_slow_query(prof)
        chrome = str(self.conf.get(cfg.OBS_TRACE_CHROME_PATH) or "")
        if chrome and obs_trace.is_enabled():
            with contextlib.suppress(OSError):
                prof.dump_chrome_trace(chrome)
        return prof

    def _ring_profile(self, prof, last: bool = True) -> None:
        with self._profile_lock:
            self._profiles[prof.query_id] = prof
            while len(self._profiles) > self._profile_ring:
                self._profiles.popitem(last=False)
            if last:
                # completion order under the lock: "last" is the most
                # recently COMPLETED query, stable under concurrent
                # collects
                self._last_profile = prof

    def _record_rejection(self, query_id: int,
                          error: BaseException, req,
                          meta: Optional[Dict[str, Any]] = None) -> None:
        """A query refused BEFORE admission (queue-full rejection)
        never reaches the profile assembly path: build a stub
        QueryProfile (status ``rejected``) and put it through the ring,
        the listener fan-out (the flight recorder bundles it under
        reason ``rejected``) and the slow-query log.  Never raises."""
        try:
            from spark_rapids_tpu_torch.obs import listener as obs_listener
            from spark_rapids_tpu_torch.obs.profile import QueryProfile
            meta = dict(meta or {})
            sched = {"sched.estimateBytes": getattr(req, "estimate", 0),
                     "sched.priority": getattr(req, "priority", 0)}
            if meta.get("session_id") is not None:
                sched["sched.sessionId"] = meta["session_id"]
            prof = QueryProfile(
                query_id=query_id,
                status="rejected",
                error=f"{type(error).__name__}: {error}",
                result_rows=None, wall_ns=0, phases={}, plan=None,
                metrics={"sched": sched},
                wall_breakdown={}, explain_lines=[], spans=[],
                plan_digest=meta.get("plan_digest"))
            self._ring_profile(prof, last=False)
            obs_listener.notify(self._query_listeners, prof, error)
            self._maybe_log_slow_query(prof)
        except Exception:
            pass

    def _record_dedup_follower(self, query_id: int, leader_qid: int,
                               state, error: Optional[BaseException],
                               meta: Optional[Dict[str, Any]],
                               wall_ns: int, result) -> Any:
        """Stub QueryProfile for a single-flight follower: it never
        executed, so it records a pointer at the leader's query id
        (``sched.dedup.leaderQueryId``), whose profile holds the real
        execution.  Rings, notifies the listeners and logs a slow one
        (rows carry ``deduped: true``) like the rejection stub.  Returns
        the profile (None on any failure)."""
        try:
            from spark_rapids_tpu_torch.obs import listener as obs_listener
            from spark_rapids_tpu_torch.obs.profile import QueryProfile
            meta = dict(meta or {})
            sched = {"sched.dedup.leaderQueryId": leader_qid,
                     "sched.deduped": 1}
            if meta.get("session_id") is not None:
                sched["sched.sessionId"] = meta["session_id"]
            status = getattr(state, "value", str(state))
            nrows = None
            try:
                if result is not None:
                    nrows = int(result.num_rows)
            except Exception:
                nrows = None
            prof = QueryProfile(
                query_id=query_id,
                status=status,
                error=None if error is None
                else f"{type(error).__name__}: {error}",
                result_rows=nrows, wall_ns=int(wall_ns), phases={},
                plan=None,
                metrics={"sched": sched,
                         "sharing": {"sched.dedup.leaderQueryId":
                                     leader_qid}},
                wall_breakdown={}, explain_lines=[], spans=[],
                plan_digest=meta.get("plan_digest"))
            self._ring_profile(prof)
            obs_listener.notify(self._query_listeners, prof, error)
            self._maybe_log_slow_query(prof)
            return prof
        except Exception:
            return None

    def _maybe_log_slow_query(self, prof) -> None:
        """Structured slow-query log: one JSONL record per query at or
        over ``obs.slowQueryMs`` (failures included), appended to
        ``obs.slowQueryPath`` or routed through the
        ``spark_rapids_tpu_torch.obs.slowquery`` logger.  Never fails
        the query."""
        threshold_ms = int(self.conf.get(cfg.OBS_SLOW_QUERY_MS))
        if threshold_ms <= 0:
            return
        # a rejection logs whatever its wall: the overload signal
        if prof.status != "rejected" and \
                prof.wall_ns < threshold_ms * 1e6:
            return
        try:
            import json as _json
            import time as _time
            # one rendering of the profile exists (to_dict): the log
            # record is a field subset of it plus the log-only extras
            d = prof.to_dict()
            record = {"ts_unix": _time.time(),
                      "threshold_ms": threshold_ms,
                      "session_id": prof.metrics.get("sched", {}).get(
                          "sched.sessionId"),
                      "queue_wait_s": prof.metrics.get("sched", {}).get(
                          "sched.queueWaitNs", 0) / 1e9}
            # exact token-based attribution (obs/compile.row_fields —
            # the same derivation the reference's /queries rows use),
            # not the registry window, which a concurrent neighbour's
            # first calls would bleed into
            from spark_rapids_tpu_torch.obs import compile as obs_compile
            record.update(obs_compile.row_fields(prof.query_id))
            for key in ("query_id", "plan_digest", "status", "error",
                        "wall_s", "result_rows", "phases",
                        "wall_breakdown"):
                record[key] = d[key]
            leader = prof.metrics.get("sched", {}).get(
                "sched.dedup.leaderQueryId")
            if leader is not None:
                record["deduped"] = True
                record["leader_query_id"] = leader
            line = _json.dumps(record, default=str)
            from spark_rapids_tpu_torch.obs import recorder as obs_recorder
            from spark_rapids_tpu_torch.obs import registry as obsreg
            obsreg.get_registry().inc("obs.slowQueries")
            obs_recorder.record_event("query.slow",
                                      query=prof.query_id,
                                      wall_s=record["wall_s"])
            path = str(self.conf.get(cfg.OBS_SLOW_QUERY_PATH) or "")
            if path:
                from spark_rapids_tpu_torch.obs import jsonl as obs_jsonl
                obs_jsonl.rotating_append(
                    path, line,
                    int(self.conf.get(cfg.OBS_SLOW_QUERY_MAX_BYTES)))
            else:
                import logging
                logging.getLogger(
                    "spark_rapids_tpu_torch.obs.slowquery").warning(line)
        except Exception:
            pass

    def _phase(self, run, name: str):
        return run.phase(name) if run is not None \
            else contextlib.nullcontext()

    def _execute_inner(self, plan: lp.LogicalPlan, run=None):
        """(planned result, Arrow table) of one query; ``run`` (a
        ``QueryRun`` or None) times its plan, execute and collect
        phases."""
        from spark_rapids_tpu_torch.columnar.batch import to_arrow_all
        from spark_rapids_tpu_torch.exec import kernel_cache
        from spark_rapids_tpu_torch.exec.context import set_input_file
        from spark_rapids_tpu_torch.exec.tpu_basic import DeviceToHostExec
        # executor-longevity guard (see the kernel_cache docstring)
        kernel_cache.maybe_clear_for_map_pressure()
        set_input_file("")  # fresh query: no stale input_file_name()
        with self._phase(run, "plan"):
            result = self._plan_physical(plan)
        if run is not None:
            run.planned = result
        p = result.plan
        if isinstance(p, DeviceToHostExec):
            # drain the device plan first, then download every batch
            # behind one barrier: one packed copy per wire dtype, one
            # wait for all of them
            with self._phase(run, "execute"):
                batches = self._drain_partitions(p.children[0].execute())
            with self._phase(run, "collect"):
                with timed(p.metrics, "transition.download"):
                    tables = to_arrow_all(batches, self.copy_stream)
                table = concat_tables(tables, p.schema)
            # the terminal download exec never ran execute(); stamp it
            # with the collected result
            p.metrics.add_rows(table.num_rows)
            p.metrics.add_batches(len(tables))
            return result, table
        with self._phase(run, "execute"):
            tables = self._drain_partitions(p.execute())
        with self._phase(run, "collect"):
            table = concat_tables(tables, p.schema)
        return result, table

    def _execute_device(self, plan: lp.LogicalPlan):
        """ColumnarRdd-style handoff: the device batches of every
        partition, with no download."""
        from spark_rapids_tpu_torch.exec.tpu_basic import (DeviceToHostExec,
                                                           HostToDeviceExec)
        result = self._plan_physical(plan)
        p = result.plan
        if isinstance(p, DeviceToHostExec):
            p = p.children[0]  # strip the terminal download
        else:
            p = HostToDeviceExec(p, self.conf.get(cfg.MIN_BUCKET_ROWS),
                                 device=self.device)
            p.copy_stream = self.copy_stream
        return self._drain_partitions(p.execute())

    # plan-capture hook for tests
    def add_plan_listener(self, fn) -> None:
        self._plan_listeners.append(fn)

    def remove_plan_listener(self, fn) -> None:
        self._plan_listeners.remove(fn)

    # -- observability surface ---------------------------------------------
    @property
    def obs_server(self):
        """The live telemetry endpoint (obs/server.ObsHttpServer) when
        ``obs.http.enabled=true``; None otherwise.  ``obs_server.port``
        is the bound port (ephemeral under ``obs.http.port=0``)."""
        return self._obs_server

    @property
    def sentinel(self):
        """The drift sentinel (obs/sentinel.DriftSentinel) when
        ``obs.sentinel.enabled=true``; None otherwise.
        ``sentinel.stats()`` reports ticks/breaches/episodes;
        ``sentinel.stop()`` halts the watcher thread."""
        return self._sentinel

    @property
    def precompile_service(self):
        """The background precompile service
        (sched/precompile.PrecompileService) when this session was
        created with ``sched.precompile.enabled=true``; None otherwise.
        ``precompile_service.wait()`` blocks until the initial corpus
        replay finishes; ``precompile_service.stop()`` ends it early."""
        return self._precompile_service

    @property
    def flight_recorder(self):
        """The flight recorder (obs/recorder.FlightRecorder) when
        ``obs.recorder.dir`` is set; None otherwise."""
        return self._recorder

    def last_query_profile(self):
        """The QueryProfile of the most recently COMPLETED action (None
        before the first action, or while ``obs.profile.enabled=false``
        has kept new profiles from being assembled)."""
        with self._profile_lock:
            return self._last_profile

    def query_profile(self, query_id: int):
        """The QueryProfile for ``query_id`` from the bounded per-query
        ring (``sched.profileRing`` entries; None once evicted or when
        profiling is off)."""
        with self._profile_lock:
            return self._profiles.get(query_id)

    def register_query_listener(self, listener) -> None:
        """Register a QueryExecutionListener analog: ``on_success(
        profile)`` / ``on_failure(profile, exception)`` fire after
        every action (obs/listener.py)."""
        self._query_listeners.append(listener)

    def remove_query_listener(self, listener) -> None:
        self._query_listeners.remove(listener)


class DataFrameReader:
    def __init__(self, session: TpuSparkSession):
        self.session = session
        self._options: Dict[str, Any] = {}

    def option(self, key: str, value: Any) -> "DataFrameReader":
        self._options[key] = value
        return self

    def _scan(self, fmt: str, paths) -> DataFrame:
        from spark_rapids_tpu_torch.io.readers import (_partition_fields,
                                                       expand_paths,
                                                       infer_schema)
        from spark_rapids_tpu_torch.plan.logical import Field, Schema
        if isinstance(paths, str):
            paths = [paths]
        files, part_values = expand_paths(fmt, list(paths))
        if not files:
            raise FileNotFoundError(f"no {fmt} files under {paths}")
        schema = infer_schema(fmt, files, self._options)
        pfields = _partition_fields(part_values)
        if pfields:
            schema = Schema(list(schema.fields) +
                            [Field(k, d, True) for k, d in pfields])
        if self._options.get("columns"):
            schema = Schema([schema.field(c)
                             for c in self._options["columns"]])
        opts = dict(self._options)
        opts["part_values"] = part_values
        opts["part_fields"] = pfields
        # the pre-expansion roots, as the reference records them: the
        # plan digest keys a file scan on them (plan/digest.py)
        opts["source_roots"] = [os.path.abspath(p) for p in paths]
        return DataFrame(
            lp.FileScan(fmt, files, schema, opts), self.session)

    def parquet(self, *paths) -> DataFrame:
        return self._scan("parquet", list(paths))

    def csv(self, *paths, header: bool = True, sep: str = ","
            ) -> DataFrame:
        self._options.setdefault("header", header)
        self._options.setdefault("sep", sep)
        return self._scan("csv", list(paths))

    def orc(self, *paths) -> DataFrame:
        return self._scan("orc", list(paths))
