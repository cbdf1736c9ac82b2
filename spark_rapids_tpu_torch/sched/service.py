"""Per-session concurrent query execution service.

``QueryService.submit(plan)`` returns a :class:`QueryFuture`
immediately; the query runs on its own daemon thread once the
memory-aware :class:`~spark_rapids_tpu_torch.sched.admission
.AdmissionController` admits it.  ``DataFrame.collect()`` is now
literally ``submit().result()`` and ``DataFrame.collect_async()``
exposes the future — the execution-service layer between the API and
the exec layer the ROADMAP's multi-tenant north star hangs off.

Copied whole from ``spark_rapids_tpu/sched/service.py``, its module
paths retargeted.  The derived budget is the card's
(``mem/device.memory_budget`` of the session's device, the grace join's
budget too), and every query runs on its own ``sched-q<id>`` thread:
the hand kernels launch on that thread's current CUDA stream, the
default one, as the calling thread's was.

Lifecycle of one query::

    submit -> QUEUED --admission--> RUNNING --+--> SUCCESS (result+profile)
        |         |                           +--> FAILED  (exception)
        |         +--> TIMED_OUT / CANCELLED (unwound via CancelToken
        |              checkpoints: admission slot released, prefetcher
        +--> rejected  drained, shuffle fetches cancelled, spill-catalog
                       entries freed)

Deadlines: ``sched.defaultTimeoutMs`` (0 = none) or the per-submit
``timeout_ms`` arm a ``threading.Timer`` that fires the query's
CancelToken with ``timed_out=True`` — one mechanism covers both a
query stuck in the wait queue and one already running.

Nested execution: a collect issued from INSIDE a running query (a
listener, user code in a pandas UDF callback) executes inline under the
parent's admission slot and token — re-admitting it would deadlock a
``maxConcurrent=1`` engine on its own child.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Any, Dict, Optional

from collections import deque

from spark_rapids_tpu_torch.obs import accounting as obsacct
from spark_rapids_tpu_torch.obs import compile as obscompile
from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.sched import cancel as _cancel
from spark_rapids_tpu_torch.sched.admission import (AdmissionController,
                                              AdmissionRequest,
                                              EstimateBook,
                                              plan_shape_key)


class QueryState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SUCCESS = "success"
    FAILED = "failed"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"


class QueryFuture:
    """Handle to one submitted query.

    ``result(timeout)`` blocks for completion and re-raises the query's
    own exception; a ``timeout`` elapsing raises the stdlib
    :class:`TimeoutError` WITHOUT cancelling the query (call
    ``cancel()`` for that).  ``profile`` carries the QueryProfile once
    the query completes (None while running or when
    ``obs.profile.enabled=false``)."""

    def __init__(self, query_id: int, token: _cancel.CancelToken):
        self.query_id = query_id
        self.token = token
        self._cond = threading.Condition()
        self._state = QueryState.QUEUED
        self._result = None
        self._error: Optional[BaseException] = None
        self.profile = None
        self.queue_wait_ns = 0
        # single-flight wiring (sched.dedup.*): followers carry the
        # leader's query id; both leader and followers hold their
        # _Flight so cancel() can route through promotion/detachment
        self.dedup_of: Optional[int] = None
        self._flight = None
        self._timer = None
        self._submitted_ns = time.monotonic_ns()

    # -- inspection ----------------------------------------------------------
    @property
    def state(self) -> QueryState:
        with self._cond:
            return self._state

    def done(self) -> bool:
        with self._cond:
            return self._state not in (QueryState.QUEUED,
                                       QueryState.RUNNING)

    def cancelled(self) -> bool:
        with self._cond:
            return self._state in (QueryState.CANCELLED,
                                   QueryState.TIMED_OUT)

    # -- control -------------------------------------------------------------
    def cancel(self, reason: str = "cancelled by user") -> bool:
        """Fire the query's CancelToken.  True when the query had not
        completed yet (cancellation will take effect at its next
        checkpoint); False when it already finished.

        Deduped queries route through the flight instead: cancelling a
        follower detaches it and leaves the flight running; cancelling
        a leader that has followers detaches the leader and promotes a
        follower (the execution itself is never killed while anyone
        still wants the result)."""
        if self.done():
            return False
        fl = self._flight
        if fl is not None:
            return fl.service._cancel_via_flight(self, reason)
        self.token.cancel(reason)
        return True

    def result(self, timeout: Optional[float] = None):
        with self._cond:
            if not self._cond.wait_for(self.done, timeout=timeout):
                raise TimeoutError(
                    f"query {self.query_id} still "
                    f"{self._state.value} after {timeout}s")
            if self._error is not None:
                raise self._error
            return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        with self._cond:
            if not self._cond.wait_for(self.done, timeout=timeout):
                raise TimeoutError(
                    f"query {self.query_id} still "
                    f"{self._state.value} after {timeout}s")
            return self._error

    # -- service side --------------------------------------------------------
    def _set_running(self) -> None:
        with self._cond:
            if self._state is QueryState.QUEUED:
                self._state = QueryState.RUNNING

    def _finish(self, state: QueryState, result=None,
                error: Optional[BaseException] = None,
                profile=None) -> None:
        with self._cond:
            if self._state not in (QueryState.QUEUED,
                                   QueryState.RUNNING):
                # first terminal state wins: a leader detached by
                # cancel() keeps CANCELLED even though its execution
                # thread later lands SUCCESS for the flight's followers
                return
            self._state = state
            self._result = result
            self._error = error
            if profile is not None:
                self.profile = profile
            self._cond.notify_all()


class _Flight:
    """One in-flight execution of a (digest, output-names) key: the
    leader future whose thread actually runs the plan, plus follower
    futures that resolve from the leader's execution outcome."""

    __slots__ = ("key", "leader", "exec_qid", "followers", "done",
                 "promoted_to", "service", "settled_state",
                 "settled_result", "settled_error", "chunk_feed",
                 "had_followers")

    def __init__(self, key, leader: QueryFuture, exec_qid: int,
                 service: "QueryService"):
        self.key = key
        self.leader = leader
        self.exec_qid = exec_qid
        self.followers: list = []
        self.done = False
        self.promoted_to: Optional[int] = None
        self.service = service
        self.settled_state: Optional[QueryState] = None
        self.settled_result = None
        self.settled_error: Optional[BaseException] = None
        # serving-tier chunk relay (serve/server.py _ChunkFeed): the
        # leader's streamer publishes encoded result chunks here so
        # follower streams send per-chunk in leader lockstep instead of
        # re-encoding after the whole flight settles.  had_followers
        # stays True once anyone joined — the leader only pays the
        # chunk-buffer memory when dedup actually occurred
        self.chunk_feed = None
        self.had_followers = False


class QueryService:
    """One per TpuSparkSession (see module docstring)."""

    def __init__(self, session):
        from spark_rapids_tpu_torch import config as cfg
        self._session = session
        conf = session.conf
        budget = int(conf.get(cfg.SCHED_MEMORY_BUDGET))
        if budget <= 0:
            budget = self._derived_budget()
        self.memory_budget = budget
        self.max_concurrent = int(conf.get(cfg.SCHED_MAX_CONCURRENT))
        self.default_timeout_ms = int(
            conf.get(cfg.SCHED_DEFAULT_TIMEOUT_MS))
        self._default_estimate = int(
            conf.get(cfg.SCHED_QUERY_ESTIMATE_BYTES))
        from spark_rapids_tpu_torch.mem import spill
        self.controller = AdmissionController(
            budget, self.max_concurrent,
            max_queued=int(conf.get(cfg.SCHED_MAX_QUEUED)),
            pressure_cb=spill.handle_memory_pressure)
        self.book = EstimateBook()
        self._tls = threading.local()
        # live query table (the /queries telemetry surface): every
        # submitted future while queued/running, plus a bounded
        # recently-completed window
        self._track_lock = threading.Lock()
        self._active: Dict[int, Dict[str, Any]] = {}
        self._recent: "deque" = deque(maxlen=64)
        # single-flight registry: (digest, output names) -> _Flight
        self.dedup_enabled = bool(conf.get(cfg.SCHED_DEDUP_ENABLED))
        self._flights: Dict[Any, _Flight] = {}
        self._flights_lock = threading.Lock()

    def _derived_budget(self) -> int:
        """Default budget: 0.9 of the session's CUDA device memory, 8 GiB
        on the CPU (``mem/device.memory_budget``, the grace join's
        derivation)."""
        from spark_rapids_tpu_torch.mem.device import memory_budget
        return memory_budget(self._session.device)

    # -- estimates -----------------------------------------------------------
    def _estimate(self, plan, explicit: Optional[int]) -> int:
        """Working-set estimate in bytes: explicit per-submit override >
        refined observation for this plan shape > conservative
        derivation (batch size x concurrent scan/shuffle depth), all
        capped at the budget so a single query always remains
        admissible."""
        from spark_rapids_tpu_torch import config as cfg
        if explicit is not None:
            return min(max(0, int(explicit)), self.memory_budget)
        if self._default_estimate > 0:
            # an operator-pinned fixed estimate beats refinement
            return min(self._default_estimate, self.memory_budget)
        refined = self.book.estimate(plan_shape_key(plan))
        if refined is not None:
            return min(refined, self.memory_budget)
        conf = self._session.conf
        depth = (int(conf.get(cfg.CONCURRENT_TPU_TASKS)) +
                 int(conf.get(cfg.SCAN_PREFETCH_DEPTH)))
        derived = int(conf.get(cfg.BATCH_SIZE_BYTES)) * max(1, depth)
        # join shapes hold a gathered build side (plus the skew/grace
        # planes' buffered buckets) on top of the streaming working set:
        # pad the unrefined derivation per join so first-run admission
        # doesn't overcommit — observed high-water refinement takes over
        # from the second run of the shape
        joins = self._count_joins(plan)
        if joins:
            derived *= 1 + min(joins, 3)
        return min(derived, self.memory_budget)

    @classmethod
    def _count_joins(cls, plan) -> int:
        n = 1 if type(plan).__name__ in ("Join", "AsOfJoin") else 0
        return n + sum(cls._count_joins(c)
                       for c in getattr(plan, "children", ()))

    def _observe(self, plan, hwm_bytes: int) -> None:
        self.book.record(plan_shape_key(plan), hwm_bytes)

    def has_live_queries(self) -> bool:
        """True while any query is queued or running — the signal the
        low-priority background services (sched/precompile replay, the
        serve incremental refresher) yield to."""
        with self._track_lock:
            return bool(self._active)

    # -- live query table (the /queries telemetry surface) -------------------
    def _track(self, fut: QueryFuture, req: AdmissionRequest,
               meta: Optional[Dict[str, Any]] = None) -> None:
        with self._track_lock:
            self._active[fut.query_id] = {
                "future": fut, "request": req, "meta": dict(meta or {}),
                "submitted_unix": time.time()}

    def _untrack(self, fut: QueryFuture) -> None:
        with self._track_lock:
            info = self._active.pop(fut.query_id, None)
            if info is not None:
                info["finished_unix"] = time.time()
                # freeze to the scalar row NOW: keeping the future
                # would pin its materialized result table (and
                # span-laden profile) in the recent window for up to
                # 64 queries after the caller dropped it
                self._recent.append(self._table_row(info))

    @staticmethod
    def _table_row(info: Dict[str, Any]) -> Dict[str, Any]:
        fut, req = info["future"], info["request"]
        meta = info.get("meta") or {}
        row = {
            "query_id": fut.query_id,
            "state": fut.state.value,
            "priority": req.priority,
            "estimate_bytes": req.estimate,
            "queue_wait_ms": round(req.queue_wait_ns / 1e6, 3),
            "submitted_unix": info["submitted_unix"],
            # serving attribution: which client session/address this
            # query belongs to (None for in-process submissions), and
            # the canonical plan digest (plan/digest.py)
            "session_id": meta.get("session_id"),
            "client_addr": meta.get("client_addr"),
            "plan_digest": meta.get("plan_digest"),
        }
        if meta.get("dedup_of") is not None:
            row["deduped"] = True
            row["leader_query_id"] = meta["dedup_of"]
        # compile attribution (obs/compile.py): null when zero, so
        # compile-bound outliers stand out in the table; the same
        # shared derivation feeds the slow-query JSONL
        row.update(obscompile.row_fields(fut.query_id))
        fin = info.get("finished_unix")
        if fin is not None:
            row["finished_unix"] = fin
            row["wall_s"] = round(fin - info["submitted_unix"], 4)
            err = fut._error
            if err is not None:
                row["error"] = f"{type(err).__name__}: {err}"
        return row

    def query_table(self) -> list:
        """Queued/running queries plus the recently-completed window,
        as JSON-friendly rows (state, priority, admitted estimate,
        queue wait) — the ``/queries`` endpoint payload.  Completed
        rows are pre-frozen scalar snapshots (see ``_untrack``)."""
        with self._track_lock:
            live = sorted(self._active.values(),
                          key=lambda i: i["future"].query_id)
            done = list(self._recent)
        return [self._table_row(i) for i in live] + done

    # -- submission ----------------------------------------------------------
    def submit(self, plan, priority: int = 0,
               timeout_ms: Optional[int] = None,
               estimate_bytes: Optional[int] = None,
               meta: Optional[Dict[str, Any]] = None) -> QueryFuture:
        """``meta`` carries serving attribution (``session_id``,
        ``client_addr`` — serve/server.py) into the live query table,
        the QueryProfile and the slow-query log; in-process submissions
        leave it None."""
        reg = obsreg.get_registry()
        qid = self._session._next_query_id()
        meta = dict(meta or {})
        if "plan_digest" not in meta:
            # the serving tier already digested the plan for its
            # result-cache key and passes it in meta — don't walk the
            # plan a second time on its behalf; one fingerprint walk
            # yields both the digest and the dedup admissibility
            from spark_rapids_tpu_torch.plan.digest import plan_fingerprint
            try:
                fp = plan_fingerprint(plan)
                meta["plan_digest"] = fp.digest
                meta.setdefault("plan_cacheable", fp.cacheable)
            except Exception:
                meta["plan_digest"] = None
                meta["plan_cacheable"] = False
        digest = meta["plan_digest"]
        # compile observatory: bind qid -> digest so CompileEvents
        # fired on any thread carrying this query's token are stamped
        # with both (obs/compile.py; compiles inside a NESTED query
        # attribute to the parent, whose token those threads carry)
        obscompile.register_query(qid, digest)
        # resource ledger: bind qid -> tenant (session x template |
        # digest).  A coalesced batch execution registers with
        # hold=True so its bill stays un-folded until the batcher
        # settles it across the member tenants (obs/accounting.py).
        obsacct.register_query(
            qid, session_id=meta.get("session_id"),
            template=meta.get("statement_template"),
            plan_digest=digest,
            hold=bool(meta.get("batched_statements")))
        # nested collect inside a running query: execute inline under
        # the parent's slot/token (re-admission would self-deadlock)
        if getattr(self._tls, "in_query", False):
            tok = _cancel.current() or _cancel.CancelToken(qid)
            fut = QueryFuture(qid, tok)
            fut._set_running()
            # nested runs ride the live table too (zero-estimate: they
            # execute under the parent's admission slot)
            self._track(fut, AdmissionRequest(qid, 0, priority=priority,
                                              token=tok), meta)
            try:
                table, prof = self._session._execute_attributed(
                    plan, query_id=qid,
                    sched_extra=self._sched_extra_base(
                        meta, {"sched.nested": 1}),
                    plan_digest=digest)
            except BaseException as e:
                fut._finish(QueryState.FAILED, error=e,
                            profile=self._session.query_profile(qid))
                obscompile.finish_query(qid)
                obsacct.finish_query(qid)
                self._untrack(fut)
                raise
            fut._finish(QueryState.SUCCESS, result=table, profile=prof)
            obscompile.finish_query(qid)
            obsacct.finish_query(qid)
            self._untrack(fut)
            return fut
        reg.inc("sched.submitted")
        token = _cancel.CancelToken(qid)
        fut = QueryFuture(qid, token)
        ms = self.default_timeout_ms if timeout_ms is None \
            else int(timeout_ms)
        # single-flight: identical deterministic plans already in
        # flight are joined, not re-executed.  The key must include the
        # output names — the digest is alias-insensitive (two queries
        # differing only in output labels share kernels but not result
        # schemas), exactly the result cache's (digest, names) rule.
        if (self.dedup_enabled and digest is not None
                and meta.get("plan_cacheable")
                and not meta.pop("no_dedup", False)):
            key = self._flight_key(plan, digest)
            if key is not None:
                if self._join_or_lead(fut, key, priority, ms, meta):
                    return fut
                reg.inc("sched.dedup.flights")
        req = AdmissionRequest(
            qid, self._estimate(plan, estimate_bytes),
            priority=priority, token=token)
        self._track(fut, req, meta)
        obsrec.record_event("sched.submitted", query=qid,
                            priority=req.priority,
                            estimate_bytes=req.estimate)
        timer = None
        if ms and ms > 0:
            timer = threading.Timer(
                ms / 1e3, token.cancel,
                kwargs={"reason": f"deadline {ms}ms exceeded",
                        "timed_out": True})
            timer.daemon = True
            timer.start()
        t = threading.Thread(target=self._run,
                             args=(fut, plan, req, timer, meta),
                             name=f"sched-q{qid}", daemon=True)
        t.start()
        return fut

    @staticmethod
    def _flight_key(plan, digest: str):
        try:
            return (digest, tuple(plan.schema.names))
        except Exception:
            return None

    def _join_or_lead(self, fut: QueryFuture, key, priority: int,
                      ms: int, meta: Dict[str, Any]) -> bool:
        """Atomically join an existing live flight as a follower (True)
        or install ``fut`` as the leader of a new flight (False).
        Follower registration — tracking included — happens under the
        flights lock so a settling flight can never miss it."""
        with self._flights_lock:
            fl = self._flights.get(key)
            if (fl is None or fl.done
                    or fl.leader.token.is_cancelled):
                nfl = _Flight(key, fut, fut.query_id, self)
                fut._flight = nfl
                self._flights[key] = nfl
                return False
            fut.dedup_of = fl.exec_qid
            fut._flight = fl
            fmeta = dict(meta)
            fmeta["dedup_of"] = fl.exec_qid
            # zero-estimate: a follower consumes no admission budget
            self._track(fut, AdmissionRequest(fut.query_id, 0,
                                              priority=priority,
                                              token=fut.token), fmeta)
            fl.followers.append(fut)
            fl.had_followers = True
        obsreg.get_registry().inc("sched.dedup.hits")
        obsrec.record_event("sched.dedup.joined", query=fut.query_id,
                            leader=fut.dedup_of)
        if ms and ms > 0:
            fut._timer = threading.Timer(
                ms / 1e3, self._timeout_follower, args=(fut, ms))
            fut._timer.daemon = True
            fut._timer.start()
        return True

    def _timeout_follower(self, fut: QueryFuture, ms: int) -> None:
        fl = fut._flight
        with self._flights_lock:
            if fl.done or fut not in fl.followers:
                return
            fl.followers.remove(fut)
        obsreg.get_registry().inc("sched.timedOut")
        self._finish_follower(
            fut, QueryState.TIMED_OUT, None,
            _cancel.QueryTimeoutError(
                f"query {fut.query_id}: deadline {ms}ms exceeded "
                f"waiting on deduped flight {fl.exec_qid}"))

    def _cancel_via_flight(self, fut: QueryFuture, reason: str) -> bool:
        """Flight-aware cancel (see QueryFuture.cancel)."""
        fl = fut._flight
        reg = obsreg.get_registry()
        promoted = None
        with self._flights_lock:
            if fl.done:
                return False
            if fut.dedup_of is not None:
                # follower: detach; the flight keeps running
                if fut not in fl.followers:
                    return False
                fl.followers.remove(fut)
                mode = "follower"
            elif fl.followers:
                # leader with followers: detach the leader, promote the
                # first follower as the flight's nominal owner — the
                # execution itself continues untouched
                promoted = fl.followers[0]
                fl.promoted_to = promoted.query_id
                mode = "leader"
            else:
                mode = "kill"
        if mode == "kill":
            fut.token.cancel(reason)
            return True
        err = _cancel.QueryCancelledError(
            f"query {fut.query_id}: {reason}")
        if mode == "follower":
            reg.inc("sched.cancelled")
            self._finish_follower(fut, QueryState.CANCELLED, None, err)
            return True
        reg.inc("sched.cancelled")
        reg.inc("sched.dedup.promotions")
        obsrec.record_event("sched.dedup.promoted", query=fl.exec_qid,
                            cancelled_leader=fut.query_id,
                            promoted_follower=promoted.query_id)
        # the leader future detaches (first terminal state wins); its
        # _run thread later settles the flight with the execution's
        # real outcome for the followers
        fut._finish(QueryState.CANCELLED, error=err)
        return True

    def _finish_exec(self, fut: QueryFuture, state: QueryState,
                     result=None,
                     error: Optional[BaseException] = None,
                     profile=None) -> None:
        """Terminal finish on the execution (leader) path: resolve the
        leader future (unless it detached first) and fan the execution
        outcome to every follower of its flight."""
        fut._finish(state, result=result, error=error, profile=profile)
        fl = fut._flight
        if fl is None:
            return
        with self._flights_lock:
            fl.done = True
            fl.settled_state = state
            fl.settled_result = result
            fl.settled_error = error
            if self._flights.get(fl.key) is fl:
                del self._flights[fl.key]
            followers = list(fl.followers)
            fl.followers = []
        if followers:
            # fair-share the leader's bill across the joined tenants
            # BEFORE any record folds (the leader's own fold happens in
            # _run's finally, after this) — dedup must not hide a
            # tenant's true consumption
            obsacct.settle_flight(fut.query_id,
                                  [f.query_id for f in followers])
        for f in followers:
            self._finish_follower(f, state, result, error)

    def _finish_follower(self, fut: QueryFuture, state: QueryState,
                         result, error) -> None:
        if fut._timer is not None:
            fut._timer.cancel()
        prof = None
        try:
            prof = self._session._record_dedup_follower(
                fut.query_id, fut.dedup_of, state, error,
                self._meta_of(fut),
                max(0, time.monotonic_ns() - fut._submitted_ns),
                result)
        except Exception:
            prof = None
        fut._finish(state, result=result, error=error, profile=prof)
        obscompile.finish_query(fut.query_id)
        obsacct.finish_query(fut.query_id)
        self._untrack(fut)
        obsrec.record_event("sched.finished", query=fut.query_id,
                            state=fut.state.value)

    def _meta_of(self, fut: QueryFuture) -> Dict[str, Any]:
        with self._track_lock:
            info = self._active.get(fut.query_id)
            return dict(info.get("meta") or {}) if info else {}

    @staticmethod
    def _sched_extra_base(meta: Dict[str, Any],
                          extra: Optional[Dict[str, Any]] = None
                          ) -> Dict[str, Any]:
        out = dict(extra or {})
        if meta.get("session_id") is not None:
            out["sched.sessionId"] = meta["session_id"]
        if meta.get("client_addr") is not None:
            out["sched.clientAddr"] = meta["client_addr"]
        return out

    # -- the worker ----------------------------------------------------------
    def _run(self, fut: QueryFuture, plan, req: AdmissionRequest,
             timer, meta: Optional[Dict[str, Any]] = None) -> None:
        reg = obsreg.get_registry()
        meta = dict(meta or {})
        self._tls.in_query = True
        tracker = None
        try:
            try:
                slot = self.controller.acquire(req)
            except _cancel.QueryCancelledError as e:
                self._finish_exec(
                    fut, QueryState.TIMED_OUT
                    if isinstance(e, _cancel.QueryTimeoutError)
                    else QueryState.CANCELLED, error=e)
                return
            except BaseException as e:   # rejected / internal
                self._finish_exec(fut, QueryState.FAILED, error=e)
                from spark_rapids_tpu_torch.sched.admission import \
                    QueryRejectedError
                if isinstance(e, QueryRejectedError):
                    # queue-full rejection happens BEFORE admission:
                    # without this hook the flight recorder and
                    # slow-query log never hear about the query at all
                    # — serving overload would be undiagnosable
                    self._session._record_rejection(fut.query_id, e,
                                                    req, meta)
                return
            fut.queue_wait_ns = req.queue_wait_ns
            # queue wait: global counter + tenant ledger (same n) +
            # SLO bucket observation — the saturation signals
            reg.inc("sched.queueWaitNs", req.queue_wait_ns)
            obsacct.charge_qid(fut.query_id, "sched.queueWaitNs",
                               req.queue_wait_ns)
            obsacct.observe_slo("slo.queueWaitMs",
                                req.queue_wait_ns / 1e6,
                                template=meta.get("statement_template"))
            fut._set_running()
            sched_extra = self._sched_extra_base(meta, {
                "sched.queueWaitNs": req.queue_wait_ns,
                "sched.estimateBytes": req.estimate,
                "sched.priority": req.priority,
            })
            try:
                from spark_rapids_tpu_torch.mem import spill
                if spill.is_enabled():
                    tracker = spill.get_catalog().track_high_water()
                with slot, _cancel.install(fut.token):
                    table, prof = self._session._execute_attributed(
                        plan, query_id=fut.query_id,
                        sched_extra=sched_extra,
                        plan_digest=meta.get("plan_digest"))
            except _cancel.QueryCancelledError as e:
                timed = isinstance(e, _cancel.QueryTimeoutError) or \
                    fut.token.timed_out
                reg.inc("sched.timedOut" if timed else "sched.cancelled")
                self._finish_exec(
                    fut, QueryState.TIMED_OUT if timed
                    else QueryState.CANCELLED, error=e,
                    profile=self._session.query_profile(fut.query_id))
                return
            except BaseException as e:
                reg.inc("sched.failed")
                self._finish_exec(
                    fut, QueryState.FAILED, error=e,
                    profile=self._session.query_profile(fut.query_id))
                return
            reg.inc("sched.completed")
            if tracker is not None:
                hw = tracker.delta()
                self._observe(plan, hw)
                if hw:
                    # HBM residency bill: peak-growth bytes x query
                    # wall — the "who parked on the chip" metric
                    wall_s = max(0.0, (time.monotonic_ns()
                                       - fut._submitted_ns) / 1e9)
                    bs = float(hw) * wall_s
                    reg.inc("hbm.byteSeconds", bs)
                    obsacct.charge_qid(fut.query_id,
                                       "hbm.byteSeconds", bs)
            # corpus emission BEFORE the future resolves: a caller that
            # observes result() may immediately read the corpus file,
            # and this thread's finally block runs after the wake-up
            obscompile.finish_query(fut.query_id)
            self._finish_exec(fut, QueryState.SUCCESS, result=table,
                              profile=prof)
        finally:
            if tracker is not None:
                tracker.close()
            if timer is not None:
                timer.cancel()
            self._tls.in_query = False
            # backstop for the failure/cancel exits (idempotent: the
            # corpus dedups on digest), and attribution freeze BEFORE
            # the table row is frozen by _untrack (which reads the
            # per-query stats)
            obscompile.finish_query(fut.query_id)
            # in-process e2e latency (serve requests observe at the
            # serve layer with their own t0 — never both); then fold
            # the ledger bill, AFTER _finish_exec ran settle_flight
            if meta.get("session_id") is None:
                obsacct.observe_slo(
                    "slo.latencyMs",
                    max(0, time.monotonic_ns() - fut._submitted_ns)
                    / 1e6)
            obsacct.finish_query(fut.query_id)
            self._untrack(fut)
            obsrec.record_event("sched.finished", query=fut.query_id,
                                state=fut.state.value)
