"""Always-on operational telemetry endpoint (opt-in HTTP server).

The per-query obs layer (profiles, recorder) is post-hoc; a long-lived multi-tenant
engine (ROADMAP item 1) needs its live state scrapeable while queries
run.  ``ObsHttpServer`` serves, from a background daemon thread:

  ``GET /metrics``          Prometheus text exposition (version 0.0.4)
                            of the process MetricsRegistry — counters,
                            gauges, histograms (as ``_count``/``_sum``
                            summaries) — with the scheduler's live
                            queued/running/admitted-bytes gauges
                            refreshed at scrape time.
  ``GET /queries``          JSON: the QueryService's live table —
                            queued/running plus a bounded
                            recently-completed window, with states,
                            priorities, admitted estimates and queue
                            wait (sched/service.QueryService
                            .query_table).
  ``GET /profiles/<qid>``   QueryProfile JSON from the session's
                            profile ring; 404 once evicted or unknown.
  ``GET /compiles``         compile-observatory ledger (obs/compile
                            .py): totals, the newest CompileEvents
                            (family, signature, tier, wall, query id +
                            plan digest), per-query attribution, the
                            shape-churn report ranked by signature
                            cardinality with width-bucketing collapse
                            estimates, and the kernel-backend
                            selection counters.  ``?n=`` bounds the
                            event count (default 256).
  ``GET /resultcache``      JSON: per-entry inspection of the serving
                            result cache (serve/result_cache.py) —
                            digest prefix, output names, bytes, age,
                            source count, and the entry's CURRENT
                            stamp drift (rewritten/deleted file
                            counts), so operators can see what the
                            incremental refresher keeps warm.
  ``GET /tenants``          JSON: the per-tenant ResourceLedger table
                            (obs/accounting.py) — kernel dispatches,
                            compile wall, scan/shuffle bytes, cache
                            hits/misses, HBM byte-seconds and queue
                            wait attributed to (session, workload),
                            single-flight followers and batched
                            members billed their fair share.
  ``GET /slo``              JSON: p50/p95/p99 interpolated from the
                            fixed-boundary SLO bucket histograms
                            (e2e latency, queue wait, first chunk;
                            global + per statement template), plus
                            the template-key legend.
  ``GET /healthz``          liveness probe.

Off by default (``obs.http.enabled=false``): nothing binds a socket
and no code on the query path changes.  The endpoint is read-only and
unauthenticated — it binds loopback unless ``obs.http.host`` says
otherwise.

Copied whole from ``spark_rapids_tpu/obs/server.py``, its imports
retargeted, but for ``/resultcache``: the serving tier (``serve/``) is
not ported, so the route answers what the reference answers for an
empty result cache, ``{"entries": [], "stats": {"entries": 0,
"bytes": 0}}``.  The serve gauges and ``/healthz``'s serve state read
``session.serve_server``, which a port session does not have yet.  The
metric names keep the reference's ``spark_rapids_tpu_`` prefix, so one
scrape configuration reads both packages.
"""

from __future__ import annotations

import json
import re
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from spark_rapids_tpu_torch.obs import registry as obsreg

_NAME_PREFIX = "spark_rapids_tpu_"
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_PREFIX + _SANITIZE.sub("_", name)


def _prom_value(v: Any) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _prom_le(bound: float) -> str:
    f = float(bound)
    if f == int(f):
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: Dict[str, Any]) -> str:
    """Render a MetricsRegistry snapshot as Prometheus text exposition
    (one ``# TYPE`` line per family; summary histograms surface as
    ``_count``/``_sum`` plus ``_min``/``_max`` gauges; bucketed SLO
    histograms render as REAL ``histogram`` families with cumulative
    ``_bucket{le=...}`` series ending in ``le="+Inf"``)."""
    lines = []
    for name in sorted(snapshot.get("counters", {})):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_prom_value(snapshot['counters'][name])}")
    for name in sorted(snapshot.get("gauges", {})):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_prom_value(snapshot['gauges'][name])}")
    for name in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][name]
        n = _prom_name(name)
        lines.append(f"# TYPE {n} summary")
        lines.append(f"{n}_count {_prom_value(h.get('count', 0))}")
        lines.append(f"{n}_sum {_prom_value(h.get('sum', 0))}")
        for bound in ("min", "max"):
            if h.get(bound) is not None:
                lines.append(f"# TYPE {n}_{bound} gauge")
                lines.append(f"{n}_{bound} {_prom_value(h[bound])}")
    for name in sorted(snapshot.get("bucket_histograms", {})):
        h = snapshot["bucket_histograms"][name]
        n = _prom_name(name)
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for bound, c in zip(h["bounds"], h["counts"]):
            cum += c
            lines.append(
                f'{n}_bucket{{le="{_prom_le(bound)}"}} {cum}')
        lines.append(
            f'{n}_bucket{{le="+Inf"}} {_prom_value(h["count"])}')
        lines.append(f"{n}_sum {_prom_value(h.get('sum', 0))}")
        lines.append(f"{n}_count {_prom_value(h.get('count', 0))}")
    return "\n".join(lines) + "\n"


_SAMPLE_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [-+0-9.eEnaif]+$")


def parse_prometheus(text: str) -> Dict[str, float]:
    """Validate Prometheus text exposition and return the unlabeled
    samples as ``{name: value}``.  Raises ``ValueError`` on a malformed
    sample line or an empty exposition — the single validator the tests
    and the ci.sh scrape both lean on, so the format check cannot
    silently diverge from the renderer."""
    samples: Dict[str, float] = {}
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if not _SAMPLE_LINE.match(line):
            raise ValueError(f"bad exposition line: {line!r}")
        n += 1
        if "{" not in line:
            name, value = line.split(" ", 1)
            samples[name] = float(value)
    if n == 0:
        raise ValueError("empty exposition")
    return samples


_LE_LABEL = re.compile(r'le="([^"]+)"')


def lint_exposition(text: str) -> Dict[str, float]:
    """Strict structural lint of a Prometheus exposition, on top of the
    per-line validation in :func:`parse_prometheus`:

      * every sample's family has a preceding ``# TYPE`` line (bucket /
        sum / count samples resolve to their ``histogram`` family, and
        sum / count also to a ``summary`` family);
      * every ``histogram`` family carries ``_bucket`` series that are
        cumulative (monotone non-decreasing in ``le`` order), end with
        ``le="+Inf"``, and the +Inf bucket equals ``_count``.

    Raises ``ValueError`` on any violation; returns the unlabeled
    samples like ``parse_prometheus``.  ci.sh runs this on EVERY
    scrape so a malformed family cannot ship behind a passing smoke.
    """
    samples = parse_prometheus(text)
    types: Dict[str, str] = {}
    hist_buckets: Dict[str, list] = {}
    hist_counts: Dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"bad TYPE line: {line!r}")
            types[parts[2]] = parts[3]
            continue
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            if not name.endswith(suffix):
                continue
            base_type = types.get(name[: -len(suffix)])
            if base_type == "histogram" or \
                    (base_type == "summary" and suffix != "_bucket"):
                family = name[: -len(suffix)]
                break
        if family not in types:
            raise ValueError(f"sample without # TYPE: {line!r}")
        if types[family] == "histogram":
            value = float(line.rsplit(" ", 1)[1])
            if name == family + "_bucket":
                m = _LE_LABEL.search(line)
                if not m:
                    raise ValueError(f"bucket without le=: {line!r}")
                hist_buckets.setdefault(family, []).append(
                    (m.group(1), value))
            elif name == family + "_count":
                hist_counts[family] = value
    for family, t in types.items():
        if t != "histogram":
            continue
        buckets = hist_buckets.get(family)
        if not buckets:
            raise ValueError(f"histogram {family} has no _bucket series")
        if buckets[-1][0] != "+Inf":
            raise ValueError(
                f"histogram {family} buckets do not end at le=+Inf")
        prev = -1.0
        for le, v in buckets:
            if v < prev:
                raise ValueError(
                    f"histogram {family} buckets not cumulative at "
                    f"le={le}")
            prev = v
        if family not in hist_counts:
            raise ValueError(f"histogram {family} missing _count")
        if buckets[-1][1] != hist_counts[family]:
            raise ValueError(
                f"histogram {family} +Inf bucket {buckets[-1][1]} != "
                f"_count {hist_counts[family]}")
    return samples


class ObsHttpServer:
    """One per session when ``obs.http.enabled=true`` (api/session.py
    keeps it on ``session.obs_server``); ``port`` is the bound port
    (ephemeral when ``obs.http.port=0``)."""

    def __init__(self, session, host: str = "127.0.0.1",
                 port: int = 0):
        # weakref: the serving thread must not pin the session (and its
        # profile ring full of results) forever — when the session is
        # collected, the finalizer stops the server and frees the port
        self._session_ref = weakref.ref(session)
        handler = self._make_handler()
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"obs-http-{self.port}", daemon=True)
        self._thread.start()
        self._finalizer = weakref.finalize(
            session, ObsHttpServer._shutdown_httpd, self._httpd)

    @staticmethod
    def _shutdown_httpd(httpd) -> None:
        try:
            httpd.shutdown()
            httpd.server_close()
        except OSError:
            pass

    def _session_obj(self):
        """The served session, or None once it was collected (the
        finalizer is stopping the server; a racing request gets 503)."""
        return self._session_ref()

    # -- route payloads ----------------------------------------------------
    def _metrics_text(self, session) -> str:
        reg = obsreg.get_registry()
        try:
            # live scheduler gauges at scrape time: a scrape between
            # queries must still see the current queue/running levels,
            # not the last admission's stale publish
            st = session.scheduler.controller.stats()
            reg.set_gauge("sched.queued", st["queued"])
            reg.set_gauge("sched.running", st["running"])
            reg.set_gauge("sched.admittedBytes", st["admitted_bytes"])
            # saturation gauge set — the elastic-executor input signal
            # (ROADMAP item 2): queue depth plus admitted/running as
            # fractions of their budgets, refreshed at scrape time so a
            # scaler polling /metrics always sees the live level
            ctrl = session.scheduler.controller
            reg.set_gauge("sched.queueDepth", st["queued"])
            budget = float(getattr(ctrl, "memory_budget", 0) or 0)
            reg.set_gauge(
                "sched.admittedFraction",
                (st["admitted_bytes"] / budget) if budget > 0 else 0.0)
            slots = float(getattr(ctrl, "max_concurrent", 0) or 0)
            reg.set_gauge(
                "sched.runningFraction",
                (st["running"] / slots) if slots > 0 else 0.0)
        except Exception:
            pass
        try:
            # serving-tier gauges, refreshed at scrape time like the
            # scheduler's (a scrape between requests must see current
            # session/cache levels, not the last mutation's publish)
            srv = getattr(session, "serve_server", None)
            if srv is not None:
                from spark_rapids_tpu_torch.serve import result_cache
                reg.set_gauge("serve.activeSessions",
                              len(srv.sessions()))
                rc = result_cache.stats()
                reg.set_gauge("serve.resultCacheBytes", rc["bytes"])
                reg.set_gauge("serve.resultCacheEntries", rc["entries"])
                reg.set_gauge("serve.resultCache.oldestEntryAgeSec",
                              result_cache.oldest_entry_age_s())
                # live leak-audit gauges: connections, streamer
                # threads and the retained-stream resume window (the
                # chaos gate asserts these return to zero after drain)
                leaks = srv.leak_stats()
                reg.set_gauge("serve.connections",
                              leaks["connections"])
                reg.set_gauge("serve.streamerThreads",
                              leaks["streamer_threads"])
                reg.set_gauge("serve.retainedStreams",
                              leaks["retained_streams"])
                reg.set_gauge("serve.retainedStreamBytes",
                              leaks["retained_bytes"])
        except Exception:
            pass
        return render_prometheus(reg.snapshot())

    @staticmethod
    def _resultcache_json() -> str:
        """Per-entry inspection of the serving result cache: the
        reference's payload for an empty cache (serve/ is not ported)."""
        return json.dumps({"entries": [],
                           "stats": {"entries": 0, "bytes": 0}})

    @staticmethod
    def _queries_json(session) -> str:
        return json.dumps(
            {"queries": session.scheduler.query_table()},
            default=str)

    @staticmethod
    def _compiles_json(max_events: int = 256) -> str:
        # function-level imports (the serve.result_cache idiom in
        # _metrics_text): the handler reaches sideways only when the
        # route is actually hit, so the module stays load-order safe
        from spark_rapids_tpu_torch.kernels import backend as kernel_backend
        from spark_rapids_tpu_torch.obs import compile as obscompile
        payload = obscompile.snapshot(max_events=max_events)
        payload["selection"] = kernel_backend.selection_snapshot()
        return json.dumps(payload, default=str)

    @staticmethod
    def _tenants_json() -> str:
        """Resource-ledger table: one row per (session, workload)
        tenant, assembled under the ledger's ONE lock (the /compiles
        idiom) so concurrent scrapes see a consistent snapshot even
        while queries charge mid-flight."""
        from spark_rapids_tpu_torch.obs import accounting as acct
        return json.dumps(acct.snapshot(), default=str)

    @staticmethod
    def _slo_json() -> str:
        """Per-template SLO quantiles interpolated from the bucketed
        histograms (one registry snapshot = one lock), plus the
        template-key legend so short keys resolve back to statement
        text."""
        from spark_rapids_tpu_torch.obs import accounting as acct
        snap = obsreg.get_registry().snapshot()
        hists = {}
        for name, h in sorted(snap.get("bucket_histograms", {}).items()):
            hists[name] = {
                "count": h["count"],
                "sum_ms": h["sum"],
                "p50": obsreg.bucket_quantile(h["bounds"], h["counts"],
                                              0.50),
                "p95": obsreg.bucket_quantile(h["bounds"], h["counts"],
                                              0.95),
                "p99": obsreg.bucket_quantile(h["bounds"], h["counts"],
                                              0.99),
            }
        return json.dumps({"histograms": hists,
                           "bounds_ms": list(obsreg.DEFAULT_MS_BOUNDS),
                           "templates": acct.template_labels()})

    @staticmethod
    def _healthz_json(session) -> str:
        """Liveness + serve-plane lifecycle: a draining or drained
        serve tier used to answer the same body as a live one, so no
        load balancer could take the replica out of rotation before
        the kill — the fleet router keys placement on ``state`` and
        falls back to in-flight draining on ``inflight``."""
        state, inflight = "serving", 0
        try:
            srv = getattr(session, "serve_server", None)
            if srv is not None:
                state = srv.state()
                inflight = srv.inflight_count()
        except Exception:
            pass
        return json.dumps(
            {"ok": True, "state": state, "inflight": inflight,
             "routes": ["/metrics", "/queries", "/profiles/<qid>",
                        "/compiles", "/resultcache", "/tenants",
                        "/slo", "/healthz"]})

    @staticmethod
    def _profile_json(session, qid: int) -> Optional[str]:
        prof = session.query_profile(qid)
        if prof is None:
            return None
        return prof.to_json(indent=None)

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # no stderr chatter per scrape
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "application/json") -> None:
                payload = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type",
                                 ctype + "; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                try:
                    session = server._session_obj()
                    if session is None:
                        self._send(503, json.dumps(
                            {"error": "session gone; server stopping"}))
                        return
                    raw_path, _, query = self.path.partition("?")
                    path = raw_path.rstrip("/") or "/"
                    if path == "/metrics":
                        # version 0.0.4 — the text exposition content
                        # type Prometheus scrapers negotiate
                        self._send(200, server._metrics_text(session),
                                   "text/plain; version=0.0.4")
                    elif path == "/queries":
                        self._send(200, server._queries_json(session))
                    elif path == "/compiles":
                        n = 256
                        for part in query.split("&"):
                            if part.startswith("n=") and \
                                    part[2:].isdigit():
                                n = int(part[2:])
                        self._send(200, server._compiles_json(n))
                    elif path == "/resultcache":
                        self._send(200, server._resultcache_json())
                    elif path == "/tenants":
                        self._send(200, server._tenants_json())
                    elif path == "/slo":
                        self._send(200, server._slo_json())
                    elif path.startswith("/profiles/"):
                        tail = path.rsplit("/", 1)[1]
                        body = (server._profile_json(session, int(tail))
                                if tail.isdigit() else None)
                        if body is None:
                            self._send(404, json.dumps(
                                {"error": f"no profile for {tail!r} "
                                          "(evicted or unknown)"}))
                        else:
                            self._send(200, body)
                    elif path in ("/", "/healthz"):
                        self._send(200, server._healthz_json(session))
                    else:
                        self._send(404, json.dumps(
                            {"error": f"unknown route {path!r}"}))
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:   # a bad scrape must not kill
                    try:                 # the serving thread
                        self._send(500, json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}))
                    except OSError:
                        pass

        return Handler

    def shutdown(self) -> None:
        """Stop serving and release the socket (idempotent; also fired
        automatically when the served session is garbage-collected)."""
        self._shutdown_httpd(self._httpd)
