"""Background precompile service: replay the compile corpus off the
serving path.

Ported from ``spark_rapids_tpu/sched/precompile.py``.  The compile
observatory (obs/compile.py) appends one JSONL record per distinct plan
digest to ``obs.compile.corpusPath``, and, with
``obs.compile.corpusReplay`` on, each program record carries a replay
payload.  The reference's payload is a pickled jax traceable that this
service re-lowers and re-compiles into the persistent XLA cache.  The
port's persistent compile cache is the ``build/`` directory of
``kernels/_build.py``, so its payload names the ``csrc`` libraries the
program's step launched kernels from (``exec/kernel_cache.
_replay_payload``), and replay calls ``kernels/_build.warm`` for each:

  * a library missing from ``build/`` is built with ``nvcc`` and
    WRITTEN, so a corpus alone can warm an empty build directory for a
    fresh process (``built``);
  * a library already in ``build/`` is reopened (``reopened``).

Either way the serving path's first call of that program runs no
``nvcc`` and classifies ``persistent`` (obs/compile.classify_tier).  A
program whose payload is null launched no kernel (every step on the
CPU, and the steps without a hand kernel on the card): it is counted
``skipped``.

Low-priority contract: between programs the service sleeps
``sched.precompile.idleWaitMs`` and, whenever the session's query
service has live (queued or running) queries, it pauses until they
drain.  Replay never touches the in-process kernel cache
(exec/kernel_cache), as the reference's does not.

Registry counters: ``sched.precompile.plans`` / ``.programs`` /
``.warmed`` / ``.skipped`` (no payload) / ``.failed`` / ``.dedup``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg


class PrecompileService:
    """Replays a precompile corpus JSONL (see module docstring).

    ``start()`` launches the replay on a daemon thread (the session
    init path); ``replay()`` runs it synchronously (tests);
    ``wait(timeout)`` blocks until the background replay finishes."""

    def __init__(self, session, corpus_path: str,
                 idle_wait_ms: int = 25):
        self._session = session
        self.corpus_path = str(corpus_path or "")
        self.idle_wait_s = max(0, int(idle_wait_ms)) / 1e3
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # the reference's six counts and wall, and per library replayed
        # whether nvcc ran (built) or the build directory had it
        # (reopened)
        self._stats = {"plans": 0, "programs": 0, "warmed": 0,
                       "skipped": 0, "failed": 0, "dedup": 0,
                       "wall_s": 0.0, "built": 0, "reopened": 0}
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="sched-precompile", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the background replay finishes (True) or the
        timeout elapses (False).  Synchronous ``replay()`` callers
        don't need this."""
        return self._done.wait(timeout)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._stats)

    # -- replay -------------------------------------------------------------
    def _run(self) -> None:
        try:
            self.replay()
        finally:
            self._done.set()

    def _busy(self) -> bool:
        """Live (queued or running) queries in this session's query
        service: the signal replay yields to."""
        try:
            return self._session._query_service.has_live_queries()
        except Exception:
            return False

    def _yield_to_serving(self) -> None:
        while not self._stop and self._busy():
            time.sleep(self.idle_wait_s or 0.005)

    def _bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._stats[name] += n

    def _records(self) -> List[dict]:
        # a DIRECTORY corpus replays every *.jsonl inside it (the fleet
        # warm-join shape); the (key, signature) dedup collapses overlap
        paths: List[str] = []
        if os.path.isdir(self.corpus_path):
            try:
                paths = sorted(
                    os.path.join(self.corpus_path, n)
                    for n in os.listdir(self.corpus_path)
                    if n.endswith(".jsonl"))
            except OSError:
                paths = []
        elif self.corpus_path:
            paths = [self.corpus_path]
        records = []
        for path in paths:
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            records.append(json.loads(line))
                        except Exception:
                            continue      # torn tail line: skip
            except OSError:
                continue
        return records

    def replay(self) -> Dict[str, Any]:
        """Walk the corpus once and warm every replayable program's
        libraries (deduplicated on (key, signature) across records).
        Returns the stats dict; never raises on per-program failures
        (counted as ``failed``)."""
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        from spark_rapids_tpu_torch.kernels import _build
        t0 = time.perf_counter()
        reg = obsreg.get_registry()
        seen = set()
        records = self._records()
        obsrec.record_event("precompile.start", corpus=self.corpus_path,
                            plans=len(records))
        for rec in records:
            if self._stop:
                break
            self._bump("plans")
            reg.inc("sched.precompile.plans")
            for prog in rec.get("programs") or []:
                if self._stop:
                    break
                dedup = (prog.get("key"), prog.get("signature"))
                if dedup in seen:
                    self._bump("dedup")
                    reg.inc("sched.precompile.dedup")
                    continue
                seen.add(dedup)
                self._bump("programs")
                reg.inc("sched.precompile.programs")
                payload = prog.get("replay")
                if not payload:
                    self._bump("skipped")
                    reg.inc("sched.precompile.skipped")
                    continue
                self._yield_to_serving()
                try:
                    spec = kc.load_replay_payload(payload)
                    tiers = [_build.warm(name)
                             for name in spec["libraries"]]
                    self._bump("built", tiers.count("fresh"))
                    self._bump("reopened", tiers.count("persistent"))
                    self._bump("warmed")
                    reg.inc("sched.precompile.warmed")
                except Exception:
                    self._bump("failed")
                    reg.inc("sched.precompile.failed")
                if self.idle_wait_s:
                    time.sleep(self.idle_wait_s)
        with self._lock:
            self._stats["wall_s"] = round(time.perf_counter() - t0, 3)
            stats = dict(self._stats)
        obsrec.record_event("precompile.done", **stats)
        return stats
