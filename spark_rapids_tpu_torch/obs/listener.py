"""QueryExecutionListener analog (Spark's
``spark.listenerManager.register`` surface).

Copied whole from ``spark_rapids_tpu/obs/listener.py``.

Listeners registered on the session fire after every action:
``on_success(profile)`` with the assembled :class:`QueryProfile` (which
carries the annotated plan), ``on_failure(profile, exception)`` with a
partial profile (``status="failure"``, the error string stamped) and
the raised exception.  Listener exceptions are swallowed (a broken
listener must not fail the query — Spark's ExecutionListenerManager
contract)."""

from __future__ import annotations

from typing import List, Optional


class QueryExecutionListener:
    """Subclass-and-override base; both hooks default to no-ops."""

    def on_success(self, profile) -> None:  # pragma: no cover - default
        pass

    def on_failure(self, profile,
                   exception: BaseException) -> None:  # pragma: no cover
        pass


def notify(listeners: List[QueryExecutionListener], profile,
           exception: Optional[BaseException]) -> None:
    """Fan a finished query out to every listener, swallowing listener
    errors (reported nowhere — the query result must win)."""
    for listener in list(listeners):
        try:
            if exception is None:
                listener.on_success(profile)
            else:
                listener.on_failure(profile, exception)
        except Exception:
            pass
