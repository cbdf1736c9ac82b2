"""Concurrent query scheduler: async submission, memory-aware
admission control, cooperative cancellation.

The port's copy of ``spark_rapids_tpu/sched/__init__.py``.

Layers (each its own module):

* :mod:`~spark_rapids_tpu_torch.sched.cancel` — per-query
  :class:`CancelToken` + the thread-local checkpoint the exec hot
  paths poll.
* :mod:`~spark_rapids_tpu_torch.sched.queue` — priority + FIFO wait queue.
* :mod:`~spark_rapids_tpu_torch.sched.admission` — memory-budget admission
  (``sched.memoryBudget`` / ``sched.maxConcurrent``) with plan-shape
  estimate refinement, plus the re-entrant device :class:`TaskGate`
  behind ``mem/device.tpu_semaphore``.
* :mod:`~spark_rapids_tpu_torch.sched.service` — per-session
  :class:`QueryService`: ``submit() -> QueryFuture``, deadlines,
  profile attachment; ``DataFrame.collect()`` == ``submit().result()``.
* :mod:`~spark_rapids_tpu_torch.sched.precompile` — the background
  replay of the compile corpus (``sched.precompile.enabled``).
"""

from spark_rapids_tpu_torch.sched.admission import (  # noqa
    AdmissionController, AdmissionRequest, EstimateBook, QueryRejectedError,
    TaskGate, plan_shape_key)
from spark_rapids_tpu_torch.sched.cancel import (  # noqa
    CancelToken, QueryCancelledError, QueryTimeoutError)
from spark_rapids_tpu_torch.sched.service import (  # noqa
    QueryFuture, QueryService, QueryState)
