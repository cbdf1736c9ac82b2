"""The DataFrame API of the port: ``TpuSparkSession``, ``Column``, ``col``,
``lit`` and ``functions`` (the reference's ``spark_rapids_tpu.api``)."""

from spark_rapids_tpu_torch.api.session import TpuSparkSession  # noqa: F401
from spark_rapids_tpu_torch.api.column import Column, col, lit  # noqa: F401
from spark_rapids_tpu_torch.api import functions  # noqa: F401
