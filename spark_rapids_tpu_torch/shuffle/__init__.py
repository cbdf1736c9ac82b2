"""See the package docstring of spark_rapids_tpu_torch."""
