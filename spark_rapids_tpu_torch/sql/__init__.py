"""SQL front end: ``session.sql("SELECT ...")``.

Ported from ``spark_rapids_tpu/sql/``: SELECT with joins, WHERE, GROUP BY
/ HAVING, ORDER BY / LIMIT, CTEs, UNION [ALL], DISTINCT, CASE, CAST, IN,
BETWEEN, LIKE, prepared-statement parameters and the function registry,
lowered to the same logical plans as the DataFrame API.
"""

from spark_rapids_tpu_torch.sql.parser import parse_sql  # noqa: F401
