#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # every phase, one CUDA card

Phases (any failure exits non-zero):

  1. build   — compile every CUDA source of the port with nvcc, one
               process per source, all started together (kernels/_build.py),
               and print the build time;
  2. parity  — every kernel, through the wrappers the main paths call,
               against its plain torch version on the card: segreduce for
               each type pair x op, sorted and with the fused gather, at
               capacities 2^18, 2^20 and 2^24 over two group-start
               densities, no flag at all and a flag at each tile's end
               (and one segment at 2^24), at 2^20+7 and 1-7 elements, and
               gathered from a longer source; every float sum three times,
               bit for bit; one device launch per call; unpack_bits for
               every width 1-32 at 2^20, 2^22 and a ragged count, fresh and
               into offset slices of a larger array; decode over 4- and
               8-byte dictionaries of 2^7, 2^15 and 2^20 entries at 2^21
               and 2^21+3 rows, keep densities 0.125, 0.25, 0 and 1 and a
               fully dropped range, and codes/keep views at odd offsets;
               decode_str at widths 1, 7, 16, 17, 33, 64 and 256, 2^18 and
               2^18+5 rows, with empty, negative and over-wide lengths,
               byte bases below 0, past the end and at every offset mod 16
               near both ends, over an aligned, an offset and a ragged
               dictionary buffer, all-kept and all-dropped masks and
               views at odd offsets; the run expansion (one launch from the
               run table and the packed bits) for every width 0-32 at
               capacities 2^16-2^22 and a ragged one, with int32 and int64
               rows, over hybrid streams, runs of 1 and bit-packed groups
               at every offset (more rows per tile than shared memory
               holds), one RLE run, shared starts and trimmed page-end
               runs, and an RLE value of 2^30 whose running sum leaves
               int32 (against the golden values), bit for bit; one device
               launch per expand, unpack, decode and decode_str call;
  3. entry   — ``entry(device="cuda")`` against pyarrow on the same table;
  4. q6      — the q6 query at TPC-DS SF10 ``store_sales`` scale
               (28,800,991 rows, 8 partitions) in memory, planned by a port
               session (entry.q6_plan: the upload pruned to four columns,
               the filter fused into TpuHashAggregateExec), checked against
               an independent pyarrow group_by, with its wall and sections;
  5. q6-parquet — the same rows written as 8 Parquet files (the reference
               bench's dataset) and scanned by the fused Parquet decode
               with the filter the planner pushes into the scan; cold run,
               then the median of 5 warm runs with sections, the fused
               batches and their capacities;
  6. q6-perfile — the same files through the scan's PERFILE reader (fused
               decode off: one batch per row group, decoded column by column
               through expand_stream); cold run, then 5 warm runs with
               sections and the host part of the decode.  Its expand
               launches and its mixed-width fallbacks must equal the counts
               predicted from the chunk plans' streams, with no unpack
               launch, in every run;
  7. session — ``bench.py::_query``'s DataFrame expression, written with
               the port's ``col``/``functions``, on a port
               ``TpuSparkSession`` on cuda in test mode over the same files,
               and the same query with a selected ``input_file_name()``
               column: each prints its physical plan, must hold the filter
               fused into the aggregate and pushed into the scan (the
               second with the scan's fused reader off and, as in the
               reference, input_file_name() in a host projection over the
               download; no other host node but the transitions), must
               match pyarrow and must launch and fall back exactly as
               phases 5 and 6 did; its planning time and warm collect wall
               (median of 5 each);
  7b. pipeline — the scan pipeline on the fused and the PERFILE q6
               (``bench.py::_query`` on a session) and the in-memory q6 over
               the same SF10 data: with ``sql.scan.prefetch.depth`` 2 and 0
               each must match pyarrow and launch and fall back exactly as
               before the pipeline (PIPELINE_COUNTS); the prefetch and
               semaphore counters (``scan.prefetchOverlapNs`` must be > 0
               on the fused q6), the
               pinned bytes held at most; one ``torch.profiler`` trace per
               form (the device's busy share: the union of kernel and
               memcpy intervals over the wall; the ten device operations
               that took the most time; the copies by kind, with no
               pageable host-to-device copy in any form; the five longest
               idle gaps, each named by the host spans it fell in); the
               sections of a
               median of 5 warm runs, with the fused host prep split into
               ``_collect_plans`` and ``assemble``, the PERFILE decode's
               O(runs) Python and the in-memory upload's host work
               (``pipeline_profile.py`` takes the same sections of another
               checkout, for runs in turns with it);
  8. q6s-parquet — q6's filter grouped by the string key ss_item_id over 4
               files of 2^20 rows (the string kernel's path, cut for time);
  8b. star   — the star-join reporting queries q3, q42, q52 and q55 of the
               port's ``bench/tpcds.py`` at SF10: date_dim, item (1,800,000
               rows) and store_sales (28,800,000 rows, every generator
               column) from the port's table builders, store_sales as 8
               Parquet files and each dimension as one, on port sessions on
               cuda with a 2 GiB broadcast threshold.  Each query prints its
               physical plan, which must hold two TpuBroadcastHashJoinExec,
               the device sort and limit, the filters pushed into the
               filtered dimensions' scans and no host node but the
               transitions; must match an independent pyarrow computation
               (integers, strings and row order exact, float sums to
               tests/parity.py's tolerance); with the counts set to 0
               before it, must launch every kernel of its path with no
               fallback but the pinned filterDecode ones, and give each
               join pair the route the reference's rule gives it; then its
               cold wall, a warm wall with sections, one profiler trace
               and its peak device memory, host syncs and hash rounds;
  8c. window — the windowed reporting queries q98 and q47 at SF10 over the
               star phase's files and ``store`` (12,000 rows, one file,
               from a generator of its own), on port sessions on cuda
               with the same threshold.  Each prints its physical plan,
               which must hold a TpuWindowExec and no CpuWindowExec, the
               device sort (and limit: q98 has none), the filters pushed
               into the filtered dimensions' scans (q98's item by its
               IN) and no host node but the transitions; must match an
               independent pyarrow/numpy computation (q98's class totals
               by a group_by joined back; q47's partition average the same
               way, its lag/lead by shifting each partition sorted on
               d_moy); with the counts set to 0 before it, must launch
               and fall back as pinned (WINDOW_COUNTS, WINDOW_FALLBACKS);
               then its cold wall, a warm wall with sections
               (``window.eval`` among them), one profiler trace and its
               peak device memory;
  8d. shuffle — the shuffle exchange over the star phase's files and
               ``catalog_sales`` (14,400,000 rows, 8 files, from its
               builder on a generator of its own), on port sessions on cuda
               at the default 10 MiB broadcast threshold: q97 under the
               ``local`` and then the ``device`` transport (its plan must
               hold two TpuShuffleExchangeExec under a full
               TpuShuffledHashJoinExec and no host node but the
               transitions; its row must match an independent pyarrow
               count of the channels' distinct customer-item pairs, and
               the two transports must agree), then q3/q42/q52/q55, whose
               join with item is now a shuffled hash join (rows against
               the star phase's pyarrow references).  With the counts set
               to 0 before each, its launches, fallbacks and (for the star
               queries) join routes must equal the pinned SHUFFLE_COUNTS,
               SHUFFLE_FALLBACKS and SHUFFLE_ROUTES; then its cold wall, a
               warm wall with sections (``exchange.partition``,
               ``exchange.upload`` or ``exchange.concat``, the joins, the
               aggregate and the scan), the rows and ``bytes_written``
               through its exchanges, one profiler trace and its peak
               device memory;
  8e. strings — the census queries q8, q15, q19, q45, q84 and q93 over the
               star phase's files, store, catalog_sales and customer
               (10,000,000 rows), customer_address (5,000,000), web_sales
               (7,200,000), store_returns (2,880,000, from the star files'
               store_sales), customer_demographics, household_demographics,
               income_band and reason at SF10 (their builders on a generator
               of their own), on port sessions on cuda at the shuffle
               phase's conf.  Each prints its physical plan, which must hold
               no host node but the transitions and its string expression
               (substring, startswith or concat) in a device filter,
               projection, fused stage or fused aggregate (q93's startswith
               also pushed into reason's scan); must match an independent
               pyarrow computation; with the counts set to 0 before it,
               its launches, fallbacks and join routes must equal the
               pinned STRINGS_COUNTS, STRINGS_FALLBACKS and STRINGS_ROUTES;
               then its cold wall and peak device memory, and (not in
               the whole smoke) a warm wall with sections (the filter's,
               projection's and fused stage's host eval time among them)
               and one profiler trace with the kernel launches inside
               those eval spans;
  8f. customer-etl — over the strings phase's customer file (10,000,000
               rows) on a port session on cuda at the strings phase's conf:
               an RLIKE filter in the device subset on c_email_address,
               md5 of the address, a literal and an NFA regexp_replace, a
               double cast to string, monotonically_increasing_id(),
               spark_partition_id() and rand(seed).  Prints its plan (no
               host node but the transitions); must match Python's re,
               hashlib and repr; the ids must count 0, 1, 2, ... within
               each partition; the ids, partition ids and rand must equal a
               port session's on the CPU over the same batches, bit for
               bit; then the pinned launches and fallbacks, its cold wall
               and peak device memory, and (not in the whole smoke) a
               warm wall with sections and one profiler trace (with the
               launches inside the eval spans);
  8g. mortgage — ``bench/mortgage.py``'s ETL (``run``: the per-loan
               delinquency features, the explode of 0..11 and its
               re-aggregation, the cleaned acquisitions), ``simple_aggregates``
               and ``delinquency_rate`` at SF 1 (perf 9,000,000 rows in 8
               files, acq 500,000 in one; the explode emits 108,000,000
               rows) on port sessions on cuda at the strings phase's conf
               with the two-stage aggregate on the device transport
               (MORT_CONF says why).
               Each prints its plan (no host node but the transitions and
               the name mapping's in-memory scan; the ETL's holds a
               TpuGenerateExec); must match an independent pyarrow/numpy
               computation (the ETL as row sets); launches, falls back and
               routes its joins as pinned (MORT_*); then its cold wall
               and peak device memory, and (not in the whole smoke) a
               warm wall with sections (``generate.count`` and
               ``generate.emit`` among them) and one profiler trace;
  8h. tpch  — TPC-H from SQL text at SF10 when the phase runs alone, SF 2
               in the whole smoke (its time limit): ``bench/tpch.py::
               generate(sf, 7)`` (at SF10 lineitem 60,900,621 rows, orders
               15,000,000, partsupp 8,000,000, part 2,000,000, customer
               1,500,000, supplier 100,000) written by pyarrow, 8
               dictionary-encoded
               files for each table over 2^20 rows, read back with
               ``setup_from_dir`` and registered as temp views on port
               sessions on cuda at the shuffle phase's conf.  Each of the
               eight SQL texts (q1, q3, q5, q6, q10, q12, q14, q19) goes
               through ``session.sql``: its parse and planning time
               (median of 5), its plan (no host node but the
               transitions), its rows against an independent pyarrow
               computation, the pinned launches, fallbacks and join
               routes (TPCH_*), the cold wall, 2 warm walls with
               sections, one profiler trace (not in the whole smoke) and
               its peak device memory;
               then its DataFrame form ``QUERIES[name]`` on the card
               against the SQL text's rows.  The cache: lineitem's q1/q6
               columns cached and registered as the lineitem view, q1 and
               q6 twice each; the first collect materializes it once
               through the device encoder, every run reads the blobs
               through TpuInMemoryTableScanExec and equals the uncached
               rows exactly (pinned CACHE_*; cache.decode, the
               expand_stream launches, the materialization time and the
               blobs' bytes printed).  The handoff: ``collect_device()``
               of q6's filtered lineitem gives CUDA batches whose rows
               equal ``collect()``.  The writers: lineitem to Parquet
               (snappy) and orders to ORC through the device encoders
               (``encode_batch`` wrapped and counted: one call per
               non-empty partition), read back by pyarrow equal to the
               generated tables, q6 over the written lineitem against
               the original's; their walls and rows/s;
  8i. oocore — over the tpch phase's Parquet files, q3 and q10 (the
               lineitem/orders shuffled joins) on port sessions on cuda
               at the reference's defaults (no grace join may activate)
               and with ``join.buildSideBudgetBytes`` at 8 MiB (below
               every exchange partition's build side),
               ``memory.device.batchStorageSize`` at 256 MiB and
               ``memory.host.spillStorageSize`` at 64 MiB (the spill dir
               under chiprun_out/): the rows against pyarrow and the
               unpartitioned run's, the grace counters, the bytes spilled
               to the host and to disk (both must move), the host
               arena's peak, each wall against the unpartitioned one, an
               empty spill catalog after each query; then two 1 GiB
               batches registered on the card and an allocation of twice
               the card: the real ``torch.cuda.OutOfMemoryError`` goes to
               ``hbm_oom_recover``, which must spill the whole device
               tier, and the batches must come back equal;
  8k. obs    — the per-query observability layer, over the SF10 q6
               files and the oocore phase's tables: q6 through port
               sessions with ``obs.profile.enabled`` on and off, 5 warm
               runs of each in turns (both medians of the CUDA-event
               walls and their difference, q6's kernels launched with no
               fallback, the row counts left on the card per query); the
               last profile: status, result rows,
               every section, the plan tree in the executed plan's order,
               the phases within the wall and each breakdown time within
               the wall times the threads that time it (the prefetch
               and task threads: the breakdown sums them, as the
               reference's does; printed beside the run's CUDA-event
               wall), ``explain_string('profile')``;
               one traced run's Chrome trace read back by ``json.load``;
               the oocore phase's grace q3 with ``obs.recorder.dir`` set:
               grace and spill events in the ring, the
               ``spill.deviceToHost`` bytes equal to the query's
               ``spill.deviceToHostBytes``, the rows against pyarrow; q6
               cancelled from a second thread through its installed
               token: ``QueryCancelledError``, one ``q<id>-cancelled-``
               bundle of the five files (status failure, the plan), an
               empty spill catalog and q6 right after against pyarrow;
               ``obs.slowQueryMs`` 1: one record per query with the
               reference's keys; each line with the card's name and
               power limit;
  8m. sched  — the query service (every ``collect()`` is its
               ``submit().result()``) on one port session on cuda with two
               query slots and the telemetry endpoint on, over the SF10
               q6 files and the TPC-H files: q6 at four filter literals,
               serial and then submitted at once, each result equal to
               its serial run bit for bit and to pyarrow, one of them
               waiting for a slot, /queries showing queued, running and
               finished rows, /tenants billing four ``digest:`` tenants
               and the ledger's window equal to the ``kernel.dispatches``
               and ``sched.queueWaitNs`` counters'; the same q6 submitted
               twice at once run as one flight; TPC-H q10 under a
               deadline that fires while it runs (TIMED_OUT, the slot
               freed, an empty spill catalog, the card's allocated memory
               back within 64 MiB, q6 right after matching); /metrics
               through the strict lint, /compiles, /profiles/<qid>,
               /healthz; warm q6 through the service and through the
               session's direct ``_execute_attributed``, in turns;
  8j. csv-orc — the tpch phase's tables (SF10 alone, SF 2 in the whole
               smoke) written as ORC (RLEv2, ZLIB, Hive's 0.8 dictionary
               threshold) and as pipe-delimited text with a header (region,
               nation, supplier, part, partsupp, lineitem), 8 files for
               each table over 2^20 rows: the eight SQL texts over views
               from ``read.orc``, and q2, q11, q16 (DataFrame forms) and
               q6 over ``read.csv(sep="|")``, each against pyarrow, with
               its plan (TpuOrcScanExec / TpuCsvScanExec, no other host
               node), the scans' fallbackColumns / fallbackFiles (q6's 8
               lineitem files fall back whole, their date columns outside
               the device parse), the pinned launches, fallbacks and
               routes, the cold wall, a warm wall with ``scan.decode`` /
               ``scan.csvDecode``, a trace and peak memory;
  8l. compile — the kernel cache, over the SF10 q6 files and a 2^24-row
               in-memory q6: registered batches and a ballast leave too
               little free device memory for the aggregate, so a real
               CUDA OOM in ``agg_update`` is spilled and retried, with
               the rows of a run without the fill, the batches back
               equal and the catalog empty; cold and warm q6 with
               ``kernel.dispatches.*``, ``kernel.cache.*``, the first
               calls per family (none in the warm run) and the
               attribution identity; the warm q6 with the observatory
               and the ledger on and off, ``COMPILE_TURNS`` in turns;
  8n. skew  — the skew join under ``sql.join.skew.enabled``
               (tests/test_join_oocore.py:273-280's shape at 2^26 fact
               rows made from a seed: 60% on one key, a 500-key tail,
               joined to its 500-row dimension and aggregated per key)
               on port sessions on cuda with broadcasts off and 16
               shuffle partitions: TpuSkewJoinReaderExec on both sides,
               ``shuffle.skew.detected`` >= 1, ``splits`` >= 2, a
               broadcast or replication; the rows equal numpy's and the
               unsplit run's (skew and adaptive off) and, alone, the
               default adaptive reader's; each wall, the gather_seg_scan
               launches and peak memory;
  8o. adaptive — TPC-H q3 and q10 over the tpch phase's files (SF10
               alone, SF 2 in the whole smoke) at the reference's
               defaults and with ``sql.adaptive.enabled`` off: every
               shuffled join reads its exchanges through
               TpuAdaptiveJoinReaderExec (none when off), both forms'
               rows equal pyarrow's and each other's; the spec lists,
               cold walls, spill and peak memory of each;
  8p. share  — over the SF10 q6 files, q6 and a second aggregate over
               the same filtered scan (same columns, same pushed filter)
               submitted at once under two slots, with
               ``sql.scan.shared.enabled`` on and off: on, the
               ``scan.shared.*`` counters are >= 1 and the unpack_bits and
               decode launches equal one query's; off, twice that; each
               result equals its serial run bit for bit (q6 also
               pyarrow); each pair's wall, spill and peak memory; an
               empty spill catalog after;
  8q. precompile — a child process runs q6 over the SF10 files with
               ``obs.compile.corpusPath``; a second child with an empty
               build directory and ``sched.precompile.enabled`` replays
               that corpus (nvcc runs in the replay), then runs q6: it
               builds nothing, every first call that launches a kernel
               library is ``persistent``, and both children's rows equal
               pyarrow's;
  9. perfile-modes — 2 files of 2^21 rows with about 4% nulls, a boolean,
               a dictionary that overflows into PLAIN pages, a 16-character
               string dictionary and a list<int32>, through the PERFILE
               reader, each row group checked against pyarrow;
  9b. window-modes — every window function and frame kind of
               tests/test_window.py (row_number, rank, dense_rank, lead/lag
               with and without a default; running, whole-partition,
               sliding ROWS and finite RANGE frames in both directions;
               sum, count, avg, min and max over int64, double with NaN and
               bool) over a 2^16-row table with about 5% nulls and one
               partition of half the rows, on a port session on cuda
               against the same DataFrame on one on the CPU: exactly,
               floats bit for bit; untimed;
  9c. shuffle-modes — over 2^16 rows with about 5% nulls (int32, int64,
               float64 with NaN and -0.0, bool, date and strings of byte
               widths 0-33 with multi-byte tails): repartition by hash,
               round robin, range and single, a coalesce, the shuffled
               join for every how (and on string keys), the two-stage
               aggregate, the partitionwise window and the range-exchange
               sort on cuda (the repartitions under both transports, the
               rest under the default ``local``) against the same
               DataFrame on a port session on the CPU: the repartitions
               partition by partition, the rest whole; exactly, floats bit
               for bit; untimed;
  9d. string-modes — every string, string-cast and date/time expression
               of the port (LIKE with %, _ and leading and trailing
               segments, literal and column needles, negative and zero
               substring positions, pads longer and shorter than the input)
               over 2^17 rows with about 5% nulls (strings of byte widths
               0-256, each function once, and 0-24, the other forms, with
               whitespace and multi-byte characters; numeric,
               boolean, date and timestamp text, valid and invalid; dates
               from 1582 to 9999; negative timestamps) on cuda against the
               same DataFrame on a port session on the CPU, bit for bit;
               then the kernel launches, copies and memsets one evaluation
               of each enqueues; untimed;
  9e. tail-modes — every expression of the last slice (md5 over byte
               widths 0-256 and 0-24; double and float -> string with
               ryu's edges and random bit patterns; RLIKE and the literal
               and NFA regexp_replace, and three regex forms outside the
               subset, which both sessions keep on the CPU with the
               reference's reasons; size, item, contains, element_at and
               array over lists with null and empty lists and null
               elements), explode, posexplode and their outer forms, the
               leaves and rand over 4 partitions of 4 batches each, and a
               list column written to Parquet and read through the
               PERFILE reader (expand_stream must launch), over 2^18 rows
               with about 5% nulls, on cuda against a port session on
               the CPU, bit for bit; then the kernel launches, copies and
               memsets one evaluation of each expression (and the
               explode's two passes) enqueues; untimed;
  9f. io-modes — 2^18 rows with about 5% nulls (int32, int64, float32
               and float64 with NaN and -0.0, bool, date, timestamp,
               strings of byte widths 0-256 with multi-byte characters, an
               all-null column) on cuda against a port session on the
               CPU: the Parquet blob (codecs none, snappy, zstd) and the
               ORC blob byte for byte, each read back by pyarrow equal to
               the input; the cache (four partitions, one empty): the
               blobs byte for byte and the rows exactly; a partitioned
               write: the same partitions, files and rows; the
               SELECT-surface queries of tests/test_sql.py (read from its
               source text) over 2^12 rows of its ``qa`` columns:
               exactly, floats bit for bit or, where a math function or a
               float sum rounds differently on the card, to
               tests/parity.py's tolerance (listed); untimed;
 10. timing  — per kernel at the shapes and on the inputs the q6 paths
               and the star, window, shuffle, strings, customer-etl,
               mortgage, skew and TPC-H queries' cold runs and the shared
               pair gave it (segreduce from every run; later runs'
               entries are named
               ``name@q6-parquet``, ``name@q6-perfile``, ``name@star``,
               ``name@window``, ``name@shuffle`` (from q97's run on the
               local transport), ``name@strings``, ``name@customer-etl``,
               ``name@mortgage``, ``name@skew`` (the split run),
               ``name@tpch``, ``name@cache`` (the
               cached q1/q6 runs), ``name@oocore`` (the grace runs),
               ``name@csv-orc`` and ``name@share`` (the shared pair): a
               check
               against the plain version, its time (CUDA events, L2
               flushed), its bytes bound, the plain version's time and a
               library call's where one computes the same function.

Before each q6 path and each star, window, shuffle, strings,
customer-etl, mortgage, TPC-H, cached, out-of-core, ORC and CSV query
(and before the obs phase's warm q6 runs) the kernel launch counts are
set to 0
(and the shared-scan window emptied, so the run decodes its own scans),
and they are read just after it: every kernel of the path must have
launched, with no fallback but the PERFILE path's predicted mixed-width
ones and the later queries' pinned filterDecode ones.  The line
before the last carries the kernel table as JSON, the line before it the
card's name and power limit; the last line is the result JSON.  Long
output goes to chiprun_out/chip_smoke.log.  ``python3 chip_smoke.py
build,parity`` (or any comma-separated subset of build, parity, entry, q6,
q6p, q6pf, session, pipeline, q6s, star, window, shuffle, strings,
customer-etl, mortgage, skew, tpch, oocore, adaptive, obs, sched,
csv-orc, compile, share, precompile, modes, window-modes, shuffle-modes,
string-modes, tail-modes, io-modes)
runs only those phases and prints no kernel table; ``tpch``, ``oocore``,
``adaptive``, ``obs``, ``sched`` and ``csv-orc`` generate, write and
remove their own files (sharing them when run together; ``obs`` and
``sched`` also write the SF10 q6 files, and alone run TPC-H at SF 2;
``compile``, ``share`` and ``precompile`` write the SF10 q6 files);
``customer-etl`` alone writes the star files and the census tables
itself; ``session`` alone writes the files and counts the
q6p and q6pf forms once itself, ``pipeline`` alone writes the files and
makes the in-memory table itself.
"""

import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

try:
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as papq
    import torch
    from spark_rapids_tpu_torch.kernels import _build
    from spark_rapids_tpu_torch.kernels import backend as kb
    from spark_rapids_tpu_torch.kernels import decode as kdec
    from spark_rapids_tpu_torch.kernels import filter_decode as kfd
    from spark_rapids_tpu_torch.kernels import segreduce as kseg
except ImportError as e:  # run outside a checkout of the repo
    print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
    sys.exit(2)

Q6_ROWS = 28_800_991
Q6_PARTS = 8
Q6S_FILES = 4
Q6S_ROWS = Q6S_FILES << 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
# set when every phase runs: the phases that cut their depth for the
# whole smoke's time limit read it (the shuffle phase's star reruns, the
# strings, customer-etl and mortgage warm runs and traces, the tpch
# phase's scale and traces)
WHOLE_SMOKE = False
OUT_DIR = "chiprun_out"
LOG_NAME = "chip_smoke.log"
SOURCES = ["segreduce", "decode", "filter_decode"]
REPLACES = {
    "segreduce.seg_scan_sorted": "spark_rapids_tpu/kernels/segreduce.py:278",
    "segreduce.gather_seg_scan": "spark_rapids_tpu/kernels/segreduce.py:286",
    "decode.unpack_bits": "spark_rapids_tpu/kernels/decode.py:155",
    "filter_decode.decode": "spark_rapids_tpu/kernels/filter_decode.py:125",
    "filter_decode.decode_str":
        "spark_rapids_tpu/kernels/filter_decode.py:178",
    "decode.expand_stream": "spark_rapids_tpu/kernels/decode.py:336",
}
SOURCE_OF = {"segreduce": kseg.SOURCE, "decode": kdec.SOURCE,
             "filter_decode": kfd.SOURCE}
SEGREDUCE = ["segreduce.seg_scan_sorted", "segreduce.gather_seg_scan"]
# the kernels each Parquet q6 path must launch
Q6P_KERNELS = SEGREDUCE + ["decode.unpack_bits", "filter_decode.decode"]
Q6S_KERNELS = ["decode.unpack_bits", "filter_decode.decode",
               "filter_decode.decode_str"]
# the kernels the PERFILE q6 must launch (its dictionary columns are not
# deferred: the per-column decode ignores the pushed filter; the expansion
# reads the packed bits itself, so nothing unpacks)
Q6PF_KERNELS = ["decode.expand_stream"] + SEGREDUCE
Q6PF_COLUMNS = ["ss_item_sk", "ss_quantity", "ss_sales_price",
                "ss_ext_sales_price"]
MODES_FILES = 2
MODES_ROWS = MODES_FILES << 21
# every q6 form runs on a port session, which configures the scan's plan
# cache from its conf: room for every chunk plan of both readers, so warm
# runs walk nothing
SCAN_CONF = {"spark.rapids.tpu.sql.scan.metadataCache.maxBytes": 8 << 30}
# host nodes test mode always allows (overrides.assert_is_on_tpu)
HOST_OK = ("CpuScanExec", "CpuFileScanExec", "HostToDeviceExec",
           "DeviceToHostExec")

_log_lines = []
# directories kept across phases (the SF10 q6 files the obs phase reads);
# removed when the script ends, whatever its outcome
_KEPT_DIRS = []


def log(msg: str) -> None:
    print(msg, flush=True)
    _log_lines.append(msg)


def detail(msg: str) -> None:
    _log_lines.append(msg)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    _write_log()
    sys.exit(1)


def _write_log() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, LOG_NAME), "w") as f:
        f.write("\n".join(_log_lines) + "\n")


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    """One nvcc per source, all started together."""
    import concurrent.futures as cf
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(_build.load, name) for name in SOURCES}
    for name, fut in futures.items():
        try:
            fut.result()
        except RuntimeError as e:
            fail(str(e)[-4000:])
        detail(f"--- nvcc {name}.cu ---\n"
               f"{_build.compiler_output.get(name, '(already built)')}")
    log(f"build: {len(SOURCES)} source(s), {len(_build.compiler_output)} "
        f"compiled in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 2. kernel vs plain version
# ---------------------------------------------------------------------------

def _float_tol(x_scan_abs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float sums: another reduction tree than the plain version, so
    |diff| <= rel * (segmented scan of |x|), rel 1e-12 for float64 and
    1e-5 for float32 (about 20 rounding steps of float32's 6e-8)."""
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    return rel * x_scan_abs + 1e-300


def wrapper_scan(new, x, op, ident, order=None, out=None):
    """The call the main path makes for these inputs: seg_scan_sorted
    without ``order``, gather_seg_scan (widening to ``out``) with it."""
    if order is None:
        if out not in (None, x.dtype):
            raise ValueError("seg_scan_sorted does not widen")
        return kseg.seg_scan_sorted(new, x, op, ident)
    return kseg.gather_seg_scan(x, order, new, op, ident, scan_np=out)


def compare(new, x, op, ident, order=None, out=None):
    """Kernel, through its wrapper, vs plain version on the same CUDA
    tensors.  Integers and min/max must agree exactly, float sums within
    :func:`_float_tol`.  Returns (max_abs_err, ok)."""
    got = wrapper_scan(new, x, op, ident, order, out)
    want = kseg.plain_seg_scan(new, x, op, ident, order, out)
    torch.cuda.synchronize()
    out_t = out or x.dtype
    if not out_t.is_floating_point:
        if out_t == torch.uint64:
            got, want = got.view(torch.int64), want.view(torch.int64)
        err = float(torch.abs(got.double() - want.double()).max())
        return err, bool(torch.equal(got, want))
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    d = torch.where(same, 0.0, torch.abs(got.double() - want.double()))
    if op != "add":
        return float(d.max()), bool(same.all())
    ax = torch.abs(x.to(out_t) if order is None
                   else x[order.long()].to(out_t))
    tol = _float_tol(kseg.plain_seg_scan(new, ax, "add", 0), out_t)
    return float(d.max()), bool((same | (d <= tol)).all())


def _values(dtype, cap, gen):
    if dtype == torch.bool:
        return torch.rand(cap, generator=gen, device="cuda") < 0.5
    if dtype.is_floating_point:
        return (torch.rand(cap, generator=gen, device="cuda",
                           dtype=torch.float64) * 2e6 - 1e6).to(dtype)
    if dtype == torch.uint64:
        v = torch.randint(0, 1 << 62, (cap,), generator=gen, device="cuda")
        return (v * 3).view(torch.uint64)   # uses the top bit too
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), (cap,),
                         generator=gen, device="cuda", dtype=dtype)


def _identity(op, dtype):
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    npd = kseg._np_dtype(dtype)
    info = np.iinfo(npd)
    return info.max if op == "min" else info.min


# the update's two rungs and the merge's: 64, 256 and 4096 tiles of 4096
# elements (twice as many tiles of 2048 for 8-byte outputs)
PARITY_CAPS = (1 << 18, 1 << 20, 1 << 24)
# group starts: q6-like short groups (every tile holds a start), and
# groups of ~2^16 rows that carry across many tiles, with no start at row 0
PARITY_DENSITIES = (1 / 60, 1 / 65536)
# layouts that stress the look-back, beside the densities: no flag at all
# (row 0 included); a flag only at each tile's last element; one segment
# spanning the capacity (the global aggregate), at 2^24 only
PARITY_LAYOUTS = ("none", "tile_last")
# capacities that are not a multiple of the tile
RAGGED_CAPS = ((1 << 20) + 7,) + tuple(range(1, 8))


def _layout_flags(layout, cap: int, tile: int, gen) -> torch.Tensor:
    if isinstance(layout, float):
        new = torch.rand(cap, generator=gen, device="cuda") < layout
        new[0] = layout > 1e-3
        return new
    new = torch.zeros(cap, dtype=torch.bool, device="cuda")
    if layout == "tile_last":
        new[tile - 1::tile] = True
    elif layout == "one_segment":
        new[0] = True
    return new


def _layout_tag(layout) -> str:
    return f"starts~1/{round(1 / layout)}" if isinstance(layout, float) \
        else layout


def phase_parity() -> None:
    """segreduce through its wrappers against its plain version, for every
    type pair x op, sorted and with the fused gather, over the densities
    and layouts above, ragged capacities and a gather from a source longer
    than the capacity.  Every float add also runs twice more and must give
    the same bits each time (the look-back folds in a fixed order)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    n_ok = n_rep = 0

    def run_all(cap: int, layouts, src: int = 0) -> None:
        nonlocal n_ok, n_rep
        order = torch.randperm(src or cap, generator=gen, device="cuda")[
            :cap].to(torch.int32)
        for layout in layouts:
            for tin, tout in sorted(kseg.KERNEL_TYPES, key=str):
                new = _layout_flags(layout, cap, kseg.tile_elems(tout), gen)
                for op in ("add", "min", "max"):
                    x = _values(tin, src or cap, gen)
                    ident = _identity(op, tout)
                    # seg_scan_sorted never widens, nor reads a longer
                    # source: gather only then
                    paths = (None, order) if tin == tout and not src \
                        else (order,)
                    for o in paths:
                        out = None if tin == tout else tout
                        err, ok = compare(new, x, op, ident, o, out)
                        tag = (f"{tin}->{tout} {op} "
                               f"{'sorted' if o is None else 'gather'} "
                               f"cap={cap} src={x.shape[0]} "
                               f"{_layout_tag(layout)}")
                        detail(f"parity {tag}: max_abs_err={err} ok={ok}")
                        if not ok:
                            fail(f"kernel != plain for {tag} "
                                 f"(max err {err})")
                        n_ok += 1
                        if op == "add" and tout.is_floating_point:
                            first = wrapper_scan(new, x, op, ident, o, out)
                            for _ in range(2):
                                again = wrapper_scan(new, x, op, ident, o,
                                                     out)
                                if not torch.equal(again.view(torch.uint8),
                                                   first.view(torch.uint8)):
                                    fail(f"float sum not repeatable: {tag}")
                            n_rep += 1

    for cap in PARITY_CAPS:
        run_all(cap, PARITY_DENSITIES + PARITY_LAYOUTS +
                (("one_segment",) if cap == 1 << 24 else ()))
    for cap in RAGGED_CAPS:
        run_all(cap, (PARITY_DENSITIES[0], "none"))
    run_all(1 << 18, PARITY_DENSITIES, src=1 << 20)
    caps = ", ".join(f"2^{c.bit_length() - 1}" for c in PARITY_CAPS)
    log(f"parity: {n_ok} kernel/plain comparisons through the wrappers "
        f"agree (caps {caps}: {len(PARITY_DENSITIES)} group-start "
        f"densities, no flag, a flag at each tile's end, one segment at "
        f"2^24; caps 2^20+7 and 1-7; cap 2^18 gathered from 2^20); "
        f"{n_rep} float sums gave the same bits over 3 calls")
    _one_launch_per_call(gen)


def _one_launch_per_call(gen) -> None:
    """Each wrapper call is one kernel launch: the device kernels that
    torch.profiler records for one call after a warm one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cap = 1 << 20
    new = _layout_flags(PARITY_DENSITIES[0], cap, 0, gen)
    x = _values(torch.float64, cap, gen)
    order = torch.randperm(cap, generator=gen, device="cuda").to(torch.int32)
    runs, packed = _synthetic_stream(7, cap, np.random.default_rng(5))
    table, pk, ncap = _stream_inputs(runs, packed, 7, "cuda")
    raw = torch.randint(0, 256, (cap * 7 // 8,), generator=gen,
                        device="cuda", dtype=torch.uint8)
    dbuf = torch.randint(0, 1 << 20, (1 << 15,), generator=gen,
                         device="cuda", dtype=torch.int32)
    codes = torch.randint(0, 1 << 15, (cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    keep = torch.rand(cap, generator=gen, device="cuda") < 0.125
    sbuf = torch.randint(0, 256, (STR_DLEN,), generator=gen, device="cuda",
                         dtype=torch.uint8)
    bb, lw, skeep = _str_inputs(cap, 17, STR_DLEN, gen)
    for name, fn in (
            ("seg_scan_sorted", partial(kseg.seg_scan_sorted, new, x, "add",
                                        0)),
            ("gather_seg_scan", partial(kseg.gather_seg_scan, x, order, new,
                                        "add", 0)),
            ("expand_stream", partial(kdec.expand_device, table, pk, 7, ncap,
                                      cap)),
            ("unpack_bits", partial(kdec.unpack_bits, raw, 7, cap)),
            ("decode", partial(kfd.decode, dbuf, codes, keep)),
            ("decode int64", partial(kfd.decode, dbuf.long(), codes, keep)),
            ("decode_str width 16", partial(kfd.decode_str, sbuf, bb, lw,
                                            skeep, 16)),
            ("decode_str width 17", partial(kfd.decode_str, sbuf, bb, lw,
                                            skeep, 17))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if not names:
            log(f"launches per {name} call: not measured (the profiler "
                f"recorded no device activity)")
        elif len(names) != 1:
            fail(f"{name} ran {len(names)} device operations per call: "
                 f"{names}")
        else:
            log(f"launches per {name} call: 1 ({names[0][:60]})")


def _exact(got: torch.Tensor, want: torch.Tensor):
    """(max_abs_err, bit-for-bit equal) of a kernel's output against its
    plain version's."""
    torch.cuda.synchronize()
    if got.dtype.is_floating_point:
        bits = torch.int32 if got.element_size() == 4 else torch.int64
        same = torch.equal(got.view(bits), want.view(bits))
    else:
        same = torch.equal(got, want)
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    return err, same


DECODE_CAP = 1 << 21
DECODE_CAPS = (DECODE_CAP, DECODE_CAP + 3)
DECODE_DICTS = (1 << 7, 1 << 15, 1 << 20)
DECODE_TYPES = (torch.int32, torch.float32, torch.int64, torch.float64)
# q6's share of kept rows, a quarter, none and all
DECODE_DENSITIES = (0.125, 0.25, 0.0, 1.0)
# (codes offset, keep offset) of views the kernel cannot read as vectors
DECODE_VIEWS = ((1, 0), (0, 3), (1, 3), (2, 1))
STR_CAP = 1 << 18
STR_WIDTHS = (1, 7, 16, 17, 33, 64, 256)
STR_DLEN = 18_000 * 16          # the q6s dictionary's bytes


def phase_parity_decode() -> None:
    """unpack_bits, decode and decode_str through their wrappers against
    their plain versions; integers and bytes must agree exactly, and the
    float dictionaries' gathers bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    n_ok = 0

    def check(tag, got, want):
        nonlocal n_ok
        err, ok = _exact(got, want)
        detail(f"parity {tag}: max_abs_err={err} ok={ok}")
        if not ok:
            fail(f"kernel != plain for {tag} (max err {err})")
        n_ok += 1

    n_unpack = 0
    for ncap in UNPACK_NCAPS:
        for w in range(1, 33):
            # one spare word in front: a 4-byte-aligned source that is not
            # 16-byte aligned takes the word loads
            buf = torch.randint(0, 256, (ncap * w // 8 + 4,), generator=gen,
                                device="cuda", dtype=torch.uint8)
            whole = torch.full((ncap + 32,), -7, dtype=torch.int32,
                               device="cuda")
            for src_off in (0, 4):
                raw = buf[src_off:src_off + ncap * w // 8]
                want = kdec.plain_unpack_bits(raw, w, ncap)
                tag = f"unpack_bits w={w} ncap={ncap} src+{src_off}"
                check(tag, kdec.unpack_bits(raw, w, ncap), want)
                # into slices of a larger array: 16-byte aligned, and not
                for off in (16, 3):
                    whole.fill_(-7)
                    dst = whole[off:off + ncap]
                    kdec.unpack_bits(raw, w, ncap, out=dst)
                    check(f"{tag} out@{off}", dst, want)
                    if not (bool((whole[:off] == -7).all()) and
                            bool((whole[off + ncap:] == -7).all())):
                        fail(f"{tag} out@{off} wrote outside its slice")
                n_unpack += 3
    n_gather = _parity_gathers(check, gen)
    rng = np.random.default_rng(13)
    n_expand = 0
    for layout, caps, widths in EXPAND_LAYOUTS:
        for cap in caps:
            for w in widths:
                runs, packed = EXPAND_STREAMS[layout](w, cap, rng)
                n_expand += _check_expand(check, f"{layout} w={w} cap={cap}",
                                          runs, packed, w, cap)
    _check_int32_wrap(check)
    n_expand += 1
    log(f"parity: {n_ok} unpack_bits/decode/decode_str/expand comparisons "
        f"through the wrappers agree exactly ({n_unpack} unpack: w 1-32 at "
        f"ncap {', '.join(map(str, UNPACK_NCAPS))}, aligned and unaligned "
        f"sources, fresh and into 16-byte aligned and unaligned slices; "
        f"{n_gather} decode/decode_str: dictionaries of 2^7, 2^15, 2^20 "
        f"entries at caps 2^21 and 2^21+3, keep densities "
        f"{', '.join(map(str, DECODE_DENSITIES))}, views at odd offsets; "
        f"string widths {', '.join(map(str, STR_WIDTHS))} at caps {STR_CAP} "
        f"and {STR_CAP + 5}, negative bases, bases at every offset mod 16 "
        f"near both ends, aligned, offset and ragged dictionary buffers, "
        f"views at odd offsets; {n_expand} expand: "
        + "; ".join(f"{layout} at caps {', '.join(map(str, caps))}"
                    for layout, caps, _ in EXPAND_LAYOUTS)
        + ", w 0-32, int32 and int64 rows; an RLE value of 2^30 whose "
        "running sum leaves int32, against the golden values)")


def _parity_gathers(check, gen) -> int:
    """decode and decode_str through their wrappers against their plain
    versions, bit for bit; returns the number of comparisons."""
    n = 0
    for dlen in DECODE_DICTS:
        for dtype in DECODE_TYPES:
            dbuf = (torch.randn(dlen, generator=gen, device="cuda",
                                dtype=torch.float64) * 1e6).to(dtype)
            for cap in DECODE_CAPS:
                # codes past both ends: the clip applies
                codes = torch.randint(-2, dlen + 2, (cap,), generator=gen,
                                      device="cuda", dtype=torch.int32)
                for density in DECODE_DENSITIES:
                    keep = torch.rand(cap, generator=gen,
                                      device="cuda") < density
                    if 0 < density < 1:
                        keep[1 << 18:(1 << 18) + (1 << 16)] = False
                    check(f"decode {dtype} dict={dlen} cap={cap} "
                          f"keep={density}", kfd.decode(dbuf, codes, keep),
                          kfd.plain_decode(dbuf, codes, keep))
                    n += 1
    # views at odd offsets, of a ragged length
    cap = DECODE_CAP + 1
    for dtype in DECODE_TYPES:
        dbuf = (torch.randn(1 << 15, generator=gen, device="cuda",
                            dtype=torch.float64) * 1e6).to(dtype)
        codes_all = torch.randint(-2, (1 << 15) + 2, (cap + 4,),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
        keep_all = torch.rand(cap + 4, generator=gen, device="cuda") < 0.125
        for co, ko in DECODE_VIEWS:
            codes, keep = codes_all[co:co + cap], keep_all[ko:ko + cap]
            check(f"decode {dtype} dict=32768 cap={cap} codes[{co}:] "
                  f"keep[{ko}:]", kfd.decode(dbuf, codes, keep),
                  kfd.plain_decode(dbuf, codes, keep))
            n += 1
    base = torch.randint(0, 256, (STR_DLEN + 16,), generator=gen,
                         device="cuda", dtype=torch.uint8)
    buffers = {"aligned": base[:STR_DLEN], "at+5": base[5:5 + STR_DLEN],
               "ragged end": base[:STR_DLEN - 7]}
    for width in STR_WIDTHS:
        for cap in (STR_CAP, STR_CAP + 5):
            for bname, dbuf in buffers.items():
                bb, lw, keep = _str_inputs(cap, width, dbuf.shape[0], gen)
                check(f"decode_str width={width} cap={cap} dict {bname}",
                      kfd.decode_str(dbuf, bb, lw, keep, width),
                      kfd.plain_decode_str(dbuf, bb, lw, keep, width))
                n += 1
    dbuf = buffers["aligned"]
    for width in (7, 16, 17, 33):
        for density in (0.0, 1.0):
            bb, lw, keep = _str_inputs(STR_CAP, width, STR_DLEN, gen,
                                       density)
            check(f"decode_str width={width} keep={density}",
                  kfd.decode_str(dbuf, bb, lw, keep, width),
                  kfd.plain_decode_str(dbuf, bb, lw, keep, width))
            n += 1
        # views at odd offsets
        bb, lw, keep = _str_inputs(STR_CAP + 4, width, STR_DLEN, gen)
        bb, lw, keep = bb[1:1 + STR_CAP], lw[2:2 + STR_CAP], \
            keep[3:3 + STR_CAP]
        check(f"decode_str width={width} bb[1:] lw[2:] keep[3:]",
              kfd.decode_str(dbuf, bb, lw, keep, width),
              kfd.plain_decode_str(dbuf, bb, lw, keep, width))
        n += 1
    return n


def _str_inputs(cap: int, width: int, dlen: int, gen, density=0.5):
    """decode_str's byte bases, lengths and keep mask: random rows, rows
    that run past the buffer's end, negative bases, bases at every offset
    mod 16 within 48 bytes of either end (full rows), and lengths of 0,
    below 0 and above the width; at density 0.5 the edge rows are kept,
    else keep is all one value."""
    bb = torch.randint(0, dlen, (cap,), generator=gen, device="cuda",
                       dtype=torch.int32)
    lw = torch.randint(0, width + 1, (cap,), generator=gen, device="cuda",
                       dtype=torch.int32)
    bb[:1024] = dlen - 3
    bb[1024:1064] = torch.arange(-40, 0, device="cuda", dtype=torch.int32)
    edge = torch.arange(48, device="cuda", dtype=torch.int32)
    bb[1064:1112] = edge
    bb[1112:1160] = dlen - 48 + edge
    lw[1024:1160] = width
    lw[2000:2100] = 0
    lw[2100:2150] = -5
    lw[2150:2200] = width + 9
    if density in (0.0, 1.0):
        keep = torch.full((cap,), bool(density), device="cuda")
    else:
        keep = torch.rand(cap, generator=gen, device="cuda") < density
        keep[:2200] = True
    return bb, lw, keep


def _bitpack(values: np.ndarray, w: int) -> bytes:
    """Parquet's LSB-first bit-pack of a multiple of 8 values."""
    bits = ((np.asarray(values, dtype=np.uint64)[:, None] >>
             np.arange(w, dtype=np.uint64)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _check_int32_wrap(check) -> None:
    """An RLE value of 2^30 after one of 2^30 - 1 at width 31 (the C
    steps' running sum leaves int32): the run table is int64 and the
    kernel gives the golden values, 2^30 included."""
    vals = np.random.default_rng(17).integers(0, 1 << 31, 16).astype(
        np.uint64)
    runs = _run_table([(16, False, 0, 0, 31), (8, True, (1 << 30) - 1, 0, 31),
                       (8, True, 1 << 30, 0, 31), (8, True, 5, 0, 31)])
    packed = _bitpack(vals, 31)
    golden = np.concatenate([vals, np.repeat(np.uint64((1 << 30) - 1), 8),
                             np.repeat(np.uint64(1 << 30), 8),
                             np.repeat(np.uint64(5), 8)]).astype(np.uint32)
    table, pk, ncap = _stream_inputs(runs, packed, 31, "cuda")
    if table.dtype != torch.int64:
        fail(f"int32 wrap: the run table is {table.dtype}, not int64")
    got = kdec.expand_stream(runs, packed, 64, device="cuda")
    if not np.array_equal(got[:40].cpu().numpy().view(np.uint32), golden):
        fail("int32 wrap: the expansion is not the golden values")
    check("expand int32 wrap w=31 cap=64 (golden)", got,
          kdec.plain_expand_device(table, pk, 31, ncap, 64))


def _check_expand(check, tag: str, runs, packed, w: int, cap: int) -> int:
    """The one-launch expansion through its wrapper against
    plain_expand_device on the same table, with the table's own rows and,
    where they are int32, widened to int64."""
    w = kdec.stream_width(runs)[1]      # as expand_stream takes it
    table, pk, ncap = _stream_inputs(runs, packed, w, "cuda")
    dtypes = [table.dtype] if table.dtype == torch.int64 else \
        [table.dtype, torch.int64]
    for rows in dtypes:
        t = table.to(rows)
        check(f"expand {tag} rows={rows} nrows={t.shape[0]}",
              kdec.expand_device(t, pk, w, ncap, cap),
              kdec.plain_expand_device(t, pk, w, ncap, cap))
    return len(dtypes)


UNPACK_NCAPS = (1 << 20, 1 << 22, (1 << 20) + 40)
EXPAND_CAPS = (1 << 16, 1 << 18, 1 << 20, 1 << 22, (1 << 20) + 7)


def _run_table(rows) -> object:
    """A RunTable from (count, is_rle, value, bit_base, width) rows."""
    from spark_rapids_tpu_torch.io.device_parquet import RunTable
    cols = list(zip(*rows)) or [()] * 5
    return RunTable(*[[int(v) for v in c] for c in cols])


def _synthetic_stream(w: int, cap: int, rng):
    """A hybrid stream of width w filling most of ``cap``: about 400
    alternating RLE runs and bit-packed runs over random packed bytes,
    some trimmed below their 8-value groups as at a page's end; at
    w = 32 one RLE value of 2^32 - 5 (int64 rows)."""
    rows = []
    bits = 0
    total = 0
    target = cap - cap // 16
    mean = max(target // 400, 8)
    k = 0
    while total < target:
        n = int(rng.integers(1, 2 * mean))
        if k % 2 == 0:
            v = (1 << 32) - 5 if w == 32 and k == 2 else \
                int(rng.integers(0, 1 << w)) if w else 0
            rows.append((min(n, target - total), True, v, 0, w))
        else:
            groups = -(-n // 8)
            rows.append((min(groups * 8 - int(rng.integers(0, 8)),
                             target - total), False, 0, bits, w))
            bits += groups * 8 * w
        total += rows[-1][0]
        k += 1
    packed = rng.integers(0, 256, -(-bits // 8), dtype=np.uint8).tobytes()
    return _run_table(rows), packed


def _short_runs_stream(w: int, cap: int, rng):
    """RLE runs of 1 between bit-packed groups of 8 trimmed to 1-8 values,
    so the dense index of a run starts at every offset within a word and
    a tile of the kernel (1024 elements) covers about 370 rows, more than
    it stages (256)."""
    k = np.arange(2 * (cap // 5) + 2)
    counts = np.where(k % 2 == 0, 1, 1 + (k // 2) % 8)
    ends = np.cumsum(counts)
    n = int(np.searchsorted(ends, cap - 1)) + 1    # runs up to cap - 1
    k, counts = k[:n], counts[:n]
    counts[-1] -= int(ends[n - 1]) - (cap - 1)
    rle = k % 2 == 0
    values = np.where(rle, rng.integers(0, 1 << w, n) if w else 0, 0)
    bases = np.where(rle, 0, np.cumsum(np.where(rle, 0, 8 * w)) - 8 * w)
    rows = zip(counts.tolist(), rle.tolist(), values.tolist(),
               bases.tolist(), [w] * n)
    nbytes = int((~rle).sum()) * w
    return _run_table(rows), rng.integers(0, 256, nbytes,
                                          dtype=np.uint8).tobytes()


def _one_rle_stream(w: int, cap: int, rng):
    """One RLE run over the whole capacity (2^32 - 5 at w = 32)."""
    v = (1 << 32) - 5 if w == 32 else int(rng.integers(0, 1 << w)) if w \
        else 0
    return _run_table([(cap, True, v, 0, w)]), b""


def _shared_starts_stream(w: int, cap: int, rng):
    """The hybrid stream with zero-count runs, RLE and bit-packed,
    before every third run: rows that share a start."""
    runs, packed = _synthetic_stream(w, cap, rng)
    rows = []
    for i, row in enumerate(zip(runs.counts, runs.is_rle, runs.values,
                                runs.bit_bases, runs.widths)):
        if i % 3 == 0:
            rows.append((0, True, int(rng.integers(0, 1 << w)) if w else 0,
                         0, w))
            rows.append((0, False, 0, row[3] if not row[1] else 0, w))
        rows.append(row)
    return _run_table(rows), packed


def _trimmed_stream(w: int, cap: int, rng):
    """Pages' last 1-bit runs of 24 packed values trimmed to 21 (the
    input of ROADMAP Queue C), repeated over most of the capacity: later
    runs start past earlier pages' padding."""
    n = max(cap // 32, 3)
    rows = [(21, False, 0, 24 * i, 1) for i in range(n)]
    return _run_table(rows), rng.integers(0, 256, -(-24 * n // 8),
                                          dtype=np.uint8).tobytes()


EXPAND_STREAMS = {"hybrid": _synthetic_stream, "short_runs": _short_runs_stream,
                  "one_rle": _one_rle_stream,
                  "shared_starts": _shared_starts_stream,
                  "trimmed": _trimmed_stream}
# (layout, caps, widths)
EXPAND_LAYOUTS = (
    ("hybrid", EXPAND_CAPS, range(33)),
    ("short_runs", (1 << 16, 1 << 18), range(33)),
    ("one_rle", EXPAND_CAPS, range(33)),
    ("shared_starts", (1 << 18, (1 << 20) + 7), range(33)),
    ("trimmed", EXPAND_CAPS, (1,)),
)


def _stream_inputs(runs, packed, w: int, device):
    """expand_stream's two uploads, as it makes them: the run table and
    the padded packed bytes, with the dense capacity."""
    from spark_rapids_tpu_torch.columnar.batch import bucket_rows
    from spark_rapids_tpu_torch.io.device_parquet import _pad_np
    ncap = bucket_rows(max(kdec._dense_extent(runs, w), 1), 32)
    table = kdec.run_table(kdec._dense_meta(
        runs, w, bucket_rows(len(runs.counts), 8)))
    pk = _pad_np(np.frombuffer(packed, np.uint8), max(ncap * w // 8, 4))
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(pk.copy()).to(device), ncap)


# ---------------------------------------------------------------------------
# 3. entry
# ---------------------------------------------------------------------------

def phase_entry() -> None:
    from spark_rapids_tpu_torch.columnar.batch import to_arrow
    from spark_rapids_tpu_torch.entry import _example_table, entry
    step, (batch,) = entry(device="cuda")
    out = to_arrow(step(batch)).sort_by("k")
    t = _example_table()
    f = t.filter(pc.greater(t["price"], 50.0))
    ref = f.group_by("k").aggregate(
        [("k", "count"), ("qty", "sum"), ("price", "mean")]).sort_by("k")
    if out["k"].to_pylist() != ref["k"].to_pylist() or \
            out["cnt"].to_pylist() != ref["k_count"].to_pylist() or \
            out["qty_sum"].to_pylist() != ref["qty_sum"].to_pylist():
        fail("entry(cuda) keys/counts/sums differ from pyarrow")
    a = out["price_avg"].to_numpy()
    r = ref["price_mean"].to_numpy()
    if not np.all(np.abs(a - r) <= 1e-9 * np.abs(r)):
        fail("entry(cuda) averages differ from pyarrow")
    log(f"entry: {out.num_rows} groups on cuda match pyarrow")


# ---------------------------------------------------------------------------
# 4. q6 at scale, with the shapes each kernel saw
# ---------------------------------------------------------------------------

class ShapeRecorder:
    """Wraps the launcher of every kernel to keep one copy of the inputs
    of each distinct call shape (first call of its class, keyed by kernel
    name and shape) and the number of calls per class.  Counting stays
    where it is: in the wrappers."""

    LAUNCHERS = ((kseg, "kernel_seg_scan"), (kdec, "kernel_unpack_bits"),
                 (kfd, "kernel_decode"), (kfd, "kernel_decode_str"),
                 (kdec, "kernel_expand"))

    def __init__(self):
        self.classes = {}
        self._orig = [getattr(mod, attr) for mod, attr in self.LAUNCHERS]

    def _keep(self, key, args) -> None:
        c = self.classes.get(key)
        if c is None:
            self.classes[key] = c = {
                "name": key[0], "calls": 0,
                "args": tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args)}
        c["calls"] += 1

    def __enter__(self):
        seg, unpack, decode, decode_str, expand = self._orig

        def rec_seg(new, x, op_key, identity, order=None, out_dtype=None,
                    name="segreduce"):
            self._keep((name, str(x.dtype), str(out_dtype or x.dtype),
                        op_key, int(new.shape[0]), int(x.shape[0])),
                       (new, x, op_key, identity, order, out_dtype))
            return seg(new, x, op_key, identity, order, out_dtype,
                       name=name)

        def rec_unpack(b, w, ncap, out=None):
            # a call into a slice keeps a copy of the slice to write into
            self._keep(("decode.unpack_bits", w, ncap, out is not None),
                       (b, w, ncap, out))
            return unpack(b, w, ncap, out)

        def rec_decode(dbuf, codes, keep):
            self._keep(("filter_decode.decode", str(dbuf.dtype),
                        dbuf.shape[0], codes.shape[0]), (dbuf, codes, keep))
            return decode(dbuf, codes, keep)

        def rec_decode_str(dbuf, bb, lw, keep, width):
            self._keep(("filter_decode.decode_str", dbuf.shape[0],
                        bb.shape[0], width), (dbuf, bb, lw, keep, width))
            return decode_str(dbuf, bb, lw, keep, width)

        def rec_expand(table, packed, w, ncap, cap):
            self._keep(("decode.expand_stream", w, ncap, cap,
                        table.shape[0], str(table.dtype)),
                       (table, packed, w, ncap, cap))
            return expand(table, packed, w, ncap, cap)

        for (mod, attr), fn in zip(self.LAUNCHERS, (
                rec_seg, rec_unpack, rec_decode, rec_decode_str,
                rec_expand)):
            setattr(mod, attr, fn)
        return self

    def __exit__(self, *a):
        for (mod, attr), fn in zip(self.LAUNCHERS, self._orig):
            setattr(mod, attr, fn)


class DownloadCounter:
    """Records each ``CopyStream.download`` (the collect's packed
    download: one wait per call) and the wire dtypes of every batch it
    copies, one pinned copy each."""

    def __enter__(self):
        from spark_rapids_tpu_torch.columnar import transfer
        self._cls = transfer.CopyStream
        self._orig = orig = self._cls.download
        self.calls = []

        def download(stream, buffers):
            self.calls.append([sorted(b) for b in buffers])
            return orig(stream, buffers)
        self._cls.download = download
        return self

    def __exit__(self, *a):
        self._cls.download = self._orig


def q6_reference(table: pa.Table, price: float = 150.0) -> pa.Table:
    f = table.filter(pc.greater(table["ss_sales_price"], price))
    return f.group_by("ss_item_sk").aggregate(
        [("ss_item_sk", "count"), ("ss_quantity", "sum"),
         ("ss_ext_sales_price", "mean")]).sort_by("ss_item_sk")


def check_q6(out: pa.Table, ref: pa.Table) -> float:
    out = out.sort_by("ss_item_sk")
    if out.num_rows != ref.num_rows:
        fail(f"q6 rows {out.num_rows} != pyarrow {ref.num_rows}")
    for got, want in (("ss_item_sk", "ss_item_sk"),
                      ("cnt", "ss_item_sk_count"),
                      ("qty", "ss_quantity_sum")):
        if not np.array_equal(out[got].to_numpy(), ref[want].to_numpy()):
            fail(f"q6 column {got} differs from pyarrow")
    a = out["aesp"].to_numpy()
    r = ref["ss_ext_sales_price_mean"].to_numpy()
    rel = np.abs(a - r) / np.abs(r)
    if not (np.all(np.isfinite(a)) and rel.max() <= 1e-9):
        fail(f"q6 averages differ from pyarrow (max rel {rel.max()})")
    return float(rel.max())


_Q6_TABLE = []


def q6_table():
    """The in-memory q6's SF10 table and its pyarrow result, made once."""
    from spark_rapids_tpu_torch.entry import gen_store_sales
    if not _Q6_TABLE:
        t0 = time.perf_counter()
        table = gen_store_sales(Q6_ROWS, seed=42)
        ref = q6_reference(table)
        log(f"q6: generated {Q6_ROWS} rows + pyarrow reference in "
            f"{time.perf_counter() - t0:.1f} s ({ref.num_rows} groups)")
        _Q6_TABLE.append((table, ref))
    return _Q6_TABLE[0]


def phase_q6():
    from spark_rapids_tpu_torch.entry import collect, q6_plan
    table, ref = q6_table()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with ShapeRecorder() as shapes:
        out = collect(q6_plan(table, partitions=Q6_PARTS, device="cuda",
                              conf=SCAN_CONF))
    launches = dict(kb.launches)
    fallbacks = dict(kb.fallbacks)
    rel = check_q6(out, ref)
    log(f"q6: {out.num_rows} groups match pyarrow (avg max rel {rel:.3g}); "
        f"launches {launches}; fallbacks {fallbacks}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in SEGREDUCE:
        if launches.get(name, 0) <= 0:
            fail(f"q6 did not launch {name}")
    if fallbacks:
        fail(f"q6 took plain fallbacks: {fallbacks}")
    walls, events, sections = [], [], []
    for i in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        plan = q6_plan(table, partitions=Q6_PARTS, device="cuda",
                       conf=SCAN_CONF)
        o = collect(plan)
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        events.append(start.elapsed_time(end) / 1e3)
        if i == 0:
            check_q6(o, ref)
        else:
            sections.append(_sections(plan))
    log(f"q6 wall: median {statistics.median(walls[1:]) * 1e3:.1f} ms of 5 "
        f"after 1 warm-up on the host clock, "
        f"{statistics.median(events[1:]) * 1e3:.1f} ms between CUDA events "
        f"(host-clock runs ms: "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}); host table "
        f"{table.nbytes / 2**30:.2f} GiB")
    med = {k: statistics.median(s[k] for s in sections)
           for k in sections[0]}
    log("q6 wall by section (host clock, median of 5; the aggregate's "
        "rung and merge choices read the device, so its sections include "
        "the device work): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in med.items()))
    return launches, shapes.classes


# exec sections timed in Metrics.extra (nanoseconds); the other extras
# are counts
TIME_SECTIONS = ("transition.upload", "scan.hostPrepTime", "scan.uploadTime",
                 "scan.dispatch", "scan.decode", "agg.update", "agg.merge")


def _sections(plan, keys=TIME_SECTIONS) -> dict:
    """Host seconds per exec section of one run (``keys``; for q6: the
    upload (Arrow -> device in memory; host prep, upload and the fused
    decode's dispatch for Parquet), the aggregate's update and merge; the
    rest of the wall is the scan's slicing, finalize and the download)."""
    out = {}

    def one(node):
        for k, ns in node.metrics.extra.items():
            if k in keys:
                out[k] = out.get(k, 0.0) + ns / 1e9
    plan.foreach(one)
    return out


# ---------------------------------------------------------------------------
# 5-6. q6 and q6s over Parquet files
# ---------------------------------------------------------------------------

def _parquet_dir(tag: str) -> str:
    """A fresh directory under chiprun_out/ for one phase's files; the
    phase removes it (the files are far larger than what a run may bring
    back)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"{tag}-", dir=OUT_DIR)


def _reset_counts() -> None:
    """Set the launch and fallback counts to 0 before a run that is read
    against its pins, and empty the shared-scan window
    (io/scan_share.py, on by default): a batch an earlier query left
    there would serve this run's scan with no decode, and every pin was
    taken from a run that decodes its own scans."""
    _clear_share()
    kb.reset_counts()


def _check_launches(tag: str, launches, fallbacks, want) -> None:
    for name in want:
        if launches.get(name, 0) <= 0:
            fail(f"{tag} did not launch {name}")
    if fallbacks:
        fail(f"{tag} took plain fallbacks: {fallbacks}")


def _scan_of(plan):
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    found = []
    plan.foreach(lambda n: found.append(n)
                 if isinstance(n, TpuParquetScanExec) else None)
    return found[0]


# sections a prefetch thread may time beside the consumer's: the rest of
# the wall is what the consumer's own sections leave
OVERLAPPED = ("scan.hostPrepTime", "scan.uploadTime")


def _fmt_sections(sec: dict, wall: float) -> str:
    rest = wall - sum(v for k, v in sec.items() if k not in OVERLAPPED)
    return ", ".join([f"{k} {v * 1e3:.1f} ms" for k, v in sec.items()] +
                     [f"rest {rest * 1e3:.1f} ms (the wall less the "
                      f"sections but {', '.join(OVERLAPPED)}, which may run "
                      f"on prefetch threads)"])


def _timed_run(make_plan):
    """(output, plan, host-clock s, CUDA-event s) of one run."""
    from spark_rapids_tpu_torch.entry import collect
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    plan = make_plan()
    out = collect(plan)
    end.record()
    torch.cuda.synchronize()
    return out, plan, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def write_q6_files(root: str) -> pa.Table:
    """The bench's 8 SF10 files under ``root``; returns the pyarrow q6."""
    from spark_rapids_tpu_torch.entry import write_store_sales
    t0 = time.perf_counter()
    write_store_sales(root, Q6_ROWS, files=Q6_PARTS)
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for f in os.listdir(root))
    ref = q6_reference(papq.read_table(root, columns=Q6PF_COLUMNS))
    log(f"q6 files: wrote {Q6_ROWS} rows in {Q6_PARTS} files "
        f"({nbytes / 2**20:.1f} MiB) + pyarrow reference in "
        f"{time.perf_counter() - t0:.1f} s ({ref.num_rows} groups)")
    return ref


def phase_q6_parquet(root: str, ref: pa.Table):
    from spark_rapids_tpu_torch.columnar.batch import bucket_rows
    from spark_rapids_tpu_torch.entry import q6_parquet_plan
    from spark_rapids_tpu_torch.io import parquet_meta as pm
    from spark_rapids_tpu_torch.io import scan_cache as sc
    # room for every chunk plan of both readers, so warm runs walk nothing
    sc.configure(True, 8 << 30)
    sc.clear()
    torch.cuda.reset_peak_memory_stats()
    walks0 = pm.walk_count()
    _reset_counts()
    with ShapeRecorder() as shapes:
        out, plan, wall, ev = _timed_run(
            lambda: q6_parquet_plan(root, device="cuda", conf=SCAN_CONF))
    launches = dict(kb.launches)
    fallbacks = dict(kb.fallbacks)
    walks = pm.walk_count() - walks0
    rel = check_q6(out, ref)
    scan = _scan_of(plan)
    fb_cols = scan.metrics.extra["fallbackColumns"]
    log(f"q6-parquet: {out.num_rows} groups match pyarrow (avg max rel "
        f"{rel:.3g}); launches {launches}; fallbacks {fallbacks}; "
        f"fallbackColumns {fb_cols}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _check_launches("q6-parquet", launches, fallbacks, Q6P_KERNELS)
    if fb_cols:
        fail(f"q6-parquet decoded {fb_cols} columns on the host")
    groups = scan._fused_groups()
    caps = {}
    for srcs, _pv in groups:
        rows = sum(sc.get_footer(p).metadata.row_group(rg).num_rows
                   for p, rg in srcs)
        caps[bucket_rows(rows)] = caps.get(bucket_rows(rows), 0) + 1
    log(f"q6-parquet fused batches: {len(groups)} "
        f"({scan.metrics.num_output_batches} emitted), capacities "
        + ", ".join(f"{n} x 2^{c.bit_length() - 1}"
                    for c, n in sorted(caps.items())))
    log(f"q6-parquet cold run (footers, {walks} page walks, plan cache "
        f"empty): {wall * 1e3:.1f} ms on the host clock, "
        f"{ev * 1e3:.1f} ms between CUDA events; sections "
        f"{_fmt_sections(_sections(plan), wall)}")
    walls, events, sections = [], [], []
    walks0 = pm.walk_count()
    for i in range(5):
        o, plan, wall, ev = _timed_run(
            lambda: q6_parquet_plan(root, device="cuda", conf=SCAN_CONF))
        walls.append(wall)
        events.append(ev)
        sections.append(_sections(plan))
        if i == 0:
            check_q6(o, ref)
    if pm.walk_count() != walks0:
        fail(f"warm q6-parquet runs walked "
             f"{pm.walk_count() - walks0} chunks")
    med_wall = statistics.median(walls)
    med = {k: statistics.median(s[k] for s in sections)
           for k in sections[0]}
    log(f"q6-parquet warm wall: median {med_wall * 1e3:.1f} ms of 5 on "
        f"the host clock, {statistics.median(events) * 1e3:.1f} ms "
        f"between CUDA events (host-clock runs ms: "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}); 0 page walks; "
        f"plan cache {sc.stats()}")
    log("q6-parquet warm wall by section (host clock, median of 5; the "
        "aggregate's rung and merge choices read the device, so its "
        "sections include the device work): "
        + _fmt_sections(med, med_wall))
    return launches, shapes.classes, fallbacks


def _perfile_prediction(root: str) -> dict:
    """The expand launches, unpack launches and mixed-width fallbacks q6
    through the PERFILE reader must make: one expand launch or one
    fallback per stream of its chunk plans (served by the plan cache, so
    nothing is walked), by the stream's bit widths, and no unpack launch:
    the expansion reads the packed bits itself."""
    from spark_rapids_tpu_torch.io import scan_cache as sc
    from spark_rapids_tpu_torch.io.device_parquet import leaf_map
    from spark_rapids_tpu_torch.plan.logical import Schema
    want = {"expand": 0, "unpack": 0, "mixed": 0, "streams": 0,
            "row_groups": 0, "widths": {}}
    for f in sorted(os.listdir(root)):
        path = os.path.join(root, f)
        pf = sc.get_footer(path)
        schema = Schema.from_arrow(pf.schema_arrow)
        leaf = leaf_map(pf)
        for rg in range(pf.metadata.num_row_groups):
            want["row_groups"] += 1
            for c in Q6PF_COLUMNS:
                p = sc.get_chunk_plan(sc.handle_key(pf, path), path, rg,
                                      leaf[c], schema.field(c).dtype, True,
                                      pf)
                streams = [("def", p.def_runs)] if p.nullable else []
                if p.mode != "plain":
                    streams.append((p.mode, p.val_runs))
                for kind, runs in streams:
                    ok, w, _ = kdec.stream_width(runs)
                    want["streams"] += 1
                    want["expand"] += ok
                    want["mixed"] += not ok
                    ws = sorted({int(x) for x, r in zip(runs.widths,
                                                        runs.is_rle)
                                 if not r})
                    key = f"{c}.{kind}: bit-packed widths {ws or 'none'}"
                    want["widths"][key] = want["widths"].get(key, 0) + 1
    return want


# host functions whose time the sections split out, by form: the fused
# host prep's two halves, the PERFILE decode's O(runs) Python, the
# in-memory upload's host work (the rest of transition.upload is the copy)
HOST_FNS = {
    "fused": (("spark_rapids_tpu_torch.io.parquet_fused", "_collect_plans"),
              ("spark_rapids_tpu_torch.io.parquet_fused", "assemble")),
    "perfile": (("spark_rapids_tpu_torch.kernels.decode", "stream_width"),
                ("spark_rapids_tpu_torch.kernels.decode", "_dense_extent"),
                ("spark_rapids_tpu_torch.kernels.decode", "_dense_meta"),
                # the run matrix of a mixed-width stream: built for the
                # row group's one upload, or uploaded on its own (a
                # checkout that uploads column by column)
                ("spark_rapids_tpu_torch.io.device_parquet", "_runs_arrays"),
                ("spark_rapids_tpu_torch.io.device_parquet", "_upload_runs")),
    "memory": (("spark_rapids_tpu_torch.columnar.batch",
                "_np_column_from_arrow"),
               ("spark_rapids_tpu_torch.columnar.batch", "_upload_hints")),
}


class FnTimer:
    """Adds up the host time of module functions while entered, over
    every thread (the prefetch threads call the fused host prep).  A
    function the checkout does not have is left out (pipeline_profile.py
    times another checkout with this script's targets)."""

    def __init__(self, targets):
        import importlib
        import threading
        mods = [(importlib.import_module(m), a) for m, a in targets]
        self.targets = [(m, a) for m, a in mods if hasattr(m, a)]
        self.seconds = {a: 0.0 for _, a in self.targets}
        self._lock = threading.Lock()

    def __enter__(self):
        self._orig = [getattr(m, a) for m, a in self.targets]
        for (m, a), fn in zip(self.targets, self._orig):
            def timed_fn(*args, _fn=fn, _a=a, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t0
                    with self._lock:
                        self.seconds[_a] += dt
            setattr(m, a, timed_fn)
        return self

    def __exit__(self, *a):
        for (m, attr), fn in zip(self.targets, self._orig):
            setattr(m, attr, fn)


def _check_perfile_counts(tag: str, launches, fallbacks, want) -> None:
    got = (launches.get("decode.expand_stream", 0),
           launches.get("decode.unpack_bits", 0),
           fallbacks.get("decode.expand.mixed_widths", 0))
    if got != (want["expand"], want["unpack"], want["mixed"]):
        fail(f"{tag}: expand/unpack launches and mixed-width fallbacks "
             f"{got} != predicted {(want['expand'], want['unpack'], want['mixed'])}")
    other = {k: v for k, v in fallbacks.items()
             if k != "decode.expand.mixed_widths"}
    if other:
        fail(f"{tag} took other plain fallbacks: {other}")
    for name in SEGREDUCE:
        if launches.get(name, 0) <= 0:
            fail(f"{tag} did not launch {name}")


def phase_q6_perfile(root: str, ref: pa.Table):
    """q6 through the PERFILE reader over the q6-parquet phase's files."""
    from spark_rapids_tpu_torch.entry import q6_perfile_plan
    from spark_rapids_tpu_torch.io import parquet_meta as pm
    from spark_rapids_tpu_torch.io import scan_cache as sc
    # room for both readers' plans (they key plans apart): warm runs walk
    # nothing
    sc.configure(True, 8 << 30)
    torch.cuda.reset_peak_memory_stats()
    walks0 = pm.walk_count()
    _reset_counts()
    with ShapeRecorder() as shapes:
        out, plan, wall, ev = _timed_run(
            lambda: q6_perfile_plan(root, device="cuda", conf=SCAN_CONF))
    launches = dict(kb.launches)
    fallbacks = dict(kb.fallbacks)
    walks = pm.walk_count() - walks0
    rel = check_q6(out, ref)
    scan = _scan_of(plan)
    fb_cols = scan.metrics.extra["fallbackColumns"]
    want = _perfile_prediction(root)
    log(f"q6-perfile: {out.num_rows} groups match pyarrow (avg max rel "
        f"{rel:.3g}); {scan.metrics.num_output_batches} batches (one per "
        f"row group of {want['row_groups']}); launches {launches}; "
        f"fallbacks {fallbacks}; fallbackColumns {fb_cols}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"q6-perfile predicted from the plans' {want['streams']} streams: "
        f"{want['expand']} expand, {want['unpack']} unpack launches, "
        f"{want['mixed']} mixed-width fallbacks; streams by width: "
        f"{want['widths']}")
    _check_perfile_counts("q6-perfile", launches, fallbacks, want)
    if fb_cols:
        fail(f"q6-perfile decoded {fb_cols} columns on the host")
    if scan.metrics.num_output_batches != want["row_groups"]:
        fail("q6-perfile did not emit one batch per row group")
    log(f"q6-perfile cold run ({walks} page walks; the fused reader's "
        f"plans are cached, the PERFILE reader walks with allow_mixed): "
        f"{wall * 1e3:.1f} ms on the host clock, {ev * 1e3:.1f} ms between "
        f"CUDA events; sections {_fmt_sections(_sections(plan), wall)}")
    walls, events, sections, hosts = [], [], [], []
    walks0 = pm.walk_count()
    for i in range(5):
        _reset_counts()
        with FnTimer(HOST_FNS["perfile"]) as ht:
            o, plan, wall, ev = _timed_run(
                lambda: q6_perfile_plan(root, device="cuda", conf=SCAN_CONF))
        _check_perfile_counts(f"warm q6-perfile run {i}", dict(kb.launches),
                              dict(kb.fallbacks), want)
        walls.append(wall)
        events.append(ev)
        sections.append(_sections(plan))
        hosts.append(ht.seconds)
        if i == 0:
            check_q6(o, ref)
    if pm.walk_count() != walks0:
        fail(f"warm q6-perfile runs walked {pm.walk_count() - walks0} "
             f"chunks")
    med_wall = statistics.median(walls)
    med = {k: statistics.median(s[k] for s in sections)
           for k in sections[0]}
    host = {k: statistics.median(h.get(k, 0.0) for h in hosts)
            for k in hosts[0]}
    log(f"q6-perfile warm wall: median {med_wall * 1e3:.1f} ms of 5 on the "
        f"host clock, {statistics.median(events) * 1e3:.1f} ms between CUDA "
        f"events (host-clock runs ms: "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}); 0 page walks; "
        f"plan cache {sc.stats()}")
    log("q6-perfile warm wall by section (host clock, median of 5; "
        "scan.decode is host work and enqueue, the aggregate's sections "
        "include the device work they wait for): "
        + _fmt_sections(med, med_wall))
    log("q6-perfile host part of scan.decode (median of 5, O(runs) "
        "Python): " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                for k, v in host.items())
        + f"; total {sum(host.values()) * 1e3:.1f} ms")
    return launches, shapes.classes, fallbacks


def bench_query(session, path, price: float = 150.0):
    """``bench.py::_query``, written against the port's ``col`` and
    ``functions`` (``price`` is its filter literal)."""
    from spark_rapids_tpu_torch.api import col, functions as F
    return (session.read.parquet(path)
            .filter(col("ss_sales_price") > price)
            .group_by("ss_item_sk")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_quantity").alias("qty"),
                 F.avg("ss_ext_sales_price").alias("aesp")))


def _plan_nodes(plan):
    nodes = []
    plan.foreach(nodes.append)
    return nodes


def _timed_collect(df):
    """(output, host-clock s, CUDA-event s) of one ``df.collect()``:
    planning, execution and the download."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = df.collect()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def _session_query(tag, df, ref, want, perfile: bool, entry_plan) -> None:
    """Plan ``df`` on its session (test mode asserts the device placement),
    check the plan the planner built, run it with the counts set to 0 and
    read them after, check the rows, and time the planning and the warm
    collect.  ``want``: the (launches, fallbacks) of the q6p or q6pf
    phase; ``entry_plan()`` builds that phase's plan, whose warm runs
    alternate with the session's so the two walls compare in one call."""
    from spark_rapids_tpu_torch.exec.tpu_aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    log(f"{tag} explain_string('physical'):\n" +
        df.explain_string("physical"))
    nodes = _plan_nodes(df.session._plan_physical(df.plan).plan)
    scans = [n for n in nodes if isinstance(n, TpuParquetScanExec)]
    aggs = [n for n in nodes if isinstance(n, TpuHashAggregateExec)]
    host = [type(n).__name__ for n in nodes
            if not n.is_tpu and type(n).__name__ not in HOST_OK]
    # input_file_name() has no device evaluator in the reference either:
    # both plan it as a host projection over the aggregate's download
    if host != (["CpuProjectExec"] if perfile else []):
        fail(f"{tag}: plan has host nodes {host}")
    if len(scans) != 1 or len(aggs) != 1:
        fail(f"{tag}: plan has {len(scans)} device scans and {len(aggs)} "
             f"aggregates")
    scan, agg = scans[0], aggs[0]
    if agg.fused_condition is None or agg.children[0] is not scan:
        fail(f"{tag}: the filter is not fused into the aggregate above "
             f"the scan")
    if scan._pushed_filter is None:
        fail(f"{tag}: the planner pushed no filter into the scan")
    if scan.allow_fused == perfile:
        fail(f"{tag}: scan allow_fused is {scan.allow_fused}")
    _reset_counts()
    out, wall, ev = _timed_collect(df)
    launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
    rel = check_q6(out, ref)
    if perfile and set(out["file"].to_pylist()) != {""}:
        fail(f"{tag}: input_file_name() after the aggregate is not empty")
    log(f"{tag}: {out.num_rows} groups match pyarrow (avg max rel "
        f"{rel:.3g}); launches {launches}; fallbacks {fallbacks}; first "
        f"run {wall * 1e3:.1f} ms on the host clock, {ev * 1e3:.1f} ms "
        f"between CUDA events")
    if (launches, fallbacks) != want:
        fail(f"{tag}: launches/fallbacks {launches} {fallbacks} != the "
             f"entry form's {want[0]} {want[1]}")
    plans = []
    for _ in range(5):
        t0 = time.perf_counter()
        df.session._plan_physical(df.plan)
        plans.append(time.perf_counter() - t0)
    log(f"{tag} planning (_plan_physical, host clock): median "
        f"{statistics.median(plans) * 1e3:.2f} ms of 5 (runs ms: "
        f"{', '.join(f'{p * 1e3:.2f}' for p in plans)})")
    walls = {"session": [], "entry": []}
    for i in range(5):
        order = ("session", "entry") if i % 2 == 0 else ("entry", "session")
        for who in order:
            if who == "session":
                wall = _timed_collect(df)[1]
            else:
                wall = _timed_run(entry_plan)[2]
            walls[who].append(wall)
    for who, label in (("session", "warm collect wall"),
                       ("entry", "entry form's warm wall, in turns")):
        w = walls[who]
        log(f"{tag} {label}: median {statistics.median(w) * 1e3:.1f} ms "
            f"of 5 on the host clock (runs ms: "
            f"{', '.join(f'{x * 1e3:.1f}' for x in w)})")


def phase_session(root: str, ref: pa.Table, counts: dict) -> None:
    """``bench.py::_query`` over the SF10 files on a port session on
    ``cuda``, and the same query with a selected ``input_file_name()``
    column (the planner switches the scan to its PERFILE reader).  Their
    launch and fallback counts must equal the q6p and q6pf phases'
    (``counts``: their (launches, fallbacks) by phase)."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.entry import (collect, q6_parquet_plan,
                                              q6_perfile_plan)
    want = dict(counts)
    for key, make in (("q6p", q6_parquet_plan), ("q6pf", q6_perfile_plan)):
        if key not in want:  # the phase runs alone: count that form once
            _reset_counts()
            collect(make(root, device="cuda", conf=SCAN_CONF))
            want[key] = dict(kb.launches), dict(kb.fallbacks)
    conf = dict(SCAN_CONF, **{
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True})
    session = TpuSparkSession(conf, device="cuda")
    _session_query("session q6", bench_query(session, root), ref,
                   want["q6p"], perfile=False, entry_plan=lambda:
                   q6_parquet_plan(root, device="cuda", conf=SCAN_CONF))
    session = TpuSparkSession(dict(conf, **{
        "spark.rapids.tpu.sql.test.allowedNonTpu": "CpuProjectExec"}),
        device="cuda")
    _session_query("session q6 + input_file_name()",
                   bench_query(session, root).with_column(
                       "file", F.input_file_name()),
                   ref, want["q6pf"], perfile=True, entry_plan=lambda:
                   q6_perfile_plan(root, device="cuda", conf=SCAN_CONF))


def phase_q6s_parquet():
    from spark_rapids_tpu_torch.entry import (q6s_parquet_plan,
                                              write_store_sales)
    root = _parquet_dir("q6s-parquet")
    try:
        write_store_sales(root, Q6S_ROWS, files=Q6S_FILES, item_id=True)
        t = papq.read_table(root, columns=["ss_item_id", "ss_quantity",
                                           "ss_sales_price"])
        f = t.filter(pc.greater(t["ss_sales_price"], 150.0))
        ref = f.group_by("ss_item_id").aggregate(
            [("ss_item_id", "count"), ("ss_quantity", "sum")]
        ).sort_by("ss_item_id")
        _reset_counts()
        with ShapeRecorder() as shapes:
            out, _plan, wall, ev = _timed_run(
                lambda: q6s_parquet_plan(root, device="cuda",
                                         conf=SCAN_CONF))
        launches = dict(kb.launches)
        fallbacks = dict(kb.fallbacks)
        out = out.sort_by("ss_item_id")
        for got, want in (("ss_item_id", "ss_item_id"),
                          ("cnt", "ss_item_id_count"),
                          ("qty", "ss_quantity_sum")):
            if out[got].to_pylist() != ref[want].to_pylist():
                fail(f"q6s column {got} differs from pyarrow")
        log(f"q6s-parquet: {Q6S_ROWS} rows in {Q6S_FILES} files, "
            f"{out.num_rows} string groups match pyarrow; cold wall "
            f"{wall * 1e3:.1f} ms ({ev * 1e3:.1f} ms between CUDA events); "
            f"launches {launches}; fallbacks {fallbacks}")
        _check_launches("q6s-parquet", launches, fallbacks, Q6S_KERNELS)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, shapes.classes


def _modes_table(n: int, seed: int) -> pa.Table:
    """About 4% nulls in every column; a boolean; a double dictionary
    that overflows into PLAIN pages; 16-character string keys; a
    list<int32> of 0-4 elements, some lists and elements null."""
    from spark_rapids_tpu_torch.entry import item_ids
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.04
    null_list = nulls()
    # a null list spans no elements (pyarrow refuses one that does)
    lens = np.where(null_list, 0, rng.integers(0, 5, n)).astype(np.int32)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    elems = pa.array(rng.integers(0, 100, int(offsets[-1])).astype(np.int32),
                     mask=rng.random(int(offsets[-1])) < 0.04)
    lists = pa.ListArray.from_arrays(pa.array(offsets), elems,
                                     mask=pa.array(null_list))
    return pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64(), mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "f": pa.array(np.round(rng.uniform(0, 1e6, n), 2), mask=nulls()),
        "s": pa.array(item_ids(rng.integers(1, 5001, n)).to_numpy(
            zero_copy_only=False), type=pa.string(), mask=nulls()),
        "l": lists,
    })


def _list_matches(col, want: pa.ListArray, n: int) -> bool:
    """The port's [cap, L] list column against pyarrow's list array."""
    lens = np.where(want.is_null().to_numpy(zero_copy_only=False), 0,
                    np.diff(want.offsets.to_numpy()))
    L = col.data.shape[1]
    if lens.max(initial=0) > L:
        return False
    flat = want.flatten()
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(rows.shape[0]) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    data = np.zeros((n, L), np.int32)
    ev = np.zeros((n, L), bool)
    data[rows, cols] = flat.fill_null(0).to_numpy()
    ev[rows, cols] = ~flat.is_null().to_numpy(zero_copy_only=False)
    valid = ~want.is_null().to_numpy(zero_copy_only=False)
    return (np.array_equal(col.validity[:n].cpu().numpy(), valid) and
            np.array_equal(col.lengths[:n].cpu().numpy(), lens) and
            np.array_equal(col.data[:n].cpu().numpy(), data) and
            np.array_equal(col.elem_validity[:n].cpu().numpy(), ev))


def phase_perfile_modes() -> None:
    """Every decode mode of the PERFILE reader at 2^21 rows per file,
    checked row group by row group against pyarrow."""
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, to_arrow
    from spark_rapids_tpu_torch.config import RapidsTpuConf
    from spark_rapids_tpu_torch.io import device_parquet as dp
    from spark_rapids_tpu_torch.io import parquet_meta as pm
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    from spark_rapids_tpu_torch.plan.logical import FileScan, Schema
    root = _parquet_dir("perfile-modes")
    try:
        t0 = time.perf_counter()
        paths = []
        for i in range(MODES_FILES):
            p = os.path.join(root, f"part-{i:04d}.parquet")
            papq.write_table(_modes_table(MODES_ROWS // MODES_FILES, 300 + i),
                             p, use_dictionary=["k", "f", "s", "l"],
                             dictionary_pagesize_limit=256 << 10,
                             data_page_version="1.0")
            paths.append(p)
        pf = papq.ParquetFile(paths[0])
        modes = {}
        schema = Schema.from_arrow(pf.schema_arrow)
        for c, leaf in dp.leaf_map(pf).items():
            if schema.field(c).dtype.is_list:
                modes[c] = "list"
                continue
            chunk = pm.read_chunk_pages(paths[0], 0, leaf, parquet_file=pf)
            modes[c] = dp.plan_chunk(chunk, schema.field(c).dtype,
                                     allow_mixed=True).mode
        if modes != {"k": "dict", "b": "bool", "f": "mixed",
                     "s": "dict_str", "l": "list"}:
            fail(f"perfile-modes: files do not hold every mode: {modes}")
        log(f"perfile-modes: wrote {MODES_ROWS} rows in {MODES_FILES} files "
            f"in {time.perf_counter() - t0:.1f} s; first chunks' modes "
            f"{modes}")
        scan = TpuParquetScanExec(
            FileScan("parquet", paths, schema, {}),
            RapidsTpuConf({"spark.rapids.tpu.sql.format.parquet.fusedDecode"
                           ".enabled": False}), device="cuda")
        _reset_counts()
        t0 = time.perf_counter()
        n_rg = 0
        for part, path in zip(scan.execute(), paths):
            want_pf = papq.ParquetFile(path)
            for rg, batch in enumerate(part):
                want = want_pf.read_row_group(rg)
                n = want.num_rows
                if int(batch.num_rows) != n:
                    fail(f"perfile-modes {path}#{rg}: {batch.num_rows} rows "
                         f"!= {n}")
                flat = [c for c in batch.names if c != "l"]
                got = to_arrow(DeviceBatch(
                    flat, [batch.columns[batch.names.index(c)]
                           for c in flat], n))
                if not got.equals(want.select(flat).cast(got.schema)):
                    fail(f"perfile-modes {path}#{rg}: flat columns differ "
                         f"from pyarrow")
                lcol = batch.columns[batch.names.index("l")]
                if not _list_matches(lcol, want["l"].combine_chunks(), n):
                    fail(f"perfile-modes {path}#{rg}: the list column "
                         f"differs from pyarrow")
                n_rg += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
        fb_cols = scan.metrics.extra["fallbackColumns"]
        log(f"perfile-modes: {n_rg} row groups match pyarrow in "
            f"{wall:.1f} s (check included); launches {launches}; "
            f"fallbacks {fallbacks}; fallbackColumns {fb_cols}")
        if launches.get("decode.expand_stream", 0) <= 0:
            fail("perfile-modes did not launch decode.expand_stream")
        if launches.get("decode.unpack_bits", 0):
            fail("perfile-modes launched decode.unpack_bits")
        if set(fallbacks) - {"decode.expand.mixed_widths"} or fb_cols:
            fail("perfile-modes took fallbacks other than mixed widths")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# 11. the scan pipeline: prefetch depth, counters, traces, sections
# ---------------------------------------------------------------------------

DEPTH_KEY = "spark.rapids.tpu.sql.scan.prefetch.depth"
# the launches and fallbacks of each q6 form as they were before the scan
# pipeline, which must not change them: the fused and PERFILE q6 through
# bench.py::_query on a session, the in-memory q6 through entry.q6_plan
PIPELINE_COUNTS = {
    "fused": ({"decode.unpack_bits": 48, "filter_decode.decode": 32,
               "segreduce.seg_scan_sorted": 48,
               "segreduce.gather_seg_scan": 37}, {}),
    "perfile": ({"decode.expand_stream": 160,
                 "segreduce.seg_scan_sorted": 32,
                 "segreduce.gather_seg_scan": 133},
                {"decode.expand.mixed_widths": 32}),
    "memory": ({"segreduce.seg_scan_sorted": 96,
                "segreduce.gather_seg_scan": 69}, {}),
}
PIPELINE_COUNTERS = ("scan.prefetchStalls", "scan.prefetchOverlapNs",
                     "scan.prefetchStallNs", "semaphore.acquires",
                     "semaphore.waitNs")
def pipeline_forms(root: str, table: pa.Table):
    """form -> run(conf) -> (Arrow output, planned plan): the fused and the
    PERFILE q6 as bench.py::_query on a port session (its partitions drain
    on concurrentTpuTasks threads), the in-memory q6 as entry.q6_plan."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.entry import collect, q6_plan

    def on_session(conf):
        s = TpuSparkSession(dict(
            {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True},
            **conf), device="cuda")
        plans = []
        s.add_plan_listener(lambda r: plans.append(r.plan))
        out = bench_query(s, root).collect()
        return out, plans[-1]

    def memory(conf):
        plan = q6_plan(table, partitions=Q6_PARTS, device="cuda",
                       conf=conf)
        return collect(plan), plan

    perfile = {"spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled":
               False}
    return {"fused": lambda conf: on_session(dict(SCAN_CONF, **conf)),
            "perfile": lambda conf: on_session(dict(SCAN_CONF, **perfile,
                                                    **conf)),
            "memory": lambda conf: memory(dict(SCAN_CONF, **conf))}


def form_sections(form: str, run, conf: dict, reps: int = 5) -> dict:
    """Median of ``reps`` warm runs of one form (after one warm-up): the
    wall on the host clock, every exec section, the host functions of
    HOST_FNS[form], and the runs' walls."""
    run(conf)
    torch.cuda.synchronize()
    walls, secs, fns = [], [], []
    for _ in range(reps):
        with FnTimer(HOST_FNS[form]) as ft:
            t0 = time.perf_counter()
            _out, plan = run(conf)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        secs.append(_sections(plan))
        fns.append(dict(ft.seconds))
    out = {"wall": statistics.median(walls)}
    for k in secs[0]:
        out[k] = statistics.median(s.get(k, 0.0) for s in secs)
    for k in fns[0]:
        out[k] = statistics.median(f[k] for f in fns)
    out["walls"] = walls
    return out


def _fmt_ms(d: dict) -> str:
    return ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in d.items()
                     if k != "walls")


def _merge(ivs):
    """Union of [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _profiler_events(prof) -> list:
    """(name, device type, start ns, end ns) of every event the profiler
    kept, read from its kineto results as torch's own event list reads
    them (hidden events left out).  Building that list of FunctionEvents
    instead took seconds per traced query of ~30,000 kernels."""
    return [(e.name(), e.device_type(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if not getattr(e, "is_hidden_event", lambda: False)()]


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def trace_form(tag: str, run, conf: dict, label: str = "pipeline",
               launch_spans=()) -> dict:
    """One warm query (every caller has just run it) under
    torch.profiler (CPU and CUDA) with the span tracer on.  The device's busy share is the union of its kernel and
    memcpy/memset intervals over the query's wall; prints the ten device
    operations that took the most time and the five longest idle gaps,
    each named by the host spans (obs/trace.py) it fell in.  For each
    span name in ``launch_spans``, counts the kernel launches the host
    made inside those spans (the launch calls the profiler records on the
    CPU; a launch from another thread in that window counts too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from spark_rapids_tpu_torch.obs import trace as obstrace
    # the session switches the span tracer from its conf, as the
    # reference's does
    conf = dict(conf, **{"spark.rapids.tpu.obs.trace.enabled": True})
    mark = obstrace.mark()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("pipeline.align"):
                t_align = time.perf_counter_ns()
            t0 = time.perf_counter_ns()
            run(conf)
            torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
    finally:
        obstrace.configure(False)
    spans = obstrace.spans_since(mark)
    events = _profiler_events(prof)
    align = [a for name, d, a, _b in events
             if name == "pipeline.align" and d == DeviceType.CPU]
    dev = [(name, a, b) for name, d, a, b in events
           if d == DeviceType.CUDA]
    if not align or not dev:
        fail(f"{label} trace {tag}: the profiler recorded "
             f"{len(dev)} device operations and {len(align)} markers")
    # profiler nanoseconds -> host perf_counter nanoseconds
    off_ns = t_align - align[0]
    ivs = [(a + off_ns, b + off_ns) for _name, a, b in dev]
    busy = [(max(a, t0), min(b, t1)) for a, b in _merge(ivs)
            if b > t0 and a < t1]
    busy_ns = sum(b - a for a, b in busy)
    wall_ns = t1 - t0
    by_name = {}      # name -> (device microseconds, operations)
    for name, a, b in dev:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (b - a) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    copies = {k: v for k, v in sorted(by_name.items())
              if k.startswith("Memcpy")}
    gaps, prev = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:5]

    def named(g0, g1):
        over = {}
        for _s, _tid, name, _cat, s0, dur, _d, _args in spans:
            ov = min(g1, s0 + dur) - max(g0, s0)
            if ov > 0:
                over[name] = over.get(name, 0) + ov
        best = sorted(over.items(), key=lambda kv: -kv[1])[:3]
        return ", ".join(f"{n} ({ov / 1e6:.1f} ms)" for n, ov in best) \
            or "no span"
    log(f"{label} trace {tag}: wall {wall_ns / 1e6:.1f} ms, device busy "
        f"{busy_ns / 1e6:.1f} ms = {busy_ns / wall_ns:.1%} of the wall "
        f"(union of {len(dev)} kernel and memcpy/memset intervals; the "
        f"profiler's own host cost is in the wall)")
    log(f"{label} trace {tag}: top device operations: " + "; ".join(
        f"{name[:60]} {tot / 1e3:.2f} ms x{n}" for name, (tot, n) in top))
    log(f"{label} trace {tag}: copies by kind: " + ("; ".join(
        f"{name} {tot / 1e3:.3f} ms x{n}"
        for name, (tot, n) in copies.items()) or "none"))
    log(f"{label} trace {tag}: longest idle gaps: " + "; ".join(
        f"{(b - a) / 1e6:.2f} ms at +{(a - t0) / 1e6:.1f} ms in "
        f"[{named(a, b)}]" for a, b in gaps))
    launches = {}
    if launch_spans:
        calls = [a + off_ns for name, d, a, _b in events
                 if d == DeviceType.CPU and name.startswith(LAUNCH_CALLS)]
        for _s, _tid, name, _cat, s0, dur, _d, _args in spans:
            if name in launch_spans:
                launches[name] = launches.get(name, 0) + sum(
                    s0 <= c < s0 + dur for c in calls)
        log(f"{label} trace {tag}: kernel launches inside "
            + ", ".join(f"{k} {launches.get(k, 0)}" for k in launch_spans)
            + f" (of {len(calls)} in the run)")
    return {"wall_ms": wall_ns / 1e6, "busy_ms": busy_ns / 1e6,
            "busy_share": busy_ns / wall_ns,
            "copies": {k: n for k, (_t, n) in copies.items()},
            "launches": launches}


def _pinned_peak() -> str:
    """The pinned memory torch's caching host allocator held at its peak
    (process lifetime: every upload of the run so far)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    peak = stats().get("allocated_bytes.peak") if stats is not None \
        else None
    if peak is None:
        return "host allocator peak not available"
    return f"host allocator's pinned peak {peak / 2**20:.1f} MiB"


def phase_pipeline(root: str, table: pa.Table, ref: pa.Table,
                   mem_ref: pa.Table) -> dict:
    """The scan pipeline on each q6 form: depth 2 and 0 give the same rows
    as pyarrow and the pinned launch and fallback counts; the prefetch and
    semaphore counters; one profiler trace each; the sections of a
    median of 5 warm runs (fused at depth 2 and 0)."""
    from spark_rapids_tpu_torch.obs import registry as obsreg
    forms = pipeline_forms(root, table)
    refs = {"fused": ref, "perfile": ref, "memory": mem_ref}
    out = {}
    for form, run in forms.items():
        for depth in (2, 0):
            conf = {DEPTH_KEY: depth}
            view = obsreg.get_registry().view()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            got, plan = run(conf)
            launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
            torch.cuda.synchronize()
            counters = view.delta()["counters"]
            rel = check_q6(got, refs[form])
            want = PIPELINE_COUNTS[form]
            log(f"pipeline {form} depth {depth}: {got.num_rows} groups match "
                f"pyarrow (avg max rel {rel:.3g}); launches {launches}; "
                f"fallbacks {fallbacks}; counters " + ", ".join(
                    f"{k} {counters.get(k, 0):.0f}"
                    for k in PIPELINE_COUNTERS)
                + f"; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if (launches, fallbacks) != want:
                fail(f"pipeline {form} depth {depth}: launches/fallbacks "
                     f"{launches} {fallbacks} != the pinned {want}")
            if form == "fused":
                scan = _scan_of(plan)
                cs = scan.copy_stream
                log(f"pipeline fused depth {depth}: "
                    f"{len(scan._fused_groups())} batches, pinned bytes "
                    f"held at most {cs.peak_held_bytes / 2**20:.1f} MiB on "
                    f"the session's copy stream; {_pinned_peak()}")
                if depth == 2 and counters.get(
                        "scan.prefetchOverlapNs", 0) <= 0:
                    fail("pipeline fused depth 2: scan.prefetchOverlapNs "
                         "is 0: the look-ahead overlapped nothing")
            out[(form, depth)] = counters
    busy = {form: trace_form(form, run, {}) for form, run in forms.items()}
    # every upload goes through pinned memory on the copy stream, the
    # PERFILE reader's included
    for form, b in busy.items():
        n = b["copies"].get("Memcpy HtoD (Pageable -> Device)", 0)
        if n:
            fail(f"pipeline trace {form}: {n} pageable host-to-device "
                 f"copies")
    for form, run in forms.items():
        depths = (2, 0) if form == "fused" else (2,)
        for depth in depths:
            sec = form_sections(form, run, {DEPTH_KEY: depth})
            log(f"pipeline sections {form} depth {depth} (host clock, "
                f"median of 5 warm runs; runs ms "
                f"{', '.join(f'{w * 1e3:.1f}' for w in sec['walls'])}): "
                + _fmt_ms(sec))
    return busy


# ---------------------------------------------------------------------------
# 8b. the star-join reporting queries at SF10
# ---------------------------------------------------------------------------

STAR_SF = 10
STAR_SEED = 7
STAR_FILES = 8
STAR_QUERIES = ("q3", "q42", "q52", "q55")
STAR_TABLES = ("date_dim", "item", "store_sales")
STAR_CONF = dict(SCAN_CONF, **{
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
    "spark.rapids.tpu.sql.test.enabled": True,
    # item's size estimate (file bytes x 3) is far over the 10 MiB
    # default; without a broadcast the planner needs the shuffled join
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 2 << 30})
# the kernel launches of each star query, pinned from its first run on
# the H100: the fused scan's unpack, the dictionary gathers the filters
# pushed into the dimension scans defer (date_dim's ints everywhere;
# item's i_brand where item is filtered), and the aggregate's gathered
# segmented scan (each query sums one float64 column; seg_scan_sorted
# serves COUNT(*), min/max and first/last, which none of them computes)
STAR_COUNTS = {
    "q3": {"decode.unpack_bits": 18, "filter_decode.decode": 4,
           "filter_decode.decode_str": 1, "segreduce.gather_seg_scan": 34},
    "q42": {"decode.unpack_bits": 18, "filter_decode.decode": 1,
            "segreduce.gather_seg_scan": 34},
    "q52": {"decode.unpack_bits": 18, "filter_decode.decode": 1,
            "segreduce.gather_seg_scan": 34},
    "q55": {"decode.unpack_bits": 19, "filter_decode.decode": 3,
            "filter_decode.decode_str": 1, "segreduce.gather_seg_scan": 34},
}
# the pushed filter's own dictionary columns decode eagerly (its operands
# must exist before the mask does) and the reference counts each as a
# scan.filterDecode.condition_column fallback of the deferred gathers, once
# per dimension batch: d_moy (and d_year where the query filters on it),
# i_manufact_id / i_manager_id where item is filtered.  No kernel falls
# back to its plain version.
STAR_FALLBACKS = {q: {"scan.filterDecode.condition_column": n}
                  for q, n in (("q3", 2), ("q42", 2), ("q52", 2),
                               ("q55", 3))}
# the dimension each star query filters in front of its join with it
STAR_FILTERED = {"q3": ("date_dim", "item"), "q42": ("date_dim",),
                 "q52": ("date_dim",), "q55": ("date_dim", "item")}
STAR_SECTIONS = ("scan.hostPrepTime", "scan.uploadTime", "scan.dispatch",
                 "join.count", "join.emit", "join.probeCount",
                 "join.probeEmit", "agg.update", "agg.merge", "sort.exec",
                 "transition.download")
STAR_COUNTERS = ("join.route.probe", "join.route.sort", "join.hostSyncs",
                 "join.hashRounds")


def star_routes(name: str, batches: int) -> dict:
    """The routes the reference's rule (tpu_join._probe_code_bits) gives
    the star query's join pairs, one pair per store_sales batch per join.
    A filtered dimension's compaction drops its scan's value-range hints:
    that join takes the sort route (through hash_group_ids, having no
    narrow code).  An unfiltered item keeps them: the probe route when
    i_item_sk's bucketed hint plus the null flag fits the direct table
    (22 bits), else the sort route on the narrow code (at SF10, items
    1..1.8M take 24 bits, bucketed to 32: 33 bits)."""
    from spark_rapids_tpu_torch.bench.tpcds import _Sizes
    from spark_rapids_tpu_torch.columnar.batch import bits_for_range
    from spark_rapids_tpu_torch.exec import kernel_abi
    from spark_rapids_tpu_torch.exec.tpu_join import _PROBE_MAX_BITS
    routes = {"join.route.probe": 0, "join.route.sort": 0}
    routes["join.route.sort"] += batches           # the date join
    vb = kernel_abi.bucket_vbits(bits_for_range(1, _Sizes(STAR_SF).ni))
    probe = "item" not in STAR_FILTERED[name] and vb is not None and \
        vb + 1 <= _PROBE_MAX_BITS
    routes["join.route.probe" if probe else "join.route.sort"] += batches
    return routes


def write_parts(root: str, tables: dict, files) -> None:
    """Each table of ``tables`` as ``files(name, table)`` Parquet files
    of equal row slices under ``root/<name>/``, written by a pool of
    threads (the Parquet writer releases the GIL): the same files a
    serial write gives."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = []
    for name, t in tables.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        n = files(name, t)
        step = -(-t.num_rows // n)
        jobs += [(t.slice(i * step, step),
                  os.path.join(d, f"part-{i:04d}.parquet"))
                 for i in range(n)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda job: papq.write_table(*job), jobs))


def write_star_files(root: str) -> dict:
    """date_dim, item and store_sales at SF10 from the port's builders
    (every generator column), store_sales as 8 Parquet files and each
    dimension as one; returns the tables."""
    from spark_rapids_tpu_torch.bench import tpcds
    t0 = time.perf_counter()
    tables = tpcds.build_tables(STAR_TABLES, STAR_SF, STAR_SEED)
    t1 = time.perf_counter()
    write_parts(root, tables,
                lambda name, _t: STAR_FILES if name == "store_sales" else 1)
    nbytes = {name: sum(os.path.getsize(os.path.join(root, name, f))
                        for f in os.listdir(os.path.join(root, name)))
              for name in tables}
    log(f"star files: generated {', '.join(f'{k} {v.num_rows} rows' for k, v in tables.items())} "
        f"at SF{STAR_SF} in {t1 - t0:.1f} s, wrote them in "
        f"{time.perf_counter() - t1:.1f} s ("
        + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in nbytes.items())
        + f"; store_sales in {STAR_FILES} files)")
    return tables


def star_reference(name: str, t: dict) -> pa.Table:
    """q3/q42/q52/q55 computed with pyarrow alone (Table.join, group_by,
    sort_by, slice), independent of both engines."""
    dd, item = t["date_dim"], t["item"]
    ss = t["store_sales"].select(["ss_sold_date_sk", "ss_item_sk",
                                  "ss_ext_sales_price"])
    moy, year = {"q3": (11, None), "q42": (11, 2000), "q52": (12, 1998),
                 "q55": (11, 1999)}[name]
    m = pc.equal(dd["d_moy"], moy)
    if year is not None:
        m = pc.and_(m, pc.equal(dd["d_year"], year))
    dd = dd.filter(m).select(["d_date_sk", "d_year"])
    if name == "q3":
        item = item.filter(pc.less_equal(item["i_manufact_id"], 100))
    elif name == "q55":
        item = item.filter(pc.equal(item["i_manager_id"], 28))
    j = ss.join(dd, keys="ss_sold_date_sk", right_keys="d_date_sk",
                join_type="inner", use_threads=True)
    j = j.join(item.select(["i_item_sk", "i_brand", "i_brand_id",
                            "i_category_id", "i_category"]),
               keys="ss_item_sk", right_keys="i_item_sk", join_type="inner")
    if name == "q42":
        g = j.group_by(["d_year", "i_category_id", "i_category"]).aggregate(
            [("ss_ext_sales_price", "sum")])
        g = g.rename_columns({"ss_ext_sales_price_sum": "total"})
        g = g.sort_by([("total", "descending"), ("d_year", "ascending"),
                       ("i_category_id", "ascending"),
                       ("i_category", "ascending")])
        out = g.select(["d_year", "i_category_id", "i_category", "total"])
    elif name == "q55":
        g = j.group_by(["i_brand", "i_brand_id"]).aggregate(
            [("ss_ext_sales_price", "sum")])
        g = g.rename_columns({"ss_ext_sales_price_sum": "ext_price",
                              "i_brand_id": "brand_id",
                              "i_brand": "brand"})
        g = g.sort_by([("ext_price", "descending"), ("brand_id", "ascending")])
        out = g.select(["brand_id", "brand", "ext_price"])
    else:
        agg = "sum_agg" if name == "q3" else "ext_price"
        g = j.group_by(["d_year", "i_brand", "i_brand_id"]).aggregate(
            [("ss_ext_sales_price", "sum")])
        g = g.rename_columns({"ss_ext_sales_price_sum": agg,
                              "i_brand_id": "brand_id", "i_brand": "brand"})
        g = g.sort_by([("d_year", "ascending"), (agg, "descending"),
                       ("brand_id", "ascending")])
        out = g.select(["d_year", "brand_id", "brand", agg])
    return out.slice(0, 100)


def check_rows(tag: str, out: pa.Table, ref: pa.Table) -> float:
    """Integers, strings, nulls and row order exact; floats to
    tests/parity.py's tolerance (rel 1e-9, abs 1e-11).  Returns the
    largest relative float difference."""
    if out.column_names != ref.column_names or out.num_rows != ref.num_rows:
        fail(f"{tag}: {out.column_names} x {out.num_rows} rows != "
             f"pyarrow {ref.column_names} x {ref.num_rows}")
    worst = 0.0
    for c in ref.column_names:
        a, b = out[c].to_pylist(), ref[c].to_pylist()
        if pa.types.is_floating(ref.schema.field(c).type):
            for x, y in zip(a, b):
                if x is None and y is None:
                    continue
                if not (x is not None and y is not None and
                        abs(x - y) <= max(1e-9 * max(abs(x), abs(y)),
                                          1e-11)):
                    fail(f"{tag}: column {c} {x!r} != pyarrow {y!r}")
                worst = max(worst, abs(x - y) / max(abs(y), 1e-300))
        elif a != b:
            fail(f"{tag}: column {c} differs from pyarrow")
    if ref.num_rows == 0:
        fail(f"{tag}: pyarrow's result is empty")
    return worst


def query_run(name: str, root: str, table_names, conf0: dict):
    """run(conf) -> (Arrow output, planned plan) of one TPC-DS query on a
    fresh port session on cuda over the files of ``table_names``."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.bench import tpcds

    def run(conf):
        s = TpuSparkSession(dict(conf0, **conf), device="cuda")
        plans = []
        s.add_plan_listener(lambda r: plans.append(r.plan))
        t = {n: s.read.parquet(os.path.join(root, n)) for n in table_names}
        out = tpcds.QUERIES[name](t).collect()
        return out, plans[-1]
    return run


def _check_star_plan(name: str, plan) -> None:
    """Both joins broadcast hash joins, the device sort and limit, the
    filters pushed into the dimension scans, no host node but the
    transitions."""
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    nodes = _plan_nodes(plan)
    names = [type(n).__name__ for n in nodes]
    if names.count("TpuBroadcastHashJoinExec") != 2:
        fail(f"star {name}: not two TpuBroadcastHashJoinExec: {names}")
    for want in ("TpuSortExec", "TpuGlobalLimitExec"):
        if want not in names:
            fail(f"star {name}: no {want}: {names}")
    host = [n for n in names if n not in HOST_OK and
            not n.startswith("Tpu")]
    if host:
        fail(f"star {name}: host nodes {host}")
    pushed = {n._schema.names[0][:2]: n._pushed_filter is not None
              for n in nodes if isinstance(n, TpuParquetScanExec)}
    want = {"d_": True, "i_": "item" in STAR_FILTERED[name], "ss": False}
    if pushed != want:
        fail(f"star {name}: filters pushed into the scans {pushed} != "
             f"{want}")


def phase_star(root: str, tables: dict):
    """q3/q42/q52/q55 at SF10 over Parquet on port sessions: plan checks,
    rows against pyarrow, kernels and routes with the counts set to 0
    before each query, then the cold wall, a warm wall with sections,
    one profiler trace and the peak device memory per query.  Returns
    (launches over the four queries, recorded classes, kernel names)."""
    from spark_rapids_tpu_torch.obs import registry as obsreg
    t0 = time.perf_counter()
    refs = {q: star_reference(q, tables) for q in STAR_QUERIES}
    log(f"star: pyarrow references in {time.perf_counter() - t0:.1f} s")
    total, names = {}, []
    # the recorder keeps the inputs of the cold runs' kernel calls
    shapes = ShapeRecorder()
    for q in STAR_QUERIES:
        run = query_run(q, root, STAR_TABLES, STAR_CONF)
        view = obsreg.get_registry().view()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        with shapes, DownloadCounter() as dl:
            out, plan = run({})
            torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        log(f"star {q}: the collect's download: {len(dl.calls)} "
            f"wait(s); pinned copies per batch, one per wire dtype: "
            f"{dl.calls}")
        if len(dl.calls) != 1:
            fail(f"star {q}: {len(dl.calls)} downloads in one collect")
        launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
        counters = view.delta()["counters"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"star {q} plan:\n{plan.tree_string()}")
        log(f"star {q} cold sections: " + _fmt_ms(
            _sections(plan, STAR_SECTIONS)))
        _check_star_plan(q, plan)
        rel = check_rows(f"star {q}", out, refs[q])
        batches = len(_scan_of_table(plan, "ss_").
                      _fused_groups())
        log(f"star {q}: {out.num_rows} rows match pyarrow (float "
            f"max rel {rel:.3g}); cold wall {cold * 1e3:.1f} ms; "
            f"launches {launches}; fallbacks {fallbacks}; "
            + ", ".join(f"{k} {counters.get(k, 0):.0f}"
                        for k in STAR_COUNTERS)
            + f" over {batches} store_sales batches; peak device "
            f"memory {peak:.2f} GiB")
        if (launches, fallbacks) != (STAR_COUNTS[q], STAR_FALLBACKS[q]):
            fail(f"star {q}: launches/fallbacks {launches} {fallbacks} "
                 f"!= the pinned {STAR_COUNTS[q]} {STAR_FALLBACKS[q]}")
        if counters.get("join.hostSyncs", 0) != 3 * batches:
            fail(f"star {q}: {counters.get('join.hostSyncs', 0)} join "
                 f"host syncs, want 3 per store_sales batch (two counts, "
                 f"one row-count read)")
        routes = {k: counters.get(k, 0) for k in STAR_COUNTERS[:2]}
        want = star_routes(q, batches)
        if routes != want:
            fail(f"star {q}: routes {routes} != the reference "
                 f"rule's {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        names += [k for k in STAR_COUNTS[q] if k not in names]
        sec = _star_sections(run)
        log(f"star {q} sections (host clock, median of {STAR_WARM} warm "
            f"runs; runs ms "
            f"{', '.join(f'{w * 1e3:.1f}' for w in sec['walls'])}): "
            + _fmt_ms(sec))
        busy = trace_form(f"star {q}", run, {}, label="star")
        log(f"star {q}: device busy {busy['busy_share']:.1%} of "
            f"{busy['wall_ms']:.1f} ms")
    return total, shapes.classes, names


def _scan_of_table(plan, prefix: str):
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    for n in _plan_nodes(plan):
        if isinstance(n, TpuParquetScanExec) and \
                n._schema.names[0].startswith(prefix):
            return n
    fail(f"no scan of {prefix}* in the plan")


# warm runs per star, window and shuffle query: 1 (5, then 3 until the
# tpch phase joined the smoke), as in the strings, customer-etl and
# mortgage phases, to keep the whole smoke inside its time limit
STAR_WARM = 1


def _star_sections(run, reps: int = STAR_WARM, keys=STAR_SECTIONS) -> dict:
    """Median of ``reps`` warm runs: the wall and every section of
    ``keys`` (host clock)."""
    walls, secs = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _out, plan = run({})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        secs.append(_sections(plan, keys))
    out = {"wall": statistics.median(walls)}
    for k in sorted({k for s in secs for k in s}):
        out[k] = statistics.median(s.get(k, 0.0) for s in secs)
    out["walls"] = walls
    return out



# ---------------------------------------------------------------------------
# 8c. the windowed reporting queries at SF10, and the window modes
# ---------------------------------------------------------------------------

WINDOW_QUERIES = ("q98", "q47")
# q47 reads store too: built on a generator of its own, so the star
# tables (and STAR_COUNTS) stay as they were
WINDOW_TABLES = STAR_TABLES + ("store",)
# the kernel launches of each windowed query, pinned from its first run
# on the H100: the fused scans' unpack and deferred dictionary gathers
# (q98: item's i_class string and i_current_price behind the pushed
# IN filter, date_dim's columns behind the date range; q47: date_dim's
# behind d_year) and the aggregate's gathered segmented scan.  The
# window stage itself launches no kernel: the reference computes it with
# XLA ops, the port with torch ops.
WINDOW_COUNTS = {
    "q98": {"decode.unpack_bits": 20, "filter_decode.decode": 3,
            "filter_decode.decode_str": 1, "segreduce.gather_seg_scan": 34},
    "q47": {"decode.unpack_bits": 52, "filter_decode.decode": 2,
            "segreduce.gather_seg_scan": 34},
}
# the pushed filters' own dictionary columns (i_category; d_date; d_year)
# are scan.filterDecode.condition_column fallbacks, once per dimension
# batch, as in the reference; no kernel falls back
WINDOW_FALLBACKS = {
    "q98": {"scan.filterDecode.condition_column": 2},
    "q47": {"scan.filterDecode.condition_column": 1},
}
# the tables whose scans take a pushed filter
WINDOW_FILTERED = {"q98": ("date_dim", "item"), "q47": ("date_dim",)}
WINDOW_SECTIONS = STAR_SECTIONS + ("window.eval",)


def write_store_file(root: str) -> pa.Table:
    """store at SF10 (12,000 rows) from the port's builders, one file."""
    from spark_rapids_tpu_torch.bench import tpcds
    store = tpcds.build_tables(("store",), STAR_SF, STAR_SEED)["store"]
    os.makedirs(os.path.join(root, "store"))
    papq.write_table(store, os.path.join(root, "store", "part-0000.parquet"))
    log(f"window files: store {store.num_rows} rows at SF{STAR_SF}, one "
        f"file")
    return store


def _same_as_previous(t: pa.Table, cols) -> np.ndarray:
    """Row i (i > 0) has the same values of ``cols`` as row i - 1."""
    same = np.ones(t.num_rows, dtype=bool)
    same[0] = False
    for c in cols:
        idx = t[c].combine_chunks().dictionary_encode().indices
        v = idx.to_numpy(zero_copy_only=False)
        same[1:] &= v[1:] == v[:-1]
    return same


def window_reference(name: str, t: dict) -> pa.Table:
    """q98 and q47 computed with pyarrow and numpy alone (joins,
    group_by, the window values by a group_by joined back or by shifting
    within each partition sorted on its order key), independent of both
    engines."""
    import datetime as dtm
    dd, item = t["date_dim"], t["item"]
    if name == "q98":
        item = item.filter(pc.is_in(item["i_category"], value_set=pa.array(
            ["Sports", "Books", "Home"])))
        dd = dd.filter(pc.and_(
            pc.greater_equal(dd["d_date"], pa.scalar(dtm.date(1999, 2, 22))),
            pc.less_equal(dd["d_date"], pa.scalar(dtm.date(1999, 3, 24)))))
        keys = ["i_item_id", "i_item_desc", "i_category", "i_class",
                "i_current_price"]
        j = t["store_sales"].select(
            ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"]).join(
            item.select(["i_item_sk"] + keys), keys="ss_item_sk",
            right_keys="i_item_sk", join_type="inner")
        j = j.join(dd.select(["d_date_sk"]), keys="ss_sold_date_sk",
                   right_keys="d_date_sk", join_type="inner")
        g = j.group_by(keys).aggregate([("ss_ext_sales_price", "sum")])
        g = g.rename_columns({"ss_ext_sales_price_sum": "itemrevenue"})
        cls = g.group_by(["i_class"]).aggregate([("itemrevenue", "sum")])
        g = g.join(cls, keys="i_class", join_type="inner")
        ratio = pc.divide(pc.multiply(g["itemrevenue"], 100.0),
                          g["itemrevenue_sum"])
        g = g.append_column("revenueratio", ratio)
        out = g.select(keys + ["itemrevenue", "revenueratio"])
        return out.sort_by([(c, "ascending") for c in
                            ("i_category", "i_class", "i_item_id",
                             "i_item_desc", "revenueratio")])
    part = ["i_category", "i_brand", "s_store_name", "s_company_name"]
    dd = dd.filter(pc.equal(dd["d_year"], 2000)).select(
        ["d_date_sk", "d_year", "d_moy"])
    j = t["store_sales"].select(
        ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
         "ss_sales_price"]).join(
        item.select(["i_item_sk", "i_category", "i_brand"]),
        keys="ss_item_sk", right_keys="i_item_sk", join_type="inner")
    j = j.join(dd, keys="ss_sold_date_sk", right_keys="d_date_sk",
               join_type="inner")
    j = j.join(t["store"].select(["s_store_sk", "s_store_name",
                                  "s_company_name"]),
               keys="ss_store_sk", right_keys="s_store_sk",
               join_type="inner")
    g = j.group_by(part + ["d_year", "d_moy"]).aggregate(
        [("ss_sales_price", "sum")])
    g = g.rename_columns({"ss_sales_price_sum": "sum_sales"})
    avg = g.group_by(part).aggregate([("sum_sales", "mean")]).rename_columns(
        {"sum_sales_mean": "avg_monthly_sales"})
    g = g.join(avg, keys=part, join_type="inner")
    # lag/lead: each partition sorted on d_moy, shifted by one
    g = g.sort_by([(c, "ascending") for c in part + ["d_moy"]])
    same = _same_as_previous(g, part)
    v = g["sum_sales"].to_numpy()
    n = g.num_rows
    prev = np.zeros(n)
    prev[1:] = v[:-1]
    nxt = np.zeros(n)
    nxt[:-1] = v[1:]
    has_next = np.zeros(n, dtype=bool)
    has_next[:-1] = same[1:]
    g = g.append_column("psum", pa.array(prev, mask=~same))
    g = g.append_column("nsum", pa.array(nxt, mask=~has_next))
    a, s = g["avg_monthly_sales"], g["sum_sales"]
    keep = pc.and_(pc.greater(a, 0.0), pc.greater(
        pc.divide(pc.abs(pc.subtract(s, a)), a), 0.1))
    g = g.filter(keep)
    g = g.append_column("dev", pc.subtract(g["sum_sales"],
                                           g["avg_monthly_sales"]))
    g = g.sort_by([("dev", "ascending"), ("s_store_name", "ascending"),
                   ("d_moy", "ascending")])
    return g.select(["i_category", "i_brand", "s_store_name", "d_year",
                     "d_moy", "sum_sales", "avg_monthly_sales", "psum",
                     "nsum"]).slice(0, 100)


def _check_window_plan(name: str, plan) -> None:
    """A TpuWindowExec and no CpuWindowExec, the device sort (and limit
    where the query has one), the filters pushed into the filtered
    dimensions' scans, no host node but the transitions."""
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    nodes = _plan_nodes(plan)
    names = [type(n).__name__ for n in nodes]
    want = ["TpuWindowExec", "TpuSortExec"] + \
        (["TpuGlobalLimitExec"] if name == "q47" else [])
    for w in want:
        if w not in names:
            fail(f"window {name}: no {w}: {names}")
    host = [n for n in names if n not in HOST_OK and
            not n.startswith("Tpu")]
    if host:
        fail(f"window {name}: host nodes {host}")
    pushed = {n._schema.names[0][:2]: n._pushed_filter is not None
              for n in nodes if isinstance(n, TpuParquetScanExec)}
    want = {"d_": True, "i_": "item" in WINDOW_FILTERED[name],
            "ss": False}
    if name == "q47":
        want["s_"] = False
    if pushed != want:
        fail(f"window {name}: filters pushed into the scans {pushed} != "
             f"{want}")


def phase_window(root: str, tables: dict):
    """q98 and q47 at SF10 over Parquet on port sessions: the plan
    checks, rows against pyarrow and numpy, the kernels with the counts
    set to 0 before each query, then the cold wall, a warm wall with
    sections, one profiler trace and the peak device memory per query.
    Returns (launches over both queries, recorded classes, kernel
    names)."""
    t0 = time.perf_counter()
    refs = {q: window_reference(q, tables) for q in WINDOW_QUERIES}
    log(f"window: pyarrow references in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{q} {r.num_rows} rows' for q, r in refs.items())})")
    total, names, pinned = {}, [], []
    shapes = ShapeRecorder()
    for q in WINDOW_QUERIES:
        run = query_run(q, root, WINDOW_TABLES, STAR_CONF)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        with shapes:
            out, plan = run({})
            torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"window {q} plan:\n{plan.tree_string()}")
        log(f"window {q} cold sections: " + _fmt_ms(
            _sections(plan, WINDOW_SECTIONS)))
        _check_window_plan(q, plan)
        rel = check_rows(f"window {q}", out, refs[q])
        win_rows = sum(n.metrics.num_output_rows for n in _plan_nodes(plan)
                       if type(n).__name__ == "TpuWindowExec")
        log(f"window {q}: {out.num_rows} rows match pyarrow (float max "
            f"rel {rel:.3g}); {win_rows} rows through the window; cold "
            f"wall {cold * 1e3:.1f} ms; launches "
            f"{launches}; fallbacks {fallbacks}; peak device memory "
            f"{peak:.2f} GiB")
        for k in ("decode.unpack_bits", "segreduce.gather_seg_scan"):
            if launches.get(k, 0) <= 0:
                fail(f"window {q} did not launch {k}")
        if (launches, fallbacks) != (WINDOW_COUNTS[q], WINDOW_FALLBACKS[q]):
            pinned.append(f"window {q}: launches/fallbacks {launches} "
                          f"{fallbacks} != the pinned {WINDOW_COUNTS[q]} "
                          f"{WINDOW_FALLBACKS[q]}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        names += [k for k in launches if k not in names]
        sec = _star_sections(run, keys=WINDOW_SECTIONS)
        log(f"window {q} sections (host clock, median of {STAR_WARM} warm "
            f"runs; "
            f"runs ms {', '.join(f'{w * 1e3:.1f}' for w in sec['walls'])}"
            f"): " + _fmt_ms(sec))
        busy = trace_form(f"window {q}", run, {}, label="window")
        log(f"window {q}: device busy {busy['busy_share']:.1%} of "
            f"{busy['wall_ms']:.1f} ms")
    if pinned:
        fail("; ".join(pinned))
    return total, shapes.classes, names


# cut from 2^20 rows to 2^18 when the mortgage and customer-etl phases
# joined the smoke, to 2^17 when the tpch phase did and to 2^16 when the
# compile phase did: the CPU session's side of these comparisons grows
# with the rows, and the whole smoke must stay inside its time limit
MODES_WINDOW_ROWS = 1 << 16


def window_modes_table(n: int, seed: int) -> pa.Table:
    """``n`` rows, about 5% nulls per column: a partition key with one
    partition over half the rows, int and double order keys, int64,
    double (with NaN) and bool values."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.05
    k = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 4000, n))
    f = rng.normal(0, 1e3, n)
    f[rng.random(n) < 0.02] = np.nan
    return pa.table({
        "k": pa.array(k.astype(np.int32), mask=nulls()),
        "o": pa.array(rng.integers(0, 400, n).astype(np.int32),
                      mask=nulls()),
        "od": pa.array(np.round(rng.uniform(-50, 50, n), 1),
                       mask=nulls()),
        "vi": pa.array(rng.integers(-10 ** 6, 10 ** 6, n), mask=nulls()),
        "vf": pa.array(f, mask=nulls()),
        "vb": pa.array(rng.random(n) < 0.5, mask=nulls()),
    })


def window_modes_frames(col, F, W):
    """(tag, [(alias, window column)]) of every window function and frame
    kind of tests/test_window.py."""
    part = W.partition_by("k")
    asc = part.order_by("o")
    desc = part.order_by(col("o").desc())

    def aggs(w, prefix, bools=True):
        out = []
        for v in ("vi", "vf"):
            out += [(f"{prefix}_sum_{v}", F.sum(v).over(w)),
                    (f"{prefix}_cnt_{v}", F.count(v).over(w)),
                    (f"{prefix}_avg_{v}", F.avg(v).over(w)),
                    (f"{prefix}_min_{v}", F.min(v).over(w)),
                    (f"{prefix}_max_{v}", F.max(v).over(w))]
        if bools:
            out += [(f"{prefix}_min_vb", F.min("vb").over(w)),
                    (f"{prefix}_max_vb", F.max("vb").over(w)),
                    (f"{prefix}_cnt_vb", F.count("vb").over(w))]
        return out
    return [
        ("ranking", [
            ("rn", F.row_number().over(asc)), ("rk", F.rank().over(asc)),
            ("dr", F.dense_rank().over(asc)),
            ("ld", F.lead("vi").over(asc)),
            ("lg2", F.lag("vf", 2).over(asc)),
            ("ldd", F.lead("vi", 1, -99).over(asc)),
            ("lgb", F.lag("vb", 1, True).over(asc))]),
        ("ranking desc", [
            ("rn", F.row_number().over(desc)), ("rk", F.rank().over(desc)),
            ("dr", F.dense_rank().over(desc)),
            ("lg", F.lag("vi").over(desc))]),
        ("running", aggs(asc, "run")),
        ("running desc", aggs(desc, "rund", bools=False)),
        ("whole partition", aggs(part, "part") +
         [("part_cnt_all", F.count("*").over(part))]),
        ("rows -3..2", aggs(asc.rows_between(-3, 2), "rows")),
        ("rows -5..0 desc", aggs(desc.rows_between(-5, 0), "rowsd")),
        ("rows -2..unbounded", aggs(
            asc.rows_between(-2, W.unbounded_following), "rowsu")),
        ("range -10..10", aggs(asc.range_between(-10, 10), "rng")),
        ("range -10..10 desc", aggs(desc.range_between(-10, 10),
                                          "rngd")),
        ("range unbounded..5", aggs(
            asc.range_between(W.unbounded_preceding, 5), "rngu",
            bools=False)),
        ("range double -1.5..1.5 desc", aggs(
            part.order_by(col("od").desc()).range_between(-1.5, 1.5),
            "rngf", bools=False)),
    ]


def _bit_equal(tag: str, got, want) -> None:
    """Same names, rows, order, nulls and values; floats by their bit
    patterns (NaN and -0.0 included).  None (an empty partition) equals
    only None."""
    if got is None or want is None:
        if got is not want:
            fail(f"{tag}: {'no' if got is None else 'some'} rows where "
                 f"the CPU session has {'no' if want is None else 'some'}")
        return
    if got.column_names != want.column_names or \
            got.num_rows != want.num_rows:
        fail(f"{tag}: {got.column_names} x {got.num_rows} != "
             f"{want.column_names} x {want.num_rows}")
    for c in want.column_names:
        _bit_equal_array(tag, c, got[c].combine_chunks(),
                         want[c].combine_chunks())


def _bit_equal_array(tag: str, c: str, a: pa.Array, b: pa.Array) -> None:
    """One column of :func:`_bit_equal`; a list column compares its
    lengths and then its flattened elements the same way."""
    if not a.is_valid().equals(b.is_valid()):
        fail(f"{tag}: column {c}: nulls differ")
    if pa.types.is_list(b.type):
        if not pc.list_value_length(a).equals(pc.list_value_length(b)):
            fail(f"{tag}: column {c}: list lengths differ")
        _bit_equal_array(tag, f"{c}[]", a.flatten(), b.flatten())
        return
    if not (pa.types.is_floating(b.type) or pa.types.is_integer(b.type)
            or pa.types.is_boolean(b.type)):
        if not a.equals(b):
            bad = next(i for i, (x, y) in enumerate(
                zip(a.to_pylist(), b.to_pylist())) if x != y)
            fail(f"{tag}: column {c} differs at row {bad}: "
                 f"{a[bad]} != {b[bad]}")
        return
    av = a.fill_null(False if pa.types.is_boolean(a.type) else 0)
    bv = b.fill_null(False if pa.types.is_boolean(b.type) else 0)
    x = av.to_numpy(zero_copy_only=False)
    y = bv.to_numpy(zero_copy_only=False)
    if x.dtype.kind == "f":
        x, y = x.view(f"i{x.itemsize}"), y.view(f"i{y.itemsize}")
    if not np.array_equal(x, y):
        bad = int(np.flatnonzero(x != y)[0])
        fail(f"{tag}: column {c} differs at row {bad}: "
             f"{a[bad]} != {b[bad]}")


def phase_window_modes() -> None:
    """Every window function and frame kind on the card against the same
    DataFrame on a port session on the CPU, over a 2^18-row table:
    exactly, float sums bit for bit (the adds are the same on identical
    input).  Untimed."""
    from spark_rapids_tpu_torch.api import TpuSparkSession, col
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window
    conf = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
            "spark.rapids.tpu.sql.test.enabled": True}
    t0 = time.perf_counter()
    table = window_modes_table(MODES_WINDOW_ROWS, 17)
    sessions = {d: TpuSparkSession(conf, device=d) for d in ("cuda", "cpu")}
    frames = window_modes_frames(col, F, Window)
    nexprs = 0
    for tag, exprs in frames:
        outs = {}
        for d, s in sessions.items():
            df = s.create_dataframe(table).select(
                "k", "o", "od", "vi", "vf", "vb",
                *[e.alias(a) for a, e in exprs])
            if d == "cuda":
                plan = df.explain_string("physical")
                if "TpuWindowExec" not in plan or "CpuWindowExec" in plan:
                    fail(f"window-modes {tag}: not a device window:\n"
                         f"{plan}")
            outs[d] = df.collect()
        _bit_equal(f"window-modes {tag}", outs["cuda"], outs["cpu"])
        nexprs += len(exprs)
    log(f"window-modes: {nexprs} window expressions in {len(frames)} "
        f"frame kinds over {MODES_WINDOW_ROWS} rows (nulls ~5%, NaN in vf, "
        f"one partition of half the rows) equal the CPU session's bit for "
        f"bit in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 8d. the shuffle exchange at SF10, and the shuffle modes
# ---------------------------------------------------------------------------

# catalog_sales draws from a generator of its own (its builder alone:
# the correlation step of build_tables reads store_returns), so the star
# tables and every earlier pin stay as they were
SHUFFLE_SEED = 11
SHUFFLE_TABLES = STAR_TABLES + ("catalog_sales",)
TRANSPORT_KEY = "spark.rapids.tpu.shuffle.transport"
SHUFFLE_TRANSPORTS = ("local", "device")
# the default broadcast threshold (10 MiB) and the default
# sql.adaptive.enabled (on: each shuffled join reads its exchanges
# through TpuAdaptiveJoinReaderExec)
SHUFFLE_CONF = dict(SCAN_CONF, **{
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
    "spark.rapids.tpu.sql.test.enabled": True})
# the kernel launches and fallbacks of each run, pinned from the first run
# on the H100 (q97 per transport; the star queries on the default
# transport): the fused scans' unpack, date_dim's deferred dictionary
# gathers (and item's where it is filtered), and the aggregates' gathered
# segmented scans (q97: the two distinct aggregates and its three sums;
# a star query's aggregate runs over the joined partitions, not the 16
# store_sales batches).  The exchange launches no kernel: the
# reference does its work with XLA ops, the port with torch ops.  The
# aggregates' counts were re-pinned in PR 21: the adaptive readers (on by
# default) coalesce the join's 8 partitions into fewer specs (the plan
# prints ``specs=``; q97's full outer join 2, a star query's item join 2,
# q55's 1), and each aggregate runs once per joined spec.
_Q97_COUNTS = {"decode.unpack_bits": 26, "filter_decode.decode": 2,
               "segreduce.gather_seg_scan": 18}
SHUFFLE_COUNTS = {
    "q97/local": _Q97_COUNTS, "q97/device": _Q97_COUNTS,
    "q3": {"decode.unpack_bits": 18, "filter_decode.decode": 4,
           "filter_decode.decode_str": 1, "segreduce.gather_seg_scan": 6},
    "q42": {"decode.unpack_bits": 18, "filter_decode.decode": 1,
            "segreduce.gather_seg_scan": 6},
    "q52": {"decode.unpack_bits": 18, "filter_decode.decode": 1,
            "segreduce.gather_seg_scan": 6},
    "q55": {"decode.unpack_bits": 19, "filter_decode.decode": 3,
            "filter_decode.decode_str": 1, "segreduce.gather_seg_scan": 2},
}
# the pushed filters' own dictionary columns, as in the star phase
SHUFFLE_FALLBACKS = {
    q: {"scan.filterDecode.condition_column": n}
    for q, n in (("q97/local", 2), ("q97/device", 2), ("q3", 2), ("q42", 2),
                 ("q52", 2), ("q55", 3))}
# the join routes, pinned from the first run on the H100: every pair on
# the sort route.  q97: its two date joins, one pair per store_sales and
# catalog_sales batch (a filtered date_dim carries no hints), and the full
# outer join's 8 partition pairs (the probe route serves inner and left
# only).  A star query: the date join, one pair per store_sales batch,
# and the item join's partition pairs (the exchange's upload hints
# i_item_sk at 33 bits with the null flag, past the direct table's 22):
# since PR 21 one pair per adaptive spec (q97 24 + 2, a star query 16 +
# 2, q55 16 + 1) where each exchange partition was one (24 + 8, 16 + 8).
_SORT = {"join.route.probe": 0}
SHUFFLE_ROUTES = dict({"q97/local": dict(_SORT, **{"join.route.sort": 26}),
                       "q97/device": dict(_SORT, **{"join.route.sort": 26})},
                      **{q: dict(_SORT, **{"join.route.sort":
                                           17 if q == "q55" else 18})
                         for q in STAR_QUERIES})
SHUFFLE_SECTIONS = ("scan.hostPrepTime", "scan.uploadTime", "scan.dispatch",
                    "exchange.partition", "exchange.upload",
                    "exchange.concat", "join.count", "join.emit",
                    "join.probeCount", "join.probeEmit", "agg.update",
                    "agg.merge", "sort.exec", "transition.download")


def write_catalog_sales(root: str) -> pa.Table:
    """catalog_sales at SF10 (14,400,000 rows, every generator column) as
    8 Parquet files."""
    from spark_rapids_tpu_torch.bench import tpcds
    t0 = time.perf_counter()
    cs = tpcds._catalog_sales(np.random.default_rng(SHUFFLE_SEED),
                              tpcds._Sizes(STAR_SF), {})
    t1 = time.perf_counter()
    write_parts(root, {"catalog_sales": cs}, lambda _n, _t: STAR_FILES)
    d = os.path.join(root, "catalog_sales")
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"shuffle files: catalog_sales {cs.num_rows} rows at SF{STAR_SF} "
        f"generated in {t1 - t0:.1f} s, written in "
        f"{time.perf_counter() - t1:.1f} s ({nbytes / 2**20:.1f} MiB in "
        f"{STAR_FILES} files)")
    return cs


def q97_reference(t: dict) -> pa.Table:
    """q97 with pyarrow alone: the distinct (customer, item) pairs of each
    channel in d_month_seq 120..131; a pair with a null key never matches.
    The full outer join's rows: one per matched pair (both sides set), one
    per unmatched pair of either side (the other side null).  A row counts
    as store_only when its catalog customer is null and as catalog_only
    when its store customer is null, so an unmatched pair whose own
    customer is null counts on both."""
    dd = t["date_dim"]
    m = pc.and_(pc.greater_equal(dd["d_month_seq"], 120),
                pc.less_equal(dd["d_month_seq"], 131))
    dates = dd.filter(m)["d_date_sk"].combine_chunks()

    def pairs(table, date, cust, item):
        x = table.select([date, cust, item])
        x = x.filter(pc.is_in(x[date], value_set=dates))
        return x.group_by([cust, item]).aggregate([]).rename_columns(
            ["c", "i"])
    s = pairs(t["store_sales"], "ss_sold_date_sk", "ss_customer_sk",
              "ss_item_sk")
    c = pairs(t["catalog_sales"], "cs_sold_date_sk", "cs_bill_customer_sk",
              "cs_item_sk")

    def keyed(x):
        return x.filter(pc.and_(pc.is_valid(x["c"]), pc.is_valid(x["i"])))
    both = keyed(s).join(keyed(c), keys=["c", "i"],
                         join_type="inner").num_rows
    s_null = pc.sum(pc.is_null(s["c"]).cast(pa.int64())).as_py() or 0
    c_null = pc.sum(pc.is_null(c["c"]).cast(pa.int64())).as_py() or 0
    return pa.table({
        "store_only": pa.array([s.num_rows - both + c_null], pa.int64()),
        "catalog_only": pa.array([c.num_rows - both + s_null], pa.int64()),
        "store_and_catalog": pa.array([both], pa.int64())})


def _check_shuffle_plan(tag: str, plan, shuffled_how: str,
                        broadcasts: int) -> None:
    """One TpuShuffledHashJoinExec of ``shuffled_how`` over two
    TpuShuffleExchangeExec, ``broadcasts`` broadcast hash joins and no
    host node but the transitions."""
    nodes = _plan_nodes(plan)
    names = [type(n).__name__ for n in nodes]
    joins = [n for n in nodes if type(n).__name__ ==
             "TpuShuffledHashJoinExec"]
    if len(joins) != 1 or joins[0].how != shuffled_how:
        fail(f"{tag}: not one {shuffled_how} TpuShuffledHashJoinExec: "
             f"{names}")
    # at the default sql.adaptive.enabled each side reads its exchange
    # through the coordinated adaptive reader
    kids = [type(c).__name__ for c in joins[0].children]
    grand = [type(c.children[0]).__name__ for c in joins[0].children]
    if kids != ["TpuAdaptiveJoinReaderExec"] * 2 or \
            grand != ["TpuShuffleExchangeExec"] * 2:
        fail(f"{tag}: the shuffled join's children are {kids} over "
             f"{grand}")
    if names.count("TpuBroadcastHashJoinExec") != broadcasts:
        fail(f"{tag}: not {broadcasts} TpuBroadcastHashJoinExec: {names}")
    host = [n for n in names if n not in HOST_OK and
            not n.startswith("Tpu")]
    if host:
        fail(f"{tag}: host nodes {host}")


def _exchange_extras(plan) -> dict:
    """Rows and bytes through the plan's exchanges (bytes only on the
    local transport)."""
    out = {"rows": 0, "bytes_written": 0, "exchanges": 0}
    for n in _plan_nodes(plan):
        if type(n).__name__ == "TpuShuffleExchangeExec":
            out["exchanges"] += 1
            out["rows"] += n.metrics.num_output_rows
            out["bytes_written"] += int(n.metrics.extra.get(
                "bytes_written", 0))
    return out


def _pinned(tag: str, got, pins: dict, key: str, errors: list) -> None:
    """Hold ``got`` to ``pins[key]``; a key with no pin yet is printed for
    pinning."""
    if key not in pins:
        log(f"{tag}: UNPINNED {key} = {got!r}")
    elif got != pins[key]:
        errors.append(f"{tag}: {got} != the pinned {pins[key]}")


def _shuffle_query(tag: str, run, ref, shuffled_how: str, broadcasts: int,
                   key: str, errors: list, shapes=None):
    """One query: a cold run with the counts set to 0 before it (the
    inputs of its kernel calls recorded when ``shapes`` is given), plan,
    rows, launches and fallbacks; then a warm wall with sections, one
    trace and the peak device memory.  Returns (output, launches)."""
    from spark_rapids_tpu_torch.obs import registry as obsreg
    view = obsreg.get_registry().view()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    if shapes is not None:
        with shapes:
            out, plan = run({})
            torch.cuda.synchronize()
    else:
        out, plan = run({})
        torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
    counters = view.delta()["counters"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} plan:\n{plan.tree_string()}")
    _check_shuffle_plan(tag, plan, shuffled_how, broadcasts)
    rel = check_rows(tag, out, ref)
    xch = _exchange_extras(plan)
    routes = {k: int(counters.get(k, 0)) for k in STAR_COUNTERS}
    log(f"{tag}: {out.num_rows} rows match pyarrow (float max rel "
        f"{rel:.3g}): {out.to_pylist()[:3]}; cold wall {cold * 1e3:.1f} "
        f"ms; {xch['rows']} rows through {xch['exchanges']} exchanges, "
        f"bytes_written {xch['bytes_written']}; launches {launches}; "
        f"fallbacks {fallbacks}; {routes}; peak device memory "
        f"{peak:.2f} GiB")
    log(f"{tag} cold sections: " + _fmt_ms(_sections(plan,
                                                     SHUFFLE_SECTIONS)))
    if launches.get("decode.unpack_bits", 0) <= 0:
        fail(f"{tag} did not launch decode.unpack_bits")
    _pinned(tag, launches, SHUFFLE_COUNTS, key, errors)
    _pinned(tag, fallbacks, SHUFFLE_FALLBACKS, key, errors)
    if broadcasts:
        _pinned(tag, {k: routes[k] for k in STAR_COUNTERS[:2]},
                SHUFFLE_ROUTES, key, errors)
    sec = _star_sections(run, keys=SHUFFLE_SECTIONS)
    log(f"{tag} sections (host clock, median of {STAR_WARM} warm runs; "
        f"runs ms "
        f"{', '.join(f'{w * 1e3:.1f}' for w in sec['walls'])}): "
        + _fmt_ms(sec))
    busy = trace_form(tag, run, {}, label="shuffle")
    log(f"{tag}: device busy {busy['busy_share']:.1%} of "
        f"{busy['wall_ms']:.1f} ms")
    return out, launches


def phase_shuffle(root: str, tables: dict):
    """q97 at SF10 under the local and the device transport, then
    q3/q42/q52/q55 at the default broadcast threshold, on port sessions
    on cuda.  Returns (q97's launches on the local transport, its recorded
    classes, the kernels it launched)."""
    t0 = time.perf_counter()
    ref97 = q97_reference(tables)
    star_reruns = () if WHOLE_SMOKE else STAR_QUERIES
    refs = {q: star_reference(q, tables) for q in star_reruns}
    log(f"shuffle: pyarrow references in {time.perf_counter() - t0:.1f} s;"
        f" q97 {ref97.to_pylist()}")
    errors, rows = [], {}
    shapes = ShapeRecorder()
    launches97 = None
    for transport in SHUFFLE_TRANSPORTS:
        run = query_run("q97", root, SHUFFLE_TABLES,
                        dict(SHUFFLE_CONF, **{TRANSPORT_KEY: transport}))
        out, launches = _shuffle_query(
            f"shuffle q97/{transport}", run, ref97, "full", 2,
            f"q97/{transport}", errors,
            shapes if transport == "local" else None)
        rows[transport] = out.to_pylist()
        if launches97 is None:
            launches97 = launches
    if rows["local"] != rows["device"]:
        fail(f"shuffle q97: the transports disagree: {rows}")
    for q in star_reruns:
        run = query_run(q, root, STAR_TABLES, SHUFFLE_CONF)
        _shuffle_query(f"shuffle {q}", run, refs[q], "inner", 1, q, errors)
    if not star_reruns:
        log("shuffle: the star queries at the default threshold are left "
            "to `python3 chip_smoke.py shuffle` (the whole smoke's time "
            "limit)")
    if errors:
        fail("; ".join(errors))
    return launches97, shapes.classes, sorted(launches97)


# cut from 2^20 rows to 2^18 when the last slice's phases joined the
# smoke and to 2^16 when the compile phase did: the CPU session's side of
# these comparisons grows with the rows, and the whole smoke must stay
# inside its time limit
MODES_SHUFFLE_ROWS = 1 << 16
# string keys: a pool of byte widths 0-33, most ending in a multi-byte
# character (tail bytes >= 0x80)
_WIDE = ("é", "中", "\U0001f600", "ÿ")


def _string_pool(rng, n: int) -> list:
    out = []
    for i in range(n):
        width = i % 34
        c = _WIDE[i % len(_WIDE)] if i % 5 else ""
        if len(c.encode()) > width:
            c = ""
        fill = width - len(c.encode())
        out.append("".join(chr(int(x)) for x in rng.integers(32, 127, fill))
                   + c)
    return out


def shuffle_modes_table(n: int, seed: int) -> pa.Table:
    """``n`` rows, about 5% nulls per column: int32 keys over 2^16 values,
    int64, float64 with NaN, -0.0 and 0.0, bool, date32, and strings from
    a pool of 4,096 of byte widths 0-33."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.05
    f = rng.normal(0, 1e3, n)
    f[rng.random(n) < 0.02] = np.nan
    f[rng.random(n) < 0.02] = -0.0
    f[rng.random(n) < 0.02] = 0.0
    pool = pa.array(_string_pool(rng, 4096))
    s = pool.take(pa.array(rng.integers(0, 4096, n)))
    return pa.table({
        "k": pa.array(rng.integers(0, 1 << 16, n).astype(np.int32),
                      mask=nulls()),
        "i64": pa.array(rng.integers(-2**62, 2**62, n), mask=nulls()),
        "f": pa.array(f, mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "d": pa.array(rng.integers(-20000, 30000, n).astype(np.int32),
                      mask=nulls()).cast(pa.date32()),
        "s": pa.array(s.to_pylist(), type=pa.string(), mask=nulls()),
    })


def _partitions_of(session, df) -> list:
    """Per output partition, its rows as one Arrow table."""
    out = []
    for it in session._plan_physical(df.plan).plan.execute():
        tables = [t for t in it if t.num_rows]
        out.append(pa.concat_tables(tables) if tables else None)
    return out


def shuffle_modes_queries(table: pa.Table, col, F, W):
    """(tag, conf, df builder, per-partition) of every shuffle mode."""
    right = table.slice(0, 1 << 16).select(["k", "i64", "s"]) \
        .rename_columns(["rk", "ri", "rs"])
    pool = pa.table({"ps": pa.array(sorted(
        {v for v in table["s"].to_pylist() if v is not None}))})
    agg_on = {"spark.rapids.tpu.sql.agg.exchange.enabled": True}
    win_on = {"spark.rapids.tpu.sql.window.exchange.enabled": True}
    sort_on = {"spark.rapids.tpu.sql.sort.exchange.enabled": True}
    out = [
        ("hash", {}, lambda s: s.create_dataframe(table, num_partitions=4)
         .repartition(8, "k", "s"), True),
        ("round robin", {}, lambda s: s.create_dataframe(
            table, num_partitions=4).repartition(8), True),
        ("range", {}, lambda s: s.create_dataframe(
            table, num_partitions=4).repartition_by_range(
            8, col("k"), col("f").desc(), col("s")), True),
        ("single", {}, lambda s: s.create_dataframe(
            table, num_partitions=4).repartition(1), True),
        ("coalesce", {}, lambda s: s.create_dataframe(
            table, num_partitions=4).repartition(8, "i64").coalesce(3),
         True),
        ("two-stage aggregate", agg_on, lambda s: s.create_dataframe(
            table, num_partitions=4).group_by("k", "s").agg(
            F.sum("i64").alias("si"), F.count("*").alias("c"),
            F.min("f").alias("mnf"), F.max("f").alias("mxf"),
            F.max("d").alias("md")), False),
        ("partitionwise window", win_on, lambda s: s.create_dataframe(
            table, num_partitions=4).select(
            "k", "i64", "f", F.row_number().over(
                W.partition_by("k").order_by("i64")).alias("rn"),
            F.sum("f").over(W.partition_by("k").order_by("i64"))
            .alias("sf")), False),
        ("range-exchange sort", sort_on, lambda s: s.create_dataframe(
            table, num_partitions=4).sort(col("f").desc(), col("k"),
                                          col("i64")), False),
    ]
    no_bcast = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    for how in ("inner", "left", "right", "full", "semi", "anti"):
        out.append((f"join {how}", no_bcast, partial(
            lambda s, how: s.create_dataframe(table, num_partitions=4).join(
                s.create_dataframe(right), col("k") == col("rk"), how=how),
            how=how), False))
    out.append(("join string keys", no_bcast, lambda s: s.create_dataframe(
        table, num_partitions=4).join(s.create_dataframe(pool),
                                      col("s") == col("ps")), False))
    return out


def phase_shuffle_modes() -> None:
    """Every repartition kind and the coalesce under both transports,
    and the shuffled join for every how, the two-stage aggregate, the
    partitionwise window and the range-exchange sort under the default
    one, on the card against the same DataFrame on a port session on the
    CPU: the repartitions partition by partition, the rest whole;
    exactly, floats bit for bit
    (the aggregate takes no float sum: the card's segmented scan adds in
    another tree than the CPU's, which the parity phase holds to a
    tolerance).  Untimed."""
    from spark_rapids_tpu_torch.api import TpuSparkSession, col
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.api.window import Window as W
    base = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
            "spark.rapids.tpu.sql.test.enabled": True}
    t0 = time.perf_counter()
    table = shuffle_modes_table(MODES_SHUFFLE_ROWS, 19)
    n = 0
    for tag, conf, make, per_part in shuffle_modes_queries(table, col, F,
                                                           W):
        cpu = TpuSparkSession(dict(base, **conf), device="cpu")
        want = make(cpu)
        want = _partitions_of(cpu, want) if per_part else [want.collect()]
        # the repartitions take both transports; the plans above an
        # exchange take the default one, which they share with the
        # repartitions' byte round trip
        for transport in SHUFFLE_TRANSPORTS if per_part else ("local",):
            s = TpuSparkSession(dict(base, **conf,
                                     **{TRANSPORT_KEY: transport}),
                                device="cuda")
            df = make(s)
            plan = df.explain_string("physical")
            if "TpuShuffleExchangeExec" not in plan:
                fail(f"shuffle-modes {tag}: no device exchange:\n{plan}")
            got = _partitions_of(s, df) if per_part else [df.collect()]
            if len(got) != len(want):
                fail(f"shuffle-modes {tag}/{transport}: {len(got)} "
                     f"partitions != the CPU session's {len(want)}")
            for p, (g, w) in enumerate(zip(got, want)):
                _bit_equal(f"shuffle-modes {tag}/{transport} partition {p}",
                           g, w)
            n += 1
    log(f"shuffle-modes: {n} mode/transport runs over "
        f"{MODES_SHUFFLE_ROWS} rows (nulls ~5%; NaN, -0.0 and strings of "
        f"byte widths 0-33 with multi-byte tails) equal the CPU session's "
        f"exactly in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 8e. the census queries with string expressions at SF10, and the string
# modes
# ---------------------------------------------------------------------------

STRINGS_QUERIES = ("q8", "q15", "q19", "q45", "q84", "q93")
# the tables each query reads
STRINGS_READS = {
    "q8": ("store_sales", "date_dim", "store", "customer",
           "customer_address"),
    "q15": ("catalog_sales", "customer", "customer_address", "date_dim"),
    "q19": ("date_dim", "store_sales", "item", "customer",
            "customer_address", "store"),
    "q45": ("web_sales", "customer", "customer_address", "date_dim", "item"),
    "q84": ("customer", "customer_address", "household_demographics",
            "income_band", "customer_demographics", "store_returns"),
    "q93": ("store_sales", "store_returns", "reason"),
}
# the string expression that kept each query's host node before the
# string group was ported, and the kind of node it now sits in
STRINGS_EXPR = {"q8": "Substring", "q15": "Substring", "q19": "Substring",
                "q45": "Substring", "q84": "Concat", "q93": "StartsWith"}
# these tables draw from a generator of their own, in the builders'
# order, so the star, window and shuffle tables (and their pins) stay as
# they were; store_returns reads the star files' store_sales
STRINGS_SEED = 13
STRINGS_TABLES = ("customer_demographics", "income_band",
                  "household_demographics", "customer_address", "customer",
                  "store_returns", "reason", "web_sales")
# tables over a million rows go to STAR_FILES files, the rest to one
STRINGS_SPLIT_ROWS = 1 << 20
# the shuffle phase's conf: the default 10 MiB broadcast threshold and
# the default local transport
STRINGS_CONF = SHUFFLE_CONF
# warm runs per query: 1 (5 until the strings phase joined the smoke, 3
# until the mortgage and customer-etl phases did, 2 until the tpch phase
# did), to keep the whole smoke inside its time limit
STRINGS_WARM = 1
# the kernel launches of each query, pinned from the first run on the
# H100: the fused scans' unpack; the dictionary gathers the pushed filters
# defer (date_dim's everywhere; customer's in q8, item's in q19,
# customer_address's in q84, reason's in q93), decode_str where a filtered
# scan defers a string column (q8 and q19); the aggregates' gathered
# segmented scans, and q8's sorted scans (its COUNT(*) per zip).
# q84 has no aggregate.  The string expressions launch no hand kernel:
# the reference computes them with XLA ops, the port with torch ops.
STRINGS_COUNTS = {
    "q8": {"decode.unpack_bits": 186, "segreduce.seg_scan_sorted": 3,
           "segreduce.gather_seg_scan": 15, "filter_decode.decode": 9,
           "filter_decode.decode_str": 2},
    "q15": {"decode.unpack_bits": 37, "filter_decode.decode": 1,
            "segreduce.gather_seg_scan": 18},
    "q19": {"decode.unpack_bits": 45, "filter_decode.decode": 4,
            "filter_decode.decode_str": 1, "segreduce.gather_seg_scan": 8},
    "q45": {"decode.unpack_bits": 25, "filter_decode.decode": 1,
            "segreduce.gather_seg_scan": 6},
    "q84": {"decode.unpack_bits": 17, "filter_decode.decode": 1},
    "q93": {"decode.unpack_bits": 53, "filter_decode.decode": 1,
            "segreduce.gather_seg_scan": 18},
}
# the pushed filters' own dictionary columns (condition_column), and the
# batches of a filtered scan with no dictionary column to defer
# (no_dict_columns), as the reference counts them
STRINGS_FALLBACKS = {
    "q8": {"scan.filterDecode.condition_column": 10,
           "scan.filterDecode.no_dict_columns": 8},
    "q15": {"scan.filterDecode.condition_column": 2},
    "q19": {"scan.filterDecode.condition_column": 3},
    "q45": {"scan.filterDecode.condition_column": 2},
    "q84": {"scan.filterDecode.condition_column": 5,
            "scan.filterDecode.no_dict_columns": 3},
    "q93": {"scan.filterDecode.condition_column": 1},
}
# the join routes, pinned from the first run on the H100: the probe route
# where both sides keep their value-range hints (unfiltered dimension
# scans and the exchanges' uploads of narrow keys), else the sort route.
# Re-pinned in PR 21 with the counts above: a shuffled join now makes one
# pair (and its aggregate one batch) per spec of its adaptive readers,
# where it made one per exchange partition (q8, q19, q45, q84 move)
STRINGS_ROUTES = {
    "q8": {"join.route.probe": 16, "join.route.sort": 25},
    "q15": {"join.route.probe": 0, "join.route.sort": 24},
    "q19": {"join.route.probe": 3, "join.route.sort": 24},
    "q45": {"join.route.probe": 0, "join.route.sort": 22},
    "q84": {"join.route.probe": 20, "join.route.sort": 16},
    "q93": {"join.route.probe": 0, "join.route.sort": 10},
}
STRINGS_EVAL = ("filter.eval", "project.eval", "fused.eval")
STRINGS_SECTIONS = SHUFFLE_SECTIONS + STRINGS_EVAL


def write_strings_files(root: str, store_sales: pa.Table) -> dict:
    """The census tables at SF10 from the port's builders (every
    generator column), on a generator of their own; returns them."""
    from spark_rapids_tpu_torch.bench import tpcds
    t0 = time.perf_counter()
    rng = np.random.default_rng(STRINGS_SEED)
    sz = tpcds._Sizes(STAR_SF)
    t = {"store_sales": store_sales}
    for name, fn in tpcds._BUILDERS:
        if name in STRINGS_TABLES:
            t[name] = fn(rng, sz, t)
    del t["store_sales"]
    t1 = time.perf_counter()
    write_parts(root, t, lambda _n, table: STAR_FILES if
                table.num_rows > STRINGS_SPLIT_ROWS else 1)
    log(f"strings files: generated "
        f"{', '.join(f'{k} {v.num_rows} rows' for k, v in t.items())} at "
        f"SF{STAR_SF} in {t1 - t0:.1f} s, wrote them in "
        f"{time.perf_counter() - t1:.1f} s")
    return t


def _prefix(a, n: int):
    return pc.utf8_slice_codeunits(a, 0, n)


def _dates(t: dict, qoy: int, year: int) -> pa.Table:
    dd = t["date_dim"]
    return dd.filter(pc.and_(pc.equal(dd["d_qoy"], qoy),
                             pc.equal(dd["d_year"], year))).select(
        ["d_date_sk"])


def _customer_zips(t: dict, sales: pa.Table, cust: str,
                   ca_cols) -> pa.Table:
    """``sales`` joined with its customer and the customer's address."""
    j = sales.join(t["customer"].select(["c_customer_sk",
                                         "c_current_addr_sk"]),
                   keys=cust, right_keys="c_customer_sk", join_type="inner")
    return j.join(t["customer_address"].select(["ca_address_sk"] +
                                               list(ca_cols)),
                  keys="c_current_addr_sk", right_keys="ca_address_sk",
                  join_type="inner")


_ZIPS15 = ["85", "86", "88", "89", "80", "81", "30", "31"]
_ITEMS45 = [f"ITEM{i:012d}" for i in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)]


def strings_reference(name: str, t: dict) -> pa.Table:
    """q8, q15, q19, q45, q84 and q93 computed with pyarrow alone (joins,
    utf8_slice_codeunits for substring, starts_with, binary_join for
    concat, group_by, sort_by), independent of both engines."""
    if name == "q8":
        pref = t["customer"].filter(pc.equal(
            t["customer"]["c_preferred_cust_flag"], "Y")).select(
            ["c_current_addr_sk"]).join(
            t["customer_address"].select(["ca_address_sk", "ca_zip"]),
            keys="c_current_addr_sk", right_keys="ca_address_sk",
            join_type="inner")
        cnt = pref.group_by("ca_zip").aggregate([("ca_zip", "count")])
        zips = pc.unique(_prefix(cnt.filter(pc.greater(
            cnt["ca_zip_count"], 1))["ca_zip"], 2))
        j = t["store_sales"].select(
            ["ss_sold_date_sk", "ss_store_sk", "ss_net_profit"]).join(
            _dates(t, 2, 1998), keys="ss_sold_date_sk",
            right_keys="d_date_sk", join_type="inner")
        j = j.join(t["store"].select(["s_store_sk", "s_store_name",
                                      "s_zip"]),
                   keys="ss_store_sk", right_keys="s_store_sk",
                   join_type="inner")
        j = j.filter(pc.is_in(_prefix(j["s_zip"], 2), value_set=zips))
        g = j.group_by("s_store_name").aggregate(
            [("ss_net_profit", "sum")]).rename_columns(
            {"ss_net_profit_sum": "profit"})
        return g.select(["s_store_name", "profit"]).sort_by(
            "s_store_name").slice(0, 100)
    if name in ("q15", "q45"):
        pre = "cs" if name == "q15" else "ws"
        cols = [f"{pre}_bill_customer_sk", f"{pre}_sold_date_sk",
                f"{pre}_sales_price"] + (["ws_item_sk"] if pre == "ws"
                                         else [])
        table = "catalog_sales" if pre == "cs" else "web_sales"
        keys = ["ca_zip"] + (["ca_city"] if pre == "ws" else [])
        ca_cols = ["ca_zip", "ca_state"] if pre == "cs" else ["ca_zip",
                                                              "ca_city"]
        j = _customer_zips(t, t[table].select(cols),
                           f"{pre}_bill_customer_sk", ca_cols)
        j = j.join(_dates(t, 2, 2001), keys=f"{pre}_sold_date_sk",
                   right_keys="d_date_sk", join_type="inner")
        zip2 = _prefix(j["ca_zip"], 2)
        if pre == "cs":
            m = pc.or_(pc.or_(pc.is_in(zip2, value_set=pa.array(_ZIPS15)),
                              pc.is_in(j["ca_state"], value_set=pa.array(
                                  ["CA", "WA", "GA"]))),
                       pc.greater(j["cs_sales_price"], 500.0))
        else:
            j = j.join(t["item"].select(["i_item_sk", "i_item_id"]),
                       keys="ws_item_sk", right_keys="i_item_sk",
                       join_type="inner")
            zip2 = _prefix(j["ca_zip"], 2)
            m = pc.or_(pc.is_in(zip2, value_set=pa.array(
                _ZIPS15 + ["38", "98"])), pc.is_in(
                j["i_item_id"], value_set=pa.array(_ITEMS45)))
        g = j.filter(m).group_by(keys).aggregate(
            [(f"{pre}_sales_price", "sum")]).rename_columns(
            {f"{pre}_sales_price_sum": "total"})
        return g.select(keys + ["total"]).sort_by(
            [(k, "ascending") for k in keys]).slice(0, 100)
    if name == "q19":
        j = t["store_sales"].select(
            ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
             "ss_store_sk", "ss_ext_sales_price"])
        dd = t["date_dim"]
        j = j.join(dd.filter(pc.and_(pc.equal(dd["d_moy"], 11),
                                     pc.equal(dd["d_year"], 1999))).select(
            ["d_date_sk"]), keys="ss_sold_date_sk", right_keys="d_date_sk",
            join_type="inner")
        item = t["item"]
        j = j.join(item.filter(pc.less_equal(item["i_manager_id"], 20))
                   .select(["i_item_sk", "i_brand", "i_brand_id",
                            "i_manufact_id"]),
                   keys="ss_item_sk", right_keys="i_item_sk",
                   join_type="inner")
        j = _customer_zips(t, j, "ss_customer_sk", ["ca_zip"])
        j = j.join(t["store"].select(["s_store_sk", "s_zip"]),
                   keys="ss_store_sk", right_keys="s_store_sk",
                   join_type="inner")
        j = j.filter(pc.not_equal(_prefix(j["ca_zip"], 5),
                                  _prefix(j["s_zip"], 5)))
        g = j.group_by(["i_brand", "i_brand_id", "i_manufact_id"]).aggregate(
            [("ss_ext_sales_price", "sum")]).rename_columns(
            {"ss_ext_sales_price_sum": "ext_price", "i_brand": "brand",
             "i_brand_id": "brand_id"})
        return g.select(["brand", "brand_id", "i_manufact_id",
                         "ext_price"]).sort_by(
            [("ext_price", "descending"), ("brand_id", "ascending"),
             ("i_manufact_id", "ascending")]).slice(0, 100)
    if name == "q84":
        ca = t["customer_address"]
        j = t["customer"].select(
            ["c_customer_id", "c_current_addr_sk", "c_current_hdemo_sk",
             "c_current_cdemo_sk", "c_first_name", "c_last_name"]).join(
            ca.filter(pc.is_in(ca["ca_city"], value_set=pa.array(
                ["Midway", "Fairview", "Oakland"]))).select(
                ["ca_address_sk"]),
            keys="c_current_addr_sk", right_keys="ca_address_sk",
            join_type="inner")
        j = j.join(t["household_demographics"].select(
            ["hd_demo_sk", "hd_income_band_sk"]),
            keys="c_current_hdemo_sk", right_keys="hd_demo_sk",
            join_type="inner")
        ib = t["income_band"]
        j = j.join(ib.filter(pc.and_(
            pc.greater_equal(ib["ib_lower_bound"], 0),
            pc.less_equal(ib["ib_upper_bound"], 100000))).select(
            ["ib_income_band_sk"]), keys="hd_income_band_sk",
            right_keys="ib_income_band_sk", join_type="inner")
        j = j.join(t["customer_demographics"].select(["cd_demo_sk"]),
                   keys="c_current_cdemo_sk", right_keys="cd_demo_sk",
                   join_type="inner")
        returned = pc.unique(t["store_returns"]["sr_cdemo_sk"])
        j = j.filter(pc.is_in(j["c_current_cdemo_sk"], value_set=returned))
        out = pa.table({
            "customer_id": j["c_customer_id"],
            "customername": pc.binary_join_element_wise(
                j["c_last_name"], j["c_first_name"], ", ")})
        return out.sort_by("customer_id").slice(0, 100)
    # q93
    r = t["reason"]
    sr = t["store_returns"].select(
        ["sr_reason_sk", "sr_ticket_number", "sr_item_sk",
         "sr_return_quantity"]).join(
        r.filter(pc.starts_with(r["r_reason_desc"], "reason 2")).select(
            ["r_reason_sk"]), keys="sr_reason_sk", right_keys="r_reason_sk",
        join_type="inner")
    sr = sr.select(["sr_ticket_number", "sr_item_sk",
                    "sr_return_quantity"]).rename_columns(
        ["r_t", "r_i", "r_q"])
    j = t["store_sales"].select(
        ["ss_ticket_number", "ss_item_sk", "ss_customer_sk", "ss_quantity",
         "ss_sales_price"]).join(
        sr, keys=["ss_ticket_number", "ss_item_sk"], right_keys=["r_t", "r_i"],
        join_type="left outer")
    q, rq, price = j["ss_quantity"], j["r_q"], j["ss_sales_price"]
    act = pc.if_else(
        pc.is_null(rq), pc.multiply(pc.cast(q, pa.float64()), price),
        pc.multiply(pc.cast(pc.subtract(q, rq), pa.float64()), price))
    g = j.append_column("act", act).group_by("ss_customer_sk").aggregate(
        [("act", "sum")]).rename_columns({"act_sum": "sumsales"})
    return g.select(["ss_customer_sk", "sumsales"]).sort_by(
        [("sumsales", "ascending"), ("ss_customer_sk", "ascending")]).slice(
        0, 100)


def _expr_names(node) -> set:
    """The class names of every expression a plan node holds."""
    from spark_rapids_tpu_torch.expr import ir
    out = set()
    for v in vars(node).values():
        for e in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(e, ir.Expression):
                out.update(type(x).__name__
                           for x in ir.collect(e, lambda x: True))
    return out


def _check_strings_plan(name: str, plan) -> str:
    """No host node but the transitions; the query's string expression
    sits in a device filter, projection, fused stage or fused aggregate
    (q93's also pushed into reason's scan).  Returns the holder's name."""
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    nodes = _plan_nodes(plan)
    names = [type(n).__name__ for n in nodes]
    host = [n for n in names if n not in HOST_OK and
            not n.startswith("Tpu")]
    if host:
        fail(f"strings {name}: host nodes {host}")
    want = STRINGS_EXPR[name]
    holders = [type(n).__name__ for n in nodes
               if type(n).__name__ in ("TpuFilterExec", "TpuProjectExec",
                                       "TpuFusedStageExec",
                                       "TpuHashAggregateExec")
               and want in _expr_names(n)]
    if not holders:
        fail(f"strings {name}: no device filter, projection or fused node "
             f"holds {want}: {names}")
    if name == "q93":
        pushed = [n for n in nodes if isinstance(n, TpuParquetScanExec)
                  and n._schema.names[0].startswith("r_")
                  and n._pushed_filter is not None]
        if not pushed:
            fail("strings q93: the startswith filter is not pushed into "
                 "reason's scan")
    return ", ".join(sorted(set(holders)))


def phase_strings(root: str, tables: dict):
    """q8, q15, q19, q45, q84 and q93 at SF10 over Parquet on port
    sessions on cuda at the shuffle phase's conf: the plan checks, rows
    against pyarrow, the kernels, fallbacks and join routes with the
    counts set to 0 before each query, then the cold wall, the warm walls
    with sections, one profiler trace (with the kernel launches inside
    the string expressions' eval spans) and the peak device memory.
    Returns (launches over the six queries, recorded classes, kernel
    names)."""
    from spark_rapids_tpu_torch.obs import registry as obsreg
    t0 = time.perf_counter()
    refs = {q: strings_reference(q, tables) for q in STRINGS_QUERIES}
    log(f"strings: pyarrow references in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{q} {r.num_rows} rows' for q, r in refs.items())})")
    del tables
    errors, total, names = [], {}, []
    shapes = ShapeRecorder()
    for q in STRINGS_QUERIES:
        tag = f"strings {q}"
        run = query_run(q, root, STRINGS_READS[q], STRINGS_CONF)
        view = obsreg.get_registry().view()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        with shapes:
            out, plan = run({})
            torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
        counters = view.delta()["counters"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{tag} plan:\n{plan.tree_string()}")
        holder = _check_strings_plan(q, plan)
        rel = check_rows(tag, out, refs[q])
        routes = {k: int(counters.get(k, 0)) for k in STAR_COUNTERS}
        log(f"{tag}: {out.num_rows} rows match pyarrow (float max rel "
            f"{rel:.3g}): {out.to_pylist()[:2]}; {STRINGS_EXPR[q]} in "
            f"{holder}; cold wall {cold * 1e3:.1f} ms; launches {launches}; "
            f"fallbacks {fallbacks}; {routes}; peak device memory "
            f"{peak:.2f} GiB")
        log(f"{tag} cold sections: " + _fmt_ms(_sections(plan,
                                                         STRINGS_SECTIONS)))
        if launches.get("decode.unpack_bits", 0) <= 0:
            fail(f"{tag} did not launch decode.unpack_bits")
        _pinned(tag, launches, STRINGS_COUNTS, q, errors)
        _pinned(tag, fallbacks, STRINGS_FALLBACKS, q, errors)
        _pinned(tag, {k: routes[k] for k in STAR_COUNTERS[:2]},
                STRINGS_ROUTES, q, errors)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        names += [k for k in launches if k not in names]
        if WHOLE_SMOKE:
            continue    # the whole smoke's limit: the cold run only
        sec = _star_sections(run, reps=STRINGS_WARM, keys=STRINGS_SECTIONS)
        log(f"{tag} sections (host clock, median of {STRINGS_WARM} warm "
            f"runs; runs ms "
            f"{', '.join(f'{w * 1e3:.1f}' for w in sec['walls'])}): "
            + _fmt_ms(sec))
        busy = trace_form(tag, run, {}, label="strings",
                          launch_spans=STRINGS_EVAL)
        log(f"{tag}: device busy {busy['busy_share']:.1%} of "
            f"{busy['wall_ms']:.1f} ms")
    if errors:
        fail("; ".join(errors))
    return total, shapes.classes, names


# cut from 2^20 rows to 2^18 when the last slice's phases joined the
# smoke: the CPU session's side of these comparisons grows with the rows,
# and the whole smoke must stay inside its time limit
MODES_STRING_ROWS = 1 << 17
_ALNUM = "abAB _%"


def _string_modes_pool(rng, n: int, widest: int) -> list:
    """Strings of byte widths 0-``widest``: letters LIKE's patterns find,
    spaces and wildcard bytes, leading and trailing whitespace, and _WIDE
    multi-byte characters."""
    out = []
    for i in range(n):
        width = int(rng.integers(0, widest + 1)) if i % 4 == 0 else \
            int(rng.integers(0, 17))
        body = "".join(_ALNUM[k] for k in rng.integers(0, len(_ALNUM), width))
        if i % 3 == 0:
            body = body + _WIDE[i % len(_WIDE)]
        if i % 7 == 0:
            body = "  " + body + "\t "
        out.append(body.encode()[:widest].decode("utf-8", errors="ignore"))
    return out


def _text_pool(rng, n: int) -> dict:
    """Numeric, boolean, date and timestamp text, valid and invalid."""
    ints = [str(int(v)) for v in rng.integers(-10 ** 12, 10 ** 12, n)]
    ints[:8] = ["9223372036854775807", "-9223372036854775808",
                "99999999999999999999", "+7", " 12 ", "1.5", "x", ""]
    floats = [repr(float(v)) for v in rng.normal(0, 1e6, n)]
    floats[:12] = ["Infinity", "-inf", "NaN", "1e400", "1e-400", "1.2.3",
                   "+.5", "5.", "1e", " 7.25 ", "123456789012345678901234",
                   "-0.0"]
    bools = list(np.array(["true", "FALSE", "y", "N", "1", "0", "yes", "no",
                           " t ", "maybe", ""])[rng.integers(0, 11, n)])
    days = rng.integers(_days_of(1582, 1, 1), _days_of(9999, 12, 31), n)
    dates = [str(np.datetime64(int(v), "D")) for v in days]
    dates[:8] = ["2024-02-30", "2023-02-29", "2000-02-29", "1969-12-31",
                 "2024-13-01", "2024-1-1", " 2024-03-05 ", "bad"]
    us = rng.integers(-10 ** 16, 2 * 10 ** 17, n)
    stamps = [str(np.datetime64(int(v), "us")).replace("T", " ")
              for v in us]
    stamps[:8] = ["2024-03-05T07:08:09", "2024-03-05", "1969-12-31 "
                  "23:59:59.999999", "2024-03-05 24:00:00", "2024-03-05 12:34",
                  "2024-03-05 12:34:56.1234567", "1800-01-01 00:00:00.5",
                  "nope"]
    return {"it": ints, "ft": floats, "bt": bools, "dtx": dates,
            "tt": stamps}


def _days_of(y: int, m: int, d: int) -> int:
    return int(np.datetime64(f"{y:04d}-{m:02d}-{d:02d}", "D").astype(
        np.int64))


def string_modes_table(n: int, seed: int) -> pa.Table:
    """``n`` rows, about 5% nulls per column: strings of byte widths 0-256
    and of 0-24 (pools of 8,192), a needle column of 0-3 bytes, a
    substring position,
    numeric, boolean, date and timestamp text, int64, int32 and bool
    values, dates from 1582 to 9999 and before the epoch, and timestamps
    from 1653 to 8307, negative ones among them."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.05

    def take(pool):
        return pa.array(pool).take(pa.array(rng.integers(0, len(pool), n)))
    s = take(_string_modes_pool(rng, 8192, 256))
    m = take(_string_modes_pool(rng, 8192, 24))
    needle = take(["", "a", "ab", "b ", "é", "ba", "abA", " ", "%", "_"])
    text = {k: take(v) for k, v in _text_pool(rng, 4096).items()}
    cols = {
        "s": pa.array(s.to_pylist(), type=pa.string(), mask=nulls()),
        "m": pa.array(m.to_pylist(), type=pa.string(), mask=nulls()),
        "n": pa.array(needle.to_pylist(), type=pa.string(), mask=nulls()),
        "p": pa.array(rng.integers(-300, 300, n).astype(np.int32),
                      mask=nulls()),
        "k": pa.array(rng.integers(-100_000, 100_000, n).astype(np.int32),
                      mask=nulls()),
        "i64": pa.array(np.where(rng.random(n) < 0.01, np.iinfo(np.int64).min,
                                 rng.integers(-2 ** 62, 2 ** 62, n)),
                        mask=nulls()),
        "i32": pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                        mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "d": pa.array(rng.integers(_days_of(1582, 1, 1), _days_of(
            9999, 12, 31), n).astype(np.int32), mask=nulls()).cast(
            pa.date32()),
        "d2": pa.array(rng.integers(-30_000, 30_000, n).astype(np.int32),
                       mask=nulls()).cast(pa.date32()),
        "t": pa.array(rng.integers(-10 ** 16, 2 * 10 ** 17, n),
                      mask=nulls()).cast(pa.timestamp("us")),
    }
    for k, v in text.items():
        cols[k] = pa.array(v.to_pylist(), type=pa.string(), mask=nulls())
    return pa.table(cols)


def string_modes_exprs(col, lit, F):
    """(group, [(alias, column)]) of every form this port's string,
    string-cast and date/time expressions take.  Each function meets the
    256-byte column ``s`` once; the other forms take the 32-byte column
    ``m`` (the CPU side's cost grows with the width)."""
    s, m, n = col("s"), col("m"), col("n")
    likes = ["a%", "%b", "a_b%", "_%_", "a%b%a", "", "%", "abA", "%é", "_",
             "% a%", "%%_b%%"]
    dates = []
    for f in ("year", "month", "dayofmonth", "dayofyear", "dayofweek",
              "weekofyear", "quarter"):
        dates += [(f"{f}_d", getattr(F, f)(col("d"))),
                  (f"{f}_t", getattr(F, f)(col("t")))]
    return [
        ("case, length, reverse, trims", [
            ("up", F.upper(s)), ("lo", F.lower(s)), ("len", F.length(s)),
            ("rev", F.reverse(s)), ("tr", F.trim(s)), ("ltr", F.ltrim(s)),
            ("rtr", F.rtrim(s)), ("ic", F.initcap(s)), ("trm", F.trim(m)),
            ("icm", F.initcap(m))]),
        ("substring", [
            ("s23", F.substring(s, 2, 3)), ("sp", F.substring(s, col("p"),
                                                              lit(4))),
            ("sn3", F.substring(m, -3, 2)), ("s05", F.substring(m, 0, 5)),
            ("sn300", F.substring(m, -300, 10)),
            ("s10", F.substring(m, 1, 0)), ("s5n", F.substring(m, 5, -1)),
            ("s20", F.substring(m, 20, 60))]),
        ("searches", [
            ("sw", s.startswith("a")), ("ew", s.endswith("b")),
            ("ct", s.contains("ab")), ("swn", s.startswith(n)),
            ("ewn", s.endswith(n)), ("ctn", s.contains(n)),
            ("sw2", m.startswith("ab")), ("swe", m.startswith("")),
            ("ewm", m.endswith("é")), ("ct2", m.contains("a b")),
            ("ctm", m.contains(n))]),
        ("like", [("lks", s.like("%ab%")), ("lks2", s.like("a_%b"))] +
         [(f"lk{i}", m.like(p)) for i, p in enumerate(likes)]),
        ("concat, locate, pads", [
            ("cc", F.concat(s, lit("-"), n)), ("loc", F.locate("a", s)),
            ("lps", F.lpad(s, 5, "*")), ("rps", F.rpad(s, 3, "ab")),
            ("cn", F.concat(n, m, n)), ("loc5", F.locate("b", m, 5)),
            ("loc2", F.locate("ab", m, 0)), ("loce", F.locate("", m, 3)),
            ("lpl", F.lpad(m, 40, "xy")), ("rpl", F.rpad(m, 40, "*")),
            ("lpm", F.lpad(m, 5, "*")), ("rpe", F.rpad(m, 20, "")),
            ("lp0", F.lpad(m, 0, "z"))]),
        ("casts from string", [
            ("i", col("it").cast("bigint")), ("i32", col("it").cast("int")),
            ("f", col("ft").cast("double")), ("f32", col("ft").cast("float")),
            ("b", col("bt").cast("boolean")), ("d", col("dtx").cast("date")),
            ("ts", col("tt").cast("timestamp")),
            ("wi", s.cast("bigint"))]),
        ("casts to string", [
            ("si64", col("i64").cast("string")),
            ("si32", col("i32").cast("string")),
            ("sb", col("b").cast("string")), ("sd", col("d").cast("string")),
            ("sd2", col("d2").cast("string")),
            ("st", col("t").cast("string"))]),
        ("date/time", dates + [
            ("hr", F.hour(col("t"))), ("mi", F.minute(col("t"))),
            ("se", F.second(col("t"))), ("da", F.date_add(col("d"), col("k"))),
            ("ds", F.date_sub(col("d2"), 7)),
            ("dd", F.datediff(col("d"), col("d2"))),
            ("ddt", F.datediff(col("t"), col("d"))),
            ("ut", F.unix_timestamp(col("t")))]),
    ]


LAUNCH_APIS = LAUNCH_CALLS + ("cudaMemcpyAsync", "cudaMemsetAsync")


def _launches_per_call(calls, phase: str = "string-modes") -> list:
    """(label, kernel launches, copies and memsets the host enqueued) of
    each (label, fn) of ``calls``, from one torch.profiler trace: each
    call runs inside a ``record_function`` range named after ``phase``,
    and the launch calls the profiler records on the CPU are counted per
    range.  Each call runs once before the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    for _label, fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in calls:
            with record_function(f"{phase}:{label}"):
                fn()
        torch.cuda.synchronize()
    events = [(n, a, b) for n, d, a, b in _profiler_events(prof)
              if d == DeviceType.CPU]
    api = [a for n, a, _b in events if n.startswith(LAUNCH_APIS)]
    return [(n.split(":", 1)[1], sum(a <= t < b for t in api))
            for n, a, b in events if n.startswith(f"{phase}:")]


def phase_string_modes() -> None:
    """Every string, string-cast and date/time expression this port
    evaluates, in every form (LIKE with %, _ and leading and trailing
    segments; literal and column needles; negative and zero substring
    positions; pads longer and shorter than the input), on the card
    against the same DataFrame on a port session on the CPU over a
    2^18-row table: exactly, floats bit for bit.  Then the kernel
    launches, copies and memsets one evaluation of each expression
    enqueues over the same table on the card.  Untimed."""
    from spark_rapids_tpu_torch.api import TpuSparkSession, col, lit
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    from spark_rapids_tpu_torch.expr import eval_tpu, ir
    from spark_rapids_tpu_torch.plan.logical import Schema
    conf = {"spark.rapids.tpu.sql.test.enabled": True,
            "spark.rapids.tpu.sql.castStringToFloat.enabled": True,
            "spark.rapids.tpu.sql.castStringToTimestamp.enabled": True}
    t0 = time.perf_counter()
    table = string_modes_table(MODES_STRING_ROWS, 23)
    sessions = {d: TpuSparkSession(conf, device=d) for d in ("cuda", "cpu")}
    groups = string_modes_exprs(col, lit, F)
    nexprs = 0
    for tag, exprs in groups:
        outs = {}
        for d, s in sessions.items():
            df = s.create_dataframe(table).select(
                *[e.alias(a) for a, e in exprs])
            if d == "cuda":
                plan = df.explain_string("physical")
                if "Cpu" in plan.replace("CpuScanExec", ""):
                    fail(f"string-modes {tag}: a host node:\n{plan}")
            outs[d] = df.collect()
        _bit_equal(f"string-modes {tag}", outs["cuda"], outs["cpu"])
        nexprs += len(exprs)
    log(f"string-modes: {nexprs} expressions in {len(groups)} groups over "
        f"{MODES_STRING_ROWS} rows (nulls ~5%; strings of byte widths 0-256 "
        f"and 0-24 with whitespace and multi-byte characters) equal the CPU "
        f"session's bit for bit in {time.perf_counter() - t0:.1f} s")
    schema = Schema.from_arrow(table.schema)
    batch = from_arrow(table, device="cuda")
    calls = [(a, partial(eval_tpu.evaluate, ir.bind(
        e.expr, schema.names, schema.dtypes, schema.nullables), batch))
        for _tag, exprs in groups for a, e in exprs]
    ops = _launches_per_call(calls)
    if len(ops) != len(calls):
        fail(f"string-modes: {len(ops)} traced evaluations of {len(calls)}")
    log(f"string-modes: kernel launches, copies and memsets per evaluation "
        f"over one {batch.capacity}-row batch (s is "
        f"{batch.column('s').data.shape[1]} bytes wide): "
        + ", ".join(f"{a} {n}" for a, n in ops))


# ---------------------------------------------------------------------------
# 9e. the mortgage ETL, the customer ETL over the census customer file, and
# the tail modes
# ---------------------------------------------------------------------------

# the mortgage ETL at SF 1: 500,000 loans, 9,000,000 performance rows, the
# explode of 0..11 emitting 108,000,000 rows
MORT_SF = 1.0
MORT_SEED = 7
MORT_PIECES = ("etl", "simple_aggregates", "delinquency_rate")
MORT_WARM = 1
# the strings phase's conf (test mode, variableFloatAgg, the default 10 MiB
# broadcast threshold) with the two-stage aggregate on the device
# transport.  A single-stage aggregate concatenates every partition's
# partial at its input capacity (the reference's layout), which for the
# explode's eight 2^24-row partials is a 2^27-row merge that does not fit
# the card; the exchange bounds each reducer's merge by its own groups.
# On the local transport the 108,000,000 exploded rows cross the host
# through Arrow IPC (exchange.upload 27.9 s of a 61.4 s warm ETL wall on
# the H100); on the device transport the slices stay on the card.
MORT_CONF = dict(STRINGS_CONF, **{
    "spark.rapids.tpu.sql.agg.exchange.enabled": True,
    TRANSPORT_KEY: "device"})
# the kernel launches, fallbacks and join routes of each piece, pinned
# from the first run on the H100 at MORT_CONF: the fused scans' unpack of
# perf's and acq's dictionary codes, the aggregates' gathered segmented
# scans (the ETL's per-loan max/min and the exploded rows' max/min) and
# sorted scans (the COUNT(*)s); no pushed filter, so no dictionary
# gather; every shuffled join on the sort route (the keys are a string
# and a long).  The routes were re-pinned in PR 21: one pair per spec of
# the joins' adaptive readers (the ETL's joins 8, 4 and 1; the simple
# aggregates' 1) where each exchange partition was one
MORT_COUNTS = {
    "etl": {"decode.unpack_bits": 102, "segreduce.gather_seg_scan": 104},
    "simple_aggregates": {"decode.unpack_bits": 64,
                          "segreduce.seg_scan_sorted": 6,
                          "segreduce.gather_seg_scan": 36},
    "delinquency_rate": {"decode.unpack_bits": 40,
                         "segreduce.gather_seg_scan": 28,
                         "segreduce.seg_scan_sorted": 6},
}
MORT_FALLBACKS = {p: {} for p in MORT_PIECES}
MORT_ROUTES = {
    "etl": {"join.route.probe": 0, "join.route.sort": 13},
    "simple_aggregates": {"join.route.probe": 0, "join.route.sort": 1},
    "delinquency_rate": {"join.route.probe": 0, "join.route.sort": 0},
}
GENERATE_SECTIONS = ("generate.count", "generate.emit")
MORT_SECTIONS = SHUFFLE_SECTIONS + STRINGS_EVAL + GENERATE_SECTIONS


def write_mortgage_files(root: str) -> dict:
    """The port's ``mortgage.generate(MORT_SF, MORT_SEED)``: perf in
    STAR_FILES files, acq in one, written by 8 threads; returns them."""
    from spark_rapids_tpu_torch.bench import mortgage
    t0 = time.perf_counter()
    t = mortgage.generate(MORT_SF, MORT_SEED)
    t1 = time.perf_counter()
    write_parts(root, t, lambda _n, table: STAR_FILES if
                table.num_rows > STRINGS_SPLIT_ROWS else 1)
    log(f"mortgage files: generated "
        f"{', '.join(f'{k} {v.num_rows} rows' for k, v in t.items())} at "
        f"SF {MORT_SF} in {t1 - t0:.1f} s, wrote them in "
        f"{time.perf_counter() - t1:.1f} s")
    return t


def _mortgage_etl_reference(t: dict) -> pa.Table:
    """``mortgage.run`` with pyarrow and numpy: the per-loan worst status
    and first delinquent dates (group_by), joined back to every
    performance row, the explode of 0..11 as ``np.repeat`` and a tiled
    ``month_y``, the re-aggregation over a packed key of all seven group
    columns, the cleaned acquisition records (seller names through the
    name mapping) and the final inner join."""
    from spark_rapids_tpu_torch.bench import mortgage
    perf, acq = t["perf"], t["acq"]
    st = perf["current_loan_delinquency_status"]
    agg = pa.table({"quarter": perf["quarter"], "loan_id": perf["loan_id"],
                    "s": st}).group_by(["quarter", "loan_id"]).aggregate(
        [("s", "max")])
    worst = agg["s_max"]
    agg = pa.table({"a_quarter": agg["quarter"], "a_loan_id": agg["loan_id"],
                    "e30": pc.greater_equal(worst, 1),
                    "e90": pc.greater_equal(worst, 3),
                    "e180": pc.greater_equal(worst, 6)})
    date = perf["monthly_reporting_period"]
    j = pa.table({"quarter": perf["quarter"], "loan_id": perf["loan_id"],
                  "d12": st, "upb": perf["current_actual_upb"],
                  "ym": pc.add(pc.multiply(pc.year(date), 12),
                               pc.month(date))}).join(
        agg, keys=["loan_id", "quarter"], right_keys=["a_loan_id",
                                                     "a_quarter"],
        join_type="left outer")
    quarters = pc.unique(j["quarter"])
    qcode = pc.index_in(j["quarter"], value_set=quarters).to_numpy()
    flags = sum(w * j[c].combine_chunks().to_numpy(
        zero_copy_only=False).astype(np.int64)
        for w, c in ((1, "e30"), (2, "e90"), (4, "e180")))
    n = j.num_rows
    month_y = np.tile(np.arange(12, dtype=np.int64), n)
    mody = np.repeat(j["ym"].to_numpy(), 12) - 24000 - month_y
    josh = np.floor(mody.astype(np.float64) / 12.0).astype(np.int64)
    if josh.min() < -8 or josh.max() > 7:
        fail(f"mortgage reference: josh_mody_n {josh.min()}..{josh.max()} "
             f"outside the packed key's range")
    # key: loan, quarter, the three flags, josh_mody_n, month_y
    base = (j["loan_id"].to_numpy() * 16 + qcode) * 8 + flags
    key = (np.repeat(base, 12) * 16 + (josh + 8)) * 16 + month_y
    del mody, josh, month_y
    g = pa.table({"key": key,
                  "d12": np.repeat(j["d12"].to_numpy(), 12),
                  "upb": np.repeat(j["upb"].to_numpy(), 12)}).group_by(
        "key").aggregate([("d12", "max"), ("upb", "min")])
    del key
    k = g["key"].to_numpy()
    month_y, k = k % 16, k // 16
    josh, k = k % 16 - 8, k // 16
    flags, k = k % 8, k // 8
    qcode, loan = k % 16, k // 16
    ts_base = 24000 + josh * 12 + month_y
    tmp = ts_base % 12
    perf_d = pa.table({
        "loan_id": loan,
        "quarter": quarters.take(pa.array(qcode)),
        "timestamp_year": np.floor((ts_base - 1).astype(np.float64) /
                                   12.0).astype(np.int64),
        "timestamp_month": np.where(tmp == 0, 12, tmp),
        "delinquency_12": (
            (g["d12_max"].to_numpy() > 3).astype(np.int32) +
            (g["upb_min"].to_numpy() == 0.0).astype(np.int32)),
        "ever_30": (flags & 1) != 0, "ever_90": (flags & 2) != 0,
        "ever_180": (flags & 4) != 0})
    canon = mortgage._CANON
    to_name = pc.take(pa.array(list(canon.values())), pc.index_in(
        acq["seller_name"], value_set=pa.array(list(canon.keys()))))
    acq_c = pa.table({
        "q_loan_id": acq["loan_id"], "q_quarter": acq["quarter"],
        "seller": pc.coalesce(to_name, acq["seller_name"]),
        **{c: acq[c] for c in ("orig_channel", "orig_interest_rate",
                               "orig_upb", "dti", "borrower_credit_score",
                               "first_home_buyer")}})
    out = perf_d.join(acq_c, keys=["loan_id", "quarter"],
                      right_keys=["q_loan_id", "q_quarter"],
                      join_type="inner")
    return out.select(["loan_id", "quarter", "timestamp_year",
                       "timestamp_month", "delinquency_12", "ever_30",
                       "ever_90", "ever_180", "seller", "orig_channel",
                       "orig_interest_rate", "orig_upb", "dti",
                       "borrower_credit_score", "first_home_buyer"])


def mortgage_reference(piece: str, t: dict) -> pa.Table:
    """The three pieces of ``bench/mortgage.py`` computed with pyarrow
    (and numpy for the ETL's explode), independent of both engines."""
    if piece == "etl":
        return _mortgage_etl_reference(t)
    perf = t["perf"]
    st = "current_loan_delinquency_status"
    if piece == "simple_aggregates":
        loans = perf.select(["quarter", "loan_id"]).group_by(
            ["quarter", "loan_id"]).aggregate([]).group_by(
            "quarter").aggregate([("loan_id", "count")])
        stats = perf.group_by("quarter").aggregate(
            [("interest_rate", "mean"), ("current_actual_upb", "sum"),
             (st, "max")])
        j = stats.join(loans, keys="quarter", join_type="inner")
        return pa.table({
            "quarter": j["quarter"], "loans": j["loan_id_count"],
            "avg_rate": j["interest_rate_mean"],
            "total_upb": j["current_actual_upb_sum"],
            "worst_status": j[f"{st}_max"]}).sort_by("quarter")
    per_loan = perf.group_by(["quarter", "loan_id"]).aggregate(
        [(st, "max")])
    ev = pc.cast(pc.greater_equal(per_loan[f"{st}_max"], 3), pa.int64())
    g = pa.table({"quarter": per_loan["quarter"], "ev": ev}).group_by(
        "quarter").aggregate([("ev", "count"), ("ev", "sum")])
    loans, ev90 = g["ev_count"], g["ev_sum"]
    return pa.table({
        "quarter": g["quarter"], "loans": loans, "ever_90": ev90,
        "rate": pc.divide(pc.cast(ev90, pa.float64()),
                          pc.cast(loans, pa.float64()))}).sort_by("quarter")


def check_rows_unordered(tag: str, out: pa.Table, ref: pa.Table,
                         key) -> None:
    """Row sets equal without order: both tables sorted on ``key(table)``
    (an int64 array unique per row), then every column equal (floats to
    tests/parity.py's tolerance), nulls included."""
    if out.column_names != ref.column_names or out.num_rows != ref.num_rows:
        fail(f"{tag}: {out.column_names} x {out.num_rows} rows != "
             f"reference {ref.column_names} x {ref.num_rows}")
    if ref.num_rows == 0:
        fail(f"{tag}: the reference is empty")
    ka, kb_ = key(out), key(ref)
    ia, ib = np.argsort(ka, kind="stable"), np.argsort(kb_, kind="stable")
    if not np.array_equal(ka[ia], kb_[ib]):
        fail(f"{tag}: the row keys differ from the reference's")
    if len(np.unique(kb_)) != len(kb_):
        fail(f"{tag}: the sort key is not unique")
    ia, ib = pa.array(ia), pa.array(ib)
    for c in ref.column_names:
        a = out[c].combine_chunks().take(ia)
        b = ref[c].combine_chunks().take(ib)
        if a.type != b.type:
            fail(f"{tag}: column {c} is {a.type}, the reference's {b.type}")
        if not a.is_valid().equals(b.is_valid()):
            fail(f"{tag}: column {c}: nulls differ")
        if pa.types.is_floating(b.type):
            x = a.fill_null(0).to_numpy()
            y = b.fill_null(0).to_numpy()
            ok = np.isclose(x, y, rtol=1e-9, atol=1e-11) | (
                np.isnan(x) & np.isnan(y))
            if not ok.all():
                i = int(np.flatnonzero(~ok)[0])
                fail(f"{tag}: column {c}: {x[i]!r} != {y[i]!r}")
        elif not a.equals(b):
            fail(f"{tag}: column {c} differs from the reference")


def _etl_key(t: pa.Table) -> np.ndarray:
    """loan, year, month: one output row each."""
    return (t["loan_id"].to_numpy() * 4096 +
            (t["timestamp_year"].to_numpy() - 1990) * 16 +
            t["timestamp_month"].to_numpy())


def mortgage_run(piece: str, root: str):
    """run(conf) -> (Arrow output, planned plan) of one mortgage piece on a
    fresh port session on cuda over the perf and acq files."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.bench import mortgage

    def run(conf):
        s = TpuSparkSession(dict(MORT_CONF, **conf), device="cuda")
        plans = []
        s.add_plan_listener(lambda r: plans.append(r.plan))
        t = {n: s.read.parquet(os.path.join(root, n))
             for n in ("perf", "acq")}
        df = mortgage.run(t, s) if piece == "etl" else \
            getattr(mortgage, piece)(t)
        return df.collect(), plans[-1]
    return run


def _check_host_free(tag: str, plan, must=()) -> list:
    """No host node but the transitions and in-memory scans; every name of
    ``must`` present.  Returns the node names."""
    names = [type(n).__name__ for n in _plan_nodes(plan)]
    host = [n for n in names if n not in HOST_OK and
            not n.startswith("Tpu")]
    if host:
        fail(f"{tag}: host nodes {host}")
    for want in must:
        if want not in names:
            fail(f"{tag}: no {want}: {names}")
    return names


def _etl_query(tag: str, run, check, pins, shapes, errors, total, names,
               warm: int, sections, must=(), launch_spans=STRINGS_EVAL,
               routes=None, trace=True):
    """One query of the mortgage or customer-ETL phase: the cold run with
    the counts set to 0 just before it (plan, rows, pinned launches,
    fallbacks and routes, peak memory), then ``warm`` warm walls with
    sections and (``trace``) one profiler trace."""
    from spark_rapids_tpu_torch.obs import registry as obsreg
    counts, falls, route_pins = pins
    view = obsreg.get_registry().view()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with shapes:
        out, plan = run({})
        torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
    counters = view.delta()["counters"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} plan:\n{plan.tree_string()}")
    _check_host_free(tag, plan, must)
    t1 = time.perf_counter()
    what = check(out)
    jr = {k: int(counters.get(k, 0)) for k in STAR_COUNTERS[:2]}
    log(f"{tag}: {out.num_rows} rows {what} (checked in "
        f"{time.perf_counter() - t1:.1f} s); cold wall {cold * 1e3:.1f} ms; "
        f"launches {launches}; fallbacks {fallbacks}; routes {jr}; peak "
        f"device memory {peak:.2f} GiB")
    log(f"{tag} cold sections: " + _fmt_ms(_sections(plan, sections)))
    del plan      # its exchanges may hold device memory
    key = tag.split(" ", 1)[1]
    _pinned(tag, launches, counts, key, errors)
    _pinned(tag, fallbacks, falls, key, errors)
    if routes:
        _pinned(tag, jr, route_pins, key, errors)
    if not launches:
        fail(f"{tag} launched no kernel")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    names += [k for k in launches if k not in names]
    del out
    if warm:
        sec = _star_sections(run, reps=warm, keys=sections)
        log(f"{tag} sections (host clock, median of {warm} warm runs; "
            f"runs ms {', '.join(f'{w * 1e3:.1f}' for w in sec['walls'])}"
            f"): " + _fmt_ms(sec))
    if trace:
        busy = trace_form(tag, run, {}, label=tag.split(" ")[0],
                          launch_spans=launch_spans)
        log(f"{tag}: device busy {busy['busy_share']:.1%} of "
            f"{busy['wall_ms']:.1f} ms")


def phase_mortgage():
    """The mortgage ETL (``bench/mortgage.py``: ``run``,
    ``simple_aggregates``, ``delinquency_rate``) at SF 1 over Parquet on
    port sessions on cuda.  Each prints its plan (no host node but the
    transitions and the name mapping's in-memory scan; the ETL's holds a
    TpuGenerateExec), must match an independent pyarrow/numpy computation
    (row sets without order for the ETL), launches, falls back and routes
    its joins as pinned, then its cold wall, a warm wall with sections
    (``generate.count`` and ``generate.emit`` among them), one profiler
    trace and its peak device memory.  Returns (launches over the three,
    recorded classes, kernel names)."""
    root = _parquet_dir("mortgage")
    try:
        t = write_mortgage_files(root)
        t0 = time.perf_counter()
        refs = {p: mortgage_reference(p, t) for p in MORT_PIECES}
        log(f"mortgage: references in {time.perf_counter() - t0:.1f} s ("
            + ", ".join(f"{p} {r.num_rows} rows" for p, r in refs.items())
            + ")")
        del t
        errors, total, names = [], {}, []
        shapes = ShapeRecorder()
        for p in MORT_PIECES:
            tag = f"mortgage {p}"
            ref = refs.pop(p)
            if p == "etl":
                def check(out, ref=ref, tag=tag):
                    check_rows_unordered(tag, out, ref, _etl_key)
                    return "match the pyarrow/numpy reference as row sets"
            else:
                def check(out, ref=ref, tag=tag):
                    rel = check_rows(tag, out, ref)
                    return f"match pyarrow (float max rel {rel:.3g}): " \
                        f"{out.to_pylist()[:2]}"
            _etl_query(tag, mortgage_run(p, root), check,
                       (MORT_COUNTS, MORT_FALLBACKS, MORT_ROUTES), shapes,
                       errors, total, names,
                       # the whole smoke's limit: the cold run only
                       0 if WHOLE_SMOKE else MORT_WARM, MORT_SECTIONS,
                       must=("TpuGenerateExec",) if p == "etl" else (),
                       launch_spans=STRINGS_EVAL + GENERATE_SECTIONS,
                       routes=True, trace=not WHOLE_SMOKE)
        if errors:
            fail("; ".join(errors))
        return total, shapes.classes, names
    finally:
        shutil.rmtree(root, ignore_errors=True)


CUST_PATTERN = "^c[0-9]*[13579]@example"
CUST_SEED = 11
CUST_WARM = 1
# pinned from the first run on the H100: unpack_bits for the birth year's
# dictionary codes in each of the 8 fused batches (the key and the
# address are PLAIN); the RLIKE filter stays a device filter above the
# scan, which counts the reference's condition_columns fallback per batch
CUST_COUNTS = {"query": {"decode.unpack_bits": 8}}
CUST_FALLBACKS = {"query": {"scan.filterDecode.condition_columns": 8}}
CUST_SECTIONS = ("scan.hostPrepTime", "scan.uploadTime", "scan.dispatch") + \
    STRINGS_EVAL + ("transition.download",)


def customer_etl_query(s, root: str, col, lit, F, full: bool = True):
    """The census customer file's odd-numbered e-mail addresses (an RLIKE
    in the device subset), with md5 of the address, a literal and an NFA
    regexp_replace, a double (the key over the birth year, a dictionary
    column) cast to string and the two partition leaves and rand.  ``full=False`` keeps the key, the leaves and rand, and
    selects the same rows by ``c_customer_sk % 2 == 0`` (the address of
    customer k is ``c{k - 1}@example.com``), so a CPU session gets the
    same batches without running the NFA on the host."""
    c = s.read.parquet(os.path.join(root, "customer"))
    em = col("c_email_address")
    cols = [col("c_customer_sk")]
    if full:
        cols += [F.md5(em).alias("h"),
                 F.regexp_replace(em, "@example", "@ex").alias("lit"),
                 F.regexp_replace(em, "[0-9]+", "#").alias("nfa"),
                 (col("c_customer_sk") / col("c_birth_year")).cast(
                     "string").alias("ratio")]
    cols += [F.monotonically_increasing_id().alias("mid"),
             F.spark_partition_id().alias("pid"),
             F.rand(CUST_SEED).alias("r")]
    keep = em.rlike(CUST_PATTERN) if full else \
        (col("c_customer_sk") % 2 == 0)
    return c.filter(keep).select(*cols)


def _customer_reference_file(path: str) -> dict:
    """:func:`customer_etl_reference`'s rows of one customer file (run in
    a pool worker)."""
    import hashlib
    import re
    t = papq.read_table(path, columns=["c_customer_sk", "c_birth_year",
                                       "c_email_address"])
    rx = re.compile(CUST_PATTERN)
    digits = re.compile("[0-9]+")
    emails = t["c_email_address"].to_pylist()
    keep = [i for i, e in enumerate(emails)
            if e is not None and rx.search(e)]
    sks = t["c_customer_sk"].to_numpy()[keep].tolist()
    years = t["c_birth_year"].to_numpy()[keep].tolist()
    em = [emails[i] for i in keep]
    return {"c_customer_sk": sks,
            "h": [hashlib.md5(e.encode()).hexdigest() for e in em],
            "lit": [re.sub("@example", "@ex", e) for e in em],
            "nfa": [digits.sub("#", e) for e in em],
            "ratio": [repr(k / y) for k, y in zip(sks, years)]}


def customer_etl_reference(root: str) -> pa.Table:
    """The same rows with Python's ``re``, ``hashlib`` and ``repr``, by
    c_customer_sk: one spawned worker per customer file."""
    import multiprocessing
    d = os.path.join(root, "customer")
    files = sorted(os.path.join(d, f) for f in os.listdir(d))
    with multiprocessing.get_context("spawn").Pool(len(files)) as pool:
        parts = pool.map(_customer_reference_file, files)
    t = pa.table({k: pa.array(sum((p[k] for p in parts), []),
                              pa.int64() if k == "c_customer_sk" else
                              pa.string())
                  for k in parts[0]})
    return t.sort_by("c_customer_sk")


def _check_leaves(tag: str, out: pa.Table) -> int:
    """spark_partition_id() is the id's top bits; within each partition,
    in c_customer_sk order (the scan's order), the id's low 33 bits count
    0, 1, 2, ...  Returns the partitions seen."""
    mid = out["mid"].to_numpy()
    pid = out["pid"].to_numpy()
    if not np.array_equal(mid >> 33, pid):
        fail(f"{tag}: monotonically_increasing_id() >> 33 != "
             f"spark_partition_id()")
    for p in np.unique(pid):
        low = mid[pid == p] & ((1 << 33) - 1)
        if not np.array_equal(low, np.arange(len(low))):
            fail(f"{tag}: partition {p}'s row offsets do not count 0, 1, "
                 f"2, ...")
    return len(np.unique(pid))


def phase_customer_etl(root: str, customer: pa.Table):
    """The customer ETL over the strings phase's customer file (10,000,000
    rows) on a port session on cuda at the shuffle phase's conf: the plan
    (no host node but the transitions), the rows against Python's re,
    hashlib and repr, the leaves' structure, rand and the leaves bit for
    bit against a port session on the CPU over the same batches; the
    pinned launches and fallbacks; the cold wall, a warm wall with
    sections, one trace and the peak device memory.  Returns (launches,
    recorded classes, kernel names)."""
    from spark_rapids_tpu_torch.api import TpuSparkSession, col, lit
    from spark_rapids_tpu_torch.api import functions as F
    t0 = time.perf_counter()
    ref = customer_etl_reference(root)
    log(f"customer-etl: the re/hashlib/repr reference in "
        f"{time.perf_counter() - t0:.1f} s ({ref.num_rows} of "
        f"{customer.num_rows} rows)")
    t0 = time.perf_counter()
    cpu = customer_etl_query(TpuSparkSession(STRINGS_CONF, device="cpu"),
                             root, col, lit, F, full=False).collect()
    cpu = cpu.sort_by("c_customer_sk")
    log(f"customer-etl: the CPU session's leaves and rand in "
        f"{time.perf_counter() - t0:.1f} s")

    def run(conf):
        s = TpuSparkSession(dict(STRINGS_CONF, **conf), device="cuda")
        plans = []
        s.add_plan_listener(lambda r: plans.append(r.plan))
        return customer_etl_query(s, root, col, lit, F).collect(), plans[-1]

    def check(out):
        tag = "customer-etl query"
        out = out.sort_by("c_customer_sk")
        if out.num_rows != ref.num_rows:
            fail(f"{tag}: {out.num_rows} rows != the reference's "
                 f"{ref.num_rows}")
        for c in ref.column_names:
            if not out[c].combine_chunks().equals(ref[c].combine_chunks()):
                a, b = out[c].to_pylist(), ref[c].to_pylist()
                i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                fail(f"{tag}: column {c} row {i}: {a[i]!r} != {b[i]!r}")
        _bit_equal(f"{tag} leaves and rand vs the CPU session",
                   out.select(cpu.column_names), cpu)
        parts = _check_leaves(tag, out)
        return (f"match re/hashlib/repr; ids, partition ids ({parts} "
                f"partitions) and rand equal the CPU session's bit for bit")
    errors, total, names = [], {}, []
    shapes = ShapeRecorder()
    _etl_query("customer-etl query", run, check,
               (CUST_COUNTS, CUST_FALLBACKS, None), shapes, errors, total,
               names, 0 if WHOLE_SMOKE else CUST_WARM, CUST_SECTIONS,
               trace=not WHOLE_SMOKE)    # the whole smoke: cold only
    if errors:
        fail("; ".join(errors))
    return total, shapes.classes, names


# 2^20 rows until the tpch phase joined the smoke (its time limit)
MODES_TAIL_ROWS = 1 << 18
TAIL_FLOATS = [0.0, -0.0, float("nan"), float("inf"), float("-inf"),
               5e-324, 2.2250738585072014e-308, 1.7976931348623157e308,
               1e16, 9999999999999998.0, 1e-4, 1e-5, 0.5, 2.5, 4.35, 1.005,
               2.675, 0.1, 0.3, 1 / 3, 1e22, 1e23, 9.999999999999999e15]


def _list_column(rng, n: int, floats: bool) -> pa.Array:
    """Lists of 0-8 elements, ~5% null lists, ~8% null elements."""
    lens = rng.integers(0, 9, n)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    m = int(offsets[-1])
    vals = rng.integers(-4, 12, m)
    values = pa.array(vals + 0.5 if floats else vals,
                      mask=rng.random(m) < 0.08)
    null = np.concatenate([rng.random(n) < 0.05, [False]])
    return pa.ListArray.from_arrays(pa.array(offsets, mask=null), values)


def tail_modes_table(n: int, seed: int) -> pa.Table:
    """``n`` rows: strings of byte widths 0-256, 0-24 and 0-12 (pools of
    8,192, whitespace and multi-byte characters), doubles (the ryu edges, random
    bit patterns, normal values) and floats, list<int64> and
    list<double> with null and empty lists and null elements, int32
    indexes and int64 values; about 5% nulls per column."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.05

    def take(pool):
        return pa.array(pool).take(pa.array(rng.integers(0, len(pool), n)))
    bits = rng.integers(0, 2 ** 63, n, dtype=np.int64).view(np.float64)
    f = np.where(rng.random(n) < 0.5, bits,
                 rng.normal(0, 1, n) * 10.0 ** rng.integers(-30, 30, n))
    f[:len(TAIL_FLOATS)] = TAIL_FLOATS
    return pa.table({
        "s": pa.array(take(_string_modes_pool(rng, 8192, 256)).to_pylist(),
                      type=pa.string(), mask=nulls()),
        "m": pa.array(take(_string_modes_pool(rng, 8192, 24)).to_pylist(),
                      type=pa.string(), mask=nulls()),
        "w": pa.array(take(_string_modes_pool(rng, 8192, 12)).to_pylist(),
                      type=pa.string(), mask=nulls()),
        "f": pa.array(f, mask=nulls()),
        "f32": pa.array(np.clip(np.nan_to_num(f), -3e38, 3e38).astype(
            np.float32), mask=nulls()),
        "arr": _list_column(rng, n, False),
        "farr": _list_column(rng, n, True),
        "k": pa.array(rng.integers(-10, 10, n).astype(np.int32),
                      mask=nulls()),
        "x": pa.array(rng.integers(-5, 12, n), mask=nulls()),
    })


def tail_modes_exprs(col, lit, F):
    """(group, [(alias, column)]) of every form of this slice's
    expressions: md5 over two widths, float and double -> string, RLIKE
    and regexp_replace (literal and NFA paths; the NFA replace over the
    12-byte column, as the CPU side's cost grows with width times
    starts), and the list group."""
    s, m, w = col("s"), col("m"), col("w")
    arr, farr = col("arr"), col("farr")
    return [
        ("md5", [("h", F.md5(s)), ("hm", F.md5(m))]),
        ("float to string", [("fs", col("f").cast("string")),
                             ("f32s", col("f32").cast("string"))]),
        ("regex", [
            ("r1", m.rlike("[ab]+ ")), ("r2", m.rlike("^a")),
            ("r3", m.rlike("b$")), ("r4", m.rlike("(ab|ba)+")),
            ("r5", m.rlike(r"\s|_")), ("r6", m.rlike("^[aAbB ]*$")),
            ("x1", F.regexp_replace(s, "ab", "<>")),
            ("x2", F.regexp_replace(m, " ", "")),
            ("x3", F.regexp_replace(w, "a+", "A")),
            ("x4", F.regexp_replace(w, "[ab]{2,3}", "")),
            ("x5", F.regexp_replace(w, r"\s+", "_")),
            ("x6", F.regexp_replace(w, "^[aA]", "^"))]),
        ("lists", [
            ("n", F.size(arr)), ("i0", arr[0]), ("i2", farr[2]),
            ("c3", F.array_contains(arr, 3)),
            ("cf", F.array_contains(farr, 1.5)),
            ("cx", F.array_contains(arr, col("x"))),
            ("e1", F.element_at(arr, 1)), ("en", F.element_at(farr, -1)),
            ("ek", F.element_at(arr, col("k"))),
            ("mk", F.array(col("x"), col("k"), lit(3))),
            ("mkf", F.array(col("f"), col("x")))]),
    ]


# regex forms outside the device subset: (alias, pattern, replacement or
# None for RLIKE, the reason the plan must name); both sessions keep them
# on the CPU
TAIL_FALLBACKS = (("o1", r"(a)\1", None, "outside the device regex subset"),
                  ("o2", "(a)b", "<$1>", "group/backslash references"),
                  ("o3", "a{1,2}(ab)?", "X", "may differ from longest-match"))


def _tail_generate(s, table, F):
    """explode, posexplode and their outer forms over the list columns."""
    df = s.create_dataframe(table).select("k", "arr", "farr")
    return [("explode", df.select("k", F.explode("arr").alias("v"))),
            ("explode_outer", df.select("k",
                                        F.explode_outer("arr").alias("v"))),
            ("posexplode", df.select("k", F.posexplode("farr"))),
            ("posexplode_outer", df.select("k",
                                           F.posexplode_outer("farr")))]


def phase_tail_modes() -> None:
    """Every expression this slice ports, in every form, on cuda against
    the same DataFrame on a port session on the CPU over a 2^20-row
    table, bit for bit; the forms outside the regex subset on the CPU in
    both with the reference's reasons; explode/posexplode and the outer
    forms; the partition leaves and rand over 4 partitions of 4 batches
    each; a list column written to Parquet and read through the PERFILE
    reader (expand_stream must launch) and exploded; then the kernel
    launches, copies and memsets one evaluation of each expression, and
    the explode's two passes, enqueue.  Untimed."""
    from spark_rapids_tpu_torch.api import TpuSparkSession, col, lit
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    from spark_rapids_tpu_torch.exec import generate
    from spark_rapids_tpu_torch.expr import eval_tpu, ir
    from spark_rapids_tpu_torch.plan.logical import Schema
    conf = {"spark.rapids.tpu.sql.test.enabled": True,
            "spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    t0 = time.perf_counter()
    table = tail_modes_table(MODES_TAIL_ROWS, 29)
    sessions = {d: TpuSparkSession(conf, device=d) for d in ("cuda", "cpu")}
    groups = tail_modes_exprs(col, lit, F)
    nexprs = 0

    def both(tag, make, host_ok=False, must=None):
        outs = {}
        for d, s in sessions.items():
            df = make(s)
            if d == "cuda":
                plan = df.explain_string("physical")
                if not host_ok and "Cpu" in plan.replace("CpuScanExec", ""):
                    fail(f"tail-modes {tag}: a host node:\n{plan}")
                if must and must not in plan:
                    fail(f"tail-modes {tag}: no {must}:\n{plan}")
            outs[d] = df.collect()
        _bit_equal(f"tail-modes {tag}", outs["cuda"], outs["cpu"])
        return outs["cuda"]
    for tag, exprs in groups:
        t1 = time.perf_counter()
        both(tag, lambda s: s.create_dataframe(table).select(
            *[e.alias(a) for a, e in exprs]))
        nexprs += len(exprs)
        detail(f"tail-modes {tag}: {len(exprs)} forms equal in "
               f"{time.perf_counter() - t1:.1f} s")
    ok_conf = dict(conf, **{"spark.rapids.tpu.sql.test.allowedNonTpu":
                            "CpuProjectExec"})
    # these run on the host in both sessions: a slice of the table does
    head = table.slice(0, 1 << 16)
    for a, pat, rep, why in TAIL_FALLBACKS:
        e = col("w").rlike(pat) if rep is None else \
            F.regexp_replace(col("w"), pat, rep)
        fb = {d: TpuSparkSession(ok_conf, device=d).create_dataframe(
            head).select(e.alias(a)) for d in ("cuda", "cpu")}
        text = fb["cuda"].explain_string("tpu")
        if why not in text:
            fail(f"tail-modes {a}: the plan does not name '{why}':\n{text}")
        _bit_equal(f"tail-modes {a}", fb["cuda"].collect(),
                   fb["cpu"].collect())
    for tag, _df in _tail_generate(sessions["cuda"], table, F):
        both(tag, lambda s, tag=tag: dict(_tail_generate(s, table, F))[tag],
             must="TpuGenerateExec")
    leaf_batch = MODES_TAIL_ROWS >> 4     # 4 batches per partition
    lconf = {"spark.rapids.tpu.sql.reader.batchSizeRows": leaf_batch}
    lsess = {d: TpuSparkSession(dict(conf, **lconf), device=d)
             for d in ("cuda", "cpu")}

    def leaves(s):
        df = s.create_dataframe(table.select(["x", "k"]), num_partitions=4)
        return df.select("x", F.spark_partition_id().alias("p"),
                         F.monotonically_increasing_id().alias("mid"),
                         F.rand(3).alias("r"))
    outs = {d: leaves(s).collect() for d, s in lsess.items()}
    _bit_equal("tail-modes leaves", outs["cuda"], outs["cpu"])
    parts = sorted(set(outs["cuda"]["p"].to_pylist()))
    if parts != [0, 1, 2, 3] or \
            (outs["cuda"]["mid"].to_numpy() &
             ((1 << 33) - 1)).max() < leaf_batch:
        fail(f"tail-modes leaves: partitions {parts}, offsets not past "
             f"one batch")
    fouts = {d: s.create_dataframe(table.select(["x"]), num_partitions=4)
             .filter(F.monotonically_increasing_id() % 5 == 2)
             .select("x", F.spark_partition_id().alias("p")).collect()
             for d, s in lsess.items()}
    _bit_equal("tail-modes leaves in a filter", fouts["cuda"], fouts["cpu"])
    # a list column through the PERFILE reader
    root = _parquet_dir("tail-modes")
    try:
        papq.write_table(table.select(["k", "arr"]),
                         os.path.join(root, "part-0000.parquet"),
                         row_group_size=1 << 18)
        pconf = {"spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled":
                 False}
        _reset_counts()
        pout = {}
        for d in ("cuda", "cpu"):
            s = TpuSparkSession(dict(conf, **pconf), device=d)
            df = s.read.parquet(root).select(
                "k", F.size("arr").alias("n"),
                F.explode_outer("arr").alias("v"))
            if d == "cuda":
                plan = df.explain_string("physical")
                pout[d] = df.collect()
                expand = dict(kb.launches).get("decode.expand_stream", 0)
            else:
                pout[d] = df.collect()
        if "TpuGenerateExec" not in plan or expand <= 0:
            fail(f"tail-modes perfile: expand_stream launches {expand}:\n"
                 f"{plan}")
        _bit_equal("tail-modes perfile list", pout["cuda"], pout["cpu"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"tail-modes: {nexprs} expressions in {len(groups)} groups, "
        f"{len(TAIL_FALLBACKS)} regex forms outside the subset (on the CPU "
        f"in both, with the reference's reasons), 4 generate forms, the "
        f"leaves and rand over 4 partitions of {leaf_batch}-row batches, "
        f"and a "
        f"list column through the PERFILE reader ({expand} expand_stream "
        f"launches) over {MODES_TAIL_ROWS} rows equal the CPU session's "
        f"bit for bit in {time.perf_counter() - t0:.1f} s")
    schema = Schema.from_arrow(table.schema)
    batch = from_arrow(table, device="cuda")

    def bound(e):
        return ir.bind(e.expr, schema.names, schema.dtypes, schema.nullables)
    calls = [(a, partial(eval_tpu.evaluate, bound(e), batch))
             for _tag, exprs in groups for a, e in exprs]
    calls += [(a, partial(eval_tpu.evaluate, bound(e), batch)) for a, e in (
        ("pid", F.spark_partition_id()),
        ("mid", F.monotonically_increasing_id()), ("rand", F.rand(3)))]
    gen = ir.bind(F.explode(col("arr")).expr, schema.names, schema.dtypes,
                  schema.nullables)

    def explode():
        v = eval_tpu.evaluate(gen.children[0], batch)
        counts = generate._counts(v, batch, False)
        total = int(counts.sum())
        from spark_rapids_tpu_torch.columnar.batch import bucket_rows
        out_schema = Schema.from_arrow(pa.schema(
            list(table.schema) + [pa.field("v", pa.int64())]))
        return generate._generate_kernel(batch, v, counts, total,
                                         bucket_rows(total), gen,
                                         out_schema, False, False)
    calls.append(("explode", explode))
    ops = _launches_per_call(calls, "tail-modes")
    if len(ops) != len(calls):
        fail(f"tail-modes: {len(ops)} traced evaluations of {len(calls)}")
    log(f"tail-modes: kernel launches, copies and memsets per evaluation "
        f"over one {batch.capacity}-row batch (s is "
        f"{batch.column('s').data.shape[1]} bytes wide, m "
        f"{batch.column('m').data.shape[1]}, w "
        f"{batch.column('w').data.shape[1]}): "
        + ", ".join(f"{a} {n}" for a, n in ops))


# ---------------------------------------------------------------------------
# 8h. TPC-H from SQL text at SF10: the SQL front end, the cache, the
# writers with the device encoders and the device handoff; the io modes
# ---------------------------------------------------------------------------

# SF10 when the phase runs alone (``python3 chip_smoke.py tpch``, about
# 600 s on the H100); SF 2 in the whole smoke, whose time limit neither
# SF10 nor SF 5 fits (the whole smoke took 1402.2 s with SF 5)
TPCH_SF = 10.0
TPCH_SF_WHOLE = 2.0
TPCH_SEED = 7
TPCH_SQL = ("q1", "q3", "q5", "q6", "q10", "q12", "q14", "q19")
TPCH_WARM = 2
# the mortgage phase's conf: test mode, variableFloatAgg, the default
# 10 MiB broadcast threshold (lineitem's and orders' joins shuffle), and
# the two-stage aggregate on the device transport.  The single-stage
# aggregate concatenates every batch's partial at its input capacity (the
# reference's layout): q1's merge over lineitem's partials ran out of the
# card (73.22 GiB allocated by torch when it failed, H100 80GB).
TPCH_CONF = MORT_CONF
# the kernel launches, fallbacks and join routes of each query at each
# scale, pinned from the first run on the H100: the fused scans' unpack
# of the dictionary codes and the aggregates' gathered segmented scans
# everywhere, q1's COUNT(*) through seg_scan_sorted.  Only q1 and q6 read
# one table, so only their WHERE clauses sit directly above a scan and
# are pushed into it (the dictionary gathers decode / decode_str and the
# condition columns' filterDecode fallbacks); the SQL front end, like the
# reference's, keeps the other queries' WHERE clauses above their joins.
# q5's nation/region joins take the probe route, the rest the sort route.
# PR 21 re-pinned q14 at SF 2: its join's adaptive readers coalesce the 8
# partitions into 4 specs, and the aggregate above runs once per spec
TPCH_COUNTS = {
    10.0: {"q1": {"decode.unpack_bits": 256, "filter_decode.decode": 192,
                  "filter_decode.decode_str": 64,
                  "segreduce.gather_seg_scan": 56,
                  "segreduce.seg_scan_sorted": 4},
           "q3": {"decode.unpack_bits": 169, "segreduce.gather_seg_scan": 16},
           "q5": {"decode.unpack_bits": 176, "segreduce.gather_seg_scan": 8},
           "q6": {"decode.unpack_bits": 192, "filter_decode.decode": 32,
                  "segreduce.gather_seg_scan": 66},
           "q10": {"decode.unpack_bits": 170,
                   "segreduce.gather_seg_scan": 16},
           "q12": {"decode.unpack_bits": 72, "segreduce.gather_seg_scan": 8},
           "q14": {"decode.unpack_bits": 161,
                   "segreduce.gather_seg_scan": 36},
           "q19": {"decode.unpack_bits": 226,
                   "segreduce.gather_seg_scan": 18}},
    2.0: {"q1": {"decode.unpack_bits": 64, "filter_decode.decode": 48,
                 "filter_decode.decode_str": 16,
                 "segreduce.gather_seg_scan": 56,
                 "segreduce.seg_scan_sorted": 4},
          "q3": {"decode.unpack_bits": 43, "segreduce.gather_seg_scan": 16},
          "q5": {"decode.unpack_bits": 40, "segreduce.gather_seg_scan": 8},
          "q6": {"decode.unpack_bits": 48, "filter_decode.decode": 8,
                 "segreduce.gather_seg_scan": 18},
          "q10": {"decode.unpack_bits": 44, "segreduce.gather_seg_scan": 16},
          "q12": {"decode.unpack_bits": 18, "segreduce.gather_seg_scan": 8},
          "q14": {"decode.unpack_bits": 41, "segreduce.gather_seg_scan": 20},
          "q19": {"decode.unpack_bits": 58,
                  "segreduce.gather_seg_scan": 18}}}
TPCH_FALLBACKS = {
    sf: dict({q: {} for q in TPCH_SQL},
             q1={"scan.filterDecode.condition_column": 32 // per},
             q6={"scan.filterDecode.condition_column": 96 // per})
    for sf, per in ((10.0, 1), (2.0, 4))}
_NO_JOIN = {"join.route.probe": 0, "join.route.sort": 0}
# one pair per spec of the shuffled join's adaptive readers (the plan
# prints ``specs=``): partitions under the 64 MiB advisory size coalesce,
# more of them at SF 2
TPCH_ROUTES = {sf: {
    "q1": _NO_JOIN, "q6": _NO_JOIN,
    "q3": {"join.route.probe": 0, "join.route.sort": q3},
    "q5": {"join.route.probe": 16, "join.route.sort": q5},
    "q10": {"join.route.probe": 8, "join.route.sort": q10},
    "q12": {"join.route.probe": 0, "join.route.sort": 8},
    "q14": {"join.route.probe": 0, "join.route.sort": q14},
    "q19": {"join.route.probe": 0, "join.route.sort": 8}}
    for sf, q3, q5, q10, q14 in ((10.0, 12, 20, 16, 8), (2.0, 10, 17, 10,
                                                         4))}
TPCH_SECTIONS = SHUFFLE_SECTIONS + STRINGS_EVAL
# the lineitem columns q1 and q6 read: the cached relation's projection
CACHE_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
CACHE_QUERIES = ("q1", "q6")
# launches and fallbacks of each (query, round) over the cached lineitem
# at each scale, pinned from the first run on the H100: the first run's
# materializing scan unpacks the dictionary codes; every run expands the
# five non-string columns' def-level streams (one launch per column and
# blob) and aggregates
def _cache_counts(blobs: int, unpack: int) -> dict:
    q1 = {"decode.expand_stream": 5 * blobs, "segreduce.gather_seg_scan": 56,
          "segreduce.seg_scan_sorted": 4}
    q6 = {"decode.expand_stream": 5 * blobs,
          "segreduce.gather_seg_scan": 2 * blobs + 2}
    return {"q1#1": dict(q1, **{"decode.unpack_bits": unpack}),
            "q6#1": q6, "q1#2": q1, "q6#2": q6}


# lineitem's scan gives 32 blobs at SF10 and 8 at SF 2
CACHE_COUNTS = {10.0: _cache_counts(32, 256), 2.0: _cache_counts(8, 64)}
CACHE_FALLBACKS = {sf: {k: {} for k in ("q1#1", "q6#1", "q1#2", "q6#2")}
                   for sf in (10.0, 2.0)}
HANDOFF_DEVICE = "cuda"


def write_tpch_files(root: str, sf: float) -> dict:
    """The port's ``tpch.generate(sf, TPCH_SEED)``: each table of
    more than 2^20 rows in STAR_FILES files, the others in one, written
    by 8 threads (dictionary-encoded, pyarrow's defaults); returns the
    tables."""
    from spark_rapids_tpu_torch.bench import tpch
    t0 = time.perf_counter()
    t = tpch.generate(sf, TPCH_SEED)
    t1 = time.perf_counter()
    write_parts(root, t, lambda _n, table: STAR_FILES if
                table.num_rows > STRINGS_SPLIT_ROWS else 1)
    log(f"tpch files: generated "
        f"{', '.join(f'{k} {v.num_rows} rows' for k, v in t.items())} at "
        f"SF {sf:g} in {t1 - t0:.1f} s, wrote them in "
        f"{time.perf_counter() - t1:.1f} s")
    return t


def _date(y: int, m: int, d: int):
    import datetime
    return pa.scalar(datetime.date(y, m, d), pa.date32())


def _revenue(t: pa.Table):
    return pc.multiply(t["l_extendedprice"],
                       pc.subtract(pa.scalar(1.0), t["l_discount"]))


def _between(a, lo, hi):
    return pc.and_(pc.greater_equal(a, lo), pc.less_equal(a, hi))


def tpch_reference(name: str, t: dict) -> pa.Table:
    """One of the eight SQL queries computed by pyarrow alone (filters,
    ``Table.join``, ``group_by``, ``sort_by``) from the generated tables."""
    L, O, C = t["lineitem"], t["orders"], t["customer"]
    inner = partial(pa.Table.join, join_type="inner")
    if name == "q1":
        li = L.filter(pc.less_equal(L["l_shipdate"], _date(1998, 9, 2)))
        dp = _revenue(li)
        g = pa.table({
            "f": li["l_returnflag"], "s": li["l_linestatus"],
            "q": li["l_quantity"], "p": li["l_extendedprice"], "dp": dp,
            "ch": pc.multiply(dp, pc.add(pa.scalar(1.0), li["l_tax"])),
            "d": li["l_discount"]}).group_by(["f", "s"]).aggregate([
                ("q", "sum"), ("p", "sum"), ("dp", "sum"), ("ch", "sum"),
                ("q", "mean"), ("p", "mean"), ("d", "mean"),
                ("q", "count", pc.CountOptions(mode="all"))])
        g = g.sort_by([("f", "ascending"), ("s", "ascending")])
        return pa.table({
            "l_returnflag": g["f"], "l_linestatus": g["s"],
            "sum_qty": g["q_sum"], "sum_base_price": g["p_sum"],
            "sum_disc_price": g["dp_sum"], "sum_charge": g["ch_sum"],
            "avg_qty": g["q_mean"], "avg_price": g["p_mean"],
            "avg_disc": g["d_mean"], "count_order": g["q_count"]})
    if name == "q3":
        c = C.filter(pc.equal(C["c_mktsegment"], "BUILDING")) \
            .select(["c_custkey"])
        o = O.filter(pc.less(O["o_orderdate"], _date(1995, 3, 15))).select(
            ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])
        co = inner(o, c, "o_custkey", "c_custkey")
        li = L.filter(pc.greater(L["l_shipdate"], _date(1995, 3, 15))) \
            .select(["l_orderkey", "l_extendedprice", "l_discount"])
        j = inner(li, co, "l_orderkey", "o_orderkey")
        j = j.append_column("rev", _revenue(j))
        g = j.group_by(["l_orderkey", "o_orderdate", "o_shippriority"]) \
            .aggregate([("rev", "sum")])
        g = g.sort_by([("rev_sum", "descending"),
                       ("o_orderdate", "ascending")]).slice(0, 10)
        return pa.table({"l_orderkey": g["l_orderkey"],
                         "revenue": g["rev_sum"],
                         "o_orderdate": g["o_orderdate"],
                         "o_shippriority": g["o_shippriority"]})
    if name == "q5":
        r = t["region"].filter(pc.equal(t["region"]["r_name"], "ASIA"))
        n = inner(t["nation"].select(["n_nationkey", "n_name",
                                      "n_regionkey"]),
                  r.select(["r_regionkey"]), "n_regionkey", "r_regionkey")
        s = inner(t["supplier"].select(["s_suppkey", "s_nationkey"]),
                  n.select(["n_nationkey", "n_name"]), "s_nationkey",
                  "n_nationkey")
        o = O.filter(pc.and_(
            pc.greater_equal(O["o_orderdate"], _date(1994, 1, 1)),
            pc.less(O["o_orderdate"], _date(1995, 1, 1)))) \
            .select(["o_orderkey", "o_custkey"])
        co = inner(o, C.select(["c_custkey", "c_nationkey"]), "o_custkey",
                   "c_custkey")
        lco = inner(L.select(["l_orderkey", "l_suppkey", "l_extendedprice",
                              "l_discount"]), co, "l_orderkey", "o_orderkey")
        j = inner(lco, s, ["l_suppkey", "c_nationkey"],
                  ["s_suppkey", "s_nationkey"])
        j = j.append_column("rev", _revenue(j))
        g = j.group_by(["n_name"]).aggregate([("rev", "sum")]) \
            .sort_by([("rev_sum", "descending")])
        return pa.table({"n_name": g["n_name"], "revenue": g["rev_sum"]})
    if name == "q6":
        li = L.filter(pc.and_(pc.and_(
            pc.greater_equal(L["l_shipdate"], _date(1994, 1, 1)),
            pc.less(L["l_shipdate"], _date(1995, 1, 1))), pc.and_(
            _between(L["l_discount"], 0.05, 0.07),
            pc.less(L["l_quantity"], 24.0))))
        return pa.table({"revenue": [pc.sum(pc.multiply(
            li["l_extendedprice"], li["l_discount"])).as_py()]})
    if name == "q10":
        o = O.filter(pc.and_(
            pc.greater_equal(O["o_orderdate"], _date(1993, 10, 1)),
            pc.less(O["o_orderdate"], _date(1994, 1, 1)))) \
            .select(["o_orderkey", "o_custkey"])
        li = L.filter(pc.equal(L["l_returnflag"], "R")).select(
            ["l_orderkey", "l_extendedprice", "l_discount"])
        j = inner(li, o, "l_orderkey", "o_orderkey")
        j = j.append_column("rev", _revenue(j))
        g = j.group_by(["o_custkey"]).aggregate([("rev", "sum")])
        c = inner(C.select(["c_custkey", "c_name", "c_acctbal", "c_phone",
                            "c_nationkey", "c_address", "c_comment"]),
                  t["nation"].select(["n_nationkey", "n_name"]),
                  "c_nationkey", "n_nationkey")
        g = inner(g, c, "o_custkey", "c_custkey").sort_by(
            [("rev_sum", "descending"), ("o_custkey", "ascending")]) \
            .slice(0, 20)
        return pa.table({"c_custkey": g["o_custkey"], "c_name": g["c_name"],
                         "revenue": g["rev_sum"],
                         "c_acctbal": g["c_acctbal"], "n_name": g["n_name"],
                         "c_address": g["c_address"],
                         "c_phone": g["c_phone"],
                         "c_comment": g["c_comment"]})
    if name == "q12":
        li = L.filter(pc.and_(pc.and_(
            pc.is_in(L["l_shipmode"], pa.array(["MAIL", "SHIP"])),
            pc.less(L["l_commitdate"], L["l_receiptdate"])), pc.and_(
            pc.less(L["l_shipdate"], L["l_commitdate"]), pc.and_(
                pc.greater_equal(L["l_receiptdate"], _date(1994, 1, 1)),
                pc.less(L["l_receiptdate"], _date(1995, 1, 1)))))) \
            .select(["l_orderkey", "l_shipmode"])
        j = inner(li, O.select(["o_orderkey", "o_orderpriority"]),
                  "l_orderkey", "o_orderkey")
        high = pc.cast(pc.is_in(j["o_orderpriority"],
                                pa.array(["1-URGENT", "2-HIGH"])), pa.int64())
        g = pa.table({"m": j["l_shipmode"], "h": high,
                      "lo": pc.subtract(1, high)}).group_by(["m"]) \
            .aggregate([("h", "sum"), ("lo", "sum")]) \
            .sort_by([("m", "ascending")])
        return pa.table({"l_shipmode": g["m"], "high_line_count": g["h_sum"],
                         "low_line_count": g["lo_sum"]})
    if name == "q14":
        li = L.filter(pc.and_(
            pc.greater_equal(L["l_shipdate"], _date(1995, 9, 1)),
            pc.less(L["l_shipdate"], _date(1995, 10, 1)))).select(
            ["l_partkey", "l_extendedprice", "l_discount"])
        j = inner(li, t["part"].select(["p_partkey", "p_type"]),
                  "l_partkey", "p_partkey")
        rev = _revenue(j)
        promo = pc.if_else(pc.starts_with(j["p_type"], "PROMO"), rev, 0.0)
        return pa.table({"promo_revenue": [
            pc.sum(promo).as_py() * 100.0 / pc.sum(rev).as_py()]})
    # q19
    li = L.filter(pc.and_(
        pc.is_in(L["l_shipmode"], pa.array(["AIR", "REG AIR"])),
        pc.equal(L["l_shipinstruct"], "DELIVER IN PERSON"))).select(
        ["l_partkey", "l_quantity", "l_extendedprice", "l_discount"])
    j = inner(li, t["part"].select(["p_partkey", "p_brand", "p_container",
                                    "p_size"]), "l_partkey", "p_partkey")
    cond = None
    for brand, cont, qlo, qhi, shi in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11,
             5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10,
             20, 10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30,
             15)):
        one = pc.and_(pc.and_(
            pc.equal(j["p_brand"], brand),
            pc.is_in(j["p_container"], pa.array(list(cont)))), pc.and_(
            _between(j["l_quantity"], float(qlo), float(qhi)),
            _between(j["p_size"], 1, shi)))
        cond = one if cond is None else pc.or_(cond, one)
    return pa.table({"revenue": [pc.sum(_revenue(j.filter(cond))).as_py()]})


def tpch_session(root: str, conf: dict):
    """A port session on cuda with the TPC-H files registered as temp
    views (``setup_from_dir``, ``create_or_replace_temp_view``); returns
    (session, the DataFrames by table)."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.bench import tpch
    s = TpuSparkSession(dict(TPCH_CONF, **conf), device="cuda")
    t = tpch.setup_from_dir(s, root)
    for n, df in t.items():
        df.create_or_replace_temp_view(n)
    return s, t


def tpch_run(name: str, root: str, sql: bool = True, views=None):
    """run(conf) -> (Arrow output, planned plan) of one TPC-H query on a
    fresh port session on cuda: its SQL text through ``session.sql``, or
    its DataFrame form.  ``views(session, tables)`` may replace views."""
    from spark_rapids_tpu_torch.bench import tpch

    def run(conf):
        s, t = tpch_session(root, conf)
        if views is not None:
            views(s, t)
        plans = []
        s.add_plan_listener(lambda r: plans.append(r.plan))
        df = s.sql(tpch.SQL_QUERIES[name]) if sql else tpch.QUERIES[name](t)
        return df.collect(), plans[-1]
    return run


def _parse_and_plan_ms(root: str, name: str):
    """Median of 5 of the parse (``session.sql``) and of the planning
    (``_plan_physical``) of one SQL text, in ms."""
    from spark_rapids_tpu_torch.bench import tpch
    s, _t = tpch_session(root, {})
    parse, plan = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        df = s.sql(tpch.SQL_QUERIES[name])
        t1 = time.perf_counter()
        s._plan_physical(df.plan)
        plan.append(time.perf_counter() - t1)
        parse.append(t1 - t0)
    return statistics.median(parse) * 1e3, statistics.median(plan) * 1e3


def _tpch_sql_queries(root: str, t: dict, sf: float, shapes, errors, total,
                      names):
    """The eight SQL texts at SF10; returns their outputs by name."""
    from spark_rapids_tpu_torch.obs import registry as obsreg
    outs = {}
    for q in TPCH_SQL:
        tag = f"tpch {q}"
        t0 = time.perf_counter()
        ref = tpch_reference(q, t)
        log(f"{tag}: pyarrow reference {ref.num_rows} rows in "
            f"{time.perf_counter() - t0:.1f} s")

        def check(out, ref=ref, tag=tag):
            rel = check_rows(tag, out, ref)
            outs[tag.split(" ")[1]] = out
            return f"match pyarrow (float max rel {rel:.3g}): " \
                f"{out.to_pylist()[:2]}"
        parse_ms, plan_ms = _parse_and_plan_ms(root, q)
        log(f"{tag}: parse {parse_ms:.2f} ms, planning {plan_ms:.2f} ms "
            f"(median of 5)")
        view = obsreg.get_registry().view()
        _etl_query(tag, tpch_run(q, root), check,
                   (TPCH_COUNTS[sf], TPCH_FALLBACKS[sf], TPCH_ROUTES[sf]),
                   shapes,
                   errors, total, names, TPCH_WARM, TPCH_SECTIONS,
                   # the whole smoke's limit: no trace
                   routes=True, trace=not WHOLE_SMOKE)
        counters = view.delta()["counters"]
        log(f"{tag}: join host syncs "
            f"{int(counters.get('join.hostSyncs', 0))}, hash rounds "
            f"{int(counters.get('join.hashRounds', 0))} (cold and warm runs)")
        _reset_counts()
        t0 = time.perf_counter()
        df_out, _plan = tpch_run(q, root, sql=False)({})
        rel = check_rows(f"{tag} DataFrame form", df_out, outs[q])
        log(f"{tag}: the DataFrame form QUERIES[{q!r}] on the card equals "
            f"the SQL text's rows (float max rel {rel:.3g}; "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms)")
    return outs


def _tpch_cache(root: str, outs: dict, sf: float, shapes, errors):
    """lineitem's q1/q6 columns cached and registered as the lineitem
    view; q1 and q6 twice each.  Returns (launches, kernel names)."""
    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.exec import cache as cache_mod
    s, t = tpch_session(root, {})
    cached = t["lineitem"].select(*CACHE_COLUMNS).cache()
    cached.create_or_replace_temp_view("lineitem")
    rel = cached.plan
    mat = []
    real = cache_mod.materialize

    def timed_materialize(relation, *args, **kw):
        t0 = time.perf_counter()
        was = relation.materialized
        real(relation, *args, **kw)
        torch.cuda.synchronize()
        if not was:
            mat.append(time.perf_counter() - t0)
    cache_mod.materialize = timed_materialize
    total, names, plans = {}, [], []
    s.add_plan_listener(lambda r: plans.append(r.plan))
    try:
        for rnd in (1, 2):
            for q in CACHE_QUERIES:
                tag = f"cache {q} #{rnd}"
                _reset_counts()
                t0 = time.perf_counter()
                with shapes:
                    out = s.sql(tpch.SQL_QUERIES[q]).collect()
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
                plan = plans[-1]
                names_ = _check_host_free(tag, plan,
                                          ("TpuInMemoryTableScanExec",))
                if not out.equals(outs[q]):
                    check_rows(tag, out, outs[q])
                    fail(f"{tag}: rows equal the uncached query's only to "
                         f"the float tolerance, not exactly")
                scan = next(n for n in _plan_nodes(plan)
                            if type(n).__name__ == "TpuInMemoryTableScanExec")
                log(f"{tag}: {out.num_rows} rows equal the uncached query's "
                    f"exactly; wall {wall * 1e3:.1f} ms; cache.decode "
                    f"{scan.metrics.extra.get('cache.decode', 0) / 1e6:.1f} "
                    f"ms; host-decoded columns "
                    f"{scan.metrics.extra['fallbackColumns']}; launches "
                    f"{launches}; fallbacks {fallbacks}; expand_stream "
                    f"launches {launches.get('decode.expand_stream', 0)}")
                detail(f"{tag} plan:\n{plan.tree_string()} ({names_})")
                key = f"{q}#{rnd}"
                _pinned(tag, launches, CACHE_COUNTS[sf], key, errors)
                _pinned(tag, fallbacks, CACHE_FALLBACKS[sf], key, errors)
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                names += [k for k in launches if k not in names]
                if rnd == 1 and q == CACHE_QUERIES[0]:
                    if rel.device_encoded is not True:
                        fail("cache: the first collect did not materialize "
                             "through the device encoder")
                    blob_bytes = sum(len(b) for b in rel.blobs)
                    log(f"cache: materialized {len(rel.blobs)} blobs of "
                        f"{blob_bytes} bytes (lineitem's "
                        f"{len(CACHE_COLUMNS)} q1/q6 columns) through the "
                        f"device encoder in {mat[0] * 1e3:.1f} ms")
        if len(mat) != 1:
            fail(f"cache: materialized {len(mat)} times, not once")
    finally:
        cache_mod.materialize = real
    return total, names


def _read_back(path: str, fmt: str) -> pa.Table:
    files = sorted(f for f in os.listdir(path) if f.endswith("." + fmt))
    if fmt == "orc":
        import pyarrow.orc as paorc
        return pa.concat_tables(paorc.ORCFile(os.path.join(path, f)).read()
                                for f in files)
    return pa.concat_tables(papq.read_table(os.path.join(path, f))
                            for f in files)


def _same_rows(tag: str, got: pa.Table, want: pa.Table, key) -> str:
    """In order when the write kept the scan's order; else as row sets."""
    if got.schema.equals(want.schema) and got.equals(want):
        return "in order"
    check_rows_unordered(tag, got, want, key)
    return "as row sets"


def _tpch_write(root: str, t: dict, outs: dict):
    """lineitem to Parquet (snappy) and orders to ORC, each read from the
    pyarrow files and encoded on the device; read back by pyarrow; q6 over
    the written lineitem."""
    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.io import orc_encode, parquet_encode
    s, tables = tpch_session(root, {})
    for fmt, name, mod, key in (
            ("parquet", "lineitem", parquet_encode,
             lambda x: x["l_orderkey"].to_numpy() * 8 +
             x["l_linenumber"].to_numpy()),
            ("orc", "orders", orc_encode,
             lambda x: x["o_orderkey"].to_numpy())):
        calls = []
        real = mod.encode_batch

        def counting(batch, *a, real=real, calls=calls, **kw):
            calls.append(int(batch.num_rows))
            return real(batch, *a, **kw)
        mod.encode_batch = counting
        out_dir = os.path.join(root, f"written-{name}")
        try:
            w = tables[name].write
            if fmt == "parquet":
                w = w.option("compression", "snappy")
            t0 = time.perf_counter()
            stats = getattr(w, fmt)(out_dir)
            wall = time.perf_counter() - t0
        finally:
            mod.encode_batch = real
        if not calls or len(calls) != stats.num_files or \
                min(calls) <= 0 or sum(calls) != t[name].num_rows:
            fail(f"write {name}: {len(calls)} encode_batch calls of "
                 f"{calls} rows for {stats.num_files} files of "
                 f"{stats.num_rows} rows")
        t1 = time.perf_counter()
        back = _read_back(out_dir, fmt)
        how = _same_rows(f"write {name}", back, t[name], key)
        log(f"write {name} ({fmt}, device encoder): {stats.num_rows} rows "
            f"in {stats.num_files} files ({len(calls)} encode_batch calls, "
            f"one per non-empty partition), {stats.num_bytes} bytes, wall "
            f"{wall * 1e3:.1f} ms = {stats.num_rows / wall:.0f} rows/s; "
            f"pyarrow reads it back equal to the table {how} (in "
            f"{time.perf_counter() - t1:.1f} s)")
        del back
    s2, _ = tpch_session(root, {})
    s2.read.parquet(os.path.join(root, "written-lineitem")) \
        .create_or_replace_temp_view("lineitem")
    q6 = s2.sql(tpch.SQL_QUERIES["q6"]).collect()
    rel = check_rows("write q6", q6, outs["q6"])
    log(f"write: q6 over the written lineitem {q6.to_pylist()} equals q6 "
        f"over the original (float rel {rel:.3g})")


def _tpch_handoff(root: str) -> None:
    """``collect_device()`` of q6's filtered lineitem (the columns q6
    reads): CUDA tensors whose rows equal ``collect()``."""
    from spark_rapids_tpu_torch.api import col, lit
    from spark_rapids_tpu_torch.columnar.batch import to_arrow_all
    import datetime
    _s, t = tpch_session(root, {})
    df = t["lineitem"].select(
        "l_shipdate", "l_discount", "l_quantity", "l_extendedprice").filter(
        (col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
        & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
        & (col("l_discount") >= lit(0.05)) & (col("l_discount") <= lit(0.07))
        & (col("l_quantity") < lit(24.0)))
    t0 = time.perf_counter()
    batches = df.collect_device()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    devs = {a.device.type for b in batches for c in b.columns
            for a in (c.data, c.validity, c.lengths) if a is not None}
    if not batches or devs != {HANDOFF_DEVICE}:
        fail(f"handoff: {len(batches)} batches on {devs}")
    got = pa.concat_tables(to_arrow_all(batches))
    want = df.collect()
    if not got.equals(want):
        fail("handoff: the device batches' rows differ from collect()")
    log(f"handoff: collect_device() gave {len(batches)} batches on "
        f"{sorted(devs)} in {wall * 1e3:.1f} ms; their {got.num_rows} rows "
        f"equal collect()'s")


def phase_tpch(root: str, t: dict, sf: float):
    """TPC-H at SF10 (SF 2 in the whole smoke) through ``session.sql``
    over temp views on port sessions on cuda, over the Parquet files
    under ``root``: the eight SQL texts (plan, pyarrow reference, the
    DataFrame form, pinned launches, fallbacks and routes, parse and
    planning time, cold and warm walls with sections, a trace, peak
    memory), then the cache, the writers and the device handoff.
    Returns ((launches, classes, names) of the SQL queries, the same of
    the cached ones)."""
    errors, total, names = [], {}, []
    shapes = ShapeRecorder()
    outs = _tpch_sql_queries(root, t, sf, shapes, errors, total, names)
    cache_shapes = ShapeRecorder()
    c_total, c_names = _tpch_cache(root, outs, sf, cache_shapes, errors)
    _tpch_handoff(root)
    _tpch_write(root, t, outs)
    if errors:
        fail("; ".join(errors))
    return (total, shapes.classes, names), \
        (c_total, cache_shapes.classes, c_names)


# ---------------------------------------------------------------------------
# 8i. TPC-H from ORC and pipe-delimited text; 8j. the out-of-core joins
# ---------------------------------------------------------------------------

# Hive's orc.dictionary.key.threshold: a string column with at most 80%
# distinct values is written DICTIONARY_V2 (pyarrow's default of 0 writes
# every string DIRECT_V2)
ORC_DICT_THRESHOLD = 0.8
# the tables the CSV queries read: q2, q11 and q16 (whose tables hold no
# date) and q6's lineitem, whose dates send each file to the host
CSV_TABLES = ("region", "nation", "supplier", "part", "partsupp",
              "lineitem")
CSV_QUERIES = ("q2", "q11", "q16", "q6")
CSV_ORC_WARM = 1
CSV_ORC_SECTIONS = TPCH_SECTIONS + ("scan.decode", "scan.orcHost",
                                    "scan.csvDecode")
# launches, kernel fallbacks and join routes of each query at each scale,
# pinned from the first run on the H100
_GSS, _SSS = "segreduce.gather_seg_scan", "segreduce.seg_scan_sorted"
# only the aggregates launch: the ORC and CSV decodes are torch ops.  q6's
# count follows its batches (32 stripes at SF10, 8 at SF 2); the CSV scans
# give one batch per file, 8 files at both scales.  Since PR 21 a shuffled
# join makes one pair, and the aggregate above it one batch, per spec of
# its adaptive readers (partitions under the 64 MiB advisory size
# coalesce, more of them at SF 2): the routes of q3, q5, q10 and q14 from
# ORC and q2, q11 and q16 from text, and q14's (SF 2) and q11's (SF10)
# counts, were re-pinned
ORC_COUNTS = {sf: {"q1": {_GSS: 56, _SSS: 4}, "q3": {_GSS: 16},
                   "q5": {_GSS: 8}, "q6": {_GSS: q6}, "q10": {_GSS: 16},
                   "q12": {_GSS: 8}, "q14": {_GSS: q14}, "q19": {_GSS: 18}}
              for sf, q6, q14 in ((10.0, 66, 36), (2.0, 18, 20))}
ORC_FALLBACKS = {sf: {q: {} for q in TPCH_SQL} for sf in (10.0, 2.0)}
ORC_ROUTES = {sf: {"q1": _NO_JOIN, "q6": _NO_JOIN,
                   "q3": {"join.route.probe": 0, "join.route.sort": q3},
                   "q5": {"join.route.probe": 0, "join.route.sort": q5},
                   "q10": {"join.route.probe": 0, "join.route.sort": q10},
                   "q12": {"join.route.probe": 0, "join.route.sort": 8},
                   "q14": {"join.route.probe": 0, "join.route.sort": q14},
                   "q19": {"join.route.probe": 0, "join.route.sort": 8}}
              for sf, q3, q5, q10, q14 in ((10.0, 12, 36, 24, 8),
                                           (2.0, 10, 33, 18, 4))}
CSV_COUNTS = {sf: {"q2": {_GSS: 24}, "q11": {_GSS: q11}, "q16": {_SSS: 8},
                   "q6": {_GSS: 18}} for sf, q11 in ((10.0, 24), (2.0, 34))}
CSV_FALLBACKS = {sf: {q: {} for q in CSV_QUERIES} for sf in (10.0, 2.0)}
CSV_ROUTES = {sf: {"q2": {"join.route.probe": 0, "join.route.sort": q2},
                   "q11": {"join.route.probe": 0, "join.route.sort": q11},
                   "q16": {"join.route.probe": 0, "join.route.sort": q16},
                   "q6": _NO_JOIN}
              for sf, q2, q11, q16 in ((10.0, 27, 14, 10), (2.0, 52, 32, 9))}
# the scans' fallbackColumns / fallbackFiles of each query (ORC: the
# columns of each stripe the device decode does not cover: at SF10
# o_orderkey passes 2^24 and its DIRECT runs go to Arrow, in each of the
# 15 orders stripes q3, q5, q10 and q12 read; CSV: q6's lineitem files,
# each sent to the host whole by its date columns)
ORC_SCAN_FALLBACKS = {
    10.0: dict({q: (0, 0) for q in TPCH_SQL},
               **{q: (15, 0) for q in ("q3", "q5", "q10", "q12")}),
    2.0: {q: (0, 0) for q in TPCH_SQL}}
CSV_SCAN_FALLBACKS = {sf: {"q2": (0, 0), "q11": (0, 0), "q16": (0, 0),
                           "q6": (0, STAR_FILES)} for sf in (10.0, 2.0)}


def write_orc_csv_files(root: str, t: dict) -> None:
    """Every TPC-H table as ORC (RLEv2, ZLIB, Hive's dictionary threshold)
    under ``root/orc/<table>/`` and ``CSV_TABLES`` as pipe-delimited text
    with a header and no trailing delimiter under ``root/csv/<table>/``:
    STAR_FILES files for each table of more than 2^20 rows, one for the
    others, written by 8 threads."""
    import pyarrow.csv as pacsv
    import pyarrow.orc as paorc
    from concurrent.futures import ThreadPoolExecutor
    jobs = []
    for fmt, names in (("orc", list(t)), ("csv", CSV_TABLES)):
        for name in names:
            table = t[name]
            d = os.path.join(root, fmt, name)
            os.makedirs(d)
            n = STAR_FILES if table.num_rows > STRINGS_SPLIT_ROWS else 1
            step = -(-table.num_rows // n)
            jobs += [(fmt, table.slice(i * step, step),
                      os.path.join(d, f"part-{i:04d}.{fmt}"))
                     for i in range(n)]

    def write(job):
        fmt, part, path = job
        if fmt == "orc":
            paorc.write_table(part, path, compression="zlib",
                              dictionary_key_size_threshold=
                              ORC_DICT_THRESHOLD)
        else:
            pacsv.write_csv(part, path, pacsv.WriteOptions(
                delimiter="|", quoting_style="none"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, jobs))
    sizes = {fmt: sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(os.path.join(root, fmt))
                      for f in fs) for fmt in ("orc", "csv")}
    log(f"csv-orc files: {len(jobs)} files in "
        f"{time.perf_counter() - t0:.1f} s; ORC {sizes['orc'] / 2**30:.2f} "
        f"GiB, pipe-delimited {sizes['csv'] / 2**30:.2f} GiB")


def _q2_reference(t: dict) -> pa.Table:
    inner = partial(pa.Table.join, join_type="inner")
    r = t["region"].filter(pc.equal(t["region"]["r_name"], "EUROPE"))
    n = inner(t["nation"], r.select(["r_regionkey"]), "n_regionkey",
              "r_regionkey")
    s = inner(t["supplier"], n.select(["n_nationkey", "n_name"]),
              "s_nationkey", "n_nationkey")
    eu = inner(t["partsupp"], s, "ps_suppkey", "s_suppkey")
    mc = eu.group_by("ps_partkey").aggregate([("ps_supplycost", "min")])
    p = t["part"]
    p = p.filter(pc.and_(pc.equal(p["p_size"], 15),
                         pc.ends_with(p["p_type"], "BRASS")))
    j = inner(eu, p.select(["p_partkey", "p_mfgr"]), "ps_partkey",
              "p_partkey")
    j = inner(j, mc, ["ps_partkey", "ps_supplycost"],
              ["ps_partkey", "ps_supplycost_min"])
    j = j.sort_by([("s_acctbal", "descending"), ("n_name", "ascending"),
                   ("s_name", "ascending"), ("ps_partkey", "ascending")])
    j = j.slice(0, 100)
    return pa.table({
        "s_acctbal": j["s_acctbal"], "s_name": j["s_name"],
        "n_name": j["n_name"], "p_partkey": j["ps_partkey"],
        "p_mfgr": j["p_mfgr"], "s_address": j["s_address"],
        "s_phone": j["s_phone"], "s_comment": j["s_comment"]})


def _q11_reference(t: dict) -> pa.Table:
    inner = partial(pa.Table.join, join_type="inner")
    n = t["nation"].filter(pc.equal(t["nation"]["n_name"], "GERMANY"))
    s = inner(t["supplier"].select(["s_suppkey", "s_nationkey"]),
              n.select(["n_nationkey"]), "s_nationkey", "n_nationkey")
    de = inner(t["partsupp"], s, "ps_suppkey", "s_suppkey")
    v = pc.multiply(de["ps_supplycost"], pc.cast(de["ps_availqty"],
                                                 pa.float64()))
    threshold = pc.sum(v).as_py() * 0.0001
    g = pa.table({"ps_partkey": de["ps_partkey"], "value": v}) \
        .group_by("ps_partkey").aggregate([("value", "sum")])
    g = g.filter(pc.greater(g["value_sum"], threshold))
    g = g.sort_by([("value_sum", "descending"), ("ps_partkey", "ascending")])
    return pa.table({"ps_partkey": g["ps_partkey"], "value": g["value_sum"]})


def _q16_reference(t: dict) -> pa.Table:
    s = t["supplier"]
    bad = s.filter(pc.match_like(s["s_comment"], "%Customer%Complaints%"))
    ps = t["partsupp"].join(bad.select(["s_suppkey"]), "ps_suppkey",
                            "s_suppkey", join_type="left anti")
    p = t["part"]
    p = p.filter(pc.and_(pc.and_(
        pc.not_equal(p["p_brand"], "Brand#45"),
        pc.invert(pc.starts_with(p["p_type"], "MEDIUM POLISHED"))),
        pc.is_in(p["p_size"], pa.array([49, 14, 23, 45, 19, 3, 36, 9],
                                       pa.int32()))))
    j = ps.join(p.select(["p_partkey", "p_brand", "p_type", "p_size"]),
                "ps_partkey", "p_partkey", join_type="inner")
    d = j.select(["p_brand", "p_type", "p_size", "ps_suppkey"]) \
        .group_by(["p_brand", "p_type", "p_size", "ps_suppkey"]) \
        .aggregate([])
    g = d.group_by(["p_brand", "p_type", "p_size"]).aggregate(
        [("ps_suppkey", "count")])
    g = g.sort_by([("ps_suppkey_count", "descending"),
                   ("p_brand", "ascending"), ("p_type", "ascending"),
                   ("p_size", "ascending")])
    return pa.table({"p_brand": g["p_brand"], "p_type": g["p_type"],
                     "p_size": g["p_size"],
                     "supplier_cnt": g["ps_suppkey_count"]})


def csv_orc_reference(name: str, t: dict) -> pa.Table:
    """pyarrow's result of a CSV-form query (q2, q11, q16: DataFrame
    forms) or of an SQL text (tpch_reference)."""
    refs = {"q2": _q2_reference, "q11": _q11_reference,
            "q16": _q16_reference}
    return refs[name](t) if name in refs else tpch_reference(name, t)


def orc_csv_run(name: str, root: str, fmt: str, scan_fallbacks: list):
    """run(conf) -> (Arrow output, planned plan) of one TPC-H query on a
    fresh port session on cuda: over ORC, its SQL text through
    ``session.sql`` over views from ``read.orc``; over CSV, its DataFrame
    form over ``read.csv(sep="|")``.  Each run's scan fallback counters
    (:func:`_scan_fallbacks`) land in ``scan_fallbacks`` (not the plan:
    a kept plan keeps its exchanges' device memory)."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.bench import tpch

    def run(conf):
        s = TpuSparkSession(dict(TPCH_CONF, **conf), device="cuda")
        seen = []
        s.add_plan_listener(lambda r: seen.append(r.plan))
        if fmt == "orc":
            for n in tpch.TPCH_TABLES:
                s.read.orc(os.path.join(root, "orc", n)) \
                    .create_or_replace_temp_view(n)
            df = s.sql(tpch.SQL_QUERIES[name])
        else:
            t = {n: s.read.csv(os.path.join(root, "csv", n), sep="|")
                 for n in CSV_TABLES}
            df = tpch.QUERIES[name](t)
        out = df.collect()
        scan_fallbacks.append(_scan_fallbacks(seen[-1]))
        return out, seen[-1]
    return run


def _scan_fallbacks(plan) -> tuple:
    """(fallbackColumns, fallbackFiles) summed over the plan's ORC and CSV
    scans."""
    cols = files = 0
    for n in _plan_nodes(plan):
        if type(n).__name__ in ("TpuOrcScanExec", "TpuCsvScanExec"):
            cols += int(n.metrics.extra.get("fallbackColumns", 0))
            files += int(n.metrics.extra.get("fallbackFiles", 0))
    return cols, files


def _q11_empty(tag: str, out: pa.Table, root: str, t: dict) -> str:
    """q11 keeps the parts whose value passes 0.0001 of Germany's total,
    the fraction TPC-H sets for SF 1 (the spec scales it by 1/SF), so at
    SF 2 and 10 no part passes, in pyarrow either.  The output must be
    empty too, and the total it was held to must equal pyarrow's."""
    from spark_rapids_tpu_torch.api import TpuSparkSession, col, lit
    from spark_rapids_tpu_torch.api import functions as F
    if out.num_rows:
        fail(f"{tag}: {out.num_rows} rows where pyarrow has none")
    s = TpuSparkSession(TPCH_CONF, device="cuda")
    r = {n: s.read.csv(os.path.join(root, "csv", n), sep="|")
         for n in ("partsupp", "supplier", "nation")}
    total = (r["partsupp"]
             .join(r["supplier"], col("ps_suppkey") == col("s_suppkey"))
             .join(r["nation"].filter(col("n_name") == lit("GERMANY")),
                   col("s_nationkey") == col("n_nationkey"))
             .agg(F.sum(col("ps_supplycost") * col("ps_availqty"))
                  .alias("total")).collect()["total"][0].as_py())
    n = t["nation"].filter(pc.equal(t["nation"]["n_name"], "GERMANY"))
    s_ = t["supplier"].join(n.select(["n_nationkey"]), "s_nationkey",
                            "n_nationkey", join_type="inner")
    de = t["partsupp"].join(s_.select(["s_suppkey"]), "ps_suppkey",
                            "s_suppkey", join_type="inner")
    want = pc.sum(pc.multiply(de["ps_supplycost"], pc.cast(
        de["ps_availqty"], pa.float64()))).as_py()
    if abs(total - want) > 1e-9 * abs(want):
        fail(f"{tag}: Germany's total {total!r} != pyarrow's {want!r}")
    return (f"empty, as pyarrow's (no part passes 0.0001 of Germany's "
            f"total {total:.6g}, which equals pyarrow's)")


def _catalog_empty(tag: str) -> None:
    from spark_rapids_tpu_torch.mem import spill
    left = spill.get_catalog().num_buffers()
    if left:
        fail(f"{tag}: the spill catalog still holds {left} buffers")


def phase_csv_orc(root: str, t: dict, sf: float):
    """TPC-H from ORC (the eight SQL texts over ``read.orc`` views) and
    from pipe-delimited text (q2, q11 and q16's DataFrame forms, and q6,
    whose lineitem files fall back whole) on port sessions on cuda: plan
    (TpuOrcScanExec / TpuCsvScanExec and no other host node), rows
    against pyarrow, the scans' fallback counters, pinned launches,
    fallbacks and routes, cold and warm walls with the decode sections,
    a trace and peak memory; the catalog holds no buffer after each.
    Returns (launches, classes, names)."""
    errors, total, names = [], {}, []
    shapes = ShapeRecorder()
    write_orc_csv_files(root, t)
    for fmt, queries, pins, scan_pins in (
            ("orc", TPCH_SQL,
             (ORC_COUNTS[sf], ORC_FALLBACKS[sf], ORC_ROUTES[sf]),
             ORC_SCAN_FALLBACKS[sf]),
            ("csv", CSV_QUERIES,
             (CSV_COUNTS[sf], CSV_FALLBACKS[sf], CSV_ROUTES[sf]),
             CSV_SCAN_FALLBACKS[sf])):
        scan = "TpuOrcScanExec" if fmt == "orc" else "TpuCsvScanExec"
        for q in queries:
            tag = f"{fmt} {q}"
            ref = csv_orc_reference(q, t)

            def check(out, ref=ref, tag=tag, q=q):
                if q == "q11" and ref.num_rows == 0:
                    return _q11_empty(tag, out, root, t)
                rel = check_rows(tag, out, ref)
                return f"match pyarrow (float max rel {rel:.3g}): " \
                    f"{out.to_pylist()[:1]}"
            fbs = []
            # the whole smoke's limit: the warm run and the trace only
            # when run alone
            _etl_query(tag, orc_csv_run(q, root, fmt, fbs), check, pins,
                       shapes, errors, total, names,
                       0 if WHOLE_SMOKE else CSV_ORC_WARM,
                       CSV_ORC_SECTIONS, must=(scan,), routes=True,
                       trace=not WHOLE_SMOKE)
            fb = fbs[0]
            log(f"{tag}: fallbackColumns {fb[0]}, fallbackFiles {fb[1]} "
                f"(cold run)")
            _pinned(tag, fb, scan_pins, q, errors)
            _catalog_empty(tag)
    if errors:
        fail("; ".join(errors))
    return total, shapes.classes, names


OOCORE_QUERIES = ("q3", "q10")
# below every exchange partition's build side at SF 2 and SF10 (tens of
# MiB at 2^20-row capacity): each join partition takes the grace join
OOCORE_BUDGET = 8 << 20
OOCORE_CONF = {
    "spark.rapids.tpu.sql.join.buildSideBudgetBytes": OOCORE_BUDGET,
    "spark.rapids.tpu.memory.device.batchStorageSize": 256 << 20,
    # smaller than the parked partitions of one join: some reach disk
    "spark.rapids.tpu.memory.host.spillStorageSize": 64 << 20}
SPILL_COUNTERS = ("spill.deviceToHostBytes", "spill.hostToDiskBytes")
GRACE_COUNTERS = ("join.grace.activations", "join.grace.partitions",
                  "join.grace.restreams", "join.grace.fallbacks",
                  "join.grace.spilledBuildBytes")


def _oom_recovery() -> None:
    """Two 1 GiB batches registered on the card, then an allocation
    larger than the card: the real ``torch.cuda.OutOfMemoryError`` goes to
    ``hbm_oom_recover``, which must spill the whole device tier; the
    batches come back equal and the catalog ends empty."""
    from spark_rapids_tpu_torch import dtypes as tdt
    from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch,
                                                       DeviceColumn)
    from spark_rapids_tpu_torch.mem import spill
    from spark_rapids_tpu_torch.obs import registry as obsreg
    cat = spill.init_catalog(4 << 30, 8 << 30, device="cuda")
    n = 1 << 27

    def batch(k):
        return DeviceBatch(["v"], [DeviceColumn(
            tdt.INT64, torch.arange(n, dtype=torch.int64, device="cuda") * k,
            torch.ones(n, dtype=torch.bool, device="cuda"))], n)
    handles = [cat.register(batch(k)) for k in (1, 2)]
    held = cat.device_bytes
    retries = obsreg.get_registry().counter("mem.oomRetries")
    _free, total = torch.cuda.mem_get_info()
    try:
        torch.empty(2 * total, dtype=torch.uint8, device="cuda")
        fail("oocore: an allocation of twice the card did not fail")
    except torch.cuda.OutOfMemoryError as e:
        t0 = time.perf_counter()
        ok = spill.hbm_oom_recover(e)
        ms = (time.perf_counter() - t0) * 1e3
        err = str(e).splitlines()[0][:100]
    if not ok or cat.device_bytes != 0 or \
            any(h.tier != spill.StorageTier.HOST for h in handles):
        fail(f"oocore: hbm_oom_recover gave {ok}, device tier "
             f"{cat.device_bytes} B")
    if obsreg.get_registry().counter("mem.oomRetries") != retries + 1:
        fail("oocore: mem.oomRetries did not count the recovery")
    for k, h in zip((1, 2), handles):
        v = h.get().columns[0].data
        if not torch.equal(v, torch.arange(n, dtype=torch.int64,
                                           device="cuda") * k):
            fail("oocore: a recovered batch came back different")
        h.close()
    _catalog_empty("oocore oom")
    log(f"oocore: a real CUDA OOM ({err}) with {held / 2**30:.2f} GiB "
        f"registered: hbm_oom_recover freed {cat.spilled_device_bytes} B "
        f"(the whole device tier) in {ms:.1f} ms; host arena peak "
        f"{cat.host_arena.peak / 2**30:.2f} GiB; both batches came back "
        f"equal")


def phase_oocore(root: str, t: dict, sf: float):
    """q3 and q10 (the lineitem/orders shuffled joins) over the tpch
    phase's Parquet files, at the reference's defaults (no grace join on
    an 80 GB card) and under ``OOCORE_CONF`` (every join partition's build
    side over budget, parked partitions through the host tier to disk):
    the same rows as the unconstrained run and pyarrow, the grace and
    spill counters, the arena's peak, each wall against the unconstrained
    one; then a real CUDA OOM through ``hbm_oom_recover``.  Returns
    (launches, classes, names) of the constrained runs."""
    from spark_rapids_tpu_torch.mem import spill
    from spark_rapids_tpu_torch.obs import registry as obsreg
    reg = obsreg.get_registry()
    spill_dir = _parquet_dir("spill")
    total, names = {}, []
    shapes = ShapeRecorder()
    try:
        # the whole smoke's limit: q3 there, q10 too when run alone
        for q in OOCORE_QUERIES[:1] if WHOLE_SMOKE else OOCORE_QUERIES:
            ref = tpch_reference(q, t)
            run = tpch_run(q, root)
            outs, walls = {}, {}
            for form, conf in (("default", {}), ("grace", dict(
                    OOCORE_CONF, **{"spark.rapids.tpu.memory.spill.dir":
                                    spill_dir}))):
                tag = f"oocore {q} {form}"
                view = reg.view()
                _reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with shapes if form == "grace" else contextlib.nullcontext():
                    out, plan = run(conf)
                    torch.cuda.synchronize()
                cold = time.perf_counter() - t0
                launches = dict(kb.launches)
                c = view.delta()["counters"]
                gauges = reg.snapshot()["gauges"]
                check_rows(tag, out, ref)
                _catalog_empty(tag)
                grace = {k: int(c.get(k, 0)) for k in GRACE_COUNTERS}
                spilled = {k: int(c.get(k, 0)) for k in SPILL_COUNTERS}
                arena_peak = spill.get_catalog().arena_peak
                peak = torch.cuda.max_memory_allocated() / 2**30
                # the whole smoke's limit: its walls are the cold ones
                warm = cold
                if not WHOLE_SMOKE:
                    t0 = time.perf_counter()
                    run(conf)
                    torch.cuda.synchronize()
                    warm = time.perf_counter() - t0
                walls[form] = (cold, warm)
                outs[form] = out
                depth = f"; deepest recursion so far " \
                    f"{gauges.get('join.grace.maxRecursionDepth', 0)}" \
                    if form == "grace" else ""
                log(f"{tag}: {out.num_rows} rows match pyarrow; cold "
                    f"{cold * 1e3:.1f} ms, warm {walls[form][1] * 1e3:.1f} "
                    f"ms; grace {grace}{depth}; "
                    f"spilled {spilled} (cold run); host arena peak "
                    f"{arena_peak / 2**20:.1f}"
                    f" MiB; peak device memory {peak:.2f} GiB; launches "
                    f"{launches}")
                if form == "default" and grace["join.grace.activations"]:
                    fail(f"{tag}: the grace join activated at the defaults")
                if form == "grace":
                    if grace["join.grace.activations"] < 1 or not all(
                            spilled.values()):
                        fail(f"{tag}: no grace join through host and disk "
                             f"({grace}, {spilled})")
                    if not launches:
                        fail(f"{tag} launched no kernel")
                    for k, v in launches.items():
                        total[k] = total.get(k, 0) + v
                    names += [k for k in launches if k not in names]
            rel = check_rows(f"oocore {q} grace vs default", outs["grace"],
                             outs["default"])
            which = "cold" if WHOLE_SMOKE else "warm"
            log(f"oocore {q}: the grace rows equal the unpartitioned run's "
                f"(float max rel {rel:.3g}); {which} wall "
                f"{walls['grace'][1] * 1e3:.1f} ms against "
                f"{walls['default'][1] * 1e3:.1f} ms unpartitioned "
                f"({walls['grace'][1] / walls['default'][1]:.2f}x)")
        _oom_recovery()
        return total, shapes.classes, names
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)


OBS_RUNS = 5
# the reference's slow-query record (api/session.py::_maybe_log_slow_query)
SLOW_KEYS = {"ts_unix", "threshold_ms", "session_id", "queue_wait_s",
             "kernels_compiled", "compile_ms", "query_id", "plan_digest",
             "status", "error", "wall_s", "result_rows", "phases",
             "wall_breakdown"}
BUNDLE_FILES = ["config.json", "events.jsonl", "profile.json",
                "registry.json", "trace.json"]


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip() or f"nvidia-smi rc={smi.returncode}"


def _bundles(root: str) -> list:
    """The recorder's bundle directories (it makes ``root`` with the
    first)."""
    if not os.path.isdir(root):
        return []
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def _obs_q6(root: str, ref: pa.Table, card: str) -> None:
    """q6 through port sessions with profiling on and off, warm runs in
    turns; the last profile's checks; one traced run's Chrome trace."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.obs import profile as obsprof
    from spark_rapids_tpu_torch.obs import trace as obstrace
    conf = dict(SCAN_CONF, **{
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True})
    plans = {}
    dfs = {}
    for form, on in (("profiled", True), ("unprofiled", False)):
        s = TpuSparkSession(dict(conf, **{
            "spark.rapids.tpu.obs.profile.enabled": on}), device="cuda")
        s.add_plan_listener(
            lambda r, form=form: plans.__setitem__(form, r.plan))
        dfs[form] = bench_query(s, root)
        check_q6(dfs[form].collect(), ref)      # cold: the plan cache
    walls = {"profiled": [], "unprofiled": []}
    outs = {}
    _reset_counts()
    for i in range(OBS_RUNS):
        order = ("profiled", "unprofiled") if i % 2 == 0 else \
            ("unprofiled", "profiled")
        for form in order:
            outs[form], _wall, ev = _timed_collect(dfs[form])
            walls[form].append(ev)
    launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
    _check_launches("obs q6", launches, fallbacks, Q6P_KERNELS)
    for form, out in outs.items():
        check_q6(out, ref)
    out, ev = outs["profiled"], walls["profiled"][-1]
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"obs q6 warm walls (CUDA events, median of {OBS_RUNS} in turns): "
        f"profiled {med['profiled'] * 1e3:.1f} ms, unprofiled "
        f"{med['unprofiled'] * 1e3:.1f} ms, difference "
        f"{(med['profiled'] - med['unprofiled']) * 1e3:.1f} ms (runs ms: "
        + "; ".join(f"{k} " + ", ".join(f"{x * 1e3:.1f}" for x in v)
                    for k, v in walls.items())
        + f"); launches over the {2 * OBS_RUNS} runs {launches} [{card}]")
    # the row counts an exec left on the card as 0-d tensors: the
    # profile's assembly reads them when it reads the nodes' Metrics
    pending = sum(len(n.metrics._rows_pending)
                  for n in _plan_nodes(plans["unprofiled"]))
    log(f"obs q6: {pending} row counts left on the card per query, read "
        f"by the profile's assembly after the download [{card}]")
    s = dfs["profiled"].session
    prof = s.last_query_profile()
    if prof is None or prof.status != "success" or \
            prof.result_rows != out.num_rows:
        fail(f"obs q6: last profile {prof and prof.status}, rows "
             f"{prof and prof.result_rows} != {out.num_rows}")
    missing = [sec for sec in obsprof.SECTIONS if sec not in prof.metrics]
    if missing:
        fail(f"obs q6: profile sections missing: {missing}")
    names = [n.simple_string() for n in _plan_nodes(plans["profiled"])]
    got = [n.name for n in prof.plan.walk()]
    if got != names:
        fail(f"obs q6: profile tree {got} != executed plan {names}")
    wall = prof.wall_ns / 1e9
    # the breakdown keeps the reference's sums: host prep and upload over
    # the scan's prefetch threads, the exec times over the task threads,
    # so a time may pass the wall up to that many times; the phases run
    # one after the other on the query's thread
    from spark_rapids_tpu_torch import config as cfg
    threads = max(int(s.conf.get(cfg.CONCURRENT_TPU_TASKS)),
                  int(s.conf.get(cfg.SCAN_PREFETCH_DEPTH)))
    over = {k: v for k, v in prof.wall_breakdown.items()
            if k.endswith("_s") and not 0 <= v <= wall * threads}
    phases = sum(prof.phases.values()) / 1e9
    if over or phases > wall:
        fail(f"obs q6: breakdown times outside {threads} x the wall "
             f"{wall:.4f} s: {over}; phases {phases:.4f} s")
    tree = dfs["profiled"].explain_string("profile")
    if tree != prof.tree_string() or not all(
            n in tree for n in names):
        fail("obs q6: explain_string('profile') is not the profile's tree")
    log(f"obs q6: profile #{prof.query_id} success, {prof.result_rows} "
        f"rows, {len(obsprof.SECTIONS)} sections, tree of {len(names)} "
        f"nodes in the executed plan's order; every breakdown time within "
        f"{threads} x the wall, the phases {phases * 1e3:.1f} ms within "
        f"it [{card}]")
    log(f"obs q6 breakdown (host clock, the last profiled run's wall "
        f"{wall * 1e3:.1f} ms beside its CUDA-event wall "
        f"{ev * 1e3:.1f} ms): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in
                    prof.wall_breakdown.items() if k.endswith("_s"))
        + "; phases " + ", ".join(f"{k} {v / 1e6:.1f} ms"
                                  for k, v in prof.phases.items())
        + f" [{card}]")
    detail("obs q6 explain_string('profile'):\n" + tree)
    # one traced run: its span window as a Chrome trace
    s = TpuSparkSession(dict(conf, **{
        "spark.rapids.tpu.obs.trace.enabled": True}), device="cuda")
    try:
        check_q6(bench_query(s, root).collect(), ref)
        prof = s.last_query_profile()
        path = prof.dump_chrome_trace(
            os.path.join(OUT_DIR, "obs_q6.trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        obstrace.configure(False)
        obstrace.clear()
    if not prof.spans or not events:
        fail("obs q6: the traced run's Chrome trace holds no span")
    log(f"obs q6 traced run: {len(prof.spans)} spans, a Chrome trace of "
        f"{len(events)} events that json.load reads [{card}]")


def _obs_grace(root: str, t: dict, rec_dir: str, spill_dir: str,
               card: str) -> None:
    """The oocore phase's grace q3 with the flight recorder on: the ring's
    join and spill events against the query's spill counters."""
    from spark_rapids_tpu_torch.obs import recorder as obsrec
    from spark_rapids_tpu_torch.obs import registry as obsreg
    ref = tpch_reference("q3", t)
    view = obsreg.get_registry().view()
    out, _plan = tpch_run("q3", root)(dict(OOCORE_CONF, **{
        "spark.rapids.tpu.memory.spill.dir": spill_dir,
        "spark.rapids.tpu.obs.recorder.dir": rec_dir,
        # every event of the query: the ring keeps the newest maxEvents
        "spark.rapids.tpu.obs.recorder.maxEvents": 1 << 20}))
    torch.cuda.synchronize()
    delta = view.delta()["counters"]
    check_rows("obs grace q3", out, ref)
    _catalog_empty("obs grace q3")
    events = obsrec.get_recorder().events()
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    moved = sum(e["bytes"] for e in events
                if e["kind"] == "spill.deviceToHost")
    want = int(delta.get("spill.deviceToHostBytes", 0))
    if kinds.get("join.graceActivated", 0) < 1 or \
            kinds.get("spill.deviceToHost", 0) < 1:
        fail(f"obs grace q3: the ring holds {kinds}")
    if moved != want:
        fail(f"obs grace q3: spill.deviceToHost events moved {moved} B, "
             f"the query's spill.deviceToHostBytes {want} B")
    log(f"obs grace q3: {out.num_rows} rows match pyarrow; ring events "
        f"{kinds}; spill.deviceToHost events sum to {moved} B = the "
        f"query's spill.deviceToHostBytes; bundles "
        f"{len(_bundles(rec_dir))} [{card}]")


def _obs_cancel(root: str, ref: pa.Table, rec_dir: str, card: str) -> None:
    """q6 cancelled from a second thread through the token its session
    installed: a QueryCancelledError, one ``cancelled`` bundle, and q6
    right after on the same card."""
    import threading
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.sched import cancel as sched_cancel
    s = TpuSparkSession(dict(SCAN_CONF, **{
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.obs.recorder.dir": rec_dir}), device="cuda")
    df = bench_query(s, root)
    check_q6(df.collect(), ref)                  # cold: the plan cache
    before = _bundles(rec_dir)
    cancellers = []

    def cancel_soon(_result):
        # planning runs on the query's thread, under its installed token
        token = sched_cancel.current()
        timer = threading.Timer(0.02, token.cancel,
                                args=("cancelled by the obs phase",))
        cancellers.append(timer)
        timer.start()
    s.add_plan_listener(cancel_soon)
    t0 = time.perf_counter()
    try:
        df.collect()
        fail("obs cancel: q6 finished before its token fired")
    except sched_cancel.QueryCancelledError as e:
        err = str(e)
    ms = (time.perf_counter() - t0) * 1e3
    s.remove_plan_listener(cancel_soon)
    for timer in cancellers:
        timer.join(5)
    torch.cuda.synchronize()
    _catalog_empty("obs cancel")
    new = [b for b in _bundles(rec_dir) if b not in before]
    if len(new) != 1 or "-cancelled-" not in new[0]:
        fail(f"obs cancel: new bundles {new}")
    bundle = os.path.join(rec_dir, new[0])
    files = sorted(os.listdir(bundle))
    with open(os.path.join(bundle, "profile.json")) as f:
        prof = json.load(f)
    if files != BUNDLE_FILES or prof["status"] != "failure" or \
            prof["plan"] is None:
        fail(f"obs cancel: bundle {new[0]} holds {files}, status "
             f"{prof['status']}, plan {prof['plan'] is not None}")
    rel = check_q6(df.collect(), ref)
    log(f"obs cancel: q6 raised QueryCancelledError ({err}) after "
        f"{ms:.1f} ms; one bundle {new[0]} with {files}, status failure "
        f"and the plan; q6 right after matches pyarrow (max rel "
        f"{rel:.3g}) [{card}]")


def _obs_slow_log(root: str, ref: pa.Table, path: str, card: str) -> None:
    from spark_rapids_tpu_torch.api import TpuSparkSession
    s = TpuSparkSession(dict(SCAN_CONF, **{
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.obs.slowQueryMs": 1,
        "spark.rapids.tpu.obs.slowQueryPath": path}), device="cuda")
    runs = 2
    for _ in range(runs):
        check_q6(bench_query(s, root).collect(), ref)
    with open(path) as f:
        records = [json.loads(line) for line in f]
    bad = [sorted(set(r) ^ SLOW_KEYS) for r in records if set(r) != SLOW_KEYS]
    if len(records) != runs or bad:
        fail(f"obs slow log: {len(records)} records for {runs} queries, "
             f"keys off the reference's: {bad}")
    log(f"obs slow log: {len(records)} records for {runs} queries with "
        f"the reference's keys, walls "
        + ", ".join(f"{r['wall_s'] * 1e3:.1f}" for r in records)
        + f" ms [{card}]")


def phase_obs(q6_root: str, q6_ref: pa.Table, root: str, t: dict) -> None:
    """The per-query observability layer on the card: q6's profile with
    profiling on and off, the grace q3's recorder events, a cancelled q6's
    bundle and the slow-query log."""
    card = _card()
    scratch = _parquet_dir("obs")
    try:
        _obs_q6(q6_root, q6_ref, card)
        _obs_grace(root, t, os.path.join(scratch, "grace-recorder"),
                   os.path.join(scratch, "spill"), card)
        _obs_cancel(q6_root, q6_ref, os.path.join(scratch, "recorder"),
                    card)
        _obs_slow_log(q6_root, q6_ref, os.path.join(scratch, "slow.jsonl"),
                      card)
    finally:
        from spark_rapids_tpu_torch.obs import recorder as obsrec
        obsrec.disable()
        shutil.rmtree(scratch, ignore_errors=True)


# the sched phase: four q6 literals under two query slots, the deadline
# of TPC-H q10 (fires while q10 runs on the card: its warm SF 2 wall is
# seconds) and the turns of the service's cost
SCHED_PRICES = (150.0, 140.0, 130.0, 120.0)
SCHED_SLOTS = 2
SCHED_DEADLINE_MS = 1000
SCHED_TURNS = 6
SCHED_MEM_SLACK = 64 << 20


def _scrape(port: int, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def _tenant_sums(snap: dict, metrics) -> dict:
    return {m: sum(r["usage"].get(m, 0.0) for r in snap["tenants"])
            for m in metrics}


def _spilled() -> float:
    from spark_rapids_tpu_torch.obs import registry as obsreg
    return obsreg.get_registry().counter("spill.deviceToHostBytes")


def _sched_table_sig(s, table: pa.Table, card: str) -> None:
    """The digest's walk of an in-memory q6 (plan/digest.py::_table_sig):
    the whole SF10 table is keyed by identity (over 64 MiB), a 2^21-row
    slice by the SHA-1 of its Arrow IPC stream, once per table object."""
    from spark_rapids_tpu_torch.api import col, functions as F
    from spark_rapids_tpu_torch.plan.digest import plan_fingerprint
    parts = []
    for tag, t in (("whole", table),
                   ("2^21 rows", table.slice(0, 1 << 21).combine_chunks())):
        plan = (s.create_dataframe(t).filter(col("ss_sales_price") > 150.0)
                .group_by("ss_item_sk").agg(F.count("*").alias("cnt"))).plan
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            fp = plan_fingerprint(plan)
            ms.append((time.perf_counter() - t0) * 1e3)
        parts.append(f"{tag} ({t.nbytes} B, cacheable {fp.cacheable}) "
                     f"first {ms[0]:.3f} ms, again {ms[1]:.3f} ms")
    log("sched digest walk of the in-memory q6: " + "; ".join(parts)
        + f" [{card}]")


def _sched_concurrency(s, root: str, card: str):
    """Four warm q6 literals, serial then all submitted at once under two
    slots, with /queries scraped throughout: each result equals its
    serial run bit for bit and pyarrow; one waited in the queue; /tenants
    bills four digest tenants; the ledger's window equals the counters'.
    Returns the futures."""
    import threading
    from spark_rapids_tpu_torch.obs import registry as obsreg
    from spark_rapids_tpu_torch.plan.digest import plan_digest
    port = s.obs_server.port
    table = papq.read_table(root, columns=Q6PF_COLUMNS)
    dfs = [bench_query(s, root, p) for p in SCHED_PRICES]
    serial = []
    spill0 = _spilled()
    for p, df in zip(SCHED_PRICES, dfs):
        out = df.collect().sort_by("ss_item_sk")
        check_q6(out, q6_reference(table, p))
        serial.append(out)
    spill1 = _spilled()
    _sched_table_sig(s, table, card)
    del table
    # the admission estimate each literal now gets (refined from the
    # serial runs' high water) and the pressure spill it may trigger
    estimate = s.scheduler._estimate(dfs[0].plan, None)
    pressure0 = obsreg.get_registry().counter("sched.pressureSpillBytes")
    metrics = ("kernel.dispatches", "sched.queueWaitNs")
    reg = obsreg.get_registry()
    before = _tenant_sums(json.loads(_scrape(port, "/tenants")[1]), metrics)
    counters = {m: reg.counter(m) for m in metrics}
    states, stop = set(), threading.Event()

    def watch():
        while not stop.is_set():
            for row in json.loads(_scrape(port, "/queries")[1])["queries"]:
                states.add(row["state"])
            time.sleep(0.005)
    watcher = threading.Thread(target=watch, name="sched-watch")
    watcher.start()
    try:
        _reset_counts()
        t0 = time.perf_counter()
        futs = [df.collect_async() for df in dfs]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        spill2 = _spilled()
    finally:
        stop.set()
        watcher.join(30)
    pressure = reg.counter("sched.pressureSpillBytes") - pressure0
    ctrl_budget = s.scheduler.controller.memory_budget
    _check_launches("sched concurrency", kb.launches, kb.fallbacks,
                    Q6P_KERNELS)
    for p, a, b in zip(SCHED_PRICES, serial, outs):
        if not a.equals(b.sort_by("ss_item_sk")):
            fail(f"sched: q6 at {p} under the scheduler differs from its "
                 f"serial run")
    waits = [f.queue_wait_ns for f in futs]
    if not any(w > 0 for w in waits):
        fail(f"sched: no q6 waited for a slot ({waits} ns)")
    if not {"queued", "running", "success"} <= states:
        fail(f"sched: /queries showed the states {sorted(states)}")
    snap = json.loads(_scrape(port, "/tenants")[1])
    digests = {"digest:" + plan_digest(df.plan)[:16] for df in dfs}
    billed = {r["workload"] for r in snap["tenants"]
              if r["session_id"] == "(in-process)"}
    if len(digests) != 4 or not digests <= billed:
        fail(f"sched: /tenants bills {sorted(billed)}, not the four "
             f"{sorted(digests)}")
    after = _tenant_sums(snap, metrics)
    for m in metrics:
        ledger = after[m] - before[m]
        counter = reg.counter(m) - counters[m]
        if counter <= 0 or abs(ledger - counter) > 1e-6 * counter:
            fail(f"sched: the tenants' {m} {ledger} != the counter's "
                 f"{counter}")
    log(f"sched concurrency: q6 at {SCHED_PRICES} under {SCHED_SLOTS} "
        f"slots in {wall * 1e3:.1f} ms, each equal to its serial run and "
        f"pyarrow; queue waits "
        + ", ".join(f"{w / 1e6:.1f}" for w in waits)
        + f" ms; estimate {estimate} B each of a {ctrl_budget} B budget; "
        f"spilled device->host {int(spill1 - spill0)} B in the serial "
        f"runs, {int(spill2 - spill1)} B under the scheduler, "
        f"{int(pressure)} B of it by the admission's pressure hook; "
        f"/queries states {sorted(states)}; four digest tenants; "
        f"ledger = counters over the window: "
        + ", ".join(f"{m} {after[m] - before[m]:.0f}" for m in metrics)
        + f" [{card}]")
    return futs


def _sched_single_flight(s, root: str, ref: pa.Table, card: str) -> None:
    from spark_rapids_tpu_torch.obs import registry as obsreg
    view = obsreg.get_registry().view()
    df = bench_query(s, root)
    a, b = df.collect_async(), df.collect_async()
    ta, tb = a.result(timeout=300), b.result(timeout=300)
    d = view.delta()["counters"]
    once = {k: d.get(k, 0) for k in ("sched.submitted", "sched.admitted",
                                      "sched.completed", "sched.dedup.hits")}
    if b.dedup_of != a.query_id or once != {
            "sched.submitted": 2, "sched.admitted": 1,
            "sched.completed": 1, "sched.dedup.hits": 1}:
        fail(f"sched single flight: follower of {b.dedup_of} (leader "
             f"{a.query_id}), counters {once}")
    if not ta.equals(tb):
        fail("sched single flight: the two futures' tables differ")
    check_q6(ta, ref)
    log(f"sched single flight: q{b.query_id} joined q{a.query_id}'s "
        f"flight: {once}, sched.dedup.flights "
        f"{int(d.get('sched.dedup.flights', 0))}; equal tables [{card}]")


def _sched_deadline(tpch_root: str, q6_root: str, ref: pa.Table,
                    card: str) -> None:
    """TPC-H q10 under a deadline that fires while it runs: TIMED_OUT,
    the slot freed, an empty spill catalog, the card's memory back; then
    q6 on the same session (the tpch phase's conf)."""
    from spark_rapids_tpu_torch.bench import tpch
    from spark_rapids_tpu_torch.sched import QueryState, QueryTimeoutError
    s, _tables = tpch_session(tpch_root, dict(SCAN_CONF, **{
        "spark.rapids.tpu.sched.maxConcurrent": SCHED_SLOTS}))
    q10 = s.sql(tpch.SQL_QUERIES["q10"])
    runs = []
    for _ in range(2):
        # twice: what the first run leaves allocated beyond the query
        # (first-call state) shows as a difference between the two
        _clear_share()
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fut = q10.collect_async(timeout_ms=SCHED_DEADLINE_MS)
        try:
            fut.result(timeout=300)
            fail("sched deadline: q10 finished inside its deadline")
        except QueryTimeoutError as e:
            err = str(e)
        ms = (time.perf_counter() - t0) * 1e3
        started = fut.profile is not None and fut.profile.plan is not None
        state = fut.state
        del fut
        # the shared-scan window may keep up to its 64 MiB of q10's scan
        # batches by design: drop them, so what is left is the query's
        _clear_share()
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        stats = s.scheduler.controller.stats()
        if state is not QueryState.TIMED_OUT or not started:
            fail(f"sched deadline: q10 ended {state}, planned {started}")
        if stats["running"] or stats["queued"] or stats["admitted_bytes"]:
            fail(f"sched deadline: the controller holds {stats}")
        _catalog_empty("sched deadline")
        if mem1 - mem0 > SCHED_MEM_SLACK:
            fail(f"sched deadline: {mem1 - mem0} B still allocated on the "
                 f"card")
        runs.append(f"TIMED_OUT after {ms:.1f} ms ({err}), "
                    f"memory_allocated {mem0} -> {mem1} B")
    rel = check_q6(bench_query(s, q6_root).collect(), ref)
    log(f"sched deadline: q10 under {SCHED_DEADLINE_MS} ms, twice: "
        + "; ".join(runs) + f"; each time the slot freed and the spill "
        f"catalog empty; q6 next matches (max rel {rel:.3g}) [{card}]")


def _sched_endpoint(s, futs, card: str) -> None:
    from spark_rapids_tpu_torch.obs.server import lint_exposition
    port = s.obs_server.port
    samples = lint_exposition(_scrape(port, "/metrics")[1])
    for name in ("sched_submitted", "sched_admitted", "sched_completed",
                 "sched_queueWaitNs", "sched_timedOut",
                 "sched_dedup_hits"):
        if f"spark_rapids_tpu_{name}" not in samples:
            fail(f"sched endpoint: /metrics has no {name}")
    rows = json.loads(_scrape(port, "/queries")[1])["queries"]
    mine = {r["query_id"]: r for r in rows}
    for f in futs:
        row = mine.get(f.query_id)
        if row is None or row["state"] != "success" or \
                not row["plan_digest"]:
            fail(f"sched endpoint: /queries row of q{f.query_id}: {row}")
    compiles = json.loads(_scrape(port, "/compiles?n=8")[1])
    prof = json.loads(_scrape(port, f"/profiles/{futs[0].query_id}")[1])
    health = json.loads(_scrape(port, "/healthz")[1])
    if prof["query_id"] != futs[0].query_id or \
            prof["plan_digest"] is None or not health["ok"] or \
            "totals" not in compiles:
        fail(f"sched endpoint: profile {prof.get('query_id')}, health "
             f"{health}, compiles keys {sorted(compiles)}")
    log(f"sched endpoint: /metrics lints ({len(samples)} samples), "
        f"/queries {len(rows)} rows, /compiles {compiles['totals']}, "
        f"/profiles/{futs[0].query_id} status {prof['status']}, /healthz "
        f"{health['state']} [{card}]")


def _sched_cost(s, root: str, ref: pa.Table, card: str) -> None:
    """Warm q6 through ``collect()`` (the service: a digest walk, a
    thread, a future) and through ``_execute_attributed`` called directly
    on this thread, in turns, CUDA events."""
    df = bench_query(s, root)
    walls = {"service": [], "direct": []}
    spill0 = _spilled()
    runs = {"service": df.collect,
            "direct": lambda: s._execute_attributed(df.plan)[0]}
    for i in range(SCHED_TURNS):
        for mode in (("service", "direct") if i % 2 == 0
                     else ("direct", "service")):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = runs[mode]()
            end.record()
            torch.cuda.synchronize()
            check_q6(out, ref)
            walls[mode].append(start.elapsed_time(end))
    med = {k: statistics.median(v) for k, v in walls.items()}
    log("sched cost: warm q6 (CUDA events, median of "
        f"{SCHED_TURNS} in turns) through the service "
        f"{med['service']:.1f} ms (runs {min(walls['service']):.1f}-"
        f"{max(walls['service']):.1f}), direct {med['direct']:.1f} ms "
        f"(runs {min(walls['direct']):.1f}-{max(walls['direct']):.1f}), "
        f"difference {med['service'] - med['direct']:.2f} ms; spilled "
        f"device->host {int(_spilled() - spill0)} B [{card}]")


def phase_sched(q6_root: str, q6_ref: pa.Table, tpch_root: str) -> None:
    """The query service on the card, with the endpoint on: four q6
    literals under two slots, a single flight, a deadline inside TPC-H
    q10, the endpoint's routes and the service's cost on the warm q6."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    card = _card()
    s = TpuSparkSession(dict(SCAN_CONF, **{
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sched.maxConcurrent": SCHED_SLOTS,
        "spark.rapids.tpu.obs.http.enabled": True}), device="cuda")
    try:
        futs = _sched_concurrency(s, q6_root, card)
        _sched_single_flight(s, q6_root, q6_ref, card)
        _sched_deadline(tpch_root, q6_root, q6_ref, card)
        _sched_endpoint(s, futs, card)
        _sched_cost(s, q6_root, q6_ref, card)
    finally:
        s.obs_server.shutdown()


# the compile phase's OOM query: one in-memory batch of this many q6 rows
COMPILE_OOM_ROWS = 1 << 24
COMPILE_OOM_CONF = {
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
    "spark.rapids.tpu.sql.test.enabled": True,
    # one partition, one batch: no concat of partials outside a dispatch
    "spark.rapids.tpu.sql.reader.batchSizeRows": COMPILE_OOM_ROWS,
    # above the registered fill and the query's partials: the budget
    # itself spills nothing
    "spark.rapids.tpu.memory.device.batchStorageSize": 16 << 30,
    "spark.rapids.tpu.memory.host.spillStorageSize": 16 << 30}
COMPILE_TURNS = 6
# the compile phase's device (a CPU rehearsal sets "cpu")
COMPILE_DEVICE = "cuda"


def _settle() -> None:
    """Free what unreachable Python objects still hold on the card, and
    the allocator's unused blocks: what an earlier phase left as cyclic
    garbage would otherwise be freed mid-query, in the middle of a
    measurement or a fill."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _take_cached_blocks() -> list:
    """Tensors holding every free block of 2 MiB or more that the caching
    allocator keeps inside segments it cannot release (a segment with a
    live tensor in it).  ``mem_get_info`` does not see those blocks, yet a
    query reuses them; a fill must take them first.  An allocation that
    grew the reserved memory came from the driver: it is freed at once,
    and the size halves."""
    held = []
    size = 1 << 30
    while size >= 2 << 20:
        before = torch.cuda.memory_reserved()
        t = torch.empty(size, dtype=torch.uint8, device=COMPILE_DEVICE)
        if torch.cuda.memory_reserved() > before:
            del t
            torch.cuda.empty_cache()
            size >>= 1
            continue
        held.append(t)
    return held


def _compile_oom(card: str) -> None:
    """A real CUDA OOM inside a query: registered batches plus a ballast
    tensor leave less free device memory than the aggregate's update
    needs, but more than the upload; the query must return the rows of a
    run without the fill after the kernel cache's spill and retry, move
    ``mem.oomRetries``, and leave the registered batches equal and the
    catalog empty.  The fill takes the allocator's unreleasable cached
    blocks first (``_take_cached_blocks``), then a ballast from what the
    driver reports free.  A run that needed no retry tightens the fill,
    up to three times."""
    from spark_rapids_tpu_torch import dtypes as tdt
    from spark_rapids_tpu_torch.api import TpuSparkSession, col
    from spark_rapids_tpu_torch.api import functions as F
    from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch,
                                                       DeviceColumn)
    from spark_rapids_tpu_torch.mem import spill
    from spark_rapids_tpu_torch.obs import registry as obsreg
    table = q6_table()[0].slice(0, COMPILE_OOM_ROWS).select(
        ["ss_item_sk", "ss_quantity", "ss_sales_price",
         "ss_ext_sales_price"])
    s = TpuSparkSession(COMPILE_OOM_CONF, device=COMPILE_DEVICE)
    df = (s.create_dataframe(table).filter(col("ss_sales_price") > 150.0)
          .group_by("ss_item_sk")
          .agg(F.count("*").alias("cnt"), F.sum("ss_quantity").alias("qty"),
               F.avg("ss_ext_sales_price").alias("aesp")))
    # the run without the fill: its rows and its device memory above the
    # baseline; the upload alone is the bare scan's batch
    _settle()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = df.collect().sort_by("ss_item_sk")
    need = torch.cuda.max_memory_allocated() - base
    check_q6(want, q6_reference(table))
    upload = sum(b.nbytes() for b in s.create_dataframe(
        table).collect_device())
    _settle()
    work = need - upload
    if work <= 0:
        fail(f"compile oom: the query needs {need} B over its upload "
             f"{upload} B")
    # registered batches: 1 GiB each, enough to cover the retry twice
    cat = spill.get_catalog()
    n = 1 << 27
    k_batches = max(2, -(-2 * need // (9 * n)))

    def batch(k):
        return DeviceBatch(["v"], [DeviceColumn(
            tdt.INT64,
            torch.arange(n, dtype=torch.int64, device=COMPILE_DEVICE) * k,
            torch.ones(n, dtype=torch.bool, device=COMPILE_DEVICE))], n)
    handles = [cat.register(batch(k)) for k in range(1, k_batches + 1)]
    registered = cat.device_bytes
    if cat.spilled_device_bytes or any(
            h.tier != spill.StorageTier.DEVICE for h in handles):
        fail("compile oom: the device budget spilled a registered batch")
    reg = obsreg.get_registry()
    for share in (2, 4, 8):
        _settle()
        cached = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
        ballast = _take_cached_blocks()
        free = torch.cuda.mem_get_info()[0]
        ballast.append(torch.empty(max(free - upload - work // share, 0),
                                   dtype=torch.uint8, device=COMPILE_DEVICE))
        free_fill = torch.cuda.mem_get_info()[0]
        view = reg.view()
        _reset_counts()
        t0 = time.perf_counter()
        out = df.collect().sort_by("ss_item_sk")     # must not raise
        wall = time.perf_counter() - t0
        d = view.delta()["counters"]
        launches = dict(kb.launches)
        del ballast
        _settle()
        if not out.equals(want):
            fail("compile oom: the query's rows under the fill differ from "
                 "the run without it")
        if d.get("mem.oomRetries", 0) >= 1:
            break
        log(f"compile oom: no OOM with {free_fill} B free (the upload "
            f"plus 1/{share} of the rest of the need; {cached} B of "
            f"unreleasable cached blocks taken first); tightening [{card}]")
    retried = {k.split(".", 2)[2]: int(v) for k, v in d.items()
               if k.startswith("kernel.oomRetries.")}
    if d.get("mem.oomRetries", 0) < 1 or not retried:
        fail(f"compile oom: no OOM retry with {free_fill} B free (the "
             f"query needs {need} B, its upload {upload} B): {d}")
    for k, h in enumerate(handles, 1):
        if h.tier == spill.StorageTier.DEVICE:
            fail("compile oom: a registered batch was not spilled")
        v = h.get().columns[0].data
        if not torch.equal(v, torch.arange(n, dtype=torch.int64,
                                           device=COMPILE_DEVICE) * k):
            fail("compile oom: a spilled batch came back different")
        h.close()
    _catalog_empty("compile oom")
    log(f"compile oom: {k_batches} registered batches "
        f"({registered / 2**30:.2f} GiB) and a ballast (first the "
        f"allocator's {cached} B of unreleasable cached blocks) left "
        f"{free_fill} B free (the upload plus 1/{share} of the rest); the "
        f"aggregate "
        f"needs {need} B over the baseline, its upload {upload} B; the "
        f"query over {COMPILE_OOM_ROWS} rows retried in {retried} "
        f"(mem.oomRetries +{int(d['mem.oomRetries'])}, spilled "
        f"{int(d.get('spill.deviceToHostBytes', 0))} B to the host) and "
        f"returned the {out.num_rows} rows of the run without the fill in "
        f"{wall * 1e3:.1f} ms; launches {launches}; the batches came back "
        f"equal and the catalog is empty [{card}]")


def _compile_counts(root: str, ref: pa.Table, card: str):
    """Cold and warm q6 over the SF10 files: the dispatch and cache
    counters, the first-call events per family, the warm run's zero
    events and the attribution identity.  Returns the DataFrame."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    from spark_rapids_tpu_torch.obs import compile as obscompile
    from spark_rapids_tpu_torch.obs import registry as obsreg
    s = TpuSparkSession(dict(SCAN_CONF, **{
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True}), device=COMPILE_DEVICE)
    df = bench_query(s, root)
    reg = obsreg.get_registry()
    kc.clear()
    obscompile.reset()
    window = reg.view()
    deltas = {}
    for run in ("cold", "warm"):
        view = reg.view()
        _reset_counts()
        out, _wall, ev = _timed_collect(df)
        check_q6(out, ref)
        _check_launches(f"compile q6 {run}", kb.launches, kb.fallbacks,
                        Q6P_KERNELS)
        d = view.delta()["counters"]
        deltas[run] = d
        shown = {k: int(v) for k, v in sorted(d.items())
                 if k.startswith(("kernel.dispatches", "kernel.cache."))}
        log(f"compile q6 {run}: {ev * 1e3:.1f} ms (CUDA events); {shown} "
            f"[{card}]")
    fams = {}
    for e in obscompile.events():
        fams.setdefault(e["family"], []).append(
            f"{e['wall_ms']:.3f} ms {e['tier']}")
    log(f"compile q6 cold first calls per family (host wall, tier): "
        f"{fams} [{card}]")
    if deltas["cold"].get("kernel.compile.events", 0) <= 0:
        fail("compile q6: the cold run recorded no first call")
    if deltas["warm"].get("kernel.compile.events", 0) or \
            deltas["warm"].get("kernel.cache.compiles", 0):
        fail(f"compile q6: the warm run recorded first calls: "
             f"{deltas['warm']}")
    for run, d in deltas.items():
        if d.get("kernel.dispatches", 0) <= 0 or \
                d.get("kernel.dispatches.agg_update.pallas", 0) <= 0:
            fail(f"compile q6 {run}: no agg_update.pallas dispatch: {d}")
    snap = obscompile.snapshot(max_events=0)
    t = snap["totals"]
    attributed = sum(r["kernels_compiled"]
                     for r in snap["per_query"].values())
    compiles = window.delta()["counters"].get("kernel.cache.compiles", 0)
    if attributed + t["unattributed_fresh"] + t["evicted_compiled"] != \
            compiles:
        fail(f"compile q6: {attributed} attributed + "
             f"{t['unattributed_fresh']} unattributed + "
             f"{t['evicted_compiled']} evicted != kernel.cache.compiles "
             f"{compiles}")
    log(f"compile q6: sum(kernels_compiled) {attributed} + unattributed "
        f"{t['unattributed_fresh']} + evicted {t['evicted_compiled']} == "
        f"kernel.cache.compiles {int(compiles)}; churn "
        f"{obscompile.churn_report()}")
    return df


def _compile_wrapper_cost(df, ref: pa.Table, card: str) -> None:
    """Warm q6 with the observatory and the ledger on and off, in turns:
    each turn clears the kernel cache so the steps are built in its mode
    (the observe wrapper is installed at build time), runs once untimed
    and once timed with CUDA events.  The garbage collector's passes
    inside the timed runs are counted and timed per mode: the wrappers
    allocate a few tuples per dispatch, and a pass over a large heap
    costs far more than the wrappers themselves."""
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    from spark_rapids_tpu_torch.obs import accounting as obsacct
    from spark_rapids_tpu_torch.obs import compile as obscompile
    walls = {"on": [], "off": []}
    gcs = {"on": [0, 0.0], "off": [0, 0.0]}
    clock = {"mode": None, "t0": 0.0}

    def on_gc(phase, info):
        if clock["mode"] is None:
            return
        if phase == "start":
            clock["t0"] = time.perf_counter()
        else:
            g = gcs[clock["mode"]]
            g[0] += 1
            g[1] += (time.perf_counter() - clock["t0"]) * 1e3
    gc.callbacks.append(on_gc)
    try:
        for i in range(COMPILE_TURNS):
            for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
                obscompile.configure(mode == "on")
                obsacct.configure(mode == "on")
                kc.clear()
                check_q6(df.collect(), ref)
                clock["mode"] = mode
                out, _wall, ev = _timed_collect(df)
                clock["mode"] = None
                check_q6(out, ref)
                walls[mode].append(ev)
    finally:
        clock["mode"] = None
        gc.callbacks.remove(on_gc)
        obscompile.configure(True)
        obsacct.configure(True)
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"compile wrappers: warm q6 (CUDA events, median of "
        f"{COMPILE_TURNS} in turns) observatory+ledger on "
        f"{med['on'] * 1e3:.1f} ms, off {med['off'] * 1e3:.1f} ms, "
        f"difference {(med['on'] - med['off']) * 1e3:.2f} ms (runs ms: "
        + "; ".join(f"{k} " + ", ".join(f"{x * 1e3:.1f}" for x in v)
                    for k, v in walls.items())
        + "); garbage-collector passes inside the timed runs: "
        + "; ".join(f"{k} {n} taking {ms:.1f} ms"
                    for k, (n, ms) in gcs.items()) + f" [{card}]")


def phase_compile(q6_root: str, q6_ref: pa.Table) -> None:
    """The kernel cache on the card: a real CUDA OOM inside a query,
    retried by the cache; cold and warm q6's dispatch, cache and
    first-call counts; the wrappers' cost on the warm q6."""
    card = _card()
    _compile_oom(card)
    df = _compile_counts(q6_root, q6_ref, card)
    _compile_wrapper_cost(df, q6_ref, card)


MODES_IO_ROWS = 1 << 18
# the join surface's self-joins on a 6-value key grow with the square of
# the rows (2^16 rows: ~180M joined rows, 101 s on a CPU session)
MODES_SQL_ROWS = 1 << 12
IO_CODECS = ("none", "snappy", "zstd")


def io_modes_table(n: int, seed: int) -> pa.Table:
    """Every encoder type with about 5% nulls: int32, int64, float32 and
    float64 (NaN and -0.0 among them), bool, date, timestamp, strings of
    byte widths 0-256 with multi-byte characters, an all-null column, a
    partition key and the row number."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.05
    f64 = rng.normal(size=n) * 1e3
    f64[rng.random(n) < 0.03] = np.nan
    f64[rng.random(n) < 0.03] = -0.0
    f32 = rng.normal(size=n).astype(np.float32)
    f32[rng.random(n) < 0.03] = np.float32(np.nan)
    f32[rng.random(n) < 0.03] = np.float32(-0.0)
    pool = _string_modes_pool(rng, 4096, 256)
    return pa.table({
        "row": pa.array(np.arange(n), pa.int64()),
        "k": pa.array(rng.integers(0, 5, n), pa.int32(), mask=nulls()),
        "i32": pa.array(rng.integers(-2**31, 2**31 - 1, n), pa.int32(),
                        mask=nulls()),
        "i64": pa.array(rng.integers(-10**15, 10**15, n), pa.int64(),
                        mask=nulls()),
        "f32": pa.array(f32, mask=nulls()),
        "f64": pa.array(f64, mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "d": pa.array(rng.integers(-30000, 30000, n), pa.int32(),
                      mask=nulls()).cast(pa.date32()),
        "s": pa.array(pool, pa.string()).take(
            pa.array(rng.integers(0, len(pool), n), mask=nulls())),
        "none": pa.array([None] * n, pa.int64()),
        "ts": pa.array(rng.integers(-2 * 10**15, 2 * 10**15, n), pa.int64(),
                       mask=nulls()).cast(pa.timestamp("us", tz="UTC")),
    })


def _qa_modes_table(n: int, seed: int) -> pa.Table:
    """tests/test_sql.py's ``qa`` columns (ik, sk, b, s, i, l, f, d, bo,
    st, dt, ts) over ``n`` rows with about 5% nulls."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.05
    small = ["".join(rng.choice(list("abcdef"), int(rng.integers(0, 4))))
             for _ in range(64)]
    pool = _string_modes_pool(rng, 2048, 24)

    def ints(lo, hi, typ):
        return pa.array(rng.integers(lo, hi, n), typ, mask=nulls())
    return pa.table({
        "ik": ints(0, 6, pa.int32()),
        "sk": pa.array(small, pa.string()).take(
            pa.array(rng.integers(0, len(small), n), mask=nulls())),
        "b": ints(-128, 128, pa.int8()), "s": ints(-2**15, 2**15, pa.int16()),
        "i": ints(-2**31, 2**31, pa.int32()),
        "l": ints(-2**62, 2**62, pa.int64()),
        "f": pa.array(rng.normal(size=n).astype(np.float32) * 100,
                      mask=nulls()),
        "d": pa.array(rng.normal(size=n) * 1e4, mask=nulls()),
        "bo": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "st": pa.array(pool, pa.string()).take(
            pa.array(rng.integers(0, len(pool), n), mask=nulls())),
        "dt": ints(0, 40000, pa.int32()).cast(pa.date32()),
        "ts": ints(0, 2 * 10**15, pa.int64()).cast(
            pa.timestamp("us", tz="UTC")),
    })


def sql_surface_queries() -> list:
    """The SELECT-surface queries of tests/test_sql.py (``_QA_SWEEP``,
    ``_QA_SWEEP2``, ``_QA_JOINS``), read from its source text."""
    import ast
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_sql.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") in ("_QA_SWEEP", "_QA_SWEEP2",
                                         "_QA_JOINS") for t in node.targets):
            out += ast.literal_eval(node.value)
    if len(out) < 100:
        fail(f"io-modes: read {len(out)} SELECT-surface queries")
    return out


def _close_floats(tag: str, got: pa.Table, want: pa.Table) -> int:
    """:func:`_bit_equal` but for float columns, which may differ in their
    last bits (the card's math functions and the segmented scan's add
    tree differ from the CPU's): those to tests/parity.py's tolerance.
    Returns the number of float columns that were not bit for bit."""
    loose = 0
    if got.column_names != want.column_names or \
            got.num_rows != want.num_rows:
        fail(f"{tag}: {got.column_names} x {got.num_rows} != "
             f"{want.column_names} x {want.num_rows}")
    for c in want.column_names:
        a, b = got[c].combine_chunks(), want[c].combine_chunks()
        if not pa.types.is_floating(b.type):
            _bit_equal_array(tag, c, a, b)
            continue
        if not a.is_valid().equals(b.is_valid()):
            fail(f"{tag}: column {c}: nulls differ")
        x = a.fill_null(0).to_numpy(zero_copy_only=False)
        y = b.fill_null(0).to_numpy(zero_copy_only=False)
        if np.array_equal(x.view(f"i{x.itemsize}"), y.view(f"i{y.itemsize}")):
            continue
        ok = np.isclose(x, y, rtol=1e-9, atol=1e-11, equal_nan=True)
        if not ok.all():
            i = int(np.flatnonzero(~ok)[0])
            fail(f"{tag}: column {c} row {i}: {x[i]!r} != {y[i]!r}")
        loose += 1
    return loose


def phase_io_modes() -> None:
    """The encoders, the cache, the partitioned write and the SQL surface
    on cuda against a port session on the CPU: the blobs byte for byte,
    pyarrow's read-back, the rows.  Untimed."""
    import io as _io
    import pyarrow.orc as paorc
    from spark_rapids_tpu_torch.api import TpuSparkSession, col
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    from spark_rapids_tpu_torch.io import orc_encode, parquet_encode
    t0 = time.perf_counter()
    table = io_modes_table(MODES_IO_ROWS, 23)
    blobs = 0
    for codec in IO_CODECS:
        got = parquet_encode.encode_batch(from_arrow(table, device="cuda"),
                                          codec=codec)
        want = parquet_encode.encode_batch(from_arrow(table, device="cpu"),
                                           codec=codec)
        if got != want:
            fail(f"io-modes: the parquet blob ({codec}) on cuda differs "
                 f"from the CPU's")
        _bit_equal(f"io-modes parquet {codec} read back",
                   papq.read_table(_io.BytesIO(got)), table)
        blobs += 1
    no_ts = table.drop(["ts"])
    got = orc_encode.encode_batch(from_arrow(no_ts, device="cuda"))
    if got != orc_encode.encode_batch(from_arrow(no_ts, device="cpu")):
        fail("io-modes: the ORC blob on cuda differs from the CPU's")
    back = paorc.ORCFile(_io.BytesIO(got)).read()
    _bit_equal("io-modes orc read back", back, no_ts.cast(back.schema))
    blobs += 1
    base = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
            "spark.rapids.tpu.sql.castStringToFloat.enabled": True}
    sessions = {d: TpuSparkSession(base, device=d) for d in ("cuda", "cpu")}
    # 4 partitions, the last emptied by the filter
    cached = {}
    for d, s in sessions.items():
        df = s.create_dataframe(table, num_partitions=4) \
            .filter(col("row") < MODES_IO_ROWS * 3 // 4).cache()
        out = df.collect()
        if df.plan.device_encoded is not True:
            fail(f"io-modes: the {d} cache was not device-encoded")
        cached[d] = (df.plan.blobs, out, df.collect())
    if cached["cuda"][0] != cached["cpu"][0]:
        fail("io-modes: the cache's blobs on cuda differ from the CPU's")
    for i in (1, 2):
        _bit_equal(f"io-modes cache collect {i}", cached["cuda"][i],
                   cached["cpu"][i])
    parts = {}
    for d, s in sessions.items():
        path = os.path.join(OUT_DIR, f"io-modes-{d}")
        shutil.rmtree(path, ignore_errors=True)
        try:
            stats = s.create_dataframe(table, num_partitions=3) \
                .filter(col("i64").is_not_null()) \
                .write.partition_by("k").parquet(path)
            parts[d] = (stats.num_files, stats.num_rows,
                        sorted(stats.partitions),
                        {p: papq.read_table(os.path.join(path, p))
                         for p in stats.partitions})
        finally:
            shutil.rmtree(path, ignore_errors=True)
    if parts["cuda"][:3] != parts["cpu"][:3]:
        fail(f"io-modes: partitioned write {parts['cuda'][:3]} != the CPU "
             f"session's {parts['cpu'][:3]}")
    for p, tbl in parts["cuda"][3].items():
        _bit_equal(f"io-modes partition {p}", tbl, parts["cpu"][3][p])
    qa = _qa_modes_table(MODES_SQL_ROWS, 29)
    for s in sessions.values():
        s.create_dataframe(qa, num_partitions=3) \
            .create_or_replace_temp_view("qa")
    queries = sql_surface_queries()
    loose = []
    for q in queries:
        want = sessions["cpu"].sql(q).collect()
        got = sessions["cuda"].sql(q).collect()
        if "ORDER BY" not in q:
            # no total order: both sides sorted the same way
            keys = [(c, "ascending") for c in want.column_names]
            want, got = want.sort_by(keys), got.sort_by(keys)
        if _close_floats(f"io-modes sql {q!r}", got, want):
            loose.append(q)
    log(f"io-modes: {blobs} blobs over {MODES_IO_ROWS} rows (nulls ~5%, "
        f"NaN, -0.0, strings of 0-256 bytes with multi-byte characters, "
        f"an all-null column; parquet {', '.join(IO_CODECS)} and ORC) equal "
        f"the CPU's byte for byte and read back equal; the cache's "
        f"{len(cached['cuda'][0])} blobs (one partition empty) equal and "
        f"its rows exact; the partitioned write's {parts['cuda'][0]} files "
        f"equal; {len(queries)} SELECT-surface queries over "
        f"{MODES_SQL_ROWS} rows equal the CPU session's exactly"
        + (f", but for float columns within tests/parity.py's tolerance "
           f"in {len(loose)}: {loose}" if loose else "")
        + f" ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# 8n. adaptive reads, the skew split, shared scans and the precompile service
# ---------------------------------------------------------------------------

ADAPTIVE_QUERIES = ("q3", "q10")
ADAPTIVE_OFF = {"spark.rapids.tpu.sql.adaptive.enabled": False}


def _readers(plan, name: str) -> list:
    return [n for n in _plan_nodes(plan) if type(n).__name__ == name]


def _spec_summary(readers) -> str:
    """Per coordinated join (side 0's reader): its spec count against the
    exchange's partitions, and how many specs coalesce or split."""
    from spark_rapids_tpu_torch.exec import adaptive
    out = []
    for r in readers:
        if r.side:
            continue
        specs = [sp[0] for sp in r.state.specs or ()]
        split = sum(isinstance(sp, adaptive.SkewSplitSpec) for sp in specs)
        merged = sum(isinstance(sp, adaptive.CoalescedSpec)
                     and sp.end - sp.start > 1 for sp in specs)
        out.append(f"{len(specs)} specs over "
                   f"{r.children[0].partitioning.num_partitions} "
                   f"partitions ({merged} coalesced, {split} split)")
    return "; ".join(out)


def phase_adaptive(root: str, t: dict, sf: float):
    """q3 and q10 over the tpch phase's Parquet files at the reference's
    defaults (adaptive reads on) and with ``sql.adaptive.enabled`` off:
    the default plan reads every shuffled join's two exchanges through
    ``TpuAdaptiveJoinReaderExec`` (the off plan through none), both
    forms' rows equal pyarrow's and each other's, and each form's cold
    wall, spill, peak memory, launches and spec lists are printed."""
    from spark_rapids_tpu_torch.obs import registry as obsreg
    card = _card()
    reg = obsreg.get_registry()
    for q in ADAPTIVE_QUERIES:
        ref = tpch_reference(q, t)
        run = tpch_run(q, root)
        outs, walls = {}, {}
        for form, conf in (("adaptive", {}), ("off", ADAPTIVE_OFF)):
            tag = f"adaptive {q} {form} (SF {sf:g})"
            view = reg.view()
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, plan = run(conf)
            torch.cuda.synchronize()
            walls[form] = time.perf_counter() - t0
            launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
            c = view.delta()["counters"]
            peak = torch.cuda.max_memory_allocated() / 2**30
            readers = _readers(plan, "TpuAdaptiveJoinReaderExec")
            joins = _readers(plan, "TpuShuffledHashJoinExec")
            if form == "adaptive":
                kids = [[type(k).__name__ for k in j.children]
                        for j in joins]
                if not joins or any(k != ["TpuAdaptiveJoinReaderExec"] * 2
                                    for k in kids) or any(
                        type(r.children[0]).__name__ !=
                        "TpuShuffleExchangeExec" for r in readers):
                    fail(f"{tag}: the shuffled joins read {kids}")
            elif readers:
                fail(f"{tag}: adaptive readers with the key off")
            rel = check_rows(tag, out, ref)
            _check_launches(tag, launches, fallbacks,
                            ["decode.unpack_bits",
                             "segreduce.gather_seg_scan"])
            _catalog_empty(tag)
            outs[form] = out
            log(f"{tag}: {out.num_rows} rows match pyarrow (float max rel "
                f"{rel:.3g}); cold wall {walls[form] * 1e3:.1f} ms; "
                f"{len(joins)} shuffled joins"
                + (f", {_spec_summary(readers)}" if readers else "")
                + f"; spilled device->host "
                f"{int(c.get('spill.deviceToHostBytes', 0))} B; peak "
                f"device memory {peak:.2f} GiB; launches {launches} "
                f"[{card}]")
        rel = check_rows(f"adaptive {q} on vs off", outs["adaptive"],
                         outs["off"])
        log(f"adaptive {q}: the adaptive rows equal the bare exchanges' "
            f"(float max rel {rel:.3g}); cold wall "
            f"{walls['adaptive'] * 1e3:.1f} ms against "
            f"{walls['off'] * 1e3:.1f} ms ({walls['adaptive'] / walls['off']:.2f}x)"
            f" [{card}]")


# tests/test_join_oocore.py:273-280's shape at 2^26 fact rows: 60% of the
# rows on key 7, the rest uniform over 500 keys; the dimension holds
# every key once
SKEW_FACT_ROWS = 1 << 26
SKEW_KEYS = 500
SKEW_SEED = 3
SKEW_CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
             "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
             "spark.rapids.tpu.sql.shuffle.partitions": 16}
SKEW_FORMS = {
    "split": {"spark.rapids.tpu.sql.join.skew.enabled": True},
    # the unsplit run: no skew split and no adaptive split either
    "unsplit": ADAPTIVE_OFF,
    "adaptive": {}}
SKEW_COUNTERS = ("shuffle.skew.detected", "shuffle.skew.splits",
                 "shuffle.skew.broadcasts", "shuffle.skew.replications")


def skew_tables():
    rng = np.random.default_rng(SKEW_SEED)
    n = SKEW_FACT_ROWS
    keys = np.where(rng.random(n) < 0.6, 7,
                    rng.integers(0, SKEW_KEYS, n)).astype(np.int64)
    fact = pa.table({"k": keys, "lv": rng.integers(0, 1000, n)})
    dim = pa.table({"k2": np.arange(SKEW_KEYS, dtype=np.int64),
                    "rv": rng.integers(0, 1000, SKEW_KEYS)})
    return fact, dim


def skew_reference(fact: pa.Table, dim: pa.Table) -> pa.Table:
    k = fact["k"].to_numpy()
    prod = fact["lv"].to_numpy() * dim["rv"].to_numpy()[k]
    cnt = np.bincount(k, minlength=SKEW_KEYS)
    s = np.zeros(SKEW_KEYS, dtype=np.int64)
    np.add.at(s, k, prod)
    keep = cnt > 0
    return pa.table({"k": np.arange(SKEW_KEYS, dtype=np.int64)[keep],
                     "s": s[keep], "c": cnt[keep]})


def phase_skew():
    """The skew join under ``sql.join.skew.enabled``: the 2^26-row fact
    table joined to its 500-row dimension and aggregated per key, on port
    sessions on cuda with broadcasts off and 16 shuffle partitions.  The
    split plan reads both exchanges through TpuSkewJoinReaderExec and
    counts a detected bucket, at least two splits and a broadcast or a
    replication; its rows equal the unsplit run's (and, alone, the
    default adaptive reader's) and numpy's; each wall and the
    gather_seg_scan launches are printed.  Returns (launches, classes,
    names) of the split run."""
    from spark_rapids_tpu_torch.api import TpuSparkSession, col, functions as F
    from spark_rapids_tpu_torch.obs import registry as obsreg
    card = _card()
    t0 = time.perf_counter()
    fact, dim = skew_tables()
    ref = skew_reference(fact, dim)
    log(f"skew: {fact.num_rows} fact rows ({fact.nbytes} B) and the numpy "
        f"reference in {time.perf_counter() - t0:.1f} s")
    reg = obsreg.get_registry()
    shapes = ShapeRecorder()
    outs, split_launches = {}, None
    forms = ("split", "unsplit") if WHOLE_SMOKE else tuple(SKEW_FORMS)
    for form in forms:
        tag = f"skew {form}"
        s = TpuSparkSession(dict(SKEW_CONF, **SKEW_FORMS[form]),
                            device="cuda")
        plans = []
        s.add_plan_listener(lambda r: plans.append(r.plan))
        df = (s.create_dataframe(fact, num_partitions=8)
              .join(s.create_dataframe(dim), col("k") == col("k2"))
              .group_by("k").agg(F.sum(col("lv") * col("rv")).alias("s"),
                                 F.count("*").alias("c")))
        view = reg.view()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with shapes if form == "split" else contextlib.nullcontext():
            out = df.collect()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
        c = view.delta()["counters"]
        skew = {k: int(c.get(k, 0)) for k in SKEW_COUNTERS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        out = out.sort_by("k")
        if not out.equals(ref):
            fail(f"{tag}: the rows differ from numpy's")
        _check_launches(tag, launches, fallbacks,
                        ["segreduce.gather_seg_scan"])
        _catalog_empty(tag)
        names = [type(n).__name__ for n in _plan_nodes(plans[-1])]
        if form == "split":
            if names.count("TpuSkewJoinReaderExec") != 2:
                fail(f"{tag}: the plan holds {names}")
            if skew["shuffle.skew.detected"] < 1 or \
                    skew["shuffle.skew.splits"] < 2 or \
                    skew["shuffle.skew.broadcasts"] + \
                    skew["shuffle.skew.replications"] < 1:
                fail(f"{tag}: the skew counters are {skew}")
            split_launches = launches
        elif any(skew.values()) or "TpuSkewJoinReaderExec" in names:
            fail(f"{tag}: the skew plane ran ({skew})")
        readers = _readers(plans[-1], "TpuAdaptiveJoinReaderExec")
        outs[form] = out
        log(f"{tag}: {out.num_rows} groups equal numpy's; wall "
            f"{wall * 1e3:.1f} ms; skew counters {skew}"
            + (f"; {_spec_summary(readers)}" if readers else "")
            + f"; gather_seg_scan launches "
            f"{launches.get('segreduce.gather_seg_scan', 0)}; launches "
            f"{launches}; peak device memory {peak:.2f} GiB [{card}]")
    for form in forms[1:]:
        if not outs[form].equals(outs["split"]):
            fail(f"skew: the {form} rows differ from the split run's")
    log(f"skew: the split rows equal the {', '.join(forms[1:])} runs' "
        f"[{card}]")
    return split_launches, shapes.classes, sorted(split_launches)


# q6's filtered scan read by a second aggregate: the same columns and the
# same pushed filter, so the two plans' scans have one share key
def share_query(session, path, price: float = 150.0):
    from spark_rapids_tpu_torch.api import col, functions as F
    return (session.read.parquet(path)
            .filter(col("ss_sales_price") > price)
            .group_by("ss_item_sk")
            .agg(F.max("ss_quantity").alias("mq"),
                 F.sum("ss_ext_sales_price").alias("sesp")))


# two query slots; a retention window that holds every decoded batch of
# the SF10 files, so a subscriber a batch behind still shares it
SHARE_CONF = dict(SCAN_CONF, **{
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
    "spark.rapids.tpu.sched.maxConcurrent": 2,
    "spark.rapids.tpu.sql.scan.shared.windowBytes": 16 << 30})
SHARE_COUNTERS = ("scan.shared.subscribers", "scan.shared.dedupedDecodes",
                  "scan.shared.multicastBatches")
SHARE_DECODES = ("decode.unpack_bits", "filter_decode.decode")


def _clear_share() -> None:
    from spark_rapids_tpu_torch.io import scan_share
    share = scan_share.peek_share()
    if share is not None:
        share.clear()


def phase_share(root: str, ref: pa.Table):
    """Two different aggregates over q6's filtered scan of the SF10
    files (q6 and ``share_query``) submitted at once on one port session
    on cuda with two query slots: with sharing on, the ``scan.shared.*``
    counters are at least 1 and the decode launches equal one query's;
    with it off, twice that.  Each result equals its serial run bit for
    bit (q6 also pyarrow); each pair's wall, spilled bytes and peak device
    memory; an empty spill catalog after.  Returns (launches, classes,
    names) of the shared pair."""
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.obs import registry as obsreg
    card = _card()
    reg = obsreg.get_registry()
    shapes = ShapeRecorder()
    shared_launches = None
    for shared in (True, False):
        tag = f"share {'on' if shared else 'off'}"
        s = TpuSparkSession(dict(SHARE_CONF, **{
            "spark.rapids.tpu.sql.scan.shared.enabled": shared}),
            device="cuda")
        dfs = (bench_query(s, root), share_query(s, root))
        serial, one = [], None
        for i, df in enumerate(dfs):
            _clear_share()
            _reset_counts()
            out = df.collect()
            torch.cuda.synchronize()
            if i == 0:
                check_q6(out, ref)
                one = {k: kb.launches.get(k, 0) for k in SHARE_DECODES}
            serial.append(out.sort_by("ss_item_sk"))
        _clear_share()
        view = reg.view()
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with shapes if shared else contextlib.nullcontext():
            futs = [df.collect_async() for df in dfs]
            outs = [f.result(timeout=300) for f in futs]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
        c = view.delta()["counters"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        _clear_share()
        counters = {k: int(c.get(k, 0)) for k in SHARE_COUNTERS}
        decodes = {k: launches.get(k, 0) for k in SHARE_DECODES}
        for a, b in zip(serial, outs):
            if not a.equals(b.sort_by("ss_item_sk")):
                fail(f"{tag}: a concurrent result differs from its serial "
                     f"run")
        waits = [f.queue_wait_ns for f in futs]
        if any(waits):
            fail(f"{tag}: a query waited for a slot ({waits} ns)")
        if shared:
            if min(counters.values()) < 1:
                fail(f"{tag}: the sharing counters are {counters}")
            if decodes != one:
                fail(f"{tag}: decode launches {decodes} != one query's "
                     f"{one}")
            shared_launches = launches
        elif any(counters.values()) or \
                decodes != {k: 2 * v for k, v in one.items()}:
            fail(f"{tag}: counters {counters}, decode launches {decodes} "
                 f"(one query's {one})")
        _check_launches(tag, launches, fallbacks, Q6P_KERNELS)
        _catalog_empty(tag)
        log(f"{tag}: q6 and a second aggregate over its scan at once in "
            f"{wall * 1e3:.1f} ms, each equal to its serial run bit for "
            f"bit; {counters}; decode launches {decodes} (one query "
            f"{one}); launches {launches}; spilled device->host "
            f"{int(c.get('spill.deviceToHostBytes', 0))} B, host->disk "
            f"{int(c.get('spill.hostToDiskBytes', 0))} B; peak device "
            f"memory {peak:.2f} GiB [{card}]")
    return shared_launches, shapes.classes, sorted(shared_launches)


PRECOMPILE_CHILD = "precompile-child"


def _precompile_child(mode: str, root: str, corpus: str, out_path: str,
                      build_dir: str = "") -> int:
    """One process of the precompile phase.  ``write``: q6 over ``root``
    on a session that appends the compile corpus to ``corpus``.
    ``replay``: the kernel libraries build into the empty ``build_dir``;
    a session with ``sched.precompile.enabled`` replays ``corpus`` and
    waits for it, then runs q6 and reports its first calls.  Writes q6's
    rows to ``out_path`` and prints one JSON line."""
    from pathlib import Path
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.obs import compile as obscompile
    rec = {"mode": mode}
    conf = dict(SCAN_CONF, **{
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True})
    if mode == "write":
        conf["spark.rapids.tpu.obs.compile.corpusPath"] = corpus
    else:
        _build.BUILD_DIR = Path(build_dir)
        conf.update({"spark.rapids.tpu.sched.precompile.enabled": True,
                     "spark.rapids.tpu.sched.precompile.corpusPath": corpus,
                     "spark.rapids.tpu.sched.precompile.idleWaitMs": 0,
                     # the q6's own corpus, to name its programs' libraries
                     "spark.rapids.tpu.obs.compile.corpusPath":
                         corpus + ".replayed"})
    t0 = time.perf_counter()
    s = TpuSparkSession(conf, device="cuda")
    if mode == "replay":
        svc = s.precompile_service
        if not svc.wait(timeout=900):
            print(json.dumps({"error": "the replay did not finish"}))
            return 1
        rec["replay"] = svc.stats()
        rec["built_by_replay"] = sorted(_build.compiler_output)
        rec["replay_s"] = time.perf_counter() - t0
    obscompile.reset()
    _reset_counts()
    t1 = time.perf_counter()
    out = bench_query(s, root).collect()
    torch.cuda.synchronize()
    rec["q6_ms"] = (time.perf_counter() - t1) * 1e3
    rec["launches"] = dict(kb.launches)
    rec["built_after_q6"] = sorted(_build.compiler_output)
    rec["events"] = [{k: e[k] for k in ("family", "key", "signature",
                                         "tier", "wall_ms")}
                     for e in obscompile.events()]
    papq.write_table(out, out_path)
    print(json.dumps(rec))
    return 0


def _run_child(*args) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), PRECOMPILE_CHILD,
         *args], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"precompile {args[0]}: exit {proc.returncode}\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_precompile(root: str, ref: pa.Table):
    """A process runs q6 over the SF10 files and writes the compile
    corpus; a fresh process with an empty build directory and
    ``sched.precompile.enabled`` replays it, so ``nvcc`` runs in the
    replay; that process's first q6 then builds nothing, every first call
    that launches a kernel library is ``persistent`` (none ``fresh``),
    and both processes' rows equal pyarrow's."""
    card = _card()
    d = _parquet_dir("precompile")
    try:
        corpus = os.path.join(d, "corpus.jsonl")
        build_dir = os.path.join(d, "build")
        os.makedirs(build_dir)
        t0 = time.perf_counter()
        w = _run_child("write", root, corpus, os.path.join(d, "w.parquet"))
        write_s = time.perf_counter() - t0
        check_q6(papq.read_table(os.path.join(d, "w.parquet")), ref)
        programs = [p for line in open(corpus)
                    for p in json.loads(line)["programs"]]
        payloads = [p for p in programs if p["replay"]]
        libs = sorted({n for p in payloads
                       for n in json.loads(p["replay"])["libraries"]})
        if not payloads or set(libs) != {"decode", "filter_decode",
                                         "segreduce"}:
            fail(f"precompile: the corpus's payloads name {libs} "
                 f"({len(payloads)} of {len(programs)} programs)")
        t0 = time.perf_counter()
        r = _run_child("replay", root, corpus, os.path.join(d, "r.parquet"),
                       build_dir)
        replay_s = time.perf_counter() - t0
        check_q6(papq.read_table(os.path.join(d, "r.parquet")), ref)
        st = r["replay"]
        if st["warmed"] < 1 or st["failed"] or st["built"] < 1 or \
                st["warmed"] + st["skipped"] != st["programs"]:
            fail(f"precompile: the replay counted {st}")
        if r["built_after_q6"] != r["built_by_replay"] or \
                set(r["built_by_replay"]) != set(libs):
            fail(f"precompile: nvcc built {r['built_by_replay']} in the "
                 f"replay and {r['built_after_q6']} after q6")
        replayed = [p for line in open(corpus + ".replayed")
                    for p in json.loads(line)["programs"]]
        kernel_progs = {(p["key"], p["signature"]) for p in replayed
                        if p["replay"]}
        tiers = {(e["key"], e["signature"]): e["tier"] for e in r["events"]}
        fresh_kernel = [k for k in kernel_progs if tiers.get(k) != "persistent"]
        if not kernel_progs or fresh_kernel:
            fail(f"precompile: first calls over kernel libraries not "
                 f"persistent: {fresh_kernel} of {sorted(kernel_progs)}")
        _check_launches("precompile q6", r["launches"], {}, Q6P_KERNELS)
        fresh = sorted({e["family"] for e in r["events"]
                        if e["tier"] == "fresh"})
        log(f"precompile: the corpus of q6 holds {len(programs)} programs, "
            f"{len(payloads)} with a payload naming {libs} (written in "
            f"{write_s:.1f} s); the replay process ({replay_s:.1f} s) "
            f"built {r['built_by_replay']} into an empty build directory "
            f"in {r['replay_s']:.1f} s, counting {st}; its first q6 "
            f"({r['q6_ms']:.1f} ms) built nothing, its "
            f"{len(kernel_progs)} first calls over kernel libraries all "
            f"persistent, {len(r['events']) - len(kernel_progs)} other "
            f"first calls (families {fresh} fresh: no kernel library); "
            f"both processes' rows equal pyarrow's; write process q6 "
            f"{w['q6_ms']:.1f} ms [{card}]")
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# 9. kernel timings at the q6 shapes
# ---------------------------------------------------------------------------

# GPU cycles each timed rep waits before its first event: about 3 ms on
# the H100, far longer than the host takes to enqueue one call (40-160 us
# measured for segreduce by segreduce_profile.py), so no idle time lands
# between the events.  A sleep of 200,000 cycles (about 0.1 ms) is
# shorter than the host at times, and then counts idle time as kernel
# time.
SLEEP_CYCLES = 5_000_000


def _time_device(fn, reps: int = 20, flush=None) -> float:
    """Mean ms per call on the device: per rep, flush L2 (the q6 caller
    finds its inputs cold), keep the GPU busy while the host enqueues,
    and time the call between CUDA events."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _segments(new: torch.Tensor) -> torch.Tensor:
    starts = torch.nonzero(new).flatten()
    if starts.numel() == 0 or int(starts[0]) != 0:
        starts = torch.cat([starts.new_zeros(1), starts])
    ends = torch.cat([starts[1:], starts.new_full((1,), new.shape[0])])
    return ends - starts


def _summary(label: str, name: str, rows, launches) -> dict:
    """One kernel's JSON entry: launch-weighted means over its shapes."""
    calls = sum(r["calls"] for r in rows)

    def mean(k):
        have = [r for r in rows if r[k] is not None]
        if not have:
            return None
        w = sum(r["calls"] for r in have)
        return sum(r[k] * r["calls"] for r in have) / w
    entry = {
        "name": label, "route": "cuda",
        "source": SOURCE_OF[name.split(".")[0]], "replaces": REPLACES[name],
        "launches": launches.get(name, 0),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": "bytes",
        "library_ms": mean("library_ms")}
    log(f"timing {label}: {calls} calls/query, launch-weighted mean "
        f"kernel {entry['ms']:.4f} ms vs bound {entry['bound_ms']:.4f} ms")
    return entry


class Case:
    """One recorded kernel input: ``run`` calls the kernel through its
    wrapper, ``plain`` its plain version; ``check`` returns (max_abs_err,
    ok) of the two, bit for bit unless given; ``nbytes`` is what the
    function must move (each input read once, each output written once,
    counting what this input's data needs); ``library`` is one torch call
    computing the same function, or None."""

    def __init__(self, run, plain, nbytes, shape, check=None, library=None):
        self.run, self.plain = run, plain
        self.nbytes, self.shape = nbytes, shape
        self.check = check or (lambda: _exact(run(), plain()))
        self.library = library


def _case(name: str, args) -> Case:
    if name in SEGREDUCE:
        new, x, op, ident, order, out = args
        out_t = out or x.dtype
        cap = new.shape[0]
        gathered = (x if order is None else x[order.long()]).to(out_t)
        reduce = {"add": "sum", "min": "min", "max": "max"}[op]
        return Case(
            partial(wrapper_scan, new, x, op, ident, order, out),
            partial(kseg.plain_seg_scan, new, x, op, ident, order, out),
            cap * ((4 if order is not None else 0) + 1 + x.element_size() +
                   gathered.element_size()),
            f"{x.dtype}->{out_t} {op} cap={cap} src={x.shape[0]}",
            check=partial(compare, new, x, op, ident, order, out),
            library=partial(torch.segment_reduce, gathered, reduce,
                            lengths=_segments(new)))
    if name == "decode.expand_stream":
        # the whole expansion: the run table and the packed bytes in, 4*cap
        # out (the run matrix the bound counted before has the table's
        # size)
        table, packed, w, ncap, cap = args
        return Case(partial(kdec.expand_device, table, packed, w, ncap, cap),
                    partial(kdec.plain_expand_device, table, packed, w, ncap,
                            cap),
                    table.numel() * table.element_size() + packed.numel() +
                    4 * cap,
                    f"w={w} ncap={ncap} cap={cap} rows={table.shape[0]} "
                    f"{table.dtype}")
    if name == "decode.unpack_bits":
        b, w, ncap, out = args
        where = " in place" if out is not None else ""
        return Case(partial(kdec.unpack_bits, b, w, ncap, out=out),
                    partial(kdec.plain_unpack_bits, b, w, ncap),
                    b.shape[0] + 4 * ncap, f"w={w} ncap={ncap}{where}")
    if name == "filter_decode.decode":
        # keep bytes; per kept row its code; each dictionary entry at
        # most once; the output
        dbuf, codes, keep = args
        cap, esize, dlen = codes.shape[0], dbuf.element_size(), dbuf.shape[0]
        kept = int(keep.sum())
        return Case(partial(kfd.decode, dbuf, codes, keep),
                    partial(kfd.plain_decode, dbuf, codes, keep),
                    cap + 4 * kept + min(kept, dlen) * esize + cap * esize,
                    f"{dbuf.dtype} dict={dlen} cap={cap} kept={kept}")
    # decode_str: keep bytes; per kept row its byte base and length; each
    # dictionary byte at most once; the output
    dbuf, bb, lw, keep, width = args
    cap, dlen = bb.shape[0], dbuf.shape[0]
    kept = int(keep.sum())
    kept_bytes = int(torch.where(keep, lw.clamp(0, width), 0).sum())
    return Case(partial(kfd.decode_str, dbuf, bb, lw, keep, width),
                partial(kfd.plain_decode_str, dbuf, bb, lw, keep, width),
                cap + 8 * kept + min(kept_bytes, dlen) + cap * width,
                f"dict={dlen} B cap={cap} width={width} kept={kept} "
                f"kept_bytes={kept_bytes}")


def phase_timing(paths):
    """``paths``: (tag, launches, recorded classes, kernel names) of each
    q6 run.  Each listed kernel is checked against its plain version and
    timed at every shape that run gave it; a kernel listed under more than
    one run is named ``name@tag`` after its first entry.  No single torch
    call computes the predicated decode functions, so their library_ms is
    null; segreduce's is ``torch.segment_reduce`` where the dtype has one."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernels, seen = [], set()
    for tag, launches, classes, names in paths:
        for name in names:
            rows = []
            for key, c in sorted(classes.items(), key=lambda kv: str(kv[0])):
                if c["name"] != name:
                    continue
                case = _case(name, c["args"])
                err, ok = case.check()
                if not ok:
                    fail(f"kernel != plain at the {tag} shape {key} "
                         f"(max err {err})")
                ms = _time_device(case.run, flush=flush)
                plain_ms = _time_device(case.plain, reps=5, flush=flush)
                library_ms = None
                if case.library is not None:
                    try:
                        library_ms = _time_device(case.library, flush=flush)
                    except (RuntimeError, NotImplementedError):
                        pass       # no segment_reduce for this dtype
                bound_ms = case.nbytes / HBM_BYTES_PER_S * 1e3
                rows.append({"calls": c["calls"], "ms": ms,
                             "plain_ms": plain_ms, "library_ms": library_ms,
                             "bound_ms": bound_ms, "max_abs_err": err})
                lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
                log(f"timing {name} {tag} [{case.shape}] x{c['calls']}/query: "
                    f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_ms / ms:.1%} of roofline), plain "
                    f"{plain_ms:.3f} ms, library {lib}, max_abs_err "
                    f"{err:g}")
            if not rows:
                fail(f"no recorded call of {name} in {tag}")
            label = f"{name}@{tag}" if name in seen else name
            seen.add(name)
            kernels.append(_summary(label, name, rows, launches))
    return kernels


ALL_PHASES = ["build", "parity", "entry", "q6", "q6p", "q6pf", "session",
              "pipeline", "q6s", "star", "window", "shuffle", "strings",
              "customer-etl", "mortgage", "skew", "tpch", "oocore",
              "adaptive", "obs", "sched", "csv-orc", "compile", "share",
              "precompile", "modes", "window-modes", "shuffle-modes",
              "string-modes", "tail-modes", "io-modes"]
# the phases that read the SF10 q6 files after oocore (kept until then)
Q6_FILE_PHASES = {"obs", "sched", "compile", "share", "precompile"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    global WHOLE_SMOKE
    if len(sys.argv) > 1 and sys.argv[1] == PRECOMPILE_CHILD:
        return _precompile_child(*sys.argv[2:])
    phases = sys.argv[1].split(",") if len(sys.argv) > 1 else ALL_PHASES
    WHOLE_SMOKE = set(ALL_PHASES) <= set(phases)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} pyarrow "
        f"{pa.__version__} on {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    from spark_rapids_tpu_torch.obs import registry as obsreg
    spilled = dict.fromkeys(SPILL_COUNTERS, 0.0)

    def done(name: str) -> None:
        # every session spills registered batches past its device budget
        # (memory.device.batchStorageSize, 4 GiB by default): the bytes
        # each phase moved to the host and to disk
        now = {k: obsreg.get_registry().counter(k) for k in SPILL_COUNTERS}
        moved = {k: int(now[k] - spilled[k]) for k in SPILL_COUNTERS}
        spilled.update(now)
        log(f"phase {name} done at {time.perf_counter() - t_start:.1f} s; "
            f"spilled device->host {moved['spill.deviceToHostBytes']} B, "
            f"host->disk {moved['spill.hostToDiskBytes']} B")
    phase_build()
    done("build")
    if "parity" in phases:
        phase_parity()
        phase_parity_decode()
        done("parity")
    if "entry" in phases:
        phase_entry()
        done("entry")
    runs, counts = {}, {}
    if "q6" in phases:
        runs["q6"] = ("q6", *phase_q6(), SEGREDUCE)
        done("q6")
    q6_files = None
    if {"q6p", "q6pf", "session", "pipeline"} & set(phases) or \
            Q6_FILE_PHASES & set(phases):
        root = _parquet_dir("q6-parquet")
        try:
            ref = write_q6_files(root)
            if Q6_FILE_PHASES & set(phases):
                # the obs, sched, compile, share and precompile phases
                # read them after oocore
                _KEPT_DIRS.append(root)
                q6_files = (root, ref)
            for key, tag, fn, names in (
                    ("q6p", "q6-parquet", phase_q6_parquet, Q6P_KERNELS),
                    ("q6pf", "q6-perfile", phase_q6_perfile,
                     Q6PF_KERNELS)):
                if key in phases:
                    launches, classes, fallbacks = fn(root, ref)
                    runs[key] = (tag, launches, classes, names)
                    counts[key] = (launches, fallbacks)
            if "session" in phases:
                phase_session(root, ref, counts)
            if "pipeline" in phases:
                table, mem_ref = q6_table()
                busy = phase_pipeline(root, table, ref, mem_ref)
                log("pipeline: device busy share " + ", ".join(
                    f"{k} {v['busy_share']:.1%} of {v['wall_ms']:.1f} ms"
                    for k, v in busy.items()))
        finally:
            if q6_files is None:
                shutil.rmtree(root, ignore_errors=True)
        done("q6p/q6pf/session/pipeline")
    if "q6s" in phases:
        runs["q6s"] = ("q6s-parquet", *phase_q6s_parquet(),
                       ["filter_decode.decode_str"])
        done("q6s")
    if {"star", "window", "shuffle", "strings", "customer-etl"} & \
            set(phases):
        # the star, window, shuffle, strings and customer-etl phases share
        # the SF10 files: store for window and strings, catalog_sales for
        # shuffle and strings, the census tables for strings and
        # customer-etl
        root = _parquet_dir("star")
        try:
            tables = write_star_files(root)
            if {"window", "strings"} & set(phases):
                tables["store"] = write_store_file(root)
            if {"shuffle", "strings"} & set(phases):
                tables["catalog_sales"] = write_catalog_sales(root)
            if {"strings", "customer-etl"} & set(phases):
                tables.update(write_strings_files(root,
                                                  tables["store_sales"]))
            done("star files")
            if "star" in phases:
                runs["star"] = ("star", *phase_star(root, tables))
                done("star")
            if "window" in phases:
                runs["window"] = ("window", *phase_window(root, tables))
                done("window")
            if "shuffle" in phases:
                runs["shuffle"] = ("shuffle", *phase_shuffle(root, tables))
                done("shuffle")
            if "strings" in phases:
                runs["strings"] = ("strings", *phase_strings(root, tables))
                done("strings")
            if "customer-etl" in phases:
                runs["customer-etl"] = ("customer-etl", *phase_customer_etl(
                    root, tables["customer"]))
                done("customer-etl")
            del tables
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if "mortgage" in phases:
        runs["mortgage"] = ("mortgage", *phase_mortgage())
        done("mortgage")
    if "skew" in phases:
        runs["skew"] = ("skew", *phase_skew())
        done("skew")
    if {"tpch", "csv-orc", "oocore", "adaptive", "obs", "sched"} & \
            set(phases):
        # the six share the generated tables; tpch, oocore, adaptive, obs
        # and sched read the Parquet files, csv-orc writes its own ORC and
        # CSV files; obs and sched alone run at the whole smoke's scale
        sf = TPCH_SF_WHOLE if WHOLE_SMOKE or not (
            {"tpch", "csv-orc", "oocore", "adaptive"} & set(phases)) \
            else TPCH_SF
        root = _parquet_dir("tpch")
        try:
            if {"tpch", "oocore", "adaptive", "obs", "sched"} & \
                    set(phases):
                t = write_tpch_files(root, sf)
            else:
                from spark_rapids_tpu_torch.bench import tpch
                t = tpch.generate(sf, TPCH_SEED)
            if "tpch" in phases:
                sql_run, cache_run = phase_tpch(root, t, sf)
                runs["tpch"] = ("tpch", *sql_run)
                runs["cache"] = ("cache", *cache_run)
                done("tpch")
            if "oocore" in phases:
                runs["oocore"] = ("oocore", *phase_oocore(root, t, sf))
                done("oocore")
            if "adaptive" in phases:
                phase_adaptive(root, t, sf)
                done("adaptive")
            if "obs" in phases:
                phase_obs(*q6_files, root, t)
                done("obs")
            if "sched" in phases:
                phase_sched(*q6_files, root)
                done("sched")
            if "csv-orc" in phases:
                runs["csv-orc"] = ("csv-orc", *phase_csv_orc(
                    os.path.join(root, "text"), t, sf))
                done("csv-orc")
            del t
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if "compile" in phases:
        phase_compile(*q6_files)
        done("compile")
    if "share" in phases:
        runs["share"] = ("share", *phase_share(*q6_files))
        done("share")
    if "precompile" in phases:
        phase_precompile(*q6_files)
        done("precompile")
    if q6_files is not None:
        shutil.rmtree(q6_files[0], ignore_errors=True)
    if "modes" in phases:
        phase_perfile_modes()
        done("modes")
    if "window-modes" in phases:
        phase_window_modes()
        done("window-modes")
    if "shuffle-modes" in phases:
        phase_shuffle_modes()
        done("shuffle-modes")
    if "string-modes" in phases:
        phase_string_modes()
        done("string-modes")
    if "tail-modes" in phases:
        phase_tail_modes()
        done("tail-modes")
    if "io-modes" in phases:
        phase_io_modes()
        done("io-modes")
    kernels = None
    if set(ALL_PHASES) <= set(phases):
        kernels = phase_timing([runs[k] for k in (
            "q6", "q6p", "q6s", "q6pf", "star", "window", "shuffle",
            "strings", "customer-etl", "mortgage", "skew", "tpch",
            "cache", "oocore", "csv-orc", "share")])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    card = _card()
    _write_log()
    print(card)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for kept in _KEPT_DIRS:
            shutil.rmtree(kept, ignore_errors=True)
