"""The port's precompile service (``sched/precompile.py``) and the
corpus replay payload against the reference's.

``tests/test_precompile.py``'s accounting and background cases: the six
``sched.precompile.*`` counters on the same corpus equal the
reference's; the corpus written under ``obs.compile.corpusPath``, with
and without ``obs.compile.corpusReplay``; a background service started
by a session's conf; and the yield to live queries.

The payload is a pinned divergence (ROADMAP Queue C): the reference's
is a pickled jax traceable, the port's names the ``csrc`` libraries a
program's first call launched kernels from.  On the CPU no kernel
launches, so a session query's programs carry ``null`` and count as
``skipped``; a step that records a launch stands in for the card here.
Replay warms each named library through ``kernels/_build.warm``, faked
here (there is no ``nvcc``): a fresh library counts ``built``, one the
build directory has ``reopened``, and the first call of a step over a
warmed library classifies ``persistent``.  The restart on an empty
build directory runs on the card (``chip_smoke.py precompile``).
"""

import json
import threading
import time

import pytest
import torch

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.obs import registry as jreg
from spark_rapids_tpu.sched.precompile import \
    PrecompileService as JPrecompileService

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.exec import kernel_cache as kc
from spark_rapids_tpu_torch.kernels import _build
from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.obs import compile as obscompile
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.sched.precompile import PrecompileService

from tests.torch_sched import join_query_threads  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

COUNTERS = ("plans", "programs", "warmed", "skipped", "failed", "dedup")
BASE = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


@pytest.fixture(autouse=True)
def _fresh_ledger():
    obscompile.reset()
    obscompile.configure(True)
    yield
    obscompile.reset()
    obscompile.configure(True)


@pytest.fixture
def fake_build(monkeypatch):
    """``_build.load`` without nvcc: the first load of a name is a
    build (``fresh``) unless ``on_disk`` lists it (``persistent``)."""
    state = {"on_disk": set(), "loads": []}
    loaded = set()

    def load(name):
        state["loads"].append(name)
        if name not in loaded:
            loaded.add(name)
            _build._thread_tally()[1 if name in state["on_disk"]
                                   else 0] += 1
        return object()

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_warmed", set())
    return state


def _launching_step(*names):
    """A kernel-cache step that records launches of ``names`` as a hand
    kernel's wrapper does on the card."""
    def step(x):
        for n in names:
            kb.record_launch(n)
        return x + 1
    return step


def _query(s, mark, col=col, F=F):
    """``mark`` gives each test a distinct plan digest (the corpus
    dedups digests)."""
    df = s.create_dataframe(
        {"k": [i % 5 for i in range(1500)],
         "x": [float(i % 90) for i in range(1500)]}, num_partitions=2)
    return (df.with_column("y", col("x") + mark).filter(col("y") > 10)
              .group_by("k").agg(F.sum("y").alias("sy")).sort("k"))


def _programs(path):
    return [p for line in open(path) for p in
            json.loads(line)["programs"]]


def test_session_corpus_programs_carry_null_payloads_on_the_cpu(tmp_path):
    """The divergence pinned: a port session query on the CPU launches
    no kernel, so every program carries ``replay: null``; the
    reference's query of the same plan carries its jax payloads."""
    corpus = str(tmp_path / "port.jsonl")
    s = TSession(dict(BASE, **{"spark.rapids.tpu.obs.compile.corpusPath":
                               corpus}), device="cpu")
    _query(s, 1.5).collect()
    progs = _programs(corpus)
    assert progs and all(p["replay"] is None for p in progs)
    ref_corpus = str(tmp_path / "ref.jsonl")
    js = JSession(dict(BASE, **{"spark.rapids.tpu.obs.compile.corpusPath":
                                ref_corpus}))
    _query(js, 1.5, jcol, JF).collect()
    assert any(p.get("replay") for p in _programs(ref_corpus))


@pytest.mark.parametrize("replay_on", [True, False])
def test_launching_program_payload_names_its_libraries(tmp_path, replay_on):
    corpus = str(tmp_path / "c.jsonl")
    obscompile.configure(True, corpus_path=corpus,
                         corpus_replay=replay_on)
    from spark_rapids_tpu_torch.sched import cancel as sched_cancel
    obscompile.register_query(901, "digest-launch")
    key = ("tpre_launch", replay_on)
    fn = kc.get_kernel(key, lambda: _launching_step(
        "segreduce.gather_seg_scan", "decode.unpack_bits",
        "segreduce.seg_scan_sorted"))
    with sched_cancel.install(sched_cancel.CancelToken(901)):
        fn(torch.zeros(4))
        fn(torch.zeros(4))
    obscompile.finish_query(901)
    (prog,) = _programs(corpus)
    if not replay_on:
        assert prog["replay"] is None
        return
    payload = json.loads(prog["replay"])
    assert payload == {"libraries": ["decode", "segreduce"],
                       "key": repr(key), "signature": prog["signature"]}
    assert kc.load_replay_payload(prog["replay"])["libraries"] == \
        ["decode", "segreduce"]


def _accounting_corpus(path):
    prog = {"family": "f", "key": "k1", "signature": "s1"}
    recs = [
        {"plan_digest": "d1", "programs": [prog, dict(prog)]},   # dedup
        {"plan_digest": "d2", "programs": [
            {"family": "f", "key": "k2", "signature": "s2"}]},   # no payload
        {"plan_digest": "d3", "programs": [
            {"family": "f", "key": "k3", "signature": "s3",
             "replay": "!!!not-base64!!!"}]},                    # failed
    ]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n"
                    + "{torn line\n")
    return str(path)


def test_replay_counts_equal_the_references(tmp_path):
    corpus = _accounting_corpus(tmp_path / "c.jsonl")
    out = {}
    for side, (S, Svc, reg, kw) in {
            "ref": (JSession, JPrecompileService, jreg, {}),
            "port": (TSession, PrecompileService, obsreg,
                     {"device": "cpu"})}.items():
        view = reg.get_registry().view()
        stats = Svc(S(BASE, **kw), corpus, idle_wait_ms=0).replay()
        d = view.delta()["counters"]
        out[side] = ({k: stats[k] for k in COUNTERS},
                     {k: d.get(f"sched.precompile.{k}", 0)
                      for k in COUNTERS})
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"plans": 3, "programs": 3, "warmed": 0,
                              "skipped": 2, "failed": 1, "dedup": 1}
    assert out["port"][0] == out["port"][1]


def test_replay_warms_libraries_and_first_calls_classify_persistent(
        tmp_path, fake_build):
    fake_build["on_disk"] = {"decode"}
    payload = kc._replay_payload(["decode", "segreduce"], ("k", 1),
                                 (((8,), "int64"),))
    corpus = tmp_path / "c.jsonl"
    corpus.write_text(json.dumps({"plan_digest": "d", "programs": [
        {"family": "f", "key": "a", "signature": "s", "replay": payload},
        {"family": "f", "key": "b", "signature": "s",
         "replay": kc._replay_payload(["nope"], ("k", 2), ())}]}) + "\n")
    fake_build_fail = fake_build["loads"]
    cache_before = len(kc._CACHE)
    svc = PrecompileService(TSession(BASE, device="cpu"), str(corpus),
                            idle_wait_ms=0)
    orig = _build.load

    def load(name):
        if name == "nope":
            raise RuntimeError("nvcc failed for nope.cu")
        return orig(name)

    _build.load = load
    try:
        stats = svc.replay()
    finally:
        _build.load = orig
    assert {k: stats[k] for k in COUNTERS} == {
        "plans": 1, "programs": 2, "warmed": 1, "skipped": 0,
        "failed": 1, "dedup": 0}
    assert (stats["built"], stats["reopened"]) == (1, 1)
    assert fake_build_fail == ["decode", "segreduce"]
    assert _build.warmed() == {"decode", "segreduce"}
    # replay never touches the in-process kernel cache
    assert len(kc._CACHE) == cache_before
    # the serving path's first call over warmed libraries runs no build
    # and classifies persistent; one over an unwarmed library does not
    warm = kc.get_kernel(("tpre_warm", 1), lambda: _launching_step(
        "decode.unpack_bits"))
    cold = kc.get_kernel(("tpre_cold", 1), lambda: _launching_step(
        "filter_decode.decode"))
    warm(torch.zeros(2))
    cold(torch.zeros(2))
    tiers = {e["family"]: e["tier"] for e in obscompile.events()}
    assert tiers["tpre_warm"] == "persistent"
    assert tiers["tpre_cold"] == "fresh"


def test_background_start_and_wait(tmp_path):
    corpus = str(tmp_path / "corpus.jsonl")
    s = TSession(dict(BASE, **{"spark.rapids.tpu.obs.compile.corpusPath":
                               corpus}), device="cpu")
    _query(s, 5.125).collect()
    # a second session starting the service against the written corpus
    # (the session-init path): background replay, wait() joins it
    s2 = TSession(dict(BASE, **{
        "spark.rapids.tpu.sched.precompile.enabled": True,
        "spark.rapids.tpu.sched.precompile.corpusPath": corpus,
        "spark.rapids.tpu.sched.precompile.idleWaitMs": 0}), device="cpu")
    svc = s2.precompile_service
    assert svc is not None
    assert svc.wait(timeout=120), "background replay did not finish"
    stats = svc.stats()
    assert stats["programs"] > 0
    assert stats["warmed"] + stats["skipped"] + stats["failed"] == \
        stats["programs"]
    # on the CPU every program launched no kernel
    assert stats["skipped"] == stats["programs"]
    assert TSession(BASE, device="cpu").precompile_service is None


def test_replay_yields_while_queries_are_live(tmp_path, fake_build):
    corpus = tmp_path / "c.jsonl"
    corpus.write_text(json.dumps({"plan_digest": "d", "programs": [
        {"family": "f", "key": "y", "signature": "s",
         "replay": kc._replay_payload(["segreduce"], ("y",), ())}]})
        + "\n")
    s = TSession(BASE, device="cpu")
    live = threading.Event()
    live.set()
    s._query_service.has_live_queries = live.is_set
    svc = PrecompileService(s, str(corpus), idle_wait_ms=1)
    svc.start()
    time.sleep(0.3)
    assert not svc.wait(0) and svc.stats()["warmed"] == 0
    assert fake_build["loads"] == []
    live.clear()
    assert svc.wait(timeout=30)
    assert svc.stats()["warmed"] == 1
    assert fake_build["loads"] == ["segreduce"]


def test_stop_ends_a_yielding_replay(tmp_path, fake_build):
    corpus = tmp_path / "c.jsonl"
    corpus.write_text(json.dumps({"plan_digest": "d", "programs": [
        {"family": "f", "key": "z", "signature": "s",
         "replay": kc._replay_payload(["decode"], ("z",), ())}]}) + "\n")
    s = TSession(BASE, device="cpu")
    s._query_service.has_live_queries = lambda: True
    svc = PrecompileService(s, str(corpus), idle_wait_ms=1)
    svc.start()
    time.sleep(0.05)
    svc.stop()
    assert svc.wait(timeout=30)
    # the yield ended at the stop; the program was already counted
    assert svc.stats()["programs"] == 1 and fake_build["loads"] in \
        ([], ["decode"])


def test_payload_without_libraries_is_rejected():
    assert kc._replay_payload([], ("k",), ()) is None
    with pytest.raises(ValueError):
        kc.load_replay_payload(json.dumps({"libraries": []}))
    with pytest.raises(ValueError):
        kc.load_replay_payload("!!!not-base64!!!")
