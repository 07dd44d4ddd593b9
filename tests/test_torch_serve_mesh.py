"""Serving on a mesh against the JAX package's, on the CPU.

The reference's ``ContinuousBatcher`` over the paged pool (and once over the
dense ring, at 4 rows, which dp 2 divides) on ``MeshPlan(dp=2,
tp=4)`` (the conftest's 8 virtual devices), and the port's on gloo worlds
of tp 2 and dp 2 x tp 2 (parallel/serving.py: rank 0 leads, every rank
steps), over the same weights (``params_from_jax``, each rank its slice).
Two tiny fp32 families: llama (GQA, 8 query heads over 4 KV heads, which
tp shards) and gpt_bigcode (MQA: its one KV head replicates). One schedule:
admissions mid-stream, greedy and seeded-sampled rows, a cancel, and a
shared prefix under one greedy and one sampled request; split passes,
chunked passes (``chunked_prefill=4, group_chunks=2``) and one int8 pool.
Held, on every rank: the tokens (and the cancel) equal the reference's,
the control's digest chain is the same (each follower checked the
leader's digest before every step), and the paged pool holds the
prefix's block once idle and none after the idle prefix is evicted.

Then the pool's layout against the reference's ``paged_cache_specs``, the
consumer on two processes with the broker in rank 0's alone, and a
follower whose leader died or whose host state diverged ending non-zero.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine.cache import paged_cache_specs as jpaged_specs
from llmss_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JConfig
from llmss_tpu.parallel import AXIS_TP as JAXIS_TP
from llmss_tpu.parallel import MeshPlan as JPlan
from llmss_tpu.parallel import make_mesh as jmake_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import GenerationParams
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.registry import load_model
from llmss_tpu_torch.parallel import Mesh
from llmss_tpu_torch.parallel import sharding as shd
from llmss_tpu_torch.parallel.launch import (
    ServeJob, World, file_init, run_jobs,
)
from llmss_tpu_torch.serve import consumer

from test_torch_multiprocess import _env, _write_llama

REPO = Path(__file__).resolve().parent.parent

FAMILIES = {
    "llama": dict(model_type="llama", vocab_size=128, hidden_size=64,
                  n_layers=2, n_heads=8, n_kv_heads=4, head_dim=16,
                  intermediate_size=128, max_position_embeddings=64,
                  activation="silu", norm="rmsnorm", mlp="swiglu",
                  positions="rotary", rope_style="half", rotary_dim=16,
                  attn_bias=False, mlp_bias=False,
                  tie_word_embeddings=False, dtype="float32"),
    "gpt_bigcode": dict(model_type="gpt_bigcode", vocab_size=128,
                        hidden_size=64, n_layers=2, n_heads=8, n_kv_heads=1,
                        head_dim=16, intermediate_size=128,
                        max_position_embeddings=64, activation="gelu",
                        norm="layernorm", mlp="gelu", positions="learned",
                        attn_bias=True, mlp_bias=True,
                        tie_word_embeddings=True, dtype="float32"),
}
PREFIX = [7, 3, 19, 42, 5, 11, 30, 2, 9, 17, 28]  # one full block of 8
BLOCK, MAX_SEQ = 8, 64
BATCHER = {"split": dict(rows=3, chunk_steps=2, group_chunks=2),
           "rows4": dict(rows=4, chunk_steps=2, group_chunks=2),
           "chunked": dict(rows=3, chunk_steps=2, group_chunks=2,
                           chunked_prefill=4)}
# (family, kv_dtype, kv_layout, passes): every pass of one engine.
CASES = [("llama", None, "paged", ("split", "chunked")),
         ("llama", "int8", "paged", ("split",)),
         ("gpt_bigcode", None, "paged", ("split", "chunked")),
         ("llama", None, "dense", ("rows4",))]
PLANS = {2: (1, 1, 2), 4: (2, 1, 2)}


def _schedule(G):
    """The steps' actions: two admissions, a step, two more (one on the
    prefix) while the first rows decode, a cancel, two more (one sampled
    on the prefix); then the batcher runs until idle."""
    g = G(max_new_tokens=8)
    s = G(max_new_tokens=7, is_greedy=False, seed=3, top_k=20)
    return [
        [("submit", "a", list(range(2, 22)), g, None),
         ("submit", "b", [5, 9, 23], s, None)],
        [],
        [("submit", "c", PREFIX + [50, 51], g, PREFIX),
         ("submit", "d", [7] * 7, g, None)],
        [("cancel", "b")],
        [("submit", "e", PREFIX + [60], s, PREFIX),
         ("submit", "f", [1, 2, 3, 4, 5], g, None)],
    ]


def _jax_pass(eng, mode) -> dict:
    """The reference batcher through the schedule: req_id -> (tokens,
    cancelled), and the blocks it holds once idle."""
    bat = JBatcher(eng, **BATCHER[mode])
    out, prefixes = {}, {}

    def cb(rid):
        def done(tokens, cancelled=False, **kw):
            out[rid] = (list(tokens), bool(cancelled))
        return done

    for actions in _schedule(JGen):
        for a in actions:
            if a[0] == "cancel":
                bat.cancel(a[1])
                continue
            _, rid, ids, gen, ptoks = a
            pfx = None
            if ptoks is not None:
                key = tuple(ptoks)
                if key not in prefixes:
                    prefixes[key] = eng.build_prefix(ptoks)
                pfx = prefixes[key]
            bat.submit(ids, gen, cb(rid), req_id=rid, prefix=pfx)
        bat.step()
    bat.run_until_idle()
    return {"outputs": out, "blocks_idle": bat.allocator.blocks_in_use
            if eng.kv_layout == "paged" else None}


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """(reference, worlds): (case index, mode) -> the JAX pass; world size
    -> every rank's ``run_jobs`` results. The worlds run while the
    reference compiles."""
    jmesh = jmake_mesh(JPlan(dp=2, tp=4), devices=devices[:8])
    jax_params, jobs = {}, []
    for i, (fam, kw) in enumerate(FAMILIES.items()):
        # Scaled past the init's 0.02, so that tokens vary.
        jax_params[fam] = jax.tree.map(lambda x: x * 10.0, jdec.init_params(
            JConfig(**kw), jmesh, jax.random.key(i)))
    for fam, kv, layout, modes in CASES:
        jobs.append(dict(
            cfg=DecoderConfig(**FAMILIES[fam]), kv_layout=layout,
            params=params_from_jax(jax.device_get(jax_params[fam])),
            max_seq_len=MAX_SEQ, block_size=BLOCK,
            passes=[dict(batcher=BATCHER[m], kv_dtype=kv,
                         schedule=_schedule(GenerationParams))
                    for m in modes]))
    d = tmp_path_factory.mktemp("serve_mesh")
    started = {n: World(run_jobs, n,
                        [ServeJob(plan=plan, **job) for job in jobs],
                        init_method=file_init(d / f"rdv{n}"))
               for n, plan in PLANS.items()}
    reference = {}
    for i, (fam, kv, layout, modes) in enumerate(CASES):
        eng = JEngine(JConfig(**FAMILIES[fam]), jax_params[fam], jmesh,
                      max_seq_len=MAX_SEQ, kv_layout=layout,
                      block_size=BLOCK, kv_dtype=kv)
        for m in modes:
            reference[i, m] = _jax_pass(eng, m)
    return reference, {n: w.results() for n, w in started.items()}


PASSES = [(i, m, n) for n in PLANS for i, (*_, modes) in enumerate(CASES)
          for m in modes]


def _id(case):
    i, mode, n = case
    fam, kv, layout, _ = CASES[i]
    dense = "-dense" if layout == "dense" else ""
    return (f"{fam}-{kv or 'fp32'}{dense}-{mode}-"
            f"dp{PLANS[n][0]}xtp{PLANS[n][2]}")


def _ranks(worlds, case):
    i, mode, n = case
    return [r[i]["passes"][CASES[i][3].index(mode)] for r in worlds[n]]


@pytest.mark.parametrize("case", PASSES, ids=_id)
def test_tokens_equal_jax_on_every_rank(case, runs):
    """Every request's tokens, and which was cancelled, equal the
    reference batcher's on dp 2 x tp 4, on every rank of the port's world
    (rank 0's answers, the followers' rows)."""
    reference, worlds = runs
    want = reference[case[0], case[1]]["outputs"]
    assert set(want) == set("abcdef") and want["b"][1]
    for p in _ranks(worlds, case):
        got = {rid: (o["tokens"], o["cancelled"])
               for rid, o in p["outputs"].items()}
        assert got == want


@pytest.mark.parametrize("case", PASSES, ids=_id)
def test_digests_equal_and_pool_drains(case, runs):
    """The ranks' digest chains are one (each follower checked the
    leader's digest before every step); idle, each paged pool holds the
    prefix's one full block, as the reference's does, and none once the
    idle prefix is evicted (the dense ring has no pool)."""
    reference, worlds = runs
    ranks = _ranks(worlds, case)
    assert len({(p["chain"], p["steps"]) for p in ranks}) == 1
    assert ranks[0]["steps"] > len(_schedule(GenerationParams))
    assert all(p["checked"] >= p["steps"] for p in ranks[1:])
    want_idle = reference[case[0], case[1]]["blocks_idle"]
    paged = CASES[case[0]][2] == "paged"
    assert want_idle == (len(PREFIX) // BLOCK if paged else None)
    for p in ranks:
        assert p["blocks_idle"] == want_idle
        assert p["blocks_drained"] == (0 if paged else None)
        assert p["graph_captures"] == 0


def test_tp_halves_the_pool_and_dp_replicates_it(runs):
    """The llama pool holds 2 of 4 KV heads a rank (the same bytes on
    the dp replicas); gpt_bigcode's one KV head is whole on every rank.
    The dense batcher's ring holds every one of its 4 rows on each dp
    replica, at the rank's 2 KV heads."""
    _, worlds = runs
    for n in PLANS:
        llama = {r[0]["passes"][0]["pool_bytes"] for r in worlds[n]}
        mqa = {r[2]["passes"][0]["pool_bytes"] for r in worlds[n]}
        dense = {r[3]["passes"][0]["pool_bytes"] for r in worlds[n]}
        assert len(llama) == len(mqa) == 1
        # [L, N + 1, bs, Hkv_local, D] fp32 K and V, 24 blocks (3 rows x 8).
        assert llama == {2 * 2 * 25 * BLOCK * 2 * 16 * 4}
        assert mqa == {2 * 2 * 25 * BLOCK * 1 * 16 * 4}
        # [L, rows, T, Hkv_local, D] fp32 K and V.
        assert dense == {2 * 2 * 4 * MAX_SEQ * 2 * 16 * 4}


def test_generate_with_a_prefix_on_dp_and_tp(devices, tmp_path):
    """``build_prefix`` and ``generate(prefix=)`` on dp 2 x tp 2, dense and
    paged: every rank returns the tokens the reference's
    ``build_prefix`` and ``generate(prefix=)`` give on dp 2 x tp 4 over
    the same weights (fp32, greedy and seeded-sampled rows)."""
    import torch_mesh_jobs

    jmesh = jmake_mesh(JPlan(dp=2, tp=4), devices=devices[:8])
    jcfg = JConfig(**FAMILIES["llama"])
    jparams = jax.tree.map(lambda x: x * 10.0, jdec.init_params(
        jcfg, jmesh, jax.random.key(1)))
    prompts = [PREFIX + [50, 51], PREFIX + [60], PREFIX + [1, 2, 3],
               PREFIX + [9]]
    kw = [dict(max_new_tokens=6), dict(max_new_tokens=6),
          dict(max_new_tokens=5, is_greedy=False, seed=3, top_k=20),
          dict(max_new_tokens=6)]
    res = World(torch_mesh_jobs.prefix_generate, 4,
                DecoderConfig(**FAMILIES["llama"]),
                params_from_jax(jax.device_get(jparams)), prompts, PREFIX,
                [GenerationParams(**k) for k in kw],
                init_method=file_init(tmp_path / "rdv"))
    want = {}
    for layout in ("dense", "paged"):
        eng = JEngine(jcfg, jparams, jmesh, max_seq_len=MAX_SEQ,
                      kv_layout=layout, block_size=BLOCK)
        want[layout] = eng.generate(prompts, [JGen(**k) for k in kw],
                                    chunk_steps=2,
                                    prefix=eng.build_prefix(PREFIX))
    for r in res.results():
        assert r == want


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("n_kv_heads", [1, 2, 4, 8])
def test_paged_specs_match_jax(n_kv_heads, tp, quantized):
    """The pool's layout: the dimension each field shards over tp equals
    the reference's ``PartitionSpec``; and a rank's pool its share."""
    want = jpaged_specs(n_kv_heads, tp, quantized=quantized)
    got = shd.paged_cache_specs(n_kv_heads, tp, quantized=quantized)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        axes = [i for i, a in enumerate(w) if a == JAXIS_TP]
        assert g == (axes[0] if axes else None), (got, want)
    local = shd.local_kv_heads(n_kv_heads, Mesh.local((2, 1, tp)))
    assert local == (n_kv_heads // tp if got.k is not None else n_kv_heads)


def _rank_cmd(fn: str, *args) -> list[str]:
    call = f"import torch_mesh_jobs as j; j.{fn}(*{list(map(str, args))!r})"
    return [sys.executable, "-c", call]


def _pair(argv_of, timeout=240):
    """Start two processes (``argv_of(rank)``); (return code, output) of
    each."""
    env = _env()
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}{REPO / 'tests'}"
    procs = [subprocess.Popen(argv_of(r), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _line(out: str, head: str) -> str:
    """The rest of ``out``'s last line that starts with ``head``."""
    lines = [ln for ln in out.splitlines() if ln.startswith(head)]
    assert lines, out
    return lines[-1][len(head):]


@pytest.mark.parametrize("mode", ["continuous", "batch"])
def test_consumer_on_two_processes_serves_from_rank0(mode, tmp_path):
    """``consumer.main --tp 2 --continuous --kv_layout paged`` (and the
    batch Worker, without ``--continuous``) on two processes: rank 0
    serves five requests from a broker in its own process (every one
    answered once, with the tokens each gets from ``generate`` alone in
    one process), drains on SIGTERM and stops rank 1, which builds no
    broker (rank 1 runs with ``RedisBroker`` made to raise) and followed
    every step (or batch)."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    _write_llama(ckpt)
    rdv = f"file://{tmp_path / 'rdv'}"
    res = _pair(lambda r: _rank_cmd("consumer_rank", ckpt, rdv, r, mode))
    for r, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {r}:\n{out}"
    import json

    answers = json.loads(_line(res[0][1], "answers "))
    assert int(_line(res[1][1], "follower steps=")) > 0
    cfg, params = load_model(ckpt, device="cpu", dtype="float32")
    from llmss_tpu_torch.engine.engine import DecodeEngine

    eng = DecodeEngine(cfg, params, device="cpu", max_seq_len=64)
    import torch_mesh_jobs

    for ids, gen, got in zip(*torch_mesh_jobs.consumer_requests(),
                             answers):
        assert got == eng.generate([ids], gen)[0]


@pytest.mark.parametrize("fault", ["leader_dies", "diverged"])
def test_follower_fails_loudly(fault, tmp_path):
    """A follower whose leader died after a step exits non-zero (the
    control group's closed connection, within its 60-s timeout); a
    follower whose host state differs from the leader's raises
    ``Diverged`` at the next step's check, and both ranks exit non-zero."""
    rdv = f"file://{tmp_path / 'rdv'}"
    res = _pair(lambda r: _rank_cmd("faulty_rank", rdv, r, fault))
    assert res[1][0] != 0, res[1][1]
    if fault == "diverged":
        assert "Diverged" in res[1][1]
        assert res[0][0] != 0
    else:
        assert res[0][0] == 3


def test_refusals_on_a_mesh():
    """What the consumer does not serve on a mesh raises naming ROADMAP
    Queue 1 item 8; the paged layout under sp > 1 is the reference's
    ValueError."""
    for argv in (["--role", "prefill", "--continuous", "--kv_layout",
                  "paged"],
                 ["--kv_tier_host_mb", "64", "--continuous"],
                 ["--supervise"],
                 ["--continuous", "--sp", "2"]):
        args = consumer._parser().parse_args(
            ["--pretrained_model_path", "x", *argv])
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            consumer.refuse_on_mesh(args)
    args = consumer._parser().parse_args(
        ["--pretrained_model_path", "x", "--continuous", "--kv_layout",
         "paged", "--tp", "2"])
    consumer.refuse_on_mesh(args)  # served
    from llmss_tpu_torch.engine.engine import DecodeEngine
    from llmss_tpu_torch.models.decoder import init_params

    cfg = DecoderConfig(**FAMILIES["llama"])
    with pytest.raises(ValueError, match="does not support sp > 1 meshes"):
        DecodeEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                     mesh=Mesh.local((1, 2, 1)), kv_layout="paged")
