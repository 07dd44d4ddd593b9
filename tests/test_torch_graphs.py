"""The torch port's decode step graphs, ``prewarm`` and ``generate_fused``
on the CPU, where a graph's replay runs the same step body over the same
static buffers: ``generate_fused`` token-identical to the JAX package's and
to ``generate``; ``prewarm``'s count; no new graph key after a prewarm
(the reference's steady-state recompile guard, tests/test_bucket.py:128,
tests/test_ragged.py:362); the batcher's device state at fixed addresses;
the persistent engine cache reset after a poisoned row; the launch
counters a replay keeps. Tiny fp32 llama as in tests/test_torch_engine.py."""

import gc
import types

import jax
import pytest
import torch

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine import graphs
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.engine.engine import variant_params
from llmss_tpu_torch.engine.metrics import EngineMetrics
from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.ops import decode_attention as da
from llmss_tpu_torch.ops import paged_attention as pa

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
PROMPTS = [[5, 9, 23, 40], list(range(3, 20)), [1, 2, 3]]
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged", block_size=8)}
# Batcher modes: layout, and chunked prefill.
MODES = {"dense": ("dense", None), "paged": ("paged", None),
         "chunked": ("paged", 4)}


@pytest.fixture(scope="module")
def model():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    return (JEngine(JCfg(**CFG), jp, mesh, max_seq_len=64),
            params_from_jax(jax.device_get(jp)))


def _engine(model, layout="dense"):
    return TEngine(TCfg(**CFG), model[1], device="cpu", max_seq_len=64,
                   **LAYOUTS[layout])


GENS = {
    "greedy": dict(max_new_tokens=9),
    "sampled": dict(max_new_tokens=9, is_greedy=False, temperature=0.8,
                    top_k=10, top_p=0.9, seed=42),
}


@pytest.mark.parametrize("kind", ["greedy", "sampled", "eos"])
def test_generate_fused_matches_jax(model, kind):
    eng = _engine(model)
    kw = dict(GENS["sampled" if kind == "sampled" else "greedy"])
    if kind == "eos":
        kw["eos_token_id"] = eng.generate_fused(PROMPTS, TGen(**kw))[1][3]
    want = model[0].generate_fused(PROMPTS, JGen(**kw))
    got = eng.generate_fused(PROMPTS, TGen(**kw))
    assert got == want
    if kind == "eos":
        assert len(got[1]) == 3 and kw["eos_token_id"] not in got[1]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("gen", sorted(GENS))
def test_generate_fused_equals_generate(model, layout, gen):
    """tests/test_engine.py:61 on the port: one fused generation gives
    the streaming loop's tokens."""
    eng = _engine(model, layout)
    want = eng.generate(PROMPTS, TGen(**GENS[gen]), chunk_steps=4)
    assert eng.generate_fused(PROMPTS, TGen(**GENS[gen])) == want
    one = eng.generate_fused(PROMPTS, TGen(**{**GENS[gen], "max_new_tokens": 1}))
    assert one == [row[:1] for row in want]


def test_prewarm_counts_and_drains(model):
    eng = _engine(model)
    # seq buckets (16, 32, 64) + {single, grouped} step x t_bucket
    # (None, 32) x 3 sampling variants
    assert eng.prewarm(3, chunk_steps=4) == 3 + 2 * 2 * 3
    assert len(eng._graphs.keys()) == 2 * 2 * 3
    assert eng.metrics.graph_captures == 12
    assert eng.prewarm(3, chunk_steps=4) == 15  # warm already: no capture
    assert eng.metrics.graph_captures == 12
    assert _engine(model).prewarm(3) == 3 + 2 * 3
    cache = eng._cache
    assert (cache.positions == -1).all() and not cache.k.any()


def test_graphs_go_with_their_cache(model):
    """A cache's buffers and graphs are dropped with it: generate at another
    row count replaces the persistent cache, and a batcher's go with it."""
    eng = _engine(model, "paged")
    eng.prewarm(3, chunk_steps=4)
    assert len(eng._graphs) == 1
    eng.generate(PROMPTS[:2], TGen(max_new_tokens=3), chunk_steps=2)
    assert len(eng._graphs) == 1
    assert set(eng._graphs._entries) == {graphs.cache_key(eng._cache)}
    assert eng._cache.positions.shape[0] == 2
    bat = ContinuousBatcher(eng, rows=2, chunk_steps=2)
    bat.prewarm()
    assert len(eng._graphs) == 2
    del bat
    gc.collect()
    assert len(eng._graphs) == 1


def test_no_new_graph_key_after_engine_prewarm(model):
    eng = _engine(model)
    eng.prewarm(3, chunk_steps=4)
    keys, replays = eng._graphs.keys(), eng.metrics.graph_replays
    gens = [TGen(**GENS["greedy"]), TGen(**GENS["sampled"]),
            TGen(max_new_tokens=9, is_greedy=False, seed=3)]
    for chunk in (1, 4):
        eng.generate(PROMPTS, gens, chunk_steps=chunk)
    for g in GENS.values():
        eng.generate_fused(PROMPTS, TGen(**g))
    assert eng._graphs.keys() == keys
    # 8 single steps, 2 chunks of 4, 8 fused steps twice
    assert eng.metrics.graph_replays - replays == 8 + 8 + 2 * 8


@pytest.mark.parametrize("mode", sorted(MODES))
def test_no_new_graph_key_after_batcher_prewarm(model, mode):
    layout, chunked = MODES[mode]
    eng = _engine(model, layout)
    bat = ContinuousBatcher(eng, rows=3, chunk_steps=2, group_chunks=2,
                            chunked_prefill=chunked)
    n = bat.prewarm()
    assert n == (0 if chunked else 3 * 3) + 2 * 3
    keys, captures = eng._graphs.keys(), eng.metrics.graph_captures
    out = {}
    for i, p in enumerate(PROMPTS + [[7] * 30]):
        g = TGen(**GENS["sampled" if i % 2 else "greedy"])
        bat.submit(p, g, lambda t, *a, i=i, **k: out.__setitem__(i, t))
    bat.run_until_idle()
    assert sorted(out) == [0, 1, 2, 3]
    assert eng._graphs.keys() == keys
    assert eng.metrics.graph_captures == captures
    assert eng.metrics.graph_replays > 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batcher_state_keeps_its_addresses(model, mode):
    """Admissions, table uploads, groups and releases write the batcher's
    device state in place: a step graph holds its addresses."""
    layout, chunked = MODES[mode]
    bat = ContinuousBatcher(_engine(model, layout), rows=2, chunk_steps=2,
                            chunked_prefill=chunked)

    def ptrs():
        return ([t.data_ptr() for t in graphs.cache_tensors(bat.cache)]
                + [bat._tokens_dev.data_ptr(), bat._cur_pos_dev.data_ptr()])

    before = ptrs()
    bat.prewarm()
    out = {}
    for i, p in enumerate(PROMPTS):
        bat.submit(p, TGen(max_new_tokens=3 + 2 * i),
                   lambda t, *a, i=i, **k: out.__setitem__(i, t))
    while not bat.idle:
        bat.step()
        assert ptrs() == before
    assert sorted(out) == [0, 1, 2]


def test_persistent_cache_after_poisoned_row(model):
    """A poisoned row leaves NaN in the persistent cache; the next call's
    reset clears it, so the engine gives a fresh engine's tokens."""
    params = {**model[1], "wte": model[1]["wte"].clone()}
    params["wte"][99] = float("nan")
    eng = TEngine(TCfg(**CFG), params, device="cpu", max_seq_len=64)
    gen = TGen(max_new_tokens=8)
    poisoned = []
    eng.generate([PROMPTS[0], [4, 99]], gen, chunk_steps=4,
                 on_poisoned=poisoned.append)
    assert poisoned == [1] and eng._cache.k.isnan().any()
    fresh = TEngine(TCfg(**CFG), params, device="cpu", max_seq_len=64)
    for chunk in (1, 4):
        assert (eng.generate([PROMPTS[1], PROMPTS[2]], gen, chunk_steps=chunk)
                == fresh.generate([PROMPTS[1], PROMPTS[2]], gen,
                                  chunk_steps=chunk))


def test_replays_keep_the_launch_counters():
    """A capture's counted launches are taken back (it launches nothing);
    the kernel nodes read from the graph must match them, and every replay,
    which runs no Python, adds them again."""
    k2, k3 = da.decode_attention.launches, pa.paged_decode_attention.launches

    def capture():  # what a step's Python does while it is captured
        da.decode_attention.launches += 2
        pa.paged_decode_attention.launches += 5

    counted = graphs.counted_capture(capture)
    assert da.decode_attention.launches == k2
    assert sorted(n for _, n in counted) == [2, 5]
    names = (["_ZN5llmss12_GLOBAL__N_110decode_fwdI13__nv_bfloat16Li128ELi1EEEvNS0_4ArgsE"] * 2
             + ["_ZN5llmss12_GLOBAL__N_111split_mergeI13__nv_bfloat16Li128EEEvNS0_9MergeArgsE"] * 2
             + ["_ZN5llmss12_GLOBAL__N_19paged_fwdI13__nv_bfloat16Li128ELi1EEEvNS0_4ArgsE"] * 5
             + ["nvjet_tst_128x8_64x12_4x1_v_bz_NNT"] * 3)
    launches = graphs.node_launches(names, counted)
    assert launches == counted
    replayed = []
    step = graphs.CapturedStep(
        types.SimpleNamespace(replay=lambda: replayed.append(1)), launches)
    step()
    step()
    assert replayed == [1, 1]
    assert da.decode_attention.launches == k2 + 4
    assert pa.paged_decode_attention.launches == k3 + 10


@pytest.mark.parametrize("drop", ["decode_fwd", "paged_fwd"])
def test_node_launches_must_match_the_capture(drop):
    """A step graph that holds fewer of a wrapper's kernels than its capture
    called raises: the replay counts are read from the graph."""
    counted = [(da.decode_attention, 2), (pa.paged_decode_attention, 1)]
    names = ["decode_fwd<bf16>", "decode_fwd<bf16>", "paged_fwd<bf16>"]
    with pytest.raises(RuntimeError, match="captured step graph holds"):
        graphs.node_launches([n for n in names[1:] if drop not in n] + names[:1],
                             counted)


def test_metrics_graph_counters():
    m = EngineMetrics()
    m.add_graph(captures=2)
    m.add_graph(replays=7)
    m.add_graph(replays=1)
    d = m.to_dict()
    assert (d["graph_captures"], d["graph_replays"]) == (2, 8)


@pytest.mark.parametrize("variant", graphs.SAMPLING_VARIANTS)
def test_variant_params_take_their_branch_flags(model, variant):
    sa = _engine(model)._sample_args(variant_params(*variant), 2)
    assert (sa["any_sampled"], sa["needs_filter"]) == variant


def test_step_buffers_load():
    bufs = graphs.StepBuffers(2, 4, torch.device("cpu"))
    bufs.poisoned.fill_(True)
    sa = dict(seeds=torch.tensor([1, 2]), temperature=torch.tensor([.5, 1.]),
              top_k=torch.tensor([0, 3]), top_p=torch.tensor([1., .9]),
              greedy=torch.tensor([True, False]))
    bufs.load(torch.tensor([7, 8]), torch.tensor([3, 4]), sa)
    assert bufs.tokens.tolist() == [7, 8] and bufs.cur_pos.tolist() == [3, 4]
    assert bufs.eos.tolist() == [-1, -1]
    assert not bufs.done.any() and not bufs.poisoned.any()
    assert bufs.top_k.tolist() == [0, 3] and bufs.greedy.tolist() == [True, False]
