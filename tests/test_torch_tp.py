"""The dense engine on a mesh against the JAX package's, on the CPU.

Three tiny fp32 families: llama (GQA, 4 KV heads), gpt_bigcode (MQA with
learned positions: its one KV head replicates) and gpt2 (a tied head and
an uneven vocabulary and position table, padded per rank). The JAX
reference runs on the conftest's virtual devices, ``DecodeEngine`` on
``make_mesh(MeshPlan(dp=2, sp=2, tp=2))`` (gpt2 with tp 1: the
reference's ``init_params`` refuses a vocabulary that tp does not divide)
over ``init_params(cfg, mesh, key)``; the port gets the same weights
(``params_from_jax``), and each rank its ``shard_params`` slice, on gloo
worlds spawned once per size: plans tp 2, sp 2 and dp 2 on two ranks, tp 4
on four, dp 2 x sp 2 x tp 2 on eight. Held: greedy and seeded-sampled
tokens (one batch mixing both, ``chunk_steps`` 1 and 4, and
``generate_fused``) equal the reference's on every rank, and the prefill's
first-token logits within 1e-4 relative (1e-6 absolute: only the order of
fp32 sums differs). Then the refusals, and sharded loading: each family's
tiny checkpoint read by a rank's coordinates alone equals ``shard_params``
of the whole load."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JConfig
from llmss_tpu.parallel import MeshPlan as JPlan
from llmss_tpu.parallel import make_mesh as jmake_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.registry import load_model
from llmss_tpu_torch.parallel import Mesh
from llmss_tpu_torch.parallel.launch import (
    EngineJob, World, engine_jobs, file_init, gather_logits,
)
from llmss_tpu_torch.parallel.sharding import shard_params

FAMILIES = {
    "llama": dict(model_type="llama", vocab_size=128, hidden_size=64,
                  n_layers=2, n_heads=8, n_kv_heads=4, head_dim=8,
                  intermediate_size=128, max_position_embeddings=128,
                  activation="silu", norm="rmsnorm", mlp="swiglu",
                  positions="rotary", rope_style="half", rotary_dim=8,
                  attn_bias=False, mlp_bias=False,
                  tie_word_embeddings=False, dtype="float32"),
    "gpt_bigcode": dict(model_type="gpt_bigcode", vocab_size=128,
                        hidden_size=64, n_layers=2, n_heads=8, n_kv_heads=1,
                        head_dim=8, intermediate_size=128,
                        max_position_embeddings=64, activation="gelu",
                        norm="layernorm", mlp="gelu", positions="learned",
                        attn_bias=True, mlp_bias=True,
                        tie_word_embeddings=True, dtype="float32"),
    "gpt2": dict(model_type="gpt2", vocab_size=129, hidden_size=64,
                 n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
                 intermediate_size=128, max_position_embeddings=67,
                 activation="gelu_new", norm="layernorm", mlp="gelu",
                 positions="learned", attn_bias=True, mlp_bias=True,
                 tie_word_embeddings=True, dtype="float32"),
}
PROMPTS = [list(range(1, 30)), [7, 8, 9], [5] * 17, [3, 1, 4, 1, 5]]
GENS = [dict(max_new_tokens=6), dict(max_new_tokens=6, is_greedy=False,
                                     seed=3, top_k=20),
        dict(max_new_tokens=5), dict(max_new_tokens=6, is_greedy=False,
                                     seed=9, top_p=0.9)]
FUSED = dict(max_new_tokens=5)  # greedy: rows 0 and 2 of GENS' tokens
GREEDY_ROWS = (0, 2)
MAX_SEQ = 64
PLANS = {2: [(1, 1, 2), (1, 2, 1), (2, 1, 1)], 4: [(1, 1, 4)],
         8: [(2, 2, 2)]}
LOGITS_RTOL, LOGITS_ATOL = 1e-4, 1e-6


def _jobs(ported, plans):
    gens = [GenerationParams(**g) for g in GENS]
    return [EngineJob(cfg=cfg, plan=plan, prompts=PROMPTS, params=params,
                      max_seq_len=MAX_SEQ,
                      runs=[("generate", gens, 1), ("generate", gens, 4),
                            ("fused", GenerationParams(**FUSED))])
            for plan in plans for cfg, params in ported.values()]


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """(reference, worlds): family -> (JAX tokens, JAX first-token
    logits), from the JAX engine on the virtual devices; (plan, family)
    -> every rank's ``engine_job`` result. The worlds run while the
    reference compiles."""
    jax_side, ported = {}, {}
    for i, (fam, kw) in enumerate(FAMILIES.items()):
        cfg = JConfig(**kw)
        tp = 2 if kw["vocab_size"] % 2 == 0 else 1
        jmesh = jmake_mesh(JPlan(dp=2, sp=2, tp=tp),
                           devices=devices[:4 * tp])
        # Scaled past the init's 0.02, so that tokens vary.
        params = jax.tree.map(lambda x: x * 10.0, jdec.init_params(
            cfg, jmesh, jax.random.key(i)))
        jax_side[fam] = (cfg, jmesh, params)
        ported[fam] = (DecoderConfig(**kw),
                       params_from_jax(jax.device_get(params)))
    d = tmp_path_factory.mktemp("tp")
    started = {size: World(engine_jobs, size, _jobs(ported, plans),
                           init_method=file_init(d / f"rdv{size}"))
               for size, plans in PLANS.items()}
    reference = {}
    for fam, (cfg, jmesh, params) in jax_side.items():
        eng = JEngine(cfg, params, jmesh, max_seq_len=MAX_SEQ)
        toks = eng.generate(PROMPTS, [JGen(**g) for g in GENS])
        ids, lens = eng._pad_prompts(PROMPTS)
        _, logits, _ = eng._prefill(
            eng.params, jnp.asarray(ids), eng.new_cache(len(PROMPTS)),
            jnp.asarray(lens), eng._sample_args(JGen(), len(PROMPTS)))
        reference[fam] = (toks, np.asarray(logits))
    worlds = {}
    for size, plans in PLANS.items():
        res = started[size].results()
        i = 0
        for plan in plans:
            for fam in FAMILIES:
                worlds[plan, fam] = [r[i] for r in res]
                i += 1
    return reference, worlds


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[1]


ALL = [(plan, fam) for plans in PLANS.values() for plan in plans
       for fam in FAMILIES]


def _id(case):
    (dp, sp, tp), fam = case
    return f"dp{dp}_sp{sp}_tp{tp}-{fam}"


@pytest.mark.parametrize("case", ALL, ids=_id)
def test_tokens_equal_jax_on_every_rank(case, worlds, reference):
    ranks = worlds[case]
    toks = reference[case[1]][0]
    for r in ranks:
        assert r["runs"][0] == toks, r["coords"]
        assert r["runs"][1] == toks, r["coords"]
        # generate_fused, greedy: the greedy rows' tokens.
        for row in GREEDY_ROWS:
            assert r["runs"][2][row] == toks[row][:FUSED["max_new_tokens"]]


@pytest.mark.parametrize("case", ALL, ids=_id)
def test_first_token_logits_match_jax(case, worlds, reference):
    want = reference[case[1]][1]
    got = gather_logits(worlds[case], len(PROMPTS))
    np.testing.assert_allclose(got, want, rtol=LOGITS_RTOL,
                               atol=LOGITS_ATOL * np.abs(want).max())


@pytest.mark.parametrize("case", ALL, ids=_id)
def test_plan_used_its_axes(case, worlds):
    """Each rank held its slice (weights split over tp), the gloo mesh
    captured no graph, and sp plans took the ring / LSE-merge path."""
    (dp, sp, tp), fam = case
    ranks = worlds[case]
    assert sorted((r["coords"]["dp"], r["coords"]["sp"], r["coords"]["tp"])
                  for r in ranks) == sorted(
        (a, b, c) for a in range(dp) for b in range(sp) for c in range(tp))
    sizes = {r["weight_bytes"] for r in ranks}
    assert len(sizes) == 1
    assert all(r["captures_after_prewarm"] == 0 for r in ranks)
    assert all(r["host_staging"]["calls"] == 0 for r in ranks)  # CPU


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_ring_prefill_passes_each_block_once(fam, worlds):
    """On the sp-only plan each prefill sends its fresh KV once round the
    ring (K, V and their positions: three ppermutes a layer, one hop at sp
    2) and gathers nothing: no cache chunk travels, and no rank's fresh
    KV goes out twice. The decode steps merge states (a pmax and two
    psums a layer); each prefill's last hidden state comes from the rank
    that holds it (one psum)."""
    L, prefills = FAMILIES[fam]["n_layers"], 3  # one for each of _jobs' runs
    for r in worlds[(1, 2, 1), fam]:
        n = r["collectives"]
        assert n["all_gather"] == 0
        assert n["ppermute"] == prefills * L * 3
        assert n["pmax"] > 0 and n["psum"] == 2 * n["pmax"] + prefills


def test_tp_halves_the_weights(worlds):
    full = worlds[(1, 2, 1), "llama"][0]["weight_bytes"]
    half = worlds[(1, 1, 2), "llama"][0]["weight_bytes"]
    quarter = worlds[(1, 1, 4), "llama"][0]["weight_bytes"]
    assert half < 0.6 * full and quarter < 0.35 * full


def _engine(cfg, plan, **kw):
    params = shard_params(REF_PARAMS(cfg), cfg, Mesh.local(plan))
    return DecodeEngine(cfg, params, mesh=Mesh.local(plan), max_seq_len=64,
                        **kw)


def REF_PARAMS(cfg):
    from llmss_tpu_torch.models.decoder import init_params

    return init_params(cfg, seed=0, device="cpu")


def test_refusals_name_the_plan_or_the_next_slice():
    """``Hkv % tp`` with more than one KV head raises naming the head
    plan; the paged layout, speculative decoding, shared prefixes and an
    int8 cache under sp on a mesh of more than one rank raise
    ``NotImplementedError`` naming the next mesh slice."""
    cfg = dataclasses.replace(DecoderConfig(**FAMILIES["llama"]), n_heads=12,
                              n_kv_heads=6, hidden_size=96)
    with pytest.raises(ValueError, match="tp_head_plan"):
        DecodeEngine(cfg, REF_PARAMS(cfg), mesh=Mesh.local((1, 1, 4)))
    cfg = DecoderConfig(**FAMILIES["llama"])
    with pytest.raises(NotImplementedError, match="next mesh slice"):
        _engine(cfg, (1, 1, 2), kv_layout="paged")
    with pytest.raises(NotImplementedError, match="next mesh slice"):
        _engine(cfg, (1, 2, 1), kv_dtype="int8")
    eng = _engine(cfg, (1, 1, 2))
    with pytest.raises(NotImplementedError, match="next mesh slice"):
        eng.generate_speculative([[1, 2, 3]], GenerationParams())
    with pytest.raises(NotImplementedError, match="next mesh slice"):
        eng.build_prefix([1, 2, 3])
    # One rank: nothing to refuse.
    assert _engine(cfg, (1, 1, 1), kv_layout="paged").mesh.world == 1


def _hf_model(fam: str):
    """A tiny ``transformers`` model of each family (heads that tp 2
    splits; GPT-2 with an odd vocabulary)."""
    import transformers as tr

    ll = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=96,
              max_position_embeddings=64)
    return {
        "gptj": lambda: tr.GPTJForCausalLM(tr.GPTJConfig(
            vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            rotary_dim=8)),
        "gpt_bigcode": lambda: tr.GPTBigCodeForCausalLM(tr.GPTBigCodeConfig(
            vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
            multi_query=True)),
        "gpt2": lambda: tr.GPT2LMHeadModel(tr.GPT2Config(
            vocab_size=97, n_positions=63, n_embd=64, n_layer=2, n_head=4)),
        "llama": lambda: tr.LlamaForCausalLM(tr.LlamaConfig(
            **ll, num_key_value_heads=2, tie_word_embeddings=False)),
        "mistral": lambda: tr.MistralForCausalLM(tr.MistralConfig(
            **ll, num_key_value_heads=2, tie_word_embeddings=False)),
        "qwen2": lambda: tr.Qwen2ForCausalLM(tr.Qwen2Config(
            **ll, num_key_value_heads=2, tie_word_embeddings=False)),
        "gpt_neox": lambda: tr.GPTNeoXForCausalLM(tr.GPTNeoXConfig(
            **ll, rotary_pct=0.25, use_parallel_residual=True)),
        "phi3": lambda: tr.Phi3ForCausalLM(tr.Phi3Config(
            **ll, num_key_value_heads=2, tie_word_embeddings=False,
            pad_token_id=0)),
        "gemma": lambda: tr.GemmaForCausalLM(tr.GemmaConfig(
            **ll, num_key_value_heads=1, head_dim=16)),
    }[fam]()


@pytest.mark.parametrize("fam", ["gptj", "gpt_bigcode", "gpt2", "llama",
                                 "mistral", "qwen2", "gpt_neox", "phi3",
                                 "gemma"])
def test_sharded_load_reads_the_ranks_slices(fam, tmp_path):
    """``load_model(mesh=)`` with a rank's coordinates only (no process
    group) equals ``shard_params`` of the whole load, every tensor, at tp
    2 and 4 (fused sub-ranges sliced per sub-range; GPT-2's 97-row
    vocabulary and 63-row position table padded)."""
    torch.manual_seed(0)
    _hf_model(fam).save_pretrained(tmp_path, safe_serialization=True)
    cfg, full = load_model(tmp_path, device="cpu", dtype="float32")
    for tp in (2, 4):
        if cfg.n_heads % tp or (cfg.n_kv_heads % tp and cfg.n_kv_heads > 1):
            continue
        for r in range(tp):
            mesh = Mesh.local((1, 1, tp), (0, 0, r))
            _, mine = load_model(tmp_path, dtype="float32", mesh=mesh)
            want = shard_params(full, cfg, mesh)
            flat = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda t: t.numpy(), want))
            got = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda t: t.numpy(), mine))
            assert len(flat) == len(got)
            for a, b in zip(got, flat):
                np.testing.assert_array_equal(a, b)
