"""The torch port's prompt-lookup speculative decoding against the JAX
package, on the CPU: the draft rule (host and device), the window's
deferred-write attention and its mask, the decoder's window forward, one
speculative step, and ``generate_speculative`` token for token (and
``spec_stats``) against the port's own ``generate`` and the JAX engine's
``generate_speculative``, over fp32, int8 and sliding-window models, and
the CLI's ``--speculative``.

Tolerances: 1e-5 on the attention oracles and 1e-4 on logits, since both
sides compute in fp32 and only the order of accumulation differs. Token
streams are compared exactly (the reference asserts the same on its CPU
mesh, tests/test_speculative.py)."""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine import speculative as jspec
from llmss_tpu.engine.cache import KVCache as JKVCache
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.ops.attention import fresh_kv_window_attention as jwindow
from llmss_tpu.ops.attention import window_mask_penalty as jpenalty
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.cli.generate import main as cli_main
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine import speculative as tspec
from llmss_tpu_torch.engine.cache import KVCache as TKVCache
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.models import decoder as tdec
from llmss_tpu_torch.models.common import DecoderConfig as TCfg
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.ops import decode_attention as tda

LLAMA = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
             n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
             max_position_embeddings=64, activation="silu", norm="rmsnorm",
             mlp="swiglu", positions="rotary", rope_style="half",
             attn_bias=False, mlp_bias=False, dtype="float32")
MISTRAL = {**LLAMA, "model_type": "mistral", "sliding_window": 12}
RING = 64


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def models(mesh):
    """name -> (JAX config, JAX params, torch config, torch params)."""
    out = {}
    for name, kw in (("llama", LLAMA), ("mistral", MISTRAL)):
        jp = jdec.init_params(JCfg(**kw), mesh, jax.random.key(0))
        out[name] = (JCfg(**kw), jp, TCfg(**kw),
                     params_from_jax(jax.device_get(jp)))
    return out


@pytest.fixture(scope="module")
def engines(models, mesh):
    """(JAX engine, torch engine) per (model, kv_dtype), made on first use."""
    made = {}

    def get(name="llama", kv=None):
        if (name, kv) not in made:
            jc, jp, tc, tp = models[name]
            made[name, kv] = (
                JEngine(jc, jp, mesh, max_seq_len=RING, kv_dtype=kv),
                TEngine(tc, tp, device="cpu", max_seq_len=RING, kv_dtype=kv))
        return made[name, kv]

    return get


# -- the draft rule -----------------------------------------------------------


@pytest.mark.parametrize("hist, gamma, ngram", [
    ([1, 4, 5, 6, 7, 8, 2, 4, 5, 6], 2, 3),  # a 3-gram hit
    ([1, 2, 3], 3, 3),  # no match: the last token repeated
    ([9, 2, 7, 2], 3, 3),  # a 1-gram hit, continuation padded
    ([5], 2, 3),  # a one-token history
    ([3, 1, 3, 1, 3], 4, 2),  # a periodic tail overlapping itself
])
def test_lookup_draft_matches_jax(hist, gamma, ngram):
    assert tspec.lookup_draft(hist, gamma, ngram) == jspec.lookup_draft(
        hist, gamma, ngram)


def test_device_draft_matches_host_and_jax():
    """200 fuzzed histories, padded with garbage past their length: the
    batched device draft equals the host rule and the reference's
    ``_device_draft`` row by row, padding path included."""
    rng = np.random.default_rng(7)
    H = 32
    by_shape: dict = {}
    for _ in range(200):
        L = int(rng.integers(1, H + 1))
        vocab = int(rng.integers(2, 6))  # tiny vocab: frequent n-gram hits
        row = np.full(H, 99, np.int32)
        row[:L] = rng.integers(0, vocab, L)
        key = (int(rng.integers(1, 6)), int(rng.integers(1, 4)))
        by_shape.setdefault(key, []).append((row, L))
    for (gamma, ngram), rows in sorted(by_shape.items()):
        hist = np.stack([r for r, _ in rows])
        lens = np.asarray([n for _, n in rows], np.int32)
        got = tspec.device_draft(torch.tensor(hist), torch.tensor(lens),
                                 gamma, ngram).numpy().tolist()
        jfn = jax.jit(partial(jspec._device_draft, gamma=gamma, ngram=ngram))
        for i, (row, n) in enumerate(rows):
            want = tspec.lookup_draft(row[:n].tolist(), gamma, ngram)
            assert got[i] == want, (row[:n].tolist(), gamma, ngram)
            assert np.asarray(jfn(jnp.asarray(row), jnp.int32(n))).tolist() \
                == want


# -- the window's attention ---------------------------------------------------


def _window_case(Hq, Hkv, S, cur, T=24, D=16, holes=(), seed=0):
    """q / fresh KV of an S-token window per row at positions cur[b] ..,
    over a stale ring holding positions 0 .. cur[b]-1 at slot p % T (the
    latest kept on a wrap), with ``holes`` (row, slot) invalidated."""
    rng = np.random.default_rng(seed)
    B = len(cur)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(cur):
        for p in range(n):
            kvp[b, p % T] = p
    for b, t in holes:
        kvp[b, t] = -1
    q0 = np.asarray(cur, np.int32)[:, None]
    slots = ((q0 + np.arange(S)) % T).astype(np.int32)
    return dict(q=f(B, S, Hq, D), kc=f(2, B, T, Hkv, D), vc=f(2, B, T, Hkv, D),
                kn=f(B, S, Hkv, D), vn=f(B, S, Hkv, D), kvp=kvp, q0=q0,
                slots=slots)


WINDOW_CASES = {
    "mha": dict(Hq=4, Hkv=4, S=5, cur=[10, 3]),
    "gqa_wrap": dict(Hq=4, Hkv=2, S=4, cur=[22, 40]),  # the windows wrap
    "mqa_holes": dict(Hq=6, Hkv=1, S=8, cur=[15, 0], holes=((0, 2), (0, 9))),
    "s2_gqa": dict(Hq=8, Hkv=2, S=2, cur=[1, 23], holes=((1, 22),)),
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_window_attention_matches_jax(name):
    """``window_mask_penalty`` and ``fresh_kv_window_attention`` (and K2w's
    plain twin over the stacked cache, layer 1) against the reference's
    XLA oracles: GQA / MQA, ring wrap, -1 slots and an empty row."""
    c = _window_case(**WINDOW_CASES[name])
    T = c["kvp"].shape[1]
    for t in (T, 16):
        jpen = jpenalty(jnp.asarray(c["q0"]),
                                        jnp.asarray(c["kvp"][:, :t]),
                                        jnp.asarray(c["slots"]))
        tpen = tatt.window_mask_penalty(torch.tensor(c["q0"]),
                                        torch.tensor(c["kvp"][:, :t]),
                                        torch.tensor(c["slots"]))
        np.testing.assert_array_equal(tpen.numpy(), np.asarray(jpen))
        want = np.asarray(jwindow(
            jnp.asarray(c["q"]), jnp.asarray(c["kc"][1, :, :t]),
            jnp.asarray(c["vc"][1, :, :t]), jnp.asarray(c["kn"]),
            jnp.asarray(c["vn"]), jpen))
        got = tatt.fresh_kv_window_attention(
            torch.tensor(c["q"]), torch.tensor(c["kc"][1, :, :t]),
            torch.tensor(c["vc"][1, :, :t]), torch.tensor(c["kn"]),
            torch.tensor(c["vn"]), tpen)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        via = tatt.decode_window_attention(
            *(torch.tensor(c[k]) for k in ("q", "kc", "vc", "kn", "vn", "q0",
                                           "kvp", "slots")), 1, t_len=t)
        np.testing.assert_allclose(via.numpy(), want, atol=1e-5, rtol=1e-5)


def test_window_plan_layout():
    """K2w is laid out over G * S query rows per KV head: bf16 on the
    window tile (16 rows a row warp, its splits one cluster of at most 8,
    from gamma 1 at MHA up), fp32 / fp16 on the lanes (GB rows a block)."""
    bf16, sp = torch.bfloat16, tda.sp
    p = tda.window_plan(bf16, 16, 32, 32, 128, 384, 5)  # Llama-2-7B, gamma 4
    assert p.impl == "mma" and (p.splits, p.split_slots) == (
        tda.window_tile_split(16 * 32, 384, p.smem, sp.H100_SMS,
                              sp.MAX_SPLITS))
    assert (p.rows, p.slot_warps, p.cluster) == (16, 4, p.splits)
    p = tda.window_plan(bf16, 16, 32, 32, 128, 384, 2)  # gamma 1
    assert (p.impl, p.rows) == ("mma", 16)
    assert tda.window_plan(bf16, 4, 28, 4, 128, 384, 5).rows == 48
    assert tda.window_plan(bf16, 4, 48, 1, 128, 384, 2).rows == 64
    p = tda.window_plan(torch.float32, 4, 48, 1, 128, 384, 2)
    assert p.impl == "lanes" and p.rows == tda._heads_per_block(96) == 8
    assert (p.splits, p.split_slots) == sp.split_plan(
        4, 12, 384, step=sp.lane_step(128), sms=sp.H100_SMS)
    assert tda.window_plan(torch.float16, 4, 32, 32, 128, 384, 8).impl == "lanes"


# -- the decoder's window forward ---------------------------------------------


def _ring_state(tc, B, T, cur, seed=0, holes=()):
    """A stale fp32 ring (numpy) for rows whose positions 0 .. cur[b]-1
    were written at slot p % T, with ``holes`` invalidated."""
    rng = np.random.default_rng(seed)
    shape = (tc.n_layers, B, T, tc.n_kv_heads, tc.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    kvp = np.full((B, T), -1, np.int32)
    for b, n in enumerate(cur):
        for p in range(n):
            kvp[b, p % T] = p
    for b, t in holes:
        kvp[b, t] = -1
    return k, v, kvp


def _caches(k, v, kvp):
    return (JKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kvp)),
            TKVCache(torch.tensor(k), torch.tensor(v), torch.tensor(kvp)))


@pytest.mark.parametrize("S", range(2, 9))
def test_window_forward_matches_jax(models, S):
    """An S-token window per row over a ring with history (one row
    wrapping the ring, one with invalidated slots, one bucketed read):
    logits of every window token, and the ring and positions after the
    one deferred write, equal the reference's window-defer path."""
    jc, jp, tc, tp = models["llama"]
    B, T = 3, 48
    jfwd = jax.jit(partial(jdec.forward, jc), static_argnames=("t_bucket",))
    for cur, tb in (([10, T - 3, 20], None), ([10, 5, 14], 32)):
        k, v, kvp = _ring_state(tc, B, T, cur, seed=S,
                                holes=((2, 4), (2, 11)))
        jcache, tcache = _caches(k, v, kvp)
        rng = np.random.default_rng(S)
        ids = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)
        pos = (np.asarray(cur)[:, None] + np.arange(S)).astype(np.int32)
        slots = pos % T
        jl, jcache = jfwd(jp, jnp.asarray(ids), jnp.asarray(pos), jcache,
                          jnp.asarray(slots), t_bucket=tb)
        tl, _ = tdec.forward(tc, tp, torch.tensor(ids), torch.tensor(pos),
                             tcache, torch.tensor(slots), t_bucket=tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(tcache.positions.numpy(),
                                      np.asarray(jcache.positions))
        for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_spec_step_matches_jax(models, mesh):
    """One speculative step from the same state (a repetitive row, a random
    row, a done row): choices, emits, history, lengths, done flags, ring
    and positions equal ``spec_step_impl``'s."""
    jc, jp, tc, tp = models["llama"]
    B, H, gamma = 3, RING, 3
    rng = np.random.default_rng(3)
    hist = np.zeros((B, H), np.int32)
    lens = np.asarray([12, 9, 6], np.int32)
    hist[0, :12] = [7, 3, 9] * 4
    hist[1, :9] = rng.integers(1, 64, 9)
    hist[2, :6] = rng.integers(1, 64, 6)
    k, v, kvp = _ring_state(tc, B, H, (lens - 1).tolist(), seed=4)
    done = np.asarray([False, False, True])
    eos = np.full(B, -1, np.int32)
    jcache, tcache = _caches(k, v, kvp)
    jstep = jax.jit(partial(jspec.spec_step_impl, jc, mesh, gamma=gamma))
    jch, jne, jh, jhl, jcache, jdone = jstep(
        jp, jnp.asarray(hist), jnp.asarray(lens), jcache, jnp.asarray(done),
        jnp.asarray(eos))
    th, thl, tdone = torch.tensor(hist), torch.tensor(lens), torch.tensor(done)
    tch, tne = tspec.spec_step(tc, tp, th, thl, tcache, tdone,
                               torch.tensor(eos), gamma=gamma)
    for got, want in ((tch, jch), (tne, jne), (th, jh), (thl, jhl),
                      (tdone, jdone), (tcache.positions, jcache.positions)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5)


# -- generate_speculative -----------------------------------------------------


def _both(engines, prompts, gen_kw, name="llama", kv=None, **kw):
    """(port speculative, port generate, JAX speculative) tokens, and the
    two engines' spec_stats."""
    je, te = engines(name, kv)
    spec = te.generate_speculative(prompts, TGen(**gen_kw), **kw)
    t_stats = te.metrics.spec_stats
    plain = te.generate(prompts, TGen(**gen_kw))
    jax_spec = je.generate_speculative(prompts, JGen(**gen_kw), **kw)
    return spec, plain, jax_spec, t_stats, je.metrics.spec_stats


def _prompts():
    rng = np.random.default_rng(0)
    return [[7, 3, 9, 7, 3, 9, 7, 3, 9, 7, 3],  # repetitive: hits
            rng.integers(1, 64, 10).tolist(),  # random: mostly misses
            [5]]


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_generate_speculative_matches_generate_and_jax(engines, gamma):
    spec, plain, jax_spec, ts, js = _both(
        engines, _prompts(), dict(max_new_tokens=20), gamma=gamma)
    assert spec == plain == jax_spec
    assert ts == js and ts["tokens_via_speculation"] > 0


def test_eos_mid_draft_and_mixed_lengths(engines):
    """EOS lands inside drafts; rows finish at different steps."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 64, n).tolist() for n in (4, 9, 2, 13)]
    _, te = engines()
    row0 = te.generate(prompts, TGen(max_new_tokens=24))[0]
    eos = int(row0[len(row0) // 2])
    spec, plain, jax_spec, ts, js = _both(
        engines, prompts, dict(max_new_tokens=24, eos_token_id=eos), gamma=4)
    assert spec == plain == jax_spec and ts == js
    assert min(len(o) for o in spec) < 24


@pytest.mark.parametrize("prompt, new, speculated", [
    ([3, 1, 4, 1, 5] * 8, 23, True),  # 40 of 64 slots: the plain tail ends it
    ([3, 1, 4, 1] * 16, 4, False),  # the prompt fills the ring: generate
])
def test_near_ring_capacity(engines, prompt, new, speculated):
    spec, plain, jax_spec, ts, js = _both(
        engines, [prompt], dict(max_new_tokens=new), gamma=4)
    assert spec == plain == jax_spec and ts == js
    assert (ts["verify_forwards"] > 0) == speculated


def test_sampled_requests_are_refused(engines):
    _, te = engines()
    with pytest.raises(ValueError, match="greedy"):
        te.generate_speculative([[1, 2]], TGen(max_new_tokens=4,
                                               is_greedy=False,
                                               temperature=0.8))


def test_stats_reset_between_calls(engines):
    _, te = engines()
    gen = TGen(max_new_tokens=8)
    te.generate_speculative([[7, 3, 9] * 4], gen, gamma=2)
    assert te.metrics.spec_stats["verify_forwards"] > 0
    assert te.metrics.to_dict()["speculative"] == te.metrics.spec_stats
    te.generate_speculative([[3, 1, 4, 1] * 16], gen, gamma=4)
    assert te.metrics.spec_stats["verify_forwards"] == 0


@pytest.mark.parametrize("name, kv", [("llama", "int8"), ("mistral", None)])
def test_general_path_models(engines, name, kv):
    """An int8 cache and a sliding-window model verify through the general
    (write-first, K1) path, as in the reference; same tokens and stats."""
    spec, plain, jax_spec, ts, js = _both(
        engines, _prompts(), dict(max_new_tokens=16), name=name, kv=kv,
        gamma=3)
    assert spec == plain == jax_spec and ts == js


def test_prewarm_speculative_captures_nothing_later(engines):
    """``prewarm(speculative=)`` warms the speculative step at every bucket
    and the plain tail's grouped step: a later call adds no step key (on
    the CPU a capture records its key)."""
    _, te = engines()
    n = te.prewarm(2, speculative=(2,))
    buckets = len(te.prewarm_bucket_set())
    assert n == len(te.seq_buckets()) + 3 * buckets * 2 + buckets
    keys = te._graphs.keys()
    assert sum(k[-5] == "spec" for k in keys) == buckets
    te.generate_speculative([[3, 1, 4, 1, 5] * 8, [7, 7]],
                            TGen(max_new_tokens=23), gamma=2)
    assert te._graphs.keys() == keys


def test_capture_between_groups(models, engines):
    """A step graph first met between groups (the rows crossed into a new
    t_bucket) is captured as on the card: its body runs once for real and
    the carried buffers are restored. That run must record at step 0 of
    the group, not past the last group's end; the tokens stay
    ``generate``'s."""
    _, _, tc, tp = models["llama"]
    te = TEngine(tc, tp, device="cpu", max_seq_len=RING)

    def capture(body, carry):
        saved = [t.clone() for t in carry]
        body()
        for t, s in zip(carry, saved):
            t.copy_(s)
        return None

    te._graphs._capture = capture
    prompts = [[7, 3, 9] * 3, [5, 2]]
    gen = TGen(max_new_tokens=40)
    spec = te.generate_speculative(prompts, gen, gamma=1)
    buckets = {k[-1] for k in te._graphs.keys() if k[-5] == "spec"}
    assert len(buckets) > 1, buckets
    assert te.metrics.spec_stats["verify_forwards"] > 8
    assert spec == engines()[1].generate(prompts, gen)


# -- the CLI ------------------------------------------------------------------


def _checkpoint(path):
    g = torch.Generator().manual_seed(0)
    E, I, V, Lc, H, Hkv = 64, 96, 128, 2, 4, 2
    KV = E // H * Hkv

    def w(*s):
        return torch.randn(s, generator=g) * 0.05

    t = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E),
         "lm_head.weight": w(V, E)}
    for i in range(Lc):
        p = f"model.layers.{i}"
        t.update({
            f"{p}.input_layernorm.weight": 1 + w(E),
            f"{p}.post_attention_layernorm.weight": 1 + w(E),
            f"{p}.self_attn.q_proj.weight": w(E, E),
            f"{p}.self_attn.k_proj.weight": w(KV, E),
            f"{p}.self_attn.v_proj.weight": w(KV, E),
            f"{p}.self_attn.o_proj.weight": w(E, E),
            f"{p}.mlp.gate_proj.weight": w(I, E),
            f"{p}.mlp.up_proj.weight": w(I, E),
            f"{p}.mlp.down_proj.weight": w(E, I),
        })
    save_file(t, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "architectures": ["LlamaForCausalLM"],
        "vocab_size": V, "hidden_size": E, "num_hidden_layers": Lc,
        "num_attention_heads": H, "num_key_value_heads": Hkv,
        "intermediate_size": I, "max_position_embeddings": 64,
        "hidden_act": "silu", "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "torch_dtype": "float32"}))


def _cli(path, *extra):
    return cli_main(["--pretrained_model_path", str(path), "--device", "cpu",
                     "--dtype", "float32", "--token_ids", "1,2,3,1,2,3,1",
                     "9,8", "--max_new_tokens", "12", "--max_seq_len", "64",
                     *extra])


def test_cli_speculative_same_ids(tmp_path, capsys):
    _checkpoint(tmp_path)
    plain = _cli(tmp_path, "--is_greedy")
    spec = _cli(tmp_path, "--is_greedy", "--speculative", "3")
    assert spec == plain
    assert "tok/verify" in capsys.readouterr().out.splitlines()[-1]


@pytest.mark.parametrize("flags, msg", [
    (("--speculative", "3"), "requires --is_greedy"),
    (("--speculative", "-1", "--is_greedy"), "must be >= 0"),
])
def test_cli_speculative_refusals(tmp_path, flags, msg):
    with pytest.raises(SystemExit, match=msg):
        _cli(tmp_path, *flags)
