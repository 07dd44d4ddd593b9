"""The torch port's model families against the JAX package's, on the CPU.

For each of the nine families (and Phi-3 with LongRoPE) a tiny random
checkpoint is written with ``transformers``' config and model classes
(``save_pretrained``; every weight and bias perturbed, the block and head
weights by N(0, 0.2) so that greedy tokens vary rather than repeat the
prompt's last one); then:

- ``config_from_hf`` of its ``config.json`` (a dict in the port) equals
  the JAX package's, field for field;
- the port's ``load_model(device="cpu", dtype="float32")`` gives exactly
  the tensors of the JAX ``load_model`` on a one-device CPU mesh;
- fp32 prefill logits agree within 1e-4 (only the order of accumulation
  differs), and greedy tokens of the port's ``DecodeEngine`` equal the
  JAX engine's, over the dense ring and over the paged pool.

Phi-3's LongRoPE engine picks its short or long factors from
``max_seq_len`` as the JAX engine does, and a decoder builds its rotary
frequencies once per config and device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.engine.cache import init_cache as jinit_cache
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.registry import MODEL_REGISTRY as JREGISTRY
from llmss_tpu.models.registry import load_model as jax_load_model
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.cache import init_cache as tinit_cache
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.models import decoder as tdec
from llmss_tpu_torch.models.registry import MODEL_REGISTRY, config_from_hf, load_model
from llmss_tpu_torch.weights.loader import read_config

V, E, L, H = 96, 64, 2, 4
CASES = ["gptj", "gpt_bigcode", "gpt2", "llama", "mistral", "qwen2",
         "gpt_neox", "phi3", "phi3_longrope", "gemma"]
PROMPTS = [[5, 9, 23, 40, 7, 1, 88, 3, 14, 60, 2], [17, 4, 33], [50, 51, 52, 6, 8]]
NEW = 10


def _hf_model(case: str):
    """A tiny ``transformers`` model of the case's family."""
    import transformers as tr

    llama_like = dict(vocab_size=V, hidden_size=E, num_hidden_layers=L,
                      num_attention_heads=H, intermediate_size=96,
                      max_position_embeddings=64)
    if case == "gptj":
        return tr.GPTJForCausalLM(tr.GPTJConfig(
            vocab_size=V, n_positions=64, n_embd=E, n_layer=L, n_head=H,
            rotary_dim=8))
    if case == "gpt_bigcode":
        return tr.GPTBigCodeForCausalLM(tr.GPTBigCodeConfig(
            vocab_size=V, n_positions=64, n_embd=E, n_layer=L, n_head=H,
            multi_query=True))
    if case == "gpt2":
        return tr.GPT2LMHeadModel(tr.GPT2Config(
            vocab_size=V, n_positions=64, n_embd=E, n_layer=L, n_head=H))
    if case == "llama":
        return tr.LlamaForCausalLM(tr.LlamaConfig(
            **llama_like, num_key_value_heads=2, tie_word_embeddings=False))
    if case == "mistral":
        # A window shorter than the longest prompt: it clips attention.
        return tr.MistralForCausalLM(tr.MistralConfig(
            **llama_like, num_key_value_heads=2, sliding_window=6,
            tie_word_embeddings=False))
    if case == "qwen2":
        return tr.Qwen2ForCausalLM(tr.Qwen2Config(
            **llama_like, num_key_value_heads=2, tie_word_embeddings=False))
    if case == "gpt_neox":
        return tr.GPTNeoXForCausalLM(tr.GPTNeoXConfig(
            **llama_like, rotary_pct=0.25, use_parallel_residual=True))
    if case == "phi3":
        return tr.Phi3ForCausalLM(tr.Phi3Config(
            **llama_like, num_key_value_heads=2, tie_word_embeddings=False,
            pad_token_id=0))
    if case == "phi3_longrope":
        # Context 64 over an original 32: the long factors by default.
        return tr.Phi3ForCausalLM(tr.Phi3Config(
            **llama_like, num_key_value_heads=2, tie_word_embeddings=False,
            pad_token_id=0, original_max_position_embeddings=32,
            rope_scaling={"type": "longrope",
                          "short_factor": [1.0 + 0.1 * i for i in range(8)],
                          "long_factor": [2.0 + 0.5 * i for i in range(8)]}))
    if case == "gemma":
        # head_dim 32 with 4 heads over a hidden size of 64.
        return tr.GemmaForCausalLM(tr.GemmaConfig(
            **llama_like, num_key_value_heads=1, head_dim=32))
    raise KeyError(case)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """case -> a directory holding its tiny checkpoint."""
    out = {}
    for i, case in enumerate(CASES):
        torch.manual_seed(i)
        model = _hf_model(case).eval()
        with torch.no_grad():
            for name, p in model.named_parameters():
                table = any(t in name for t in ("wte", "wpe", "embed"))
                p.add_(torch.randn_like(p) * (0.02 if table else 0.2))
        d = tmp_path_factory.mktemp(case)
        model.save_pretrained(d, safe_serialization=True)
        out[case] = d
    return out


@pytest.fixture(scope="module")
def loaded(checkpoints, mesh):
    """case -> (JAX cfg, JAX params, port cfg, port params)."""
    out = {}
    for case, d in checkpoints.items():
        jcfg, jparams = jax_load_model(d, mesh, dtype="float32")
        tcfg, tparams = load_model(d, device="cpu", dtype="float32")
        out[case] = (jcfg, jparams, tcfg, tparams)
    return out


def test_registry_holds_the_reference_families():
    assert list(MODEL_REGISTRY) == list(JREGISTRY)
    with pytest.raises(KeyError, match="not supported; have"):
        config_from_hf({"model_type": "bert"})


@pytest.mark.parametrize("case", CASES)
def test_config_equals_jax(case, checkpoints, loaded):
    jcfg, _, tcfg, _ = loaded[case]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert config_from_hf(read_config(checkpoints[case]), "float32") == tcfg
    if case == "gemma":
        assert tcfg.head_dim * tcfg.n_heads != tcfg.hidden_size
    if case == "phi3_longrope":
        assert tcfg.rope_freq_factors == tcfg.rope_freq_factors_long


def _compare(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _compare(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, f"{where}[{i}]")
    elif a is None:
        assert b is None, where
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=where)


@pytest.mark.parametrize("case", CASES)
def test_params_equal_jax_load_model(case, loaded):
    _, jparams, _, tparams = loaded[case]
    _compare(tparams, params_from_jax(jax.device_get(jparams)), case)


@pytest.mark.parametrize("case", CASES)
def test_prefill_logits_match_jax(case, loaded, mesh):
    jcfg, jparams, tcfg, tparams = loaded[case]
    B, S, T = 2, 12, 32
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kvp = np.where(pos < lens[:, None], pos, -1).astype(np.int32)
    kw = dict(n_layers=L, batch=B, max_len=T, n_kv_heads=tcfg.n_kv_heads,
              head_dim=tcfg.head_dim)
    jl, _ = jax.jit(jdec.forward, static_argnums=0)(
        jcfg, jparams, jnp.asarray(ids), jnp.asarray(pos),
        jinit_cache(mesh, dtype=jnp.float32, **kw), jnp.asarray(pos),
        gather_idx=jnp.asarray(lens - 1), kv_write_positions=jnp.asarray(kvp))
    tl, _ = tdec.forward(
        tcfg, tparams, torch.tensor(ids), torch.tensor(pos),
        tinit_cache(dtype=torch.float32, device="cpu", **kw),
        torch.tensor(pos), gather_idx=torch.tensor(lens - 1),
        kv_write_positions=torch.tensor(kvp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("case", CASES)
def test_greedy_tokens_match_jax(case, layout, loaded, mesh):
    jcfg, jparams, tcfg, tparams = loaded[case]
    kw = dict(max_seq_len=32, kv_layout=layout, block_size=8)
    want = JEngine(jcfg, jparams, mesh, **kw).generate(
        PROMPTS, JGen(max_new_tokens=NEW))
    got = TEngine(tcfg, tparams, device="cpu", **kw).generate(
        PROMPTS, TGen(max_new_tokens=NEW), chunk_steps=4)
    assert got == want
    assert [len(o) for o in got] == [NEW] * len(PROMPTS)


@pytest.mark.parametrize("max_seq_len", [24, 48])
def test_longrope_factors_follow_max_seq_len(max_seq_len, loaded, mesh):
    """Original context 32: an engine within it runs the short factors,
    one past it the long ones, as the JAX engine picks them."""
    jcfg, jparams, tcfg, tparams = loaded["phi3_longrope"]
    je = JEngine(jcfg, jparams, mesh, max_seq_len=max_seq_len)
    te = TEngine(tcfg, tparams, device="cpu", max_seq_len=max_seq_len)
    want = (tcfg.rope_freq_factors_long if max_seq_len > 32
            else tcfg.rope_freq_factors_short)
    assert te.cfg.rope_freq_factors == je.cfg.rope_freq_factors == want
    prompts = [p[:8] for p in PROMPTS]
    assert te.generate(prompts, TGen(max_new_tokens=NEW), chunk_steps=4) == (
        je.generate(prompts, JGen(max_new_tokens=NEW)))


def test_rope_tables_are_built_once(loaded, monkeypatch):
    """The engine builds its config's rotary frequencies (LongRoPE's
    factors folded in) at construction; every forward after that reads
    that same tensor and uploads nothing."""
    _, _, tcfg, tparams = loaded["phi3_longrope"]
    eng = TEngine(tcfg, tparams, device="cpu", max_seq_len=48)
    built = tdec.rope_inv_freq(eng.cfg, torch.device("cpu"))
    seen = []
    real = tdec.sin_cos_tables

    def spy(*a, inv_freq=None, **kw):
        seen.append(inv_freq)
        return real(*a, inv_freq=inv_freq, **kw)

    def no_build(*a, **kw):
        raise AssertionError("rotary frequencies rebuilt inside a forward")

    monkeypatch.setattr(tdec, "sin_cos_tables", spy)
    monkeypatch.setattr(tdec, "inv_freq_table", no_build)
    eng.generate(PROMPTS, TGen(max_new_tokens=6), chunk_steps=2)
    eng.generate(PROMPTS, TGen(max_new_tokens=6), chunk_steps=2)
    assert len(seen) > 4 and all(t is built for t in seen)
    torch.testing.assert_close(built, torch.tensor(
        [1.0 / (10000.0 ** (i / 16)) / f for i, f in
         zip(range(0, 16, 2), eng.cfg.rope_freq_factors)],
        dtype=torch.float32))


@pytest.mark.parametrize("case", CASES)
def test_cli_runs_every_family(case, checkpoints, loaded, capsys):
    """The port's CLI loads each family's checkpoint and prints the
    engine's greedy tokens; text prompts (which need a tokenizer) are
    refused with a message."""
    from llmss_tpu_torch.cli.generate import main as cli_main

    _, _, tcfg, tparams = loaded[case]
    d = str(checkpoints[case])
    out = cli_main(["--pretrained_model_path", d, "--device", "cpu",
                    "--dtype", "float32", "--token_ids", "5,9,23,40", "17,4",
                    "--max_new_tokens", "6", "--is_greedy"])
    eng = TEngine(tcfg, tparams, device="cpu", max_seq_len=10)
    assert out == eng.generate([[5, 9, 23, 40], [17, 4]],
                               TGen(max_new_tokens=6))
    assert "continuation ids" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="tokenizer"):
        cli_main(["--pretrained_model_path", d, "--device", "cpu",
                  "--prompts", "Hello"])


@pytest.mark.parametrize("S", [1, 4])
def test_learned_positions_keep_the_references_bounds(S):
    """Positions outside GPT-2 / BigCode's table: a one-token step takes
    ``jnp.take``'s rows (NaN past the table, -1 the last row), a longer
    call the one-hot product's (zero rows), as the JAX decoder embeds."""
    from llmss_tpu.ops.layers import embedding as jembedding

    wpe = np.arange(8, dtype=np.float32).reshape(4, 2)
    pos = np.array([[5, -1, 3, 0]] * 2, np.int32).reshape(-1, S)
    want = jembedding(jnp.asarray(pos), jnp.asarray(wpe), one_hot=S > 1)
    got = tdec._learned_positions(torch.tensor(pos), torch.tensor(wpe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
