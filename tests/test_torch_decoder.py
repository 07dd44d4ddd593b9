"""The torch port's decoder against the JAX package's ``forward``, on the
CPU in fp32: prefill of right-padded prompts, then decode steps with a
bucketed cache read and a ring wrap. Parameters come from the JAX
``init_params`` through ``convert.params_from_jax``.

Tolerance 1e-4 on logits: both sides compute in fp32, and only the order of
accumulation in the matmuls and softmax sums differs."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmss_tpu.engine.cache import init_cache as jinit_cache
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.cache import init_cache as tinit_cache
from llmss_tpu_torch.models import decoder as tdec
from llmss_tpu_torch.models.common import DecoderConfig as TCfg

BASE = dict(vocab_size=96, hidden_size=64, n_layers=2, head_dim=16,
            intermediate_size=96, max_position_embeddings=128, dtype="float32")
CONFIGS = {
    # Llama: GQA, RMSNorm, SwiGLU, half-style rotary.
    "llama_gqa": dict(model_type="llama", n_heads=4, n_kv_heads=2,
                      activation="silu", norm="rmsnorm", mlp="swiglu",
                      positions="rotary", rope_style="half", attn_bias=False,
                      mlp_bias=False),
    # Mistral-style sliding window on the llama structure.
    "llama_window": dict(model_type="mistral", n_heads=4, n_kv_heads=2,
                         activation="silu", norm="rmsnorm", mlp="swiglu",
                         positions="rotary", rope_style="half",
                         attn_bias=False, mlp_bias=False, sliding_window=12),
    # GPT-J: parallel residual, interleaved partial rotary, biased head.
    "gptj": dict(model_type="gptj", n_heads=4, n_kv_heads=4,
                 activation="gelu_new", norm="layernorm", mlp="mlp",
                 positions="rotary", rope_style="interleaved", rotary_dim=8,
                 parallel_residual=True, attn_bias=False, head_bias=True),
    # GPT-BigCode: MQA, learned positions, tied head, biases.
    "bigcode": dict(model_type="gpt_bigcode", n_heads=4, n_kv_heads=1,
                    activation="gelu_new", norm="layernorm", mlp="mlp",
                    positions="learned", tie_word_embeddings=True),
    # GPT-2: MHA, learned positions, tied head, biases everywhere.
    "gpt2": dict(model_type="gpt2", n_heads=4, n_kv_heads=4,
                 activation="gelu_new", norm="layernorm", mlp="mlp",
                 positions="learned", tie_word_embeddings=True),
    # Qwen2: q/k/v biases without an o bias on the llama structure.
    "qwen2": dict(model_type="qwen2", n_heads=4, n_kv_heads=2,
                  activation="silu", norm="rmsnorm", mlp="swiglu",
                  positions="rotary", rope_style="half", attn_bias=True,
                  attn_out_bias=False, mlp_bias=False),
    # GPT-NeoX: parallel residual with a second norm, partial half-style
    # rotary (rotary_pct 0.25 of head_dim 16).
    "gpt_neox": dict(model_type="gpt_neox", n_heads=4, n_kv_heads=4,
                     activation="gelu", norm="layernorm", mlp="mlp",
                     positions="rotary", rope_style="half", rotary_dim=4,
                     parallel_residual=True, parallel_residual_ln2=True),
    # Phi-3 LongRoPE: per-frequency divisors and the attention factor.
    "phi3_longrope": dict(model_type="phi3", n_heads=4, n_kv_heads=2,
                          activation="silu", norm="rmsnorm", mlp="swiglu",
                          positions="rotary", rope_style="half",
                          rotary_dim=16, attn_bias=False, mlp_bias=False,
                          rope_freq_factors=tuple(1.0 + 0.7 * i
                                                  for i in range(8)),
                          rope_attn_factor=1.19),
    # Gemma: (1 + w) RMSNorm, embeddings times sqrt(hidden), head_dim 32
    # over a hidden size of 64 with 4 heads, tied head.
    "gemma": dict(model_type="gemma", n_heads=4, n_kv_heads=1, head_dim=32,
                  activation="gelu_pytorch_tanh", norm="rmsnorm",
                  norm_scale_offset=1.0, embed_multiplier=8.0, mlp="swiglu",
                  positions="rotary", rope_style="half", attn_bias=False,
                  mlp_bias=False, tie_word_embeddings=True),
}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name, mesh):
    kw = {**BASE, **CONFIGS[name]}
    jc, tc = JCfg(**kw), TCfg(**kw)
    jp = jdec.init_params(jc, mesh, jax.random.key(1))
    tp = params_from_jax(jax.device_get(jp))
    jfwd = jax.jit(partial(jdec.forward, jc),
                   static_argnames=("last_only", "t_bucket"))
    B, S, T = 2, 16, 48
    L, Hkv, D = jc.n_layers, jc.n_kv_heads, jc.head_dim
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kvp = np.where(pos < lens[:, None], pos, -1).astype(np.int32)
    slots = pos % T

    jcache = jinit_cache(mesh, n_layers=L, batch=B, max_len=T, n_kv_heads=Hkv,
                         head_dim=D, dtype=jnp.float32)
    tcache = tinit_cache(n_layers=L, batch=B, max_len=T, n_kv_heads=Hkv,
                         head_dim=D, dtype=torch.float32, device="cpu")
    jl, jcache = jfwd(jp, jnp.asarray(ids), jnp.asarray(pos), jcache,
                      jnp.asarray(slots), gather_idx=jnp.asarray(lens - 1),
                      kv_write_positions=jnp.asarray(kvp))
    tl, _ = tdec.forward(tc, tp, torch.tensor(ids), torch.tensor(pos), tcache,
                         torch.tensor(slots), gather_idx=torch.tensor(lens - 1),
                         kv_write_positions=torch.tensor(kvp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)

    cur = lens.copy()
    tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    for step in range(40):  # row 0 reaches position 55 > T: the ring wraps
        p = cur[:, None]
        sl = p % T
        tb = 32 if step < 10 else None  # every live slot < 32 early on
        jl, jcache = jfwd(jp, jnp.asarray(tok[:, None]), jnp.asarray(p),
                          jcache, jnp.asarray(sl), last_only=True, t_bucket=tb)
        tl, _ = tdec.forward(tc, tp, torch.tensor(tok[:, None]),
                             torch.tensor(p), tcache, torch.tensor(sl),
                             t_bucket=tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
        cur += 1
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               rtol=1e-4, atol=1e-4)


def test_done_row_writes_are_dropped():
    """A done row's slot is past the ring: the write is dropped, never
    clamped into the last slot (or wrapped, for a negative slot)."""
    from llmss_tpu_torch.engine.cache import write_layer, write_positions

    pos = torch.full((2, 4), -1, dtype=torch.int32)
    write_positions(pos, torch.tensor([[7], [9]], dtype=torch.int32),
                    torch.tensor([[1], [4]]))
    assert pos.tolist() == [[-1, 7, -1, -1], [-1, -1, -1, -1]]
    k = torch.zeros(2, 4, 1, 2)
    v = torch.zeros(2, 4, 1, 2)
    new = torch.ones(2, 3, 1, 2)
    write_layer(k, v, new, new, torch.tensor([[0, 4, -1], [3, 2, 5]]))
    assert k[0, :, 0, 0].tolist() == [1, 0, 0, 0]
    assert k[1, :, 0, 0].tolist() == [0, 0, 1, 1]


def test_config_fields_match_jax():
    """The port's DecoderConfig is a field-for-field copy of the JAX one."""
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(JCfg)}
    tf = {f.name: f.default for f in dataclasses.fields(TCfg)}
    assert tf == jf
    cfg = TCfg(**{**BASE, **CONFIGS["gptj"]})
    assert cfg.torch_dtype == torch.float32
    assert (cfg.has_ln2, cfg.o_bias, cfg.q_size, cfg.kv_size) == (False, False, 64, 64)
