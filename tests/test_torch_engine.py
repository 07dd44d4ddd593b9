"""The torch port's ``DecodeEngine.generate`` against the JAX package's, on
the CPU: token-identical streams on a tiny fp32 llama, for greedy and
seeded sampled rows, mixed prompt lengths, EOS, and chunk_steps 1 and 4."""

import jax
import pytest

from llmss_tpu.engine import DecodeEngine as JEngine
from llmss_tpu.engine import GenerationParams as JGen
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JCfg
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine as TEngine
from llmss_tpu_torch.engine.engine import GenerationParams as TGen
from llmss_tpu_torch.models.common import DecoderConfig as TCfg

CFG = dict(model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
           n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
           max_position_embeddings=64, activation="silu", norm="rmsnorm",
           mlp="swiglu", positions="rotary", rope_style="half",
           attn_bias=False, mlp_bias=False, dtype="float32")
PROMPTS = [[5, 9, 23, 40], list(range(3, 20)), [1, 2, 3]]


@pytest.fixture(scope="module")
def engines():
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jp = jdec.init_params(JCfg(**CFG), mesh, jax.random.key(0))
    tp = params_from_jax(jax.device_get(jp))
    return (JEngine(JCfg(**CFG), jp, mesh, max_seq_len=64),
            TEngine(TCfg(**CFG), tp, device="cpu", max_seq_len=64))


def _gens(G, eos=None):
    return [
        G(max_new_tokens=12, eos_token_id=eos),
        G(max_new_tokens=10, is_greedy=False, temperature=0.8, top_k=10,
          top_p=0.9, seed=42),
        G(max_new_tokens=9, is_greedy=False, temperature=1.3, seed=7),
    ]


@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_generate_matches_jax(engines, chunk_steps):
    je, te = engines
    want = je.generate(PROMPTS, _gens(JGen), chunk_steps=chunk_steps)
    incs = {}
    got = te.generate(
        PROMPTS, _gens(TGen), chunk_steps=chunk_steps,
        on_increment=lambda r, t: incs.setdefault(r, []).extend(t),
    )
    assert got == want
    assert [len(o) for o in got] == [12, 10, 9]
    assert [incs.get(i, []) for i in range(3)] == got


def test_generate_eos_matches_jax(engines):
    je, te = engines
    full = te.generate(PROMPTS, _gens(TGen), chunk_steps=4)
    eos = full[0][4]  # row 0 stops at its 5th token
    want = je.generate(PROMPTS, _gens(JGen, eos), chunk_steps=4)
    got = te.generate(PROMPTS, _gens(TGen, eos), chunk_steps=4)
    assert got == want
    assert got[0] == full[0][: full[0].index(eos)]


def test_poisoned_row_is_isolated(engines):
    """A row whose logits go NaN errors alone; its batch-mate keeps the
    tokens it decodes solo."""
    _, te = engines
    params = {**te.params, "wte": te.params["wte"].clone()}
    params["wte"][99] = float("nan")
    eng = TEngine(te.cfg, params, device="cpu", max_seq_len=64)
    gen = TGen(max_new_tokens=8)
    solo = eng.generate([PROMPTS[0]], gen, chunk_steps=4)
    poisoned = []
    out = eng.generate([PROMPTS[0], [4, 99]], gen, chunk_steps=4,
                       on_poisoned=poisoned.append)
    assert poisoned == [1]
    assert out[0] == solo[0]


def test_envelope_helpers(engines):
    eng = TEngine(TCfg(**CFG), engines[1].params, device="cpu",
                  max_seq_len=1024)
    assert eng.seq_buckets() == [16, 32, 64, 128, 256, 512, 1024]
    assert eng.bucket_ladder() == list(range(64, 1024, 64))
    assert eng.decode_bucket(100) == 128
    assert eng.decode_bucket(1025) is None
    with pytest.raises(ValueError):
        eng.check_capacity(1000, 25)
    with pytest.raises(ValueError):
        TGen(is_greedy=False, temperature=0.0).validate()
