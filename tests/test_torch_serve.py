"""The torch port's batch worker, CLI and checkpoint loader, on the CPU.

The worker must answer with exactly ``engine.generate``'s tokens and error
the requests it cannot serve; the CLI runs on a tiny checkpoint written
with the ``safetensors`` package; the port's pure-Python loader must give
the same tensors as the JAX package's ``load_model``."""

import json
import time

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from llmss_tpu.models.registry import load_model as jax_load_model
from llmss_tpu.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.cli.generate import main as cli_main
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.models.decoder import init_params
from llmss_tpu_torch.models.registry import load_model
from llmss_tpu_torch.serve.broker import InProcBroker
from llmss_tpu_torch.serve.consumer import Worker
from llmss_tpu_torch.serve.protocol import GenerateRequest
from llmss_tpu_torch.weights.loader import SafetensorsFile

CFG = DecoderConfig(
    model_type="llama", vocab_size=128, hidden_size=64, n_layers=2,
    n_heads=4, n_kv_heads=2, head_dim=16, intermediate_size=96,
    max_position_embeddings=64, activation="silu", norm="rmsnorm",
    mlp="swiglu", positions="rotary", rope_style="half", attn_bias=False,
    mlp_bias=False, dtype="float32",
)


@pytest.fixture(scope="module")
def engine():
    return DecodeEngine(CFG, init_params(CFG, seed=0, device="cpu"),
                        device="cpu", max_seq_len=48)


def test_worker_answers_with_engine_tokens(engine):
    broker = InProcBroker()
    worker = Worker(engine, broker, batch_size=4, chunk_steps=4)
    reqs = [
        GenerateRequest(token_ids=[5, 9, 23], max_new_tokens=6),
        GenerateRequest(token_ids=list(range(1, 18)), max_new_tokens=9),
        GenerateRequest(token_ids=[7, 7, 7], max_new_tokens=5, is_greedy=False,
                        temperature=0.7, top_k=20, top_p=0.9, seed=3),
        GenerateRequest(token_ids=[2, 4], max_new_tokens=7, stream=True),
    ]
    for r in reqs:
        broker.push_request(r)
    assert worker.run_once() == 4
    answers = {}
    for r in reqs:
        resp = answers[r.id] = broker.wait_response(r.id, timeout=5)
        gen = GenerationParams(
            max_new_tokens=r.max_new_tokens, is_greedy=r.is_greedy,
            temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
            seed=r.seed,
        )
        want = engine.generate([r.token_ids], gen, chunk_steps=4)[0]
        assert resp.error is None and resp.token_ids == want
    streamed = []
    while (inc := broker.pop_stream(reqs[3].id)) is not None:
        streamed += inc
    assert streamed == answers[reqs[3].id].token_ids


def test_worker_errors_bad_requests(engine):
    broker = InProcBroker()
    worker = Worker(engine, broker, batch_size=8, chunk_steps=4)
    cancelled = GenerateRequest(token_ids=[1, 2], max_new_tokens=4)
    too_long = GenerateRequest(token_ids=list(range(40)), max_new_tokens=20)
    invalid = GenerateRequest(token_ids=[1], is_greedy=False, temperature=0.0)
    expired = GenerateRequest(token_ids=[1], deadline_ts=time.time() - 1)
    good = GenerateRequest(token_ids=[3, 1], max_new_tokens=3)
    for r in (cancelled, too_long, invalid, expired, good):
        broker.push_request(r)
    broker.cancel_request(cancelled.id)
    assert worker.run_once() == 5
    errors = {r.id: broker.wait_response(r.id, timeout=5).error
              for r in (cancelled, too_long, invalid, expired, good)}
    assert errors[cancelled.id] == "cancelled"
    assert "exceeds the engine's max_seq_len" in errors[too_long.id]
    assert "temperature" in errors[invalid.id]
    assert errors[expired.id] == "deadline exceeded"
    assert errors[good.id] is None
    m = engine.metrics.to_dict()
    assert m["cancelled"] >= 1 and m["deadline_expired"] >= 1


def test_worker_errors_only_the_poisoned_row(engine):
    """A row whose logits go NaN gets an error; its batch-mate its tokens."""
    params = {**engine.params, "wte": engine.params["wte"].clone()}
    params["wte"][99] = float("nan")
    eng = DecodeEngine(CFG, params, device="cpu", max_seq_len=48)
    broker = InProcBroker()
    good = GenerateRequest(token_ids=[5, 9, 23], max_new_tokens=6)
    bad = GenerateRequest(token_ids=[4, 99], max_new_tokens=6)
    broker.push_request(good)
    broker.push_request(bad)
    Worker(eng, broker, batch_size=2, chunk_steps=4).run_once()
    assert "non-finite" in broker.wait_response(bad.id, timeout=5).error
    ok = broker.wait_response(good.id, timeout=5)
    assert ok.error is None and ok.token_ids == eng.generate(
        [good.token_ids], GenerationParams(max_new_tokens=6), chunk_steps=4)[0]
    assert eng.metrics.to_dict()["poisoned_rows"] == 1


def _write_checkpoint(path, dtype=torch.float32):
    """A tiny llama checkpoint in HF layout ([out, in] linears)."""
    g = torch.Generator().manual_seed(0)
    E, I, V, L = CFG.hidden_size, CFG.intermediate_size, CFG.vocab_size, CFG.n_layers
    KV = CFG.kv_size

    def w(*s):
        return (torch.randn(s, generator=g) * 0.05).to(dtype)

    t = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": 1 + w(E),
         "lm_head.weight": w(V, E)}
    for i in range(L):
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
        "vocab_size": V, "hidden_size": E, "num_hidden_layers": L,
        "num_attention_heads": CFG.n_heads, "num_key_value_heads": CFG.n_kv_heads,
        "intermediate_size": I, "max_position_embeddings": 64,
        "hidden_act": "silu", "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "tie_word_embeddings": False,
    }))
    return t


def test_cli_runs_on_a_written_checkpoint(tmp_path, capsys):
    _write_checkpoint(tmp_path)
    out = cli_main(["--pretrained_model_path", str(tmp_path), "--device", "cpu",
                    "--dtype", "float32", "--token_ids", "1,2,3,4,5", "9,8",
                    "--max_new_tokens", "6", "--is_greedy"])
    cfg, params = load_model(tmp_path, device="cpu", dtype="float32")
    eng = DecodeEngine(cfg, params, device="cpu", max_seq_len=11)
    assert out == eng.generate([[1, 2, 3, 4, 5], [9, 8]],
                               GenerationParams(max_new_tokens=6))
    assert "continuation ids" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="speculative"):
        cli_main(["--pretrained_model_path", str(tmp_path), "--device", "cpu",
                  "--token_ids", "1", "--speculative", "2"])
    # --kv_dtype int8 is ported: it reaches the engine's int8 cache.
    out8 = cli_main(["--pretrained_model_path", str(tmp_path), "--device",
                     "cpu", "--dtype", "float32", "--token_ids", "1,2,3,4,5",
                     "--max_new_tokens", "6", "--is_greedy", "--kv_dtype",
                     "int8"])
    eng8 = DecodeEngine(cfg, params, device="cpu", max_seq_len=11,
                        kv_dtype="int8")
    assert out8 == eng8.generate([[1, 2, 3, 4, 5]],
                                 GenerationParams(max_new_tokens=6))


def test_loader_matches_jax_load_model(tmp_path):
    _write_checkpoint(tmp_path)
    mesh = make_mesh(MeshPlan(dp=1, tp=1), devices=jax.devices()[:1])
    jcfg, jparams = jax_load_model(tmp_path, mesh, dtype="float32")
    cfg, params = load_model(tmp_path, device="cpu", dtype="float32")
    want = params_from_jax(jax.device_get(jparams))
    assert cfg.n_kv_heads == jcfg.n_kv_heads and cfg.norm_eps == jcfg.norm_eps

    def compare(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                compare(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, tuple):
            for i, (x, y) in enumerate(zip(a, b)):
                compare(x, y, f"{where}[{i}]")
        elif a is None:
            assert b is None, where
        else:
            assert a.shape == b.shape, where
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=where)

    compare(params, want, "params")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_safetensors_reader_round_trips(tmp_path, dtype):
    t = {"a": torch.randn(3, 5).to(dtype), "b": torch.arange(7, dtype=torch.int32),
         "c": torch.randn(2, 2, 2).to(dtype)}
    save_file(t, str(tmp_path / "x.safetensors"))
    f = SafetensorsFile(tmp_path / "x.safetensors")
    for k, v in t.items():
        got = f.get(k)
        assert got.dtype == v.dtype and torch.equal(got, v)
    f.close()
