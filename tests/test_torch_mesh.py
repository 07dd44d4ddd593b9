"""The port's mesh (llmss_tpu_torch/parallel/) against the JAX package's:
plan resolution with its errors, the head and sequence plans, the
parameter specs and a rank's slices, the cache's layout on a mesh; and on
a world of four gloo ranks (a (dp 1, sp 2, tp 2) mesh, spawned once) real
collectives: psum and pmax, all_gather, the ring's ppermute, and a
column- then row-parallel product equal to the unsharded one."""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from llmss_tpu.engine.cache import cache_specs_for as jcache_specs_for
from llmss_tpu.models import decoder as jdec
from llmss_tpu.models.common import DecoderConfig as JConfig
from llmss_tpu.parallel import AXIS_TP as JAXIS_TP
from llmss_tpu.parallel import MeshPlan as JPlan
from llmss_tpu.parallel import make_mesh as jmake_mesh
from llmss_tpu_torch.convert import params_from_jax
from llmss_tpu_torch.engine.cache import mesh_layout
from llmss_tpu_torch.models.common import DecoderConfig
from llmss_tpu_torch.ops import attention as tatt
from llmss_tpu_torch.parallel import Mesh, MeshPlan, default_compute_dtype
from llmss_tpu_torch.parallel import sharding as shd
from llmss_tpu_torch.parallel.launch import file_init, spawn

import torch_mesh_jobs

# llmss_tpu.ops rebinds ``attention`` to the function: the module by name.
jatt = importlib.import_module("llmss_tpu.ops.attention")

PLANS = [(dict(dp=2, tp=None), 8), (dict(dp=2, sp=2, tp=2), 8),
         (dict(dp=3), 8), (dict(dp=2, tp=2), 8), (dict(), 8),
         (dict(sp=2), 6), (dict(dp=1, sp=1, tp=1), 1), (dict(tp=4), 2)]


def _resolve(plan_cls, kw, n):
    try:
        return plan_cls(**kw).resolve(n)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw,n", PLANS)
def test_plan_resolution_matches_jax(kw, n):
    """``MeshPlan.resolve`` equals the reference's, error messages too."""
    assert _resolve(MeshPlan, kw, n) == _resolve(JPlan, kw, n)


def test_default_plan_is_all_tp():
    assert MeshPlan().resolve(8) == (1, 1, 8)
    assert default_compute_dtype("cpu") == torch.float32


@pytest.mark.parametrize("Hq,Hkv,tp", [(8, 4, 2), (8, 4, 4), (8, 4, 8),
                                       (8, 1, 4), (12, 6, 4), (6, 3, 4),
                                       (32, 8, 2), (48, 1, 8), (28, 4, 4)])
def test_head_plan_matches_jax(Hq, Hkv, tp):
    assert tatt.tp_head_plan(Hq, Hkv, tp) == jatt.tp_head_plan(Hq, Hkv, tp)


@pytest.mark.parametrize("plan", [(1, 2, 2), (2, 2, 2), (1, 4, 2),
                                  (2, 4, 1)])
@pytest.mark.parametrize("B,T", [(4, 64), (3, 64), (4, 30)])
def test_sp_plan_and_cache_layout_match_jax(plan, B, T, devices):
    """The sp rule and the dense cache's layout (dp only when the batch
    divides, sp only when the length divides, KV heads by the head plan)
    equal the reference's specs."""
    dp, sp, tp = plan
    jmesh = jmake_mesh(JPlan(dp=dp, sp=sp, tp=tp),
                       devices=devices[:dp * sp * tp])
    tmesh = Mesh.local(plan)
    for Hq, Hkv in ((8, 4), (8, 1)):
        assert tatt.sp_plan(tmesh, B, T, Hq, Hkv) == jatt.sp_plan(
            jmesh, B, T, Hq, Hkv)
        spec = jcache_specs_for(jmesh, batch=B, max_len=T, n_kv_heads=Hkv,
                                dtype="float32").k
        lay = mesh_layout(tmesh, batch=B, max_len=T, n_kv_heads=Hkv)
        assert lay.batch_dp == (spec[1] is not None)
        assert lay.seq_sp == (spec[2] is not None)
        assert lay.n_kv_heads == (Hkv // tp if spec[3] is not None else Hkv)


CFGS = {
    "llama": dict(model_type="llama", vocab_size=64, hidden_size=32,
                  n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8,
                  intermediate_size=64, max_position_embeddings=64,
                  activation="silu", norm="rmsnorm", mlp="swiglu",
                  positions="rotary", rope_style="half", rotary_dim=8,
                  attn_bias=True, mlp_bias=False, tie_word_embeddings=False,
                  dtype="float32"),
    "gpt_bigcode": dict(model_type="gpt_bigcode", vocab_size=64,
                        hidden_size=32, n_layers=2, n_heads=4, n_kv_heads=1,
                        head_dim=8, intermediate_size=64,
                        max_position_embeddings=64, activation="gelu",
                        norm="layernorm", mlp="gelu", positions="learned",
                        attn_bias=True, mlp_bias=True,
                        tie_word_embeddings=True, dtype="float32"),
    "gptj": dict(model_type="gptj", vocab_size=64, hidden_size=32,
                 n_layers=2, n_heads=4, n_kv_heads=4, head_dim=8,
                 intermediate_size=64, max_position_embeddings=64,
                 activation="gelu_new", norm="layernorm", mlp="gelu",
                 positions="rotary", rope_style="interleaved", rotary_dim=4,
                 parallel_residual=True, attn_bias=False, mlp_bias=True,
                 head_bias=True, tie_word_embeddings=False,
                 dtype="float32"),
}


def _axes(node, path=""):
    """path -> sliced dimension of a spec tree: the port's (ints) or the
    reference's (PartitionSpecs, the dimension carrying tp)."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _axes(node[k], f"{path}/{k}")
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, x in zip(node._fields, node):
            yield from _axes(x, f"{path}.{f}")
    elif isinstance(node, jax.sharding.PartitionSpec):
        yield path, next((i for i, a in enumerate(node) if a == JAXIS_TP),
                         None)
    else:
        yield path, node


def _pairs(a, b, where=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{where}/{i}")
    else:
        yield where, a, b


@pytest.mark.parametrize("family", list(CFGS))
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_param_specs_match_jax(family, tp):
    """The port's own copy of ``param_specs`` slices, for every parameter,
    the dimension the reference's PartitionSpecs put on tp."""
    tspecs = shd.param_specs(DecoderConfig(**CFGS[family]), tp)
    jspecs = jdec.param_specs(JConfig(**CFGS[family]), tp)
    assert dict(_axes(tspecs)) == dict(_axes(jspecs))


@pytest.mark.parametrize("family", list(CFGS))
def test_rank_slices_equal_jax_shards(family, devices):
    """``params_from_jax(cfg=, mesh=)`` (the converted parameters'
    ``shard_params``) gives each tp rank exactly the shard the reference's
    mesh places on that rank."""
    cfg = JConfig(**CFGS[family])
    jmesh = jmake_mesh(JPlan(dp=1, sp=1, tp=2), devices=devices[:2])
    jparams = jdec.init_params(cfg, jmesh, jax.random.key(3))
    host = jax.device_get(jparams)
    tcfg = DecoderConfig(**CFGS[family])
    for r in range(2):
        mine = params_from_jax(host, cfg=tcfg,
                               mesh=Mesh.local((1, 1, 2), (0, 0, r)))
        jleaves = jax.tree_util.tree_leaves(jparams)
        tleaves = [t for _, t, _ in _pairs(mine, mine) if t is not None]
        assert len(jleaves) == len(tleaves)
        dev = devices[r]
        for j, t in zip(jleaves, tleaves):
            shard = next(s for s in j.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard.data))


def test_uneven_vocab_pads_each_rank():
    """GPT-2's 50257 at tp = 2 (here 97 rows): ceil(n / tp) rows a rank,
    the last zero-padded; the dimensions tp must divide raise."""
    x = torch.arange(97 * 3, dtype=torch.float32).view(97, 3)
    a = shd.shard_tensor(x, 0, 2, 0, pad=True)
    b = shd.shard_tensor(x, 0, 2, 1, pad=True)
    assert a.shape == b.shape == (49, 3)
    torch.testing.assert_close(torch.cat([a, b])[:97], x)
    assert b[-1].abs().sum() == 0
    with pytest.raises(ValueError, match="does not split"):
        shd.shard_tensor(x, 0, 2, 0)


def test_refused_head_plan_names_the_plan():
    cfg = dataclasses.replace(DecoderConfig(**CFGS["llama"]), n_heads=12,
                              n_kv_heads=6, hidden_size=96)
    with pytest.raises(ValueError, match="tp_head_plan"):
        shd.check_tp(cfg, 4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    init = file_init(tmp_path_factory.mktemp("mesh") / "rdv")
    return spawn(torch_mesh_jobs.collectives, 4, 0, init_method=init)


def test_psum_and_pmax(world):
    """psum over tp adds the two tp ranks' vectors; pmax over sp takes the
    larger sp rank's (rank = 2 * sp + tp, values 10 * rank + i)."""
    for r in world:
        sp, tp = r["coords"]["sp"], r["coords"]["tp"]
        i = np.arange(8)
        assert r["psum_tp"] == list(2 * i + 10 * (4 * sp + 1))
        assert r["pmax_sp"] == list(i + 10 * (2 + tp))


def test_all_gather_and_ppermute(world):
    for r in world:
        sp, tp = r["coords"]["sp"], r["coords"]["tp"]
        parts = [np.arange(8).reshape(2, 4) + 10 * (2 * sp + t)
                 for t in range(2)]
        assert r["gather_tp"] == np.concatenate(parts, 1).tolist()
        prev = 2 * ((sp - 1) % 2) + tp  # the ring's previous sp rank
        assert r["ppermute_sp"] == list(np.arange(8) + 10 * prev)


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_one_rank_axes_issue_nothing(backend):
    """Over an axis of one rank every collective returns its input and
    issues nothing, under either backend (as XLA drops them): this mesh
    has no process group, so an issued collective would raise."""
    mesh = Mesh((1, 1, 1), (0, 0, 0), "cpu", backend=backend)
    x = torch.arange(6.0).view(2, 3)
    before = dict(shd.COLLECTIVES)
    assert shd.psum(x, mesh, "tp") is x
    assert shd.pmax(x, mesh, "sp") is x
    assert shd.all_gather(x, mesh, "sp", 1) is x
    assert shd.ppermute(x, mesh, "sp") is x
    assert shd.COLLECTIVES == before


def test_sharded_matmul_equals_unsharded(world):
    for r in world:
        np.testing.assert_allclose(r["column_gathered"], r["unsharded_col"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["row_parallel"], r["full"], rtol=1e-5,
                                   atol=1e-4)
    np.testing.assert_array_equal(world[0]["row_parallel"],
                                  world[1]["row_parallel"])


@pytest.mark.parametrize("family", list(CFGS))
def test_init_params_on_a_mesh_draws_the_ranks_slices(family):
    """``init_params(mesh=)`` cuts each tensor to the tp rank's slice as it
    is drawn: equal to ``shard_params`` of the whole draw, every rank,
    an uneven vocabulary included."""
    from llmss_tpu_torch.models.decoder import init_params

    cfg = dataclasses.replace(DecoderConfig(**CFGS[family]), vocab_size=67)
    full = init_params(cfg, seed=5, device="cpu")
    for r in range(2):
        mesh = Mesh.local((1, 1, 2), (0, 0, r))
        want = shd.shard_params(full, cfg, mesh)
        got = init_params(cfg, seed=5, device="cpu", mesh=mesh)
        pairs = list(_pairs(got, want))
        assert pairs
        for where, a, b in pairs:
            assert (a is None) == (b is None), where
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
