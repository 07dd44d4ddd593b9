"""What the ranks of the mesh tests' worlds run (imported by the spawned
processes, so it imports nothing of JAX; not a test module)."""

import numpy as np
import torch

from llmss_tpu_torch.ops import ring_attention as ring
from llmss_tpu_torch.parallel import MeshPlan, make_mesh
from llmss_tpu_torch.parallel import sharding as shd


def collectives(seed: int) -> dict:
    """psum / pmax / all_gather over the axes of a (1, 2, 2) mesh, the
    ring's ppermute over sp, and a column- then row-parallel product of
    the same matrices on every rank, with the rank's slices."""
    mesh = make_mesh(MeshPlan(dp=1, sp=2, tp=2), device="cpu")
    tp, sp = mesh.coord("tp"), mesh.coord("sp")
    rank = sp * 2 + tp
    x = torch.arange(8, dtype=torch.float32) + 10 * rank
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    h = a @ shd.shard_tensor(w1, 1, 2, tp)  # column-parallel
    y = shd.psum(h @ shd.shard_tensor(w2, 0, 2, tp), mesh, "tp")  # row
    return {
        "coords": dict(mesh.coords),
        "psum_tp": shd.psum(x.clone(), mesh, "tp").tolist(),
        "pmax_sp": shd.pmax(x.clone(), mesh, "sp").tolist(),
        "gather_tp": shd.all_gather(x.view(2, 4), mesh, "tp", 1).tolist(),
        "ppermute_sp": shd.ppermute(x, mesh, "sp").tolist(),
        "column_gathered": shd.all_gather(h, mesh, "tp", 1).numpy(),
        "row_parallel": y.numpy(),
        "full": (a @ w1 @ w2).numpy(),
        "unsharded_col": (a @ w1).numpy(),
    }


def ring_cases(cases: list[dict]) -> list[np.ndarray]:
    """Each case's ``fn`` of ops/ring_attention on this rank's chunks: an
    sp-only mesh of the world; ``seq`` names the arguments split along
    dim 1 (the chunk's slots, or a ring prefill's queries)."""
    mesh = make_mesh(MeshPlan(dp=1, sp=4, tp=1), device="cpu")
    r, n = mesh.coord("sp"), mesh.size("sp")
    out = []
    for c in cases:
        args = []
        for name, a in c["args"]:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if name in c["seq"]:
                t = shd.shard_tensor(t, 1, n, r)
            args.append(t)
        res = getattr(ring, c["fn"])(*args, mesh=mesh, **c.get("kw", {}))
        out.append(res.numpy())
    return out


def consumer_requests():
    """The consumer test's requests: (prompts, their GenerationParams),
    greedy and seeded-sampled."""
    from llmss_tpu_torch.engine.engine import GenerationParams

    prompts = [[5, 9, 23, 40, 7, 1], [17, 4], list(range(2, 30)), [3] * 9,
               [8, 6, 7, 5, 3, 0, 9]]
    gens = [GenerationParams(max_new_tokens=6),
            GenerationParams(max_new_tokens=5, is_greedy=False, seed=7,
                             top_k=20),
            GenerationParams(max_new_tokens=6),
            GenerationParams(max_new_tokens=4),
            GenerationParams(max_new_tokens=6, is_greedy=False, seed=2,
                             temperature=0.8, top_p=0.9)]
    return prompts, gens


def consumer_rank(ckpt: str, rdv: str, rank: str, mode: str) -> None:
    """One rank of ``consumer.main --tp 2`` on the CPU, ``mode``
    "continuous" (``--continuous --kv_layout paged``) or "batch" (the
    batch Worker over the dense ring). Rank 0 serves ``consumer_requests`` from an InProcBroker
    in its process, then SIGTERMs itself (the drain), and prints the
    answers' tokens (``answers [...]``); rank 1 runs with ``RedisBroker``
    made to raise and prints the steps it followed."""
    import json
    import os
    import signal
    import threading

    from llmss_tpu_torch.parallel import serving
    from llmss_tpu_torch.serve import broker as brk
    from llmss_tpu_torch.serve import consumer
    from llmss_tpu_torch.serve.protocol import GenerateRequest

    rank = int(rank)
    argv = ["--pretrained_model_path", ckpt, "--device", "cpu", "--dtype",
            "float32", "--tp", "2", "--batch_size", "2", "--chunk_steps", "2",
            "--max_seq_len", "64", "--coordinator", rdv, "--num_processes",
            "2", "--process_id", str(rank)]
    if mode == "continuous":
        argv += ["--continuous", "--kv_layout", "paged"]
    if rank:
        def refuse(*a, **kw):
            raise AssertionError("a follower built a broker")

        brk.RedisBroker.__init__ = refuse
        follow, followed = serving.ServeControl.follow, []

        def counted(self, *a, **kw):
            followed.append(follow(self, *a, **kw))
            return followed[-1]

        serving.ServeControl.follow = counted
        consumer.main(argv)
        print(f"follower steps={followed[0]}", flush=True)
        return
    broker = brk.InProcBroker()
    reqs = [GenerateRequest(token_ids=p, max_new_tokens=g.max_new_tokens,
                            is_greedy=g.is_greedy, temperature=g.temperature,
                            top_k=g.top_k, top_p=g.top_p, seed=g.seed)
            for p, g in zip(*consumer_requests())]
    for r in reqs:
        broker.push_request(r)
    answers = []

    def collect():
        for r in reqs:
            a = broker.wait_response(r.id, timeout=120.0)
            answers.append(None if a is None or a.error else a.token_ids)
        os.kill(os.getpid(), signal.SIGTERM)  # drain, then stop rank 1

    t = threading.Thread(target=collect, daemon=True)
    t.start()
    consumer.main(argv, broker=broker)
    t.join()
    if any(broker.wait_response(r.id, timeout=0.0) for r in reqs):
        raise AssertionError("a request was answered twice")
    print("answers " + json.dumps(answers), flush=True)


def faulty_rank(rdv: str, rank: str, fault: str) -> None:
    """A tp 2 serving world on the CPU with a fault: ``leader_dies`` (rank
    0 exits with code 3 after its first step) or ``diverged`` (rank 1's
    digest differs from the first step on)."""
    import os

    from llmss_tpu_torch.engine.engine import DecodeEngine, GenerationParams
    from llmss_tpu_torch.engine.scheduler import ContinuousBatcher
    from llmss_tpu_torch.models.common import DecoderConfig
    from llmss_tpu_torch.models.decoder import init_params
    from llmss_tpu_torch.parallel import initialize_runtime
    from llmss_tpu_torch.parallel.serving import ServeControl

    initialize_runtime(rdv, 2, int(rank), device="cpu")
    mesh = make_mesh(MeshPlan(tp=2), device="cpu")
    cfg = DecoderConfig(
        model_type="llama", vocab_size=64, hidden_size=32, n_layers=1,
        n_heads=4, n_kv_heads=2, head_dim=8, intermediate_size=64,
        max_position_embeddings=64, norm="rmsnorm", mlp="swiglu",
        positions="rotary", rope_style="half", attn_bias=False,
        mlp_bias=False, dtype="float32")
    eng = DecodeEngine(cfg, init_params(cfg, seed=0, device="cpu", mesh=mesh),
                       mesh=mesh, max_seq_len=64, kv_layout="paged",
                       block_size=8)
    control = ServeControl(eng, timeout_s=60.0)
    if not control.leader:
        if fault == "diverged":
            digest = ContinuousBatcher.host_digest
            ContinuousBatcher.host_digest = lambda self: digest(self) + "!"
        control.follow()
        return
    bat = ContinuousBatcher(eng, rows=2, chunk_steps=2)
    control.attach(bat, max_prefixes=4)
    bat.submit([1, 2, 3], GenerationParams(max_new_tokens=8),
               lambda *a, **kw: None, req_id="x")
    bat.step()
    if fault == "leader_dies":
        os._exit(3)
    bat.run_until_idle()
    control.stop()


def prefix_generate(cfg, params, prompts, prefix, gen) -> dict:
    """``generate(prefix=)`` on a dp 2 x tp 2 mesh, dense and paged: each
    layout's tokens (every rank returns the whole batch)."""
    from llmss_tpu_torch.engine.engine import DecodeEngine

    mesh = make_mesh(MeshPlan(dp=2, tp=2), device="cpu")
    out = {}
    for layout in ("dense", "paged"):
        eng = DecodeEngine(cfg, shd.shard_params(params, cfg, mesh),
                           mesh=mesh, max_seq_len=64, kv_layout=layout,
                           block_size=8)
        out[layout] = eng.generate(prompts, gen, chunk_steps=2,
                                   prefix=eng.build_prefix(prefix))
    return out
