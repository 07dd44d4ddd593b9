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
