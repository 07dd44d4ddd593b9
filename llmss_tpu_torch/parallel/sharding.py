"""Parameter sharding and the collectives (counterpart:
llmss_tpu/parallel/sharding.py and the reference's ``param_specs``,
llmss_tpu/models/decoder.py:82-140).

The reference declares a ``PartitionSpec`` per parameter and lets GSPMD
insert the Megatron collectives. The port keeps the same declaration,
``param_specs``: for each parameter the dimension a tp rank slices (or
None: replicated), in the port's layouts (q / k ``[L, out, in]``, every
other linear ``[L, in, out]``). ``shard_params`` cuts a rank's slices from
the full parameters. Column-parallel: q, k, v, gate, up, fc_in (and
their biases); row-parallel: o, down, fc_out (their biases replicated,
added once after the tp sum); vocab-parallel: wte, wpe and the head. KV
projections shard only when ``Hkv % tp == 0``; otherwise they replicate,
which is right for MQA (one KV head) only (``ops/attention.tp_head_plan``).
A vocabulary (or position table) that ``tp`` does not divide is padded
with zero rows to ``ceil(n / tp)`` per rank, as GSPMD pads; the decoder
trims the gathered logits.

The collectives XLA inserts for the reference are explicit here, each
over one named axis of a ``Mesh``: ``psum``, ``pmax``, ``all_gather`` and
``ppermute`` (the ring's one-hop rotation). Over an axis of one rank they
return their input under every backend, as XLA drops them. Under NCCL a
collective of two or more ranks is issued on the current stream, so a
step graph captured over it would hold it; one card cannot show that
(NCCL refuses two ranks on one device), and it stays unverified until a
run on two or more cards. Under gloo over CUDA tensors every collective
copies its operand to the host and the result back, and counts the call
and its bytes in ``HOST_STAGING``; nothing else stages, and never under
NCCL.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from llmss_tpu_torch.ops.layers import LinearParams, NormParams
from llmss_tpu_torch.parallel.mesh import AXIS_TP, Mesh

Params = dict[str, Any]

# Collectives that went through the host (gloo over CUDA tensors): calls
# and bytes sent.
HOST_STAGING = {"calls": 0, "bytes": 0}
# Collectives issued over two or more ranks.
COLLECTIVES = {"psum": 0, "pmax": 0, "all_gather": 0, "ppermute": 0}

# Parameters whose sliced dimension may be uneven: padded per rank.
PADDED = ("wte", "wpe", "head")


def param_specs(cfg, tp: int) -> Params:
    """The sliced dimension of every parameter (an int) or None
    (replicated), in the structure of ``decoder.param_shapes``."""
    kv = 1 if cfg.n_kv_heads % tp == 0 else None

    def norm():  # norms replicate
        return NormParams(None, None)

    blocks: Params = {
        "ln1": norm(),
        # q / k [L, out, in]: column-parallel on the out axis.
        "q": LinearParams(1, 1 if cfg.attn_bias else None),
        "k": LinearParams(kv, kv if cfg.attn_bias else None),
        # v [L, in, out].
        "v": LinearParams(None if kv is None else 2,
                          kv if cfg.attn_bias else None),
        # o [L, in, out]: row-parallel on the in axis, bias replicated.
        "o": LinearParams(1, None),
    }
    if cfg.has_ln2:
        blocks["ln2"] = norm()
    if cfg.mlp == "swiglu":
        blocks["gate"] = LinearParams(2, None)
        blocks["up"] = LinearParams(2, None)
        blocks["down"] = LinearParams(1, None)
    else:
        blocks["fc_in"] = LinearParams(2, 1 if cfg.mlp_bias else None)
        blocks["fc_out"] = LinearParams(1, None)
    specs: Params = {"wte": 0, "blocks": blocks, "ln_f": norm()}
    if cfg.positions == "learned":
        specs["wpe"] = 0
    if not cfg.tie_word_embeddings:
        specs["head"] = LinearParams(1, 0 if cfg.head_bias else None)
    return specs


def shard_range(n: int, count: int, index: int, *, pad: bool = False
                ) -> tuple[int, int, int]:
    """``(lo, hi, local)``: rank ``index`` of ``count`` holds rows
    ``[lo, hi)`` of ``n``, in a slice of ``local`` rows (``hi - lo`` plus
    zero padding). Even splits only, unless ``pad``: then ``ceil(n /
    count)`` rows each, the last ranks padded."""
    if n % count and not pad:
        raise ValueError(f"a dimension of {n} does not split over {count} "
                         "ranks")
    local = -(-n // count)
    lo = min(n, index * local)
    return lo, min(n, lo + local), local


def shard_tensor(x: torch.Tensor, dim: int, count: int, index: int, *,
                 pad: bool = False) -> torch.Tensor:
    """Rank ``index``'s slice of ``x`` along ``dim`` (a new tensor)."""
    lo, hi, local = shard_range(x.shape[dim], count, index, pad=pad)
    part = x.narrow(dim, lo, hi - lo)
    if hi - lo == local:
        return part.clone()
    shape = list(x.shape)
    shape[dim] = local
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, 0, hi - lo).copy_(part)
    return out


def shard_params(params: Params, cfg, mesh: Mesh) -> Params:
    """The tp rank's slices of the full ``params`` (dp and sp replicate
    the parameters)."""
    tp, r = mesh.size(AXIS_TP), mesh.coord(AXIS_TP)
    check_tp(cfg, tp)
    specs = param_specs(cfg, tp)

    def walk(p, s, pad):
        if p is None:
            return None
        if isinstance(p, dict):
            return {k: walk(p[k], s[k], k in PADDED) for k in p}
        if isinstance(p, (LinearParams, NormParams)):
            return type(p)(*(walk(a, b, pad) for a, b in zip(p, s)))
        if s is None or tp == 1:
            return p
        return shard_tensor(p, s, tp, r, pad=pad)

    return walk(params, specs, False)


def check_tp(cfg, tp: int) -> None:
    """Raise unless ``cfg`` splits over ``tp`` ranks: query heads,
    KV heads (or MQA's one KV head, replicated) and MLP width."""
    from llmss_tpu_torch.ops.attention import tp_head_plan

    heads_ok = tp_head_plan(cfg.n_heads, cfg.n_kv_heads, tp)[1]
    if not heads_ok:
        raise ValueError(
            f"tp_head_plan: Hq={cfg.n_heads}, Hkv={cfg.n_kv_heads} do not "
            f"shard over tp={tp} (query heads must divide; KV heads must "
            "divide or be one, MQA)")
    if cfg.intermediate_size % tp:
        raise ValueError(f"intermediate_size {cfg.intermediate_size} does "
                         f"not split over tp={tp}")


# -- collectives ----------------------------------------------------------


def _send(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The operand as the backend takes it: contiguous, and on the host
    under gloo over CUDA (counted)."""
    if mesh.host_staged:
        HOST_STAGING["calls"] += 1
        HOST_STAGING["bytes"] += x.numel() * x.element_size()
        return x.to("cpu", copy=True).contiguous()
    return x.contiguous()


def _back(y: torch.Tensor, like: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return y.to(like.device) if mesh.host_staged else y


def _reduce(x, mesh, axis, op, name):
    if mesh.size(axis) == 1:
        return x
    COLLECTIVES[name] += 1
    y = _send(x, mesh)
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    return _back(y, x, mesh)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``lax.psum``). The sum may
    take ``x``'s storage: pass a value no one reads again."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks of ``axis``; it may take
    ``x``'s storage, as ``psum`` does."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX, "pmax")


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
               ) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` concatenated along ``dim``, in
    coordinate order."""
    n = mesh.size(axis)
    if n == 1:
        return x
    COLLECTIVES["all_gather"] += 1
    y = _send(x.movedim(dim, 0), mesh)
    g = mesh.group(axis)
    if mesh.backend == "nccl":
        out = torch.empty((n * y.shape[0], *y.shape[1:]), dtype=y.dtype,
                          device=y.device)
        dist.all_gather_into_tensor(out, y, group=g)
    else:
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=g)
        out = torch.cat(parts)
    return _back(out, x, mesh).movedim(0, dim)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1
             ) -> torch.Tensor:
    """``x`` of the rank ``shift`` places before along ``axis`` (each
    rank sends to the one ``shift`` after it: the reference's
    ``perm = [(i, (i + 1) % n)]``)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    g, r = mesh.group(axis), mesh.coord(axis)
    COLLECTIVES["ppermute"] += 1
    y = _send(x, mesh)
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y, dist.get_global_rank(g, (r + shift) % n),
                      g),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(g, (r - shift) % n), g)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _back(out, x, mesh)
