"""The int8 lane template's ring and widening (K2 / K3 over an int8 cache,
csrc/split_merge.cuh ``LaneRing<int8_t>``, csrc/common.cuh
``Vec8<int8_t>``), pinned on the CPU.

The kernels run only on the card. These tests hold what they compute to
models in Python, read off the sources themselves:

- the widening (byte ``x ^ 0x80`` as the low byte of the fp32 ``2^23 + x +
  128``, minus ``2^23 + 128``) gives ``float(x)`` for every int8 value;
- the ring: each lane makes one 16-byte copy of its slot's K or V row per
  step and reads its own 8 bytes of each back from its neighbours' chunks;
  every byte of a slot's rows is copied exactly once, and read only by
  lanes of the warp's same slot; each slot's two scales are copied once,
  by a lane of the warp that reads them; a warp's 8-byte reads are
  conflict-free;
- ``split_plan.lane_region_bytes`` for an int8 cache equals the ring the
  header's constants give.
"""

import re

import numpy as np
import pytest

from llmss_tpu_torch.ops import _build
from llmss_tpu_torch.ops import decode_attention as da
from llmss_tpu_torch.ops import paged_attention as pa
from llmss_tpu_torch.ops import split_plan as sp

HEAD_DIMS = [64, 128, 256]
SOURCES = ("decode_attention.cu", "paged_attention.cu")


def _src(name: str) -> str:
    return (_build.CSRC / name).read_text()


def _block(src: str, head: str) -> str:
    """The text of the struct or function that starts at ``head``, to its
    closing brace at the same indent."""
    start = src.index(head)
    return src[start:src.index("\n};\n", start)]


def _ring_constants() -> dict:
    """``LaneRing<int8_t>``'s constants, evaluated as the compiler would
    (``kSteps`` from the same header)."""
    src = _src("split_merge.cuh")
    env = {k: int(re.search(rf"constexpr int {k} = (\d+);", src)[1])
           for k in ("kSteps", "kStage")}
    ring = _block(src, "template <> struct LaneRing<int8_t> {")
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", ring):
        # C's integer arithmetic: + and * as they are, / truncating.
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def _ring_exprs() -> tuple[str, str, str]:
    """The byte offset expressions of ``at`` (a lane's 8 bytes) and
    ``scale_at`` (a slot's scale: base bytes, float index)."""
    ring = _block(_src("split_merge.cuh"), "template <> struct LaneRing<int8_t> {")
    at = re.search(r"char\* at\(char\* ring, int st, int u, int kv, int lane\) "
                   r"\{\s*return ([^;]+);", ring)[1]
    sc = re.search(r"float\* scale_at\(char\* ring, int kv, int k\) \{\s*"
                   r"return reinterpret_cast<float\*>\(([^)]+)\) \+\s*([^;]+);", ring)
    return at, sc[1], sc[2]


def _u32(b: np.ndarray) -> np.ndarray:
    return b.view("<u4")


def _byte_perm(x: np.ndarray, y: int, s: int) -> np.ndarray:
    """CUDA's __byte_perm: byte n of the result is byte (s >> 4n) & 7 of the
    eight bytes y:x (x the low four)."""
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                   + [np.full_like(x, (y >> (8 * i)) & 0xFF) for i in range(4)])
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(s >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def _widen(raw: np.ndarray) -> np.ndarray:
    """Vec8<int8_t>::to_float on the 8 bytes of each row of ``raw``
    ([n, 8] int8): the two 32-bit words XORed with 0x80808080, each byte b
    permuted into 0x4B0000xx and 2^23 + 128 subtracted in fp32."""
    w = _u32(np.ascontiguousarray(raw)).reshape(-1, 2) ^ np.uint32(0x80808080)
    out = np.empty(raw.shape, np.float32)
    for i in range(2):
        for b in range(4):
            f = _byte_perm(w[:, i], 0x4B000000, 0x7650 + b).view(np.float32)
            out[:, 4 * i + b] = f - np.float32(8388736.0)
    return out


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_widening_is_exact_for_every_int8_value(D):
    """The header's Vec8<int8_t> widening (its constants read off the
    source) equals float(x) for all 256 int8 values, lane by lane over
    rows of D elements, with no conversion left in the source."""
    vec = _block(_src("common.cuh"), "template <> struct Vec8<int8_t> {")
    for const in ("0x80808080u", "__byte_perm(w[i], 0x4B000000u, 0x7650 + b)",
                  "8388736.f"):
        assert const in vec
    assert "static_cast<float>" not in vec and "to_f<int8_t>" not in vec
    assert 8388736.0 == 2.0**23 + 128
    every = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    rows = np.resize(np.random.default_rng(D).permutation(every), (-(-256 // D) + 1) * D)
    rows = rows.reshape(-1, D)
    # A lane's 8 elements: row elements [8 part, 8 part + 8).
    got = _widen(rows.reshape(-1, 8)).reshape(rows.shape)
    np.testing.assert_array_equal(got, rows.astype(np.float32))
    assert set(rows.ravel().tolist()) == set(every.tolist())


def _copy_model(D: int, n_st: int):
    """The copies one warp makes over a window of ``n_st`` ring stages, as
    the two kernels issue them: per step (stage, u), each lane's 16-byte
    chunk (its ring bytes, and the (slot, K or V, element) each holds); per
    window, the scale copies of the warp's slots (k-th slot: step k // SPW,
    sub k % SPW). Returns (rows[(stage, u)] -> {byte: [(lane, what)]},
    scales {byte: [(lane, (k, kv))]}, at, scale_at)."""
    ring = _block(_src("split_merge.cuh"), "template <> struct LaneRing<int8_t> {")
    assert "tile::cp_async16(at(ring, st, u, lane & 1, lane & ~1), src, true);" in ring
    assert "cp_async_ca4(scale_at(ring, 0, k), ks);" in ring
    assert "cp_async_ca4(scale_at(ring, 1, k), vs);" in ring
    for name, (k, v) in zip(SOURCES, (("kc", "vc"), ("kp", "vp"))):
        text = _src(name)
        # base: the row's start plus this lane's first element, 8 * part;
        # the copy adds the slot's offset to it.
        assert f"const KV* src8 = lane & 1 ? {v} + (base - 8) : {k} + base;" in text
        assert "Ring::put(wring, i % Ring::STAGES, u, lane" in text
        assert "src8 + (" in text
        assert "const int e0 = part * 8;" in text
        if name == "decode_attention.cu":  # lane j: the warp's slots j, j + 32, ...
            assert "for (int k = lane; k < n_st * kSteps * SPW; k += 32) {" in text
            assert ("const int t = w0 + (k / SPW) * C::STEP + warp * SPW + k % SPW;"
                    in text)
            assert "Ring::put_scales(wring, k, a.ks + so, a.vs + so);" in text
        else:  # the thread staging window slot i's position
            assert ("Ring::put_scales(reinterpret_cast<char*>(smem) + (i % C::STEP) / SPW"
                    " * Ring::WARP_BYTES,\n                           i / C::STEP * SPW + "
                    "i % SPW, a.ks + so, a.vs + so);") in text
            assert "const int i = j * NT + threadIdx.x, t = w0 + i, p = pv[j];" in text
        # The k-th scale of step (i, u), sub: k = (i * kSteps + u) * SPW + sub.
        if name == "decode_attention.cu":
            assert ("ksc[u] = *Ring::scale_at(wring, 0, (i * kSteps + u) * SPW + sub);"
                    in text)
            assert ("vsc[u] = *Ring::scale_at(wring, 1, (i * kSteps + u) * SPW + sub);"
                    in text)
        else:
            assert "sk = i * kSteps * SPW + sub;" in text
            assert "*Ring::scale_at(wring, 0, sk + u * SPW)" in text
            assert "*Ring::scale_at(wring, 1, sk + u * SPW)" in text
        # V rows are read where they are widened, from the step's stage.
        assert "if constexpr (kQuant<KV>) st8 = i % Ring::STAGES" in text
        assert "ring_get(v8, wring, st8, u, 1, lane);" in text
        # The scales join issue(0)'s group: copied before the prologue.
        assert text.index("Ring::put_scales(") < text.index(
            "for (int i = 0; i < Ring::STAGES - 1; ++i) issue(i);")
    c = _ring_constants()
    at, sc_base, sc_idx = _ring_exprs()
    LPS, SPW = D // 8, 32 // (D // 8)

    def at_(st, u, kv, lane):
        return eval(at, {}, dict(c, ring=0, st=st, u=u, kv=kv, lane=lane))

    def scale_at(kv, k):
        env = dict(c, ring=0, kv=kv, k=k)
        return eval(sc_base, {}, env) + 4 * eval(sc_idx, {}, env)

    rows, scales = {}, {}
    for st in range(n_st):
        for u in range(c["kSteps"]):
            writes = rows.setdefault((st, u), {})
            for lane in range(32):
                sub, part = divmod(lane, LPS)
                kv = lane & 1
                e_src = part * 8 - 8 * kv  # base (- 8 on the odd lane)
                dst = at_(st, u, kv, lane & ~1)
                for j in range(16):
                    writes.setdefault(dst + j, []).append((lane, (sub, kv, e_src + j)))
    # K2: lane j of the warp copies its slots j, j + 32, ...
    for lane in range(32):
        for k in range(lane, n_st * c["kSteps"] * SPW, 32):
            for kv in range(2):
                scales.setdefault(scale_at(kv, k), []).append((lane, (k, kv)))
    return rows, scales, at_, scale_at


def _k3_scale_writer(D: int, warp: int, k: int) -> tuple[int, int]:
    """K3: (window slot i, staging thread) of the scales that warp ``warp``
    reads as its k-th: the thread of slot i writes to warp (i % STEP) //
    SPW, index (i // STEP) * SPW + i % SPW."""
    SPW = 32 // (D // 8)
    STEP = 8 * SPW
    i = (k // SPW) * STEP + warp * SPW + k % SPW
    assert ((i % STEP) // SPW, (i // STEP) * SPW + i % SPW) == (warp, k)
    return i, i % 256


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ring_copies_each_byte_once_within_the_slot(D):
    """Every K and V byte of each of the warp's SPW slots is copied exactly
    once per step, by one 16-byte copy per lane; each lane reads back its
    own 8 elements of the slot's K and V rows from chunks that lanes of its
    warp and slot copied; each slot's K and V scale are copied once per
    window, by a lane of the warp, where the slot's lanes read them; the
    stages and the scales do not overlap and fit the warp's ring."""
    LPS, SPW = D // 8, 32 // (D // 8)
    c = _ring_constants()
    n_st = c["STAGES"]  # a window that fills the ring once
    assert 8 * c["SCALE_SLOTS"] >= c["kStage"]
    assert n_st * c["kSteps"] * SPW <= c["SCALE_SLOTS"]
    rows, scales, at_, scale_at = _copy_model(D, n_st)
    seen = set()
    for (st, u), writes in rows.items():
        held = {}
        for addr, w in writes.items():
            assert len(w) == 1, f"byte {addr} copied {len(w)} times"
            assert addr not in seen
            seen.add(addr)
            held[addr] = w[0]
        assert sorted(what for _, what in held.values()) == [
            (s, kv, e) for s in range(SPW) for kv in range(2) for e in range(D)]
        per_lane = {}
        for lane, _ in held.values():
            per_lane[lane] = per_lane.get(lane, 0) + 1
        assert per_lane == {lane: 16 for lane in range(32)}
        for lane in range(32):
            sub, part = divmod(lane, LPS)
            for kv in range(2):
                base = at_(st, u, kv, lane)
                for j in range(8):
                    writer, what = held[base + j]
                    assert writer // LPS == sub, "read from another slot's lane"
                    assert what == (sub, kv, part * 8 + j)
                # This lane's slot's scale: copied once, for that slot.
                k = (st * c["kSteps"] + u) * SPW + sub
                (_, what), = scales[scale_at(kv, k)]
                assert what == (k, kv)
    assert len(scales) == 2 * n_st * c["kSteps"] * SPW
    # K3: each window slot's scales go to one (warp, k), the one that reads
    # them, from the thread that staged the slot's position.
    seen_k3 = {}
    for warp in range(8):
        for k in range(n_st * c["kSteps"] * SPW):
            i, thread = _k3_scale_writer(D, warp, k)
            assert i not in seen_k3 and 0 <= i < c["kStage"]
            seen_k3[i] = thread
            # slot i is the one lane sub = k % SPW of warp `warp` reads at
            # step k // SPW: slot_of(st, u) = (st * kSteps + u) * STEP + warp * SPW + sub
            assert i == (k // SPW) * 8 * SPW + warp * SPW + k % SPW
    assert sorted(seen_k3) == list(range(8 * n_st * c["kSteps"] * SPW))
    for addr in scales:
        assert all(b not in seen for b in range(addr, addr + 4))
    assert max(seen) < n_st * c["STAGE_BYTES"] <= min(scales)
    assert max(scales) + 4 <= c["WARP_BYTES"]


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_ring_reads_are_conflict_free(D):
    """A warp's 8-byte reads of a step's K (or V) rows: each half-warp (a
    64-bit shared load is served 16 lanes at a time) covers 32 distinct
    banks; a slot's scale is one address (a broadcast), different slots'
    scales different banks; the 16-byte copies land 16-byte aligned."""
    LPS, SPW = D // 8, 32 // (D // 8)
    c = _ring_constants()
    _, _, at_, scale_at = _copy_model(D, 1)
    for u in range(c["kSteps"]):
        for kv in range(2):
            for half in range(2):
                banks = {(at_(0, u, kv, lane) // 4 + w) % 32
                         for lane in range(16 * half, 16 * half + 16)
                         for w in range(2)}
                assert len(banks) == 32
            assert all(at_(0, u, kv, 2 * i) % 16 == 0 for i in range(16))
            slot_banks = {(scale_at(kv, u * SPW + lane // LPS) // 4) % 32
                          for lane in range(32)}
            assert len(slot_banks) == SPW


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_int8_ring_barriers_reach_every_lane(D):
    """Lanes read chunks other lanes copied and copy into stages other
    lanes read: each kernel's int8 loop has a __syncwarp() before
    issue(i + STAGES - 1) and one after cp_async_wait (K3: a
    __syncthreads() at i = 0, since other warps' threads copied its
    scales), both before the per-slot tests and the skip of steps no lane
    sees."""
    for name in SOURCES:
        text = _src(name)
        loop = text[text.index("    for (int i = 0; i < n_st; ++i) {"):]
        loop = loop[:loop.index("__any_sync")]
        lines = [ln.strip() for ln in loop.splitlines()]
        sync = "if constexpr (kQuant<KV>) __syncwarp();"
        i0 = lines.index(sync)
        assert lines[i0 + 1] == "issue(i + Ring::STAGES - 1);"
        wait = lines.index("tile::cp_async_wait<Ring::STAGES - 1>();  "
                           "// this lane's stage i landed")
        after = [ln for ln in lines[wait + 1:] if not ln.startswith("//")]
        if name == "decode_attention.cu":
            assert after[0].startswith(sync)
            first_test = 1
        else:  # K3: other warps' threads copied the scales
            assert after[:7] == ["if constexpr (kQuant<KV>) {", "if (i == 0) {",
                                 "__syncthreads();", "} else {", "__syncwarp();",
                                 "}", "}"]
            first_test = 7
        assert after[first_test].startswith("Vec8<KV> kv[kSteps], vv[kSteps];")


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_int8_lane_region_matches_the_header(D, R):
    """split_plan.lane_region_bytes(1, R, D) is the shared memory the
    header's LaneRing<int8_t> takes for a block's 8 warps (or the per-warp
    fp32 accumulators reusing it, when larger), and the int8 plans of K2
    and K3 carry it; the bf16-query MHA plans (R <= 2) still fit three
    blocks on an SM."""
    c = _ring_constants()
    nwarp = {int(re.search(r"constexpr int NWARP = (\d+);", _src(n))[1])
             for n in SOURCES}
    assert nwarp == {sp.NWARP}
    assert c["kSteps"] == sp.STEPS and c["STAGES"] == sp.INT8_STAGES
    assert c["SCALE_SLOTS"] == sp.INT8_SCALE_SLOTS
    ring = sp.NWARP * c["WARP_BYTES"]
    assert ring == sp.NWARP * (c["STAGES"] * c["kSteps"] * 2 * 32 * 8
                               + 2 * c["SCALE_SLOTS"] * 4)
    assert sp.lane_region_bytes(1, R, D) == max(ring, 4 * sp.NWARP * R * D)
    assert c["STAGE_BYTES"] % 16 == 0 and c["WARP_BYTES"] % 16 == 0
    import torch

    k3 = pa.kernel_plan(torch.bfloat16, 1, R, D, B=8, Hkv=4, n_slots=832,
                        bs=16, kv_dtype=torch.int8)
    k3_16 = pa.kernel_plan(torch.bfloat16, 1, R, D, B=8, Hkv=4, n_slots=832,
                           bs=16)
    assert k3.smem - k3_16.smem == (sp.lane_region_bytes(1, R, D)
                                    - sp.lane_region_bytes(2, R, D))
    k2 = da.kernel_plan(torch.bfloat16, 4, 4 * R, 4, D, 192,
                        kv_dtype=torch.int8)
    for plan in (k2, k3):
        assert plan.impl == "lanes_int8" and plan.smem <= _build.SMEM_LIMIT
        if R <= 2 and D <= 128:
            assert 3 * (plan.smem + 1024) <= 228 * 1024
