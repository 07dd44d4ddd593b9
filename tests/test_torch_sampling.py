"""The torch port's sampling against the JAX package's, on the CPU.

The port re-implements JAX's partitionable threefry2x32, so random bits are
compared exactly. Sampled tokens are compared exactly too: the Gumbel noise
differs from JAX's only by the ulps of two float32 logs, which does not
move an argmax on these inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmss_tpu.ops import sampling as jsamp
from llmss_tpu_torch.ops import sampling as tsamp


@pytest.mark.parametrize("seed,counter", [
    (0, 0), (42, 7), (-5, 123456), (2**31 - 1, 2**31 - 1), (1234, 99),
])
def test_threefry_bits_equal_jax(seed, counter):
    V = 1000
    key = jax.random.fold_in(jax.random.key(seed), counter)
    want = np.asarray(jax.random.bits(key, (V,)), np.uint32).astype(np.int64)
    keys = tsamp.row_keys(torch.tensor([seed], dtype=torch.int32),
                          torch.tensor([counter], dtype=torch.int32))
    got = tsamp.random_bits(keys, V)[0].numpy()
    np.testing.assert_array_equal(got, want)
    # Gumbel noise: same bits, float32 logs agree to a few ulps.
    np.testing.assert_allclose(
        tsamp.gumbel(keys, V)[0].numpy(),
        np.asarray(jax.random.gumbel(key, (V,))), rtol=1e-6, atol=1e-6)


ROWS = [  # (greedy, temperature, top_k, top_p)
    (True, 1.0, 0, 1.0),  # greedy
    (False, 0.7, 0, 1.0),  # temperature only
    (False, 1.0, 20, 1.0),  # top-k within the 64-token bucket
    (False, 1.3, 0, 0.8),  # top-p
    (False, 0.9, 40, 0.9),  # top-k + top-p
]


def _args(rows, seeds, counters, lib):
    g, t, k, p = zip(*rows)
    if lib == "jax":
        return dict(seeds=jnp.asarray(seeds, jnp.int32),
                    counters=jnp.asarray(counters, jnp.int32),
                    temperature=jnp.asarray(t, jnp.float32),
                    top_k=jnp.asarray(k, jnp.int32),
                    top_p=jnp.asarray(p, jnp.float32),
                    greedy=jnp.asarray(g, bool))
    return dict(seeds=torch.tensor(seeds, dtype=torch.int32),
                counters=torch.tensor(counters, dtype=torch.int32),
                temperature=torch.tensor(t, dtype=torch.float32),
                top_k=torch.tensor(k, dtype=torch.int32),
                top_p=torch.tensor(p, dtype=torch.float32),
                greedy=torch.tensor(g))


@pytest.mark.parametrize("extra_row", [
    None,
    (False, 1.0, 100, 1.0),  # top-k > 64: the exact full-sort fallback
    (False, 1.0, 0, 0.999),  # top-p past the bucket's mass: full sort
])
def test_sample_matches_jax(extra_row):
    rng = np.random.default_rng(0)
    V = 300
    rows = ROWS + ([extra_row] if extra_row else [])
    B = len(rows)
    for trial in range(4):
        logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
        seeds = rng.integers(-1000, 1000, B)
        counters = rng.integers(0, 5000, B)
        want = np.asarray(jsamp.sample(
            jnp.asarray(logits), **_args(rows, seeds, counters, "jax")))
        got = tsamp.sample(
            torch.tensor(logits), **_args(rows, seeds, counters, "torch"))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_host_flags_equal_device_flags():
    rng = np.random.default_rng(1)
    rows = ROWS
    logits = torch.tensor(rng.standard_normal((5, 128)).astype(np.float32))
    a = _args(rows, list(range(5)), [3] * 5, "torch")
    np.testing.assert_array_equal(
        tsamp.sample(logits, **a).numpy(),
        tsamp.sample(logits, **a, any_sampled=True, needs_filter=True).numpy())
    greedy = dict(a, greedy=torch.ones(5, dtype=torch.bool))
    np.testing.assert_array_equal(
        tsamp.sample(logits, **greedy, any_sampled=False).numpy(),
        logits.argmax(-1).numpy())


def test_fold_step_outcome_matches_jax_on_nan_rows():
    logits = np.zeros((4, 8), np.float32)
    logits[1, 3] = np.nan
    logits[2, 0] = np.inf
    tok = np.array([5, 6, 7, 2], np.int32)
    done = np.array([False, False, True, False])
    poisoned = np.zeros(4, bool)
    eos = np.array([2, 2, 2, 2], np.int32)
    want = jsamp.fold_step_outcome(*map(jnp.asarray, (logits, tok, done, poisoned, eos)))
    got = tsamp.fold_step_outcome(*map(torch.tensor, (logits, tok, done, poisoned, eos)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Row 1 is poisoned (forced done, EOS fill); row 2 was already done;
    # row 3 sampled its EOS and finishes.
    assert got[2].tolist() == [False, True, False, False]
    assert got[1].tolist() == [False, True, True, True]
    np.testing.assert_array_equal(
        tsamp.nonfinite_rows(torch.tensor(logits)).numpy(),
        np.asarray(jsamp.nonfinite_rows(jnp.asarray(logits))))
