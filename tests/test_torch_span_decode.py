"""The port's span decode and masking vs the JAX package's.

The plain PyTorch decode (``hual_tpu_torch/ops/decode.py``) is the CPU path
of the Hopper kernel's wrapper and the reference the kernel is held to on
the card (``chip_smoke.py``).  Here it must give exactly the indices of
``hual_tpu``'s XLA decode and of its Pallas kernel run in interpret mode.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hual_tpu.ops.decode import span_decode as jax_span_decode
from hual_tpu.ops.masking import attention_bias as jax_attention_bias
from hual_tpu.ops.masking import mask_logits as jax_mask_logits
from hual_tpu.ops.masking import sequence_mask as jax_sequence_mask
from hual_tpu.ops.pallas.span_decode import span_decode_pallas
from hual_tpu_torch.ops.decode import span_decode
from hual_tpu_torch.ops.kernels import span_decode as kernel
from hual_tpu_torch.ops.masking import (attention_bias, mask_logits,
                                        sequence_mask)
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)


def _inputs(B: int, T: int, seed: int):
    """Random logits and lengths with forced ties and short rows."""
    rng = np.random.default_rng(seed)
    sl = rng.normal(size=(B, T)).astype(np.float32)
    el = rng.normal(size=(B, T)).astype(np.float32)
    lens = rng.integers(2, T + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 1, 2
    sl[2] = el[2] = 0.5                       # every position ties
    sl[3, 1:4] = sl[3].max() + 1.0            # tied start maxima
    el[3, 2:5] = el[3].max() + 1.0            # tied end maxima
    lens[2] = lens[3] = T
    if B > 4:
        lens[4] = T
        sl[4], el[4] = el[4].copy(), sl[4].copy()
        sl[4, T - 1] = 9.0                    # start only at the very end
    return sl, el, lens


@pytest.mark.parametrize("B,T", [(16, 64), (13, 100), (8, 16)])
def test_decode_indices_equal_jax_and_pallas(B, T):
    sl, el, lens = _inputs(B, T, seed=B * T)
    jmask = jax_sequence_mask(jnp.asarray(lens), T)
    js, je = jax_span_decode(jnp.asarray(sl), jnp.asarray(el), jmask)
    ps, pe = span_decode_pallas(jnp.asarray(sl), jnp.asarray(el), jmask,
                                interpret=True)
    mask = sequence_mask(torch.from_numpy(lens), T)
    ts, te = span_decode(torch.from_numpy(sl), torch.from_numpy(el), mask)
    assert ts.dtype == te.dtype == torch.int32
    for ref_s, ref_e in ((js, je), (ps, pe)):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(ref_s))
        np.testing.assert_array_equal(te.numpy(), np.asarray(ref_e))
    # length-1 rows decode to (0, 0); all-tied rows to the first index
    assert (ts[0].item(), te[0].item()) == (0, 0)
    assert (ts[2].item(), te[2].item()) == (0, 0)
    assert ts[3].item() == 1 and te[3].item() == 2
    assert bool((ts <= te).all())


def test_kernel_wrapper_takes_the_plain_decode_on_cpu():
    sl, el, lens = _inputs(13, 100, seed=3)
    mask = sequence_mask(torch.from_numpy(lens), 100)
    before = kernel.span_decode.launches
    ks, ke = kernel.span_decode(torch.from_numpy(sl), torch.from_numpy(el), mask)
    ps, pe = span_decode(torch.from_numpy(sl), torch.from_numpy(el), mask)
    assert torch.equal(ks, ps) and torch.equal(ke, pe)
    assert kernel.span_decode.launches == before  # nothing was launched


def test_kernel_wrapper_raises_off_cpu_without_falling_back():
    x = torch.empty(4, 8, device="meta")
    mask = torch.empty(4, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernel.span_decode(x, x, mask)


def test_masked_probabilities_are_exact_zeros():
    sl, el, lens = _inputs(8, 16, seed=5)
    mask = sequence_mask(torch.from_numpy(lens), 16)
    prob = torch.softmax(mask_logits(torch.from_numpy(sl), mask), dim=1)
    assert bool((prob[mask == 0] == 0).all())


def test_masking_equals_jax():
    rng = np.random.default_rng(1)
    lens = np.array([1, 5, 8, 3], np.int32)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    tm = sequence_mask(torch.from_numpy(lens), 8)
    jm = jax_sequence_mask(jnp.asarray(lens), 8)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        mask_logits(torch.from_numpy(x), tm).numpy(),
        np.asarray(jax_mask_logits(jnp.asarray(x), jm)))
    qm = (rng.random((4, 5)) < 0.6).astype(np.int32)
    qm[0] = 0                                  # a fully padded query
    tb = attention_bias(tm, torch.from_numpy(qm))
    np.testing.assert_array_equal(
        tb.numpy(), np.asarray(jax_attention_bias(jm, jnp.asarray(qm))))
    # a fully masked row absorbs the bias and attends uniformly
    scores = torch.from_numpy(rng.normal(size=(4, 1, 8, 5)).astype(np.float32))
    probs = torch.softmax(scores + tb, dim=-1)
    torch.testing.assert_close(probs[0, 0], torch.full((8, 5), 0.2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("T", [64, 100, 128])
def test_decode_crafted_rows_equal_jax_and_pallas(T):
    """Rows the Hopper kernel's chunked warp scans must decode exactly: the
    suffix maximum of the end probabilities in a later 32-position chunk
    than the start, all-equal probabilities over a partial length, and a
    prefix maximum carried across chunks."""
    B = 4
    rng = np.random.default_rng(T)
    sl = rng.normal(size=(B, T)).astype(np.float32)
    el = rng.normal(size=(B, T)).astype(np.float32)
    lens = np.array([T, T // 2 + 3, T, T - 5], np.int32)
    el[0] = -5.0
    el[0, T - 2] = sl[0, 0] = 5.0           # start in chunk 0, end in the last
    sl[1] = el[1] = -0.75                   # all-equal probabilities
    sl[2] = -5.0
    sl[2, 3] = 4.0                          # the start maximum early ...
    el[2] = -5.0
    el[2, 40:] = np.linspace(0.0, 1.0, T - 40)  # ... the end maximum late
    jmask = jax_sequence_mask(jnp.asarray(lens), T)
    js, je = jax_span_decode(jnp.asarray(sl), jnp.asarray(el), jmask)
    ps, pe = span_decode_pallas(jnp.asarray(sl), jnp.asarray(el), jmask,
                                interpret=True)
    ts, te = span_decode(torch.from_numpy(sl), torch.from_numpy(el),
                         sequence_mask(torch.from_numpy(lens), T))
    for ref_s, ref_e in ((js, je), (ps, pe)):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(ref_s))
        np.testing.assert_array_equal(te.numpy(), np.asarray(ref_e))
    assert (ts[0].item(), te[0].item()) == (0, T - 2)
    assert (ts[1].item(), te[1].item()) == (0, 0)
    assert (ts[2].item(), te[2].item()) == (3, T - 1)
