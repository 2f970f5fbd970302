"""Weight bridge between the JAX package's SeqPAN and the port's.

A JAX init crosses into the port and back bit for bit over exactly the same
leaf set; a fresh port init has the JAX package's leaves, shapes and TF-fan
value ranges; a corrupt parameter dict raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hual_tpu.models.initializers import _tf_fans
from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
from hual_tpu.serve import _flatten_params
from hual_tpu_torch.models.seqpan import SeqPAN
from hual_tpu_torch.weights import load_jax_params, to_jax_params
from torch_threads import one_torch_thread  # noqa: E402,F401  (a fixture)

SMALL = dict(vdim=32, dim=16, num_heads=2, attn_layer=2, max_vlen=16,
             word_dim=24, char_dim=8, num_chars=30)
CHARADES = dict(vdim=1024, dim=128, num_heads=8, attn_layer=2, max_vlen=64,
                word_dim=300, char_dim=50, num_chars=60)


def _jax_params(kw: dict, seed: int = 0) -> dict[str, np.ndarray]:
    kw = dict(kw)
    vdim = kw.pop("vdim")
    model = JaxSeqPAN(**kw)
    b, w, c = 2, 6, 5
    batch = {"video_features": jnp.zeros((b, kw["max_vlen"], vdim)),
             "video_seq_len": jnp.ones((b,), jnp.int32),
             "word_ids": jnp.ones((b, w), jnp.int32),
             "char_ids": jnp.ones((b, w, c), jnp.int32)}
    wv = jnp.zeros((3, kw["word_dim"]))
    init = jax.jit(lambda key: model.init({"params": key}, batch, wv, 0.0,
                                          deterministic=True))
    return _flatten_params(init(jax.random.key(seed)))


@pytest.fixture(scope="module", params=["small", "charades"])
def case(request):
    kw = SMALL if request.param == "small" else CHARADES
    return request.param, kw, _jax_params(kw)


def test_roundtrip_is_bit_exact(case):
    name, kw, flat = case
    model = load_jax_params(SeqPAN(**kw), flat)
    back = to_jax_params(model)
    assert set(back) == set(flat)
    for key, value in flat.items():
        assert back[key].dtype == np.float32, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    if name == "charades":
        assert len(flat) == 170
        assert sum(v.size for v in flat.values()) == 1_187_508


def test_fresh_init_has_jax_leaves_and_fan_limits(case):
    _, kw, flat = case
    port = to_jax_params(SeqPAN(**kw, generator=torch.Generator().manual_seed(3)))
    assert set(port) == set(flat)
    for key, value in port.items():
        assert value.shape == flat[key].shape, key
        leaf = key.rsplit("/", 1)[1]
        if leaf == "label_emb":
            np.testing.assert_allclose(value @ value.T, np.eye(4), atol=1e-6)
        elif leaf == "scale":
            assert (value == 1).all(), key
        elif leaf == "bias" or leaf.startswith("bias_"):
            assert (value == 0).all(), key
        else:
            fan_in, fan_out = _tf_fans(flat[key].shape)
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert np.abs(value).max() <= limit, key
            # a real draw spreads over the range, not a constant
            assert value.std() > limit / 4, key


def test_init_is_seeded():
    a = to_jax_params(SeqPAN(**SMALL, generator=torch.Generator().manual_seed(1)))
    b = to_jax_params(SeqPAN(**SMALL, generator=torch.Generator().manual_seed(1)))
    c = to_jax_params(SeqPAN(**SMALL, generator=torch.Generator().manual_seed(2)))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["params/video_conv1d/kernel"],
                              c["params/video_conv1d/kernel"])


def test_corrupt_params_raise():
    flat = _jax_params(SMALL)
    key = "params/d_attn_0/dual_multihead_attention/query/kernel"

    wrong = dict(flat)
    wrong[key] = np.zeros((1, 16, 17), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(SeqPAN(**SMALL), wrong)

    missing = dict(flat)
    del missing[key]
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(SeqPAN(**SMALL), missing)

    unknown = dict(flat)
    unknown[key + "_typo"] = flat[key]
    with pytest.raises(ValueError, match="unknown"):
        load_jax_params(SeqPAN(**SMALL), unknown)
