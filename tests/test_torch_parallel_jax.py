"""A world-2 train step of the port (gloo on the CPU) against ``hual_tpu``'s
``make_train_step`` sharded over its 8-device CPU mesh, as
``tests/test_sharding.py`` runs it: the same weights (through
``weights.py``, ``label_emb`` moved off its orthogonal init), the same
batch, drop 0; loss within rtol 1e-5, params within rtol 2e-4 / atol 2e-6
(``test_sharding.py``'s bounds).  Most of the time is JAX's init and its
compile of the sharded step.
"""

from __future__ import annotations

import numpy as np
import pytest

from hual_tpu_torch.parallel import make_mesh
from test_torch_parallel import (LR, SEL, WIDTHS, assert_params_close,  # noqa: F401
                                 one_torch_thread, run_ranks, split, step,
                                 word_vectors)


def jax_step_ranks(rank: int, flat: dict) -> dict:
    return step(make_mesh(), drop=0.0, gumbel=False, flat=flat)


@pytest.fixture(scope="module")
def jax_reference():
    """(the initial flat params, the loss, the flat params after one step)."""
    import jax
    import jax.numpy as jnp

    from hual_tpu.models.seqpan import SeqPAN as JaxSeqPAN
    from hual_tpu.ops.optim import make_optimizer as jax_make_optimizer
    from hual_tpu.parallel.mesh import batch_sharding, replicated
    from hual_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from hual_tpu.runtime import steps as jsteps
    from hual_tpu.serve import _flatten_params

    jmodel = JaxSeqPAN(**{k: v for k, v in WIDTHS.items() if k != "vdim"})
    jdata = {k: jnp.asarray(v) for k, v in split().items()}
    batch = jax.device_get(jsteps.gather_batch(jdata, jnp.asarray(SEL),
                                               with_labels=True))
    wv = word_vectors()
    params = jmodel.init({"params": jax.random.key(0)}, batch, wv, 0.0,
                         batch["match_labels"], deterministic=True)
    flat = _flatten_params(params)
    flat["params/label_emb"] = (flat["params/label_emb"] + 0.1 * np.random.default_rng(
        4).normal(size=flat["params/label_emb"].shape)).astype(np.float32)
    tx = jax_make_optimizer(1.0, 0.01)
    mesh = jax_make_mesh()
    assert mesh.devices.shape == (8, 1)
    repl, bsh = replicated(mesh), batch_sharding(mesh)
    p = jax.device_put({"params": _unflatten(flat)}, repl)
    sharded = {k: jax.device_put(v, bsh) for k, v in batch.items()}
    train_step = jax.jit(jsteps.make_train_step(jmodel, tx, 1.0, 0.0))
    p, _, m = train_step(p, jax.device_put(tx.init(p), repl), sharded,
                         jax.device_put(wv, repl), jnp.float32(LR), jax.random.key(3))
    after = {k: np.asarray(v) for k, v in _flatten_params(jax.device_get(p)).items()}
    return flat, float(m["loss"]), after


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")[1:]
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def world2(jax_reference, tmp_path_factory):
    return run_ranks(jax_step_ranks, 2, str(tmp_path_factory.mktemp("jax_step")),
                     jax_reference[0])


def test_world2_step_matches_jax_sharded(world2, jax_reference):
    _, jloss, jparams = jax_reference
    for r in world2:
        assert r["losses"]["loss"] == pytest.approx(jloss, rel=1e-5)
        assert_params_close(r["params"], jparams)
