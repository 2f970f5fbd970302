"""The port's native ``.npy`` loader (``hual_tpu_torch/native``) against
``hual_tpu.native`` and against the NumPy path.

* ``load_npy_batch`` equals ``hual_tpu``'s bit for bit, statuses equal,
  over a directory with odd formats: f64 (parsed), Fortran order, 1-D, 3-D
  and another width (each a nonzero status), videos shorter and longer
  than ``max_vlen`` (downsampled);
* ``FeatureStore.from_dir(use_native=True)`` equals ``hual_tpu``'s bit for
  bit (its NumPy fallback included), and the NumPy path within rtol 1e-5 /
  atol 1e-6 (``tests/test_native.py``'s bounds: the bucket means sum in
  another order);
* a library that cannot be built or loaded logs a warning naming the
  cause, and ``from_dir`` reads every file with NumPy.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest

from hual_tpu import native as jax_native
from hual_tpu.data.features import FeatureStore as JaxFeatureStore
from hual_tpu_torch import native
from hual_tpu_torch.data.features import FeatureStore

MAX_VLEN, VDIM = 16, 24


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_feats")
    rng = np.random.default_rng(11)
    for i, n in enumerate([1, 5, 16, 17, 31, 40, 129]):
        np.save(d / f"v{i}.npy", rng.normal(size=(n, VDIM)).astype(np.float32))
    np.save(d / "v_f8.npy", rng.normal(size=(50, VDIM)))
    np.save(d / "v_fortran.npy",
            np.asfortranarray(rng.normal(size=(33, VDIM)).astype(np.float32)))
    return str(d)


@pytest.fixture(scope="module")
def odd_dir(feature_dir, tmp_path_factory):
    """The feature directory plus files no FeatureStore can pack."""
    d = tmp_path_factory.mktemp("native_odd")
    for name in os.listdir(feature_dir):
        os.symlink(os.path.join(feature_dir, name), d / name)
    rng = np.random.default_rng(12)
    np.save(d / "w_1d.npy", rng.normal(size=(VDIM,)).astype(np.float32))
    np.save(d / "w_3d.npy", rng.normal(size=(2, 5, VDIM)).astype(np.float32))
    np.save(d / "w_width.npy", rng.normal(size=(9, VDIM + 1)).astype(np.float32))
    return str(d)


def test_load_npy_batch_equals_hual_tpu(odd_dir):
    paths = sorted(os.path.join(odd_dir, f) for f in os.listdir(odd_dir))
    ours = native.load_npy_batch(paths, MAX_VLEN, VDIM)
    want = jax_native.load_npy_batch(paths, MAX_VLEN, VDIM)
    assert ours is not None, native.error()
    assert want is not None
    for a, b in zip(ours, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    failed = {os.path.basename(p) for p, st in zip(paths, ours[2]) if st != 0}
    assert failed == {"v_fortran.npy", "w_1d.npy", "w_3d.npy", "w_width.npy"}


def test_from_dir_equals_hual_tpu(feature_dir):
    ours = FeatureStore.from_dir(feature_dir, MAX_VLEN, use_native=True)
    want = JaxFeatureStore.from_dir(feature_dir, MAX_VLEN, use_native=True)
    assert ours.vid_index == want.vid_index
    np.testing.assert_array_equal(ours.packed, want.packed)
    np.testing.assert_array_equal(ours.lengths, want.lengths)
    assert ours.lengths.dtype == np.int32
    plain = FeatureStore.from_dir(feature_dir, MAX_VLEN, use_native=False)
    assert plain.vid_index == ours.vid_index
    np.testing.assert_array_equal(plain.lengths, ours.lengths)
    np.testing.assert_allclose(ours.packed, plain.packed, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("failure", ["build", "load"])
def test_unavailable_library_warns(feature_dir, tmp_path, monkeypatch, caplog,
                                   failure):
    lib = tmp_path / "libnpy_loader.so"
    monkeypatch.setattr(native, "library_path", lambda: lib)
    if failure == "build":
        monkeypatch.setattr(native, "GXX", str(tmp_path / "no-such-g++"))
    else:
        lib.write_bytes(b"not a shared library")
    monkeypatch.setattr(native, "_lib", None)      # as in a fresh process
    monkeypatch.setattr(native, "_error", None)
    with caplog.at_level(logging.WARNING):
        store = FeatureStore.from_dir(feature_dir, MAX_VLEN, use_native=True)
    cause = native.error()
    assert cause is not None and ("no-such-g++" in cause) == (failure == "build")
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 2 and all(cause in w for w in warnings), warnings
    plain = FeatureStore.from_dir(feature_dir, MAX_VLEN, use_native=False)
    np.testing.assert_array_equal(store.packed, plain.packed)
