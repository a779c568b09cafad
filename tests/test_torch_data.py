"""Port parity: ``data.load_dataset`` (and its synthetic stand-in) against
the JAX package's, bitwise: the synthetic mnist and cifar10 sets, the
scikit-learn ``digits`` set with its shuffle and 80/20 split, the Keras
npz layout read from ``data_dir`` and from ``HVD_DATA_DIR``, the ``info``
dict, and the error texts (an unknown name; ``digits`` without
scikit-learn).
"""

import sys

import numpy as np
import pytest

from horovod_tpu import data as jdata
from horovod_tpu_torch import data as tdata


def _same(a, b):
    (ax, ay), (atx, aty), ainfo = a
    (bx, by), (btx, bty), binfo = b
    assert ainfo == binfo
    for u, v in ((ax, bx), (ay, by), (atx, btx), (aty, bty)):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert np.array_equal(u, v)


@pytest.mark.parametrize("name,kw", [
    ("mnist", {}), ("cifar10", {}), ("cifar10", dict(n_train=64,
                                                     n_test=16))])
def test_synthetic_sets_are_bitwise_jax(name, kw, monkeypatch):
    monkeypatch.delenv("HVD_DATA_DIR", raising=False)
    got = tdata.load_dataset(name, **kw)
    _same(got, jdata.load_dataset(name, **kw))
    assert got[2] == {"real": False, "classes": 10}
    shape = (784,) if name == "mnist" else (32, 32, 3)
    assert got[0][0].shape[1:] == shape
    assert got[0][0].dtype == np.float32 and got[0][1].dtype == np.int32


def test_synthetic_helper_is_bitwise_jax():
    a = tdata._synthetic(10, (4, 4, 3), 7, 3)
    b = jdata._synthetic(10, (4, 4, 3), 7, 3)
    assert all(np.array_equal(u, v) and u.dtype == v.dtype
               for u, v in zip(a, b))


def test_digits_is_bitwise_jax():
    pytest.importorskip("sklearn")
    got = tdata.load_dataset("digits")
    _same(got, jdata.load_dataset("digits"))
    (x, y), (tx, _), info = got
    assert info["real"] and x.shape == (1437, 8, 8, 1) and len(tx) == 360


@pytest.mark.parametrize("name,shape", [("mnist", (28, 28)),
                                        ("cifar10", (32, 32, 3))])
@pytest.mark.parametrize("via_env", [False, True])
def test_npz_layout_is_read_as_jax_reads_it(name, shape, via_env, tmp_path,
                                            monkeypatch):
    rng = np.random.RandomState(0)
    np.savez(tmp_path / f"{name}.npz",
             x_train=rng.randint(0, 256, (6, *shape)).astype(np.uint8),
             y_train=rng.randint(0, 10, (6, 1)).astype(np.uint8),
             x_test=rng.randint(0, 256, (3, *shape)).astype(np.uint8),
             y_test=rng.randint(0, 10, (3,)).astype(np.uint8))
    if via_env:
        monkeypatch.setenv("HVD_DATA_DIR", str(tmp_path))
        kw = {}
    else:
        monkeypatch.delenv("HVD_DATA_DIR", raising=False)
        kw = dict(data_dir=str(tmp_path))
    got = tdata.load_dataset(name, **kw)
    _same(got, jdata.load_dataset(name, **kw))
    assert got[2]["real"] and got[0][1].shape == (6,)


def test_unknown_name_raises_jax_text():
    with pytest.raises(ValueError) as jerr:
        jdata.load_dataset("imagenet")
    with pytest.raises(ValueError) as terr:
        tdata.load_dataset("imagenet")
    assert str(terr.value) == str(jerr.value)


def test_digits_without_sklearn_raises_jax_text(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError) as jerr:
        jdata.load_dataset("digits")
    with pytest.raises(ImportError) as terr:
        tdata.load_dataset("digits")
    assert str(terr.value) == str(jerr.value)
    assert "scikit-learn" in str(terr.value)
