"""The port's native sequence parser (``seqrec_tpu_torch/data/native.py``
on its own copy of ``seqrec_io.cc``) against the Python tokenizer, as
``tests/test_native_io.py`` holds the JAX package's, and the port's
``SequenceStore`` against the JAX package's on the same file: the same
arrays exactly (ratings rtol 1e-6, as there)."""

import os

import numpy as np
import pytest

from seqrec_tpu.data.dataset import SequenceStore as JaxSequenceStore
from seqrec_tpu_torch.data import native
from seqrec_tpu_torch.data.dataset import SequenceStore


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def _python_parse(filename):
    users, items, ratings, offsets = [], [], [], [0]
    with open(filename) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            users.append(int(float(parts[0])))
            seq = parts[1:]
            items.extend(int(float(t)) for t in seq[0::2])
            ratings.extend(float(t) for t in seq[1::2])
            offsets.append(len(items))
    return users, items, ratings, offsets


def test_native_sequences_match_python(lib, tmp_path):
    fn = tmp_path / "seqs"
    fn.write_text("0 5 4.5 7 3 2 1\n\n3 9 2.5\n7 1 1 2 2 3 3 4 4\n12 8 3e0 4 -1.5\n")
    before = native.native_loads
    items, ratings, offsets, users = native.load_sequences_native(str(fn))
    assert native.native_loads == before + 1
    pu, pi, pr, po = _python_parse(str(fn))
    np.testing.assert_array_equal(users, pu)
    np.testing.assert_array_equal(items, pi)
    np.testing.assert_allclose(ratings, pr, rtol=1e-6)
    np.testing.assert_array_equal(offsets, po)


def test_native_triplets(lib, tmp_path):
    fn = tmp_path / "trips"
    fn.write_text("0\t5\t4.0\n1\t2\t1.0\n1\t9\t3.5\n")
    users, items, ratings = native.load_triplets_native(str(fn))
    np.testing.assert_array_equal(users, [0, 1, 1])
    np.testing.assert_array_equal(items, [5, 2, 9])
    np.testing.assert_allclose(ratings, [4.0, 1.0, 3.5])


def test_missing_file_gives_none(lib, tmp_path):
    assert native.load_sequences_native(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("split", ["train_set_sequences", "val_set_sequences", "test_set_sequences"])
def test_sequence_store_uses_native_and_equals_python_and_jax(lib, synthetic_dataset, split, monkeypatch):
    fn = os.path.join(synthetic_dataset, "data", split)
    before = native.native_loads
    store = SequenceStore.from_file(fn)
    assert native.native_loads == before + 1  # the native path was taken
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", True)  # the Python tokenizer
    store_py = SequenceStore.from_file(fn)
    assert native.native_loads == before + 1
    want = JaxSequenceStore.from_file(fn)
    for other in (store_py, want):
        np.testing.assert_array_equal(store.items, other.items)
        np.testing.assert_array_equal(store.offsets, other.offsets)
        np.testing.assert_array_equal(store.user_ids, other.user_ids)
        np.testing.assert_allclose(store.ratings, other.ratings, rtol=1e-6)
        assert store.items.dtype == other.items.dtype and store.offsets.dtype == other.offsets.dtype


def test_no_native_env_takes_the_python_tokenizer(synthetic_dataset, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    monkeypatch.setenv("SEQREC_NO_NATIVE", "1")
    assert native.get_lib() is None
    fn = os.path.join(synthetic_dataset, "data", "train_set_sequences")
    before = native.native_loads
    store = SequenceStore.from_file(fn)
    assert native.native_loads == before and len(store) > 0


def test_the_library_is_built_into_the_checkout(lib):
    path = native.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.isfile(path) and path.startswith(os.path.join(root, "build", "seqrec_tpu_torch") + os.sep)
