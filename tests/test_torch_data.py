"""The port's data, partition and metrics modules against the JAX
package's: numpy in both, so everything is compared for exact
equality."""
import numpy as np
import pytest
import torch

from repro_torch.core import partition as PT
from repro_torch.data import registry as DR
from repro_torch.metrics import accuracy, f1_score
from test_torch_support import reference


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.mark.parametrize("name,n,seed", [
    ("mnist", 600, 0), ("fmnist", 300, 4), ("titanic", None, 0),
    ("bank", 1000, 7)])
def test_datasets_are_bit_identical(ref, name, n, seed):
    ours = DR.make_dataset(name, n, seed=seed)
    theirs = ref.data.make_dataset(name, n, seed=seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    entry, ref_entry = DR.get_dataset(name), ref.data.get_dataset(name)
    assert (entry.n_classes, entry.arch, entry.partition) == \
        (ref_entry.n_classes, ref_entry.arch, ref_entry.partition)


LAYOUTS = [
    # dataset, n_features, n_clients, seed, max_clients, sizes
    ("mnist", 784, 3, 0, None, None),
    ("mnist", 784, 5, 0, None, None),
    ("titanic", 9, 3, 0, None, None),
    ("titanic", 9, 3, 5, None, None),
    ("bank", 51, 4, 0, None, None),
    ("titanic", 9, 3, 1, None, (5, 3, 1)),
    ("titanic", 9, 3, 0, 5, None),
    ("mnist", 784, 3, 0, 6, None),
]


@pytest.mark.parametrize("ds,nf,nc,seed,maxc,sizes", LAYOUTS)
def test_layouts_are_equal(ref, ds, nf, nc, seed, maxc, sizes):
    ours = PT.make_layout(ds, nf, nc, seed=seed, max_clients=maxc,
                          sizes=sizes)
    theirs = ref.partition.make_layout(ds, nf, nc, seed=seed,
                                       max_clients=maxc, sizes=sizes)
    np.testing.assert_array_equal(ours.perm, theirs.perm)
    np.testing.assert_array_equal(ours.inv_perm, theirs.inv_perm)
    assert ours.offsets == theirs.offsets and ours.sizes == theirs.sizes
    assert (ours.block, ours.n_real, ours.n_clients, ours.n_features) == \
        (theirs.block, theirs.n_real, theirs.n_clients, theirs.n_features)
    assert len(ours.partition) == len(theirs.partition)
    for a, b in zip(ours.partition, theirs.partition):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.masks(), theirs.masks())
    np.testing.assert_array_equal(ours.client_mask(), theirs.client_mask())
    x = np.arange(2 * nf, dtype=np.float32).reshape(2, nf)
    np.testing.assert_array_equal(ours.apply(x), theirs.apply(x))

    arrs, ref_arrs = ours.arrays("cpu"), theirs.arrays()
    for field in arrs._fields:
        a, b = getattr(arrs, field), np.asarray(getattr(ref_arrs, field))
        assert a.device.type == "cpu"
        assert a.numpy().dtype == b.dtype, field
        np.testing.assert_array_equal(a.numpy(), b)


def test_partition_helpers_are_equal(ref):
    for ds, nf, nc in (("mnist", 784, 4), ("titanic", 9, 2),
                       ("bank", 51, 5)):
        for a, b in zip(PT.make_partition(ds, nf, nc, seed=3),
                        ref.partition.make_partition(ds, nf, nc, seed=3)):
            np.testing.assert_array_equal(a, b)
    part = PT.skewed_partition(9, (5, 3, 1), seed=2)
    np.testing.assert_array_equal(
        PT.masks_for(part, 9),
        ref.partition.masks_for(
            ref.partition.skewed_partition(9, (5, 3, 1), seed=2), 9))
    with pytest.raises(ValueError, match="sum to"):
        PT.skewed_partition(9, (5, 3))
    with pytest.raises(ValueError, match="max_clients"):
        PT.make_layout("titanic", 9, 3).pad(2)


@pytest.mark.parametrize("n_classes,average", [(10, "macro"), (2, "binary")])
def test_metrics_are_equal(ref, n_classes, average):
    rng = np.random.default_rng(n_classes)
    y = rng.integers(0, n_classes, 500)
    p = np.where(rng.uniform(size=500) < 0.6, y,
                 rng.integers(0, n_classes, 500))
    assert accuracy(y, p) == ref.metrics.accuracy(y, p)
    assert f1_score(y, p, average=average) == \
        ref.metrics.f1_score(y, p, average=average)
    with pytest.raises(ValueError, match="non-finite"):
        f1_score(y, np.where(p == 0, np.nan, p.astype(np.float32)))


def test_layout_arrays_land_on_the_device_asked_for():
    lay = PT.make_layout("titanic", 9, 3, max_clients=4).arrays(
        torch.device("cpu"))
    assert lay.offsets.dtype == torch.int32
    assert lay.sizes.tolist() == [3, 3, 3, 0]
    assert lay.client_mask.tolist() == [1.0, 1.0, 1.0, 0.0]
