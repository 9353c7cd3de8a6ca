"""nbdt_torch.data against nbdt_tpu.data: the synthetic datasets' bytes per
seed, the loader's batches (order, drop_last / pad_last, shards, the valid
mask), and the train and val transforms on the same RandomState draws.

uint8 images, labels and masks are held equal; normalized f32 batches
within 1e-6 (the JAX package may take its native augment, which rounds the
normalization in another order).
"""

import numpy as np
import pytest

from test_torch_port import torch_threads  # noqa: F401  (autouse)


def _datasets(kind, **kw):
    import nbdt_tpu.data as jd
    import nbdt_torch.data as td

    return getattr(jd, kind)(**kw), getattr(td, kind)(**kw)


@pytest.mark.parametrize("kind,kw", [
    ("SyntheticDataset", dict(num_classes=7, size=40, image_size=16, seed=3)),
    ("LearnableSyntheticDataset", dict(num_classes=10, size=64, image_size=8, seed=0)),
    ("LearnableSyntheticDataset", dict(num_classes=10, size=32, image_size=8, seed=0,
                                       train=False)),
    ("LearnableSyntheticDataset", dict(num_classes=6, size=32, image_size=8, seed=2,
                                       groups=[0, 0, 1, 1, 2, 2], group_blend=0.3)),
])
def test_synthetic_datasets_are_byte_identical(kind, kw):
    j, t = _datasets(kind, **kw)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert t.classes == j.classes and len(t) == len(j)
    assert t[5][1] == j[5][1]
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)


def _batches(loader):
    return [(np.asarray(x), np.asarray(y), np.asarray(v)) for x, y, v in loader]


@pytest.mark.parametrize("kw", [
    dict(batch_size=8, shuffle=True, seed=0),
    dict(batch_size=7, shuffle=True, seed=5, drop_last=False),
    dict(batch_size=7, shuffle=False, drop_last=False, pad_last=True),
    dict(batch_size=6, shuffle=True, seed=1, num_shards=3, shard_id=2, pad_last=True),
    dict(batch_size=5, shuffle=True, seed=2, num_shards=4, shard_id=0, drop_last=False),
])
@pytest.mark.parametrize("transform", [None, "train", "train_uint8", "val"])
def test_loader_batches_match(kw, transform):
    import nbdt_tpu.data as jd
    import nbdt_torch.data as td

    jds, tds = _datasets("SyntheticDataset", num_classes=7, size=43, image_size=8, seed=1)
    make = {None: lambda ds: None,
            "train": lambda ds: ds.transform_train(seed=4),
            "train_uint8": lambda ds: ds.transform_train(seed=4, device_normalize=True),
            "val": lambda ds: ds.transform_val()}[transform]
    jl = jd.DataLoader(jds, transform=make(jds), **kw)
    tl = td.DataLoader(tds, transform=make(tds), **kw)
    assert len(tl) == len(jl)
    for epoch in range(2):  # the shuffle state carries over between epochs
        jb, tb = _batches(jl), _batches(tl)
        assert len(tb) == len(jb) == len(tl)
        for (jx, jy, jv), (tx, ty, tv) in zip(jb, tb):
            assert tx.dtype == jx.dtype and tx.shape == jx.shape, epoch
            if tx.dtype == np.uint8:
                np.testing.assert_array_equal(tx, jx)
            else:
                np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(ty, jy)
            assert ty.dtype == np.int32
            np.testing.assert_array_equal(tv, jv)


def test_prefetch_loader_yields_the_same_batches():
    import nbdt_torch.data as td

    ds = td.SyntheticDataset(num_classes=5, size=30, image_size=8)
    plain = _batches(td.DataLoader(ds, 4, shuffle=True, seed=3, drop_last=False))
    fetched = td.PrefetchLoader(td.DataLoader(ds, 4, shuffle=True, seed=3, drop_last=False))
    assert len(fetched) == len(plain)
    got = _batches(fetched)
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_prefetch_loader_raises_the_producers_error():
    import nbdt_torch.data as td

    class Broken:
        def __len__(self):
            return 2

        def __iter__(self):
            yield 1
            raise ValueError("broken batch")

    with pytest.raises(ValueError, match="broken batch"):
        list(td.PrefetchLoader(Broken()))


@pytest.mark.parametrize("pad", [0, 2, 4])
def test_transforms_match(pad):
    import nbdt_tpu.data.transforms as jt
    import nbdt_torch.data.transforms as tt

    x = np.random.RandomState(7).randint(0, 256, (19, 12, 12, 3), np.uint8)
    for hflip in (True, False):
        j = jt.make_train_transform(jt.CIFAR_MEAN, jt.CIFAR_STD, crop_pad=pad, hflip=hflip, seed=9)
        t = tt.make_train_transform(tt.CIFAR_MEAN, tt.CIFAR_STD, crop_pad=pad, hflip=hflip, seed=9)
        for _ in range(2):
            np.testing.assert_allclose(t(x), j(x), rtol=0, atol=1e-6)
        j = jt.make_train_transform(jt.CIFAR_MEAN, jt.CIFAR_STD, crop_pad=pad, hflip=hflip,
                                    seed=9, device_normalize=True)
        t = tt.make_train_transform(tt.CIFAR_MEAN, tt.CIFAR_STD, crop_pad=pad, hflip=hflip,
                                    seed=9, device_normalize=True)
        for _ in range(2):
            np.testing.assert_array_equal(t(x), j(x))
    np.testing.assert_allclose(tt.make_val_transform(tt.IMAGENET_MEAN, tt.IMAGENET_STD)(x),
                               jt.make_val_transform(jt.IMAGENET_MEAN, jt.IMAGENET_STD)(x),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt.normalize(x, tt.CIFAR_MEAN, tt.CIFAR_STD),
                                  jt.normalize(x, jt.CIFAR_MEAN, jt.CIFAR_STD))
    inv = tt.InverseNormalize(tt.CIFAR_MEAN, tt.CIFAR_STD)
    np.testing.assert_allclose(inv(tt.normalize(x, tt.CIFAR_MEAN, tt.CIFAR_STD)), x / 255.0,
                               atol=1e-6)
    if pad:
        rj, rt = np.random.RandomState(1), np.random.RandomState(1)
        np.testing.assert_array_equal(tt.random_crop(x, pad, rt), jt.random_crop(x, pad, rj))
        np.testing.assert_array_equal(tt.random_hflip(x, rt), jt.random_hflip(x, rj))


def test_cifar_reads_pickles_and_raises_when_missing(tmp_path):
    """CIFAR10 and CIFAR100 read the python-pickle files (written here in
    their layout) as the JAX package does, and raise when they are absent."""
    import pickle

    import nbdt_tpu.data as jd
    import nbdt_torch.data as td

    rng = np.random.RandomState(0)
    c10 = tmp_path / "cifar-10-batches-py"
    c10.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(c10 / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (3, 3072), np.uint8),
                         "labels": list(rng.randint(0, 10, 3))}, f)
    c100 = tmp_path / "cifar-100-python"
    c100.mkdir()
    for name in ("train", "test"):
        with open(c100 / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (4, 3072), np.uint8),
                         "fine_labels": list(rng.randint(0, 100, 4))}, f)
    with open(c100 / "meta", "wb") as f:
        pickle.dump({"fine_label_names": [f"c{i}" for i in range(100)]}, f)
    for cls in ("CIFAR10", "CIFAR100"):
        for train in (True, False):
            j = getattr(jd, cls)(root=str(tmp_path), train=train)
            t = getattr(td, cls)(root=str(tmp_path), train=train)
            np.testing.assert_array_equal(t.images, j.images)
            np.testing.assert_array_equal(t.labels, j.labels)
            assert t.classes == j.classes
        with pytest.raises(FileNotFoundError):
            getattr(td, cls)(root=str(tmp_path / "missing"))
    assert td.get_dataset("CIFAR10") is td.CIFAR10
    assert td.get_dataset("Cityscapes") is td.Cityscapes  # the port's seg dataset


def _write_png(path, rng, size):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(path)


def test_tinyimagenet_and_imagenet_read_folders(tmp_path):
    """TinyImagenet200 (the train image folder and the annotated val split)
    and Imagenet1000 (a lazy folder resized to 224) read a fake tree of PNGs
    as the JAX classes do: the same arrays, labels, classes and transforms;
    both refuse download=True, and a missing tree raises."""
    import nbdt_tpu.data.imagenet as ji

    import nbdt_torch.data as td

    rng = np.random.RandomState(0)
    tiny = tmp_path / "tiny-imagenet-200"
    wnids = ["n02", "n01", "n03"]  # unsorted on disk: classes are sorted
    tiny.mkdir()
    (tiny / "wnids.txt").write_text("\n".join(wnids) + "\n")
    for w in wnids:
        for i in range(2):
            _write_png(tiny / "train" / w / "images" / f"{w}_{i}.png", rng, 64)
    ann = []
    for i, w in enumerate(["n03", "n01", "n02", "n03"]):
        _write_png(tiny / "val" / "images" / f"val_{i}.png", rng, 64)
        ann.append(f"val_{i}.png\t{w}\t0\t0\t63\t63")
    (tiny / "val" / "val_annotations.txt").write_text("\n".join(ann) + "\n")
    for c in ("n04", "n05"):
        for i in range(2):
            _write_png(tmp_path / "imagenet-1000" / "val" / c / f"{c}_{i}.png", rng, 48)

    for train in (True, False):
        j = ji.TinyImagenet200(root=str(tmp_path), train=train)
        t = td.TinyImagenet200(root=str(tmp_path), train=train)
        assert t.images.shape[1:] == (64, 64, 3) and t.images.dtype == np.uint8
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.labels, j.labels)
        assert t.classes == j.classes == sorted(wnids)
    x = t.images
    np.testing.assert_allclose(t.transform_val()(x), j.transform_val()(x), atol=1e-6)
    np.testing.assert_allclose(t.transform_train(seed=3)(x), j.transform_train(seed=3)(x),
                               atol=1e-6)
    np.testing.assert_array_equal(t.mean, j.mean)

    j, t = (m.Imagenet1000(root=str(tmp_path), train=False) for m in (ji, td))
    assert t.classes == j.classes and len(t) == len(j) == 4
    for i in range(4):
        np.testing.assert_array_equal(t[i][0], j[i][0])
        assert t[i][0].shape == (224, 224, 3) and t[i][1] == j[i][1]
    xs = np.stack([t[i][0] for i in range(4)])
    np.testing.assert_allclose(t.transform_train(seed=1)(xs), j.transform_train(seed=1)(xs),
                               atol=1e-6)
    loader = td.DataLoader(t, 3, transform=t.transform_val(), drop_last=False, pad_last=True)
    assert [x.shape for x, _, _ in loader] == [(3, 224, 224, 3)] * 2

    assert td.get_dataset("TinyImagenet200") is td.TinyImagenet200
    assert td.get_dataset("Imagenet1000") is td.Imagenet1000
    for cls in (td.TinyImagenet200, td.Imagenet1000):
        with pytest.raises(ValueError, match="downloads no datasets"):
            cls(root=str(tmp_path), download=True)
        with pytest.raises(FileNotFoundError):
            cls(root=str(tmp_path / "missing"))


def test_synthetic_cli_datasets_take_the_dataset_resolution():
    """--synthetic builds 64px data for TinyImagenet200, 224px for
    Imagenet1000 and 32px for CIFAR, with the dataset's class count."""
    import argparse

    from nbdt_torch.main import build_datasets

    for dataset, size, n in (("TinyImagenet200", 64, 200), ("CIFAR100", 32, 100),
                             ("Imagenet1000", 224, 1000)):
        args = argparse.Namespace(synthetic=True, dataset=dataset, dataset_test=None,
                                  batch_size=2, disable_test_eval=False)
        train, test = build_datasets(args)
        assert train.images.shape[1:] == (size, size, 3) == test.images.shape[1:]
        assert len(train.classes) == len(test.classes) == n
