"""The port's segmentation path against nbdt_tpu's, on the CPU.

The datasets (every sample of the four real ones on PNG/JPEG fixtures
written here, the synthetic set, the loader) are equal exactly: the same PIL
resizes and the same RandomState draws. SegNet, the flax module of
``examples/segmentation/train_seg.py``, is held to the port's within 1e-5 at
odd and non-square crops (f32 convolutions summed in other orders); the
per-pixel wrappers within 1e-5 (soft) and exactly (hard); two trainer steps
within 1e-4 (loss and weights; the BatchNorm running variance mapped through
n/(n-1), as tests/test_torch_train.py maps it: torch updates it with the
unbiased batch variance, flax with the biased one).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_port import induced_tree_pair, random_variables, tree_pair

SEG = ["PascalContext", "LookIntoPerson", "ADE20K", "Cityscapes"]
SEG_TREES = ["Cityscapes-induced-HRNet-w48", "Cityscapes-induced-HRNet-w18-v1",
             "LookIntoPerson-induced-HRNet-w48-cls20", "PascalContext-induced-HRNet-w48-cls59",
             "ADE20K-induced-HRNet-w48"]
SHAPES = [(30, 44), (41, 27)]  # one landscape and one portrait image a split
# labels drawn in [0, hi) per dataset: LIP's include its left/right pairs,
# Cityscapes' are raw labelIds (void ones too)
MASK_HI = {"PascalContext": 60, "LookIntoPerson": 20, "ADE20K": 151, "Cityscapes": 34}
SOFT_TOL = 1e-5
STEP_TOL = 1e-4


@pytest.fixture(scope="module")
def seg_root(tmp_path_factory):
    """Two image/mask pairs a split of each dataset, in its own layout."""
    from PIL import Image

    root = tmp_path_factory.mktemp("seg")
    rng = np.random.RandomState(0)

    def write(path, hw, hi=None):
        path.parent.mkdir(parents=True, exist_ok=True)
        if hi is None:
            Image.fromarray(rng.randint(0, 256, hw + (3,), np.uint8)).save(path)
        else:
            Image.fromarray(rng.randint(0, hi, hw).astype(np.uint8)).save(path)

    for split, odgt in (("train", "training"), ("val", "validation")):
        ids = [f"{split}{i}" for i in range(len(SHAPES))]
        pc, lip, ade = root / "PascalContext", root / "LookIntoPerson", root / "ADE20K"
        pc.mkdir(exist_ok=True)
        (pc / f"{split}.txt").write_text("\n".join(ids) + "\n")
        lip.mkdir(exist_ok=True)
        (lip / f"{split}_id.txt").write_text("\n".join(ids) + "\n")
        ade.mkdir(exist_ok=True)
        (ade / f"{odgt}.odgt").write_text("".join(
            json.dumps({"fpath_img": f"ADE20K/images/{n}.jpg",
                        "fpath_segm": f"ADE20K/annotations/{n}.png"}) + "\n" for n in ids))
        for name, hw in zip(ids, SHAPES):
            write(pc / "JPEGImages" / f"{name}.jpg", hw)
            write(pc / "Masks59" / f"{name}.png", hw, MASK_HI["PascalContext"])
            write(lip / "TrainVal_images" / f"{split}_images" / f"{name}.jpg", hw)
            write(lip / "TrainVal_parsing_annotations" / f"{split}_segmentations" / f"{name}.png",
                  hw, MASK_HI["LookIntoPerson"])
            write(ade / "images" / f"{name}.jpg", hw)
            write(ade / "annotations" / f"{name}.png", hw, MASK_HI["ADE20K"])
            city = root / "Cityscapes" / "leftImg8bit" / split / f"city{name[-1]}"
            write(city / f"{name}_leftImg8bit.png", hw)
            write(root / "Cityscapes" / "gtFine" / split / f"city{name[-1]}"
                  / f"{name}_gtFine_labelIds.png", hw, MASK_HI["Cityscapes"])
    return root


def assert_samples_equal(j, t, order):
    assert len(t) == len(j)
    for i in order:
        (jx, jy), (tx, ty) = j[i], t[i]
        assert tx.dtype == np.float32 and ty.dtype == np.int32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", SEG)
def test_dataset_samples_equal(seg_root, name, split):
    """Every sample, in a repeated order (the train draws go on), at an odd
    crop below the resized sizes and above some of them (padding)."""
    import nbdt_tpu.data.segmentation as js

    import nbdt_torch.data.segmentation as ts

    kw = dict(root=str(seg_root), split=split, base_size=32, crop_size=23, seed=5)
    j, t = getattr(js, name)(**kw), getattr(ts, name)(**kw)
    assert len(t) == 2
    assert_samples_equal(j, t, [0, 1, 1, 0, 1, 0, 0, 1])
    ys = np.concatenate([t[i][1].ravel() for i in range(2)])
    assert ys.min() >= t.ignore_label and ys.max() < t.NUM_CLASS


@pytest.mark.parametrize("split", ["train", "training", "val", "validation"])
def test_ade20k_split_names_and_ignore_label(seg_root, split):
    """ADE20K's two split namings, and void mapped to a configured 255."""
    import nbdt_tpu.data.segmentation as js

    import nbdt_torch.data.segmentation as ts

    kw = dict(root=str(seg_root), split=split, base_size=24, crop_size=16, ignore_label=255)
    j, t = js.ADE20K(**kw), ts.ADE20K(**kw)
    assert t.split == j.split
    assert_samples_equal(j, t, [1, 0, 1])
    _, mask = t._load_pair(0)
    assert 255 in mask and mask[mask != 255].max() < 150


def test_lip_flip_swaps_left_and_right():
    import nbdt_tpu.data.segmentation as js

    import nbdt_torch.data.segmentation as ts

    mask = np.random.RandomState(3).randint(0, 20, (9, 7)).astype(np.int32)
    mask[0, :6] = [14, 15, 16, 17, 18, 19]
    out = ts.LookIntoPerson.__new__(ts.LookIntoPerson)._on_hflip(mask)
    np.testing.assert_array_equal(out, js.LookIntoPerson.__new__(js.LookIntoPerson)._on_hflip(mask))
    np.testing.assert_array_equal(out[0, :6], [15, 14, 17, 16, 19, 18])


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_set_and_loader_equal(split):
    """SyntheticSegDataset's samples and SegDataLoader's batches over two
    epochs: shuffled and dropping the last batch (train), or in order with
    the last batch padded by zero images and void masks (eval)."""
    import nbdt_tpu.data.segmentation as js

    import nbdt_torch.data.segmentation as ts

    train = split == "train"
    ds = [m.SyntheticSegDataset(num_classes=5, size=7, image_size=20, crop_size=13, seed=2)
          for m in (js, ts)]
    for d in ds:
        d.split = split
    jl, tl = (m.SegDataLoader(d, 3, shuffle=train, seed=4, drop_last=train)
              for m, d in zip((js, ts), ds))
    assert len(tl) == len(jl) == (2 if train else 3)
    for _ in range(2):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == len(tl)
        for (tx, ty), (jx, jy) in zip(tb, jb):
            assert tx.shape == (3, 13, 13, 3) and ty.shape == (3, 13, 13)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    if not train:
        x, y = tb[-1]
        assert (y[1:] == ds[1].ignore_label).all() and (x[1:] == 0).all()


def test_class_lists_and_tables_equal():
    import nbdt_tpu.data.segmentation as js

    import nbdt_torch.data as td
    import nbdt_torch.data.segmentation as ts

    for name in SEG:
        j, t = getattr(js, name), getattr(ts, name)
        assert t.NUM_CLASS == j.NUM_CLASS == len(t.classes)
        assert t.classes == j.classes
        assert td.get_dataset(name) is t is getattr(td, name)
    assert (ts.Cityscapes.NUM_CLASS, ts.PascalContext.NUM_CLASS, ts.LookIntoPerson.NUM_CLASS,
            ts.ADE20K.NUM_CLASS) == (19, 59, 20, 150)
    np.testing.assert_array_equal(ts.PascalContext.DETAIL_MAPPING, js.PascalContext.DETAIL_MAPPING)
    assert ts.LookIntoPerson.FLIP_PAIRS == js.LookIntoPerson.FLIP_PAIRS
    assert ts.Cityscapes._LABEL_TO_TRAIN == js.Cityscapes._LABEL_TO_TRAIN


@pytest.mark.parametrize("name", SEG)
def test_missing_data_raises(tmp_path, name):
    import nbdt_torch.data.segmentation as ts

    with pytest.raises(FileNotFoundError, match=name if name != "LookIntoPerson" else "LIP"):
        getattr(ts, name)(root=str(tmp_path))


@pytest.mark.parametrize("name", SEG_TREES)
def test_seg_tree_arrays_equal(name):
    """The vendored HRNet trees of the four seg datasets compile alike."""
    jtree, ttree = tree_pair(name)
    ja, ta = jtree.arrays, ttree.arrays
    for f in dataclasses.fields(ja):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert ta.num_classes == {"Cityscapes": 19, "LookIntoPerson": 20, "PascalContext": 59,
                              "ADE20K": 150}[name.split("-")[0]]


# -- SegNet -------------------------------------------------------------------


def flax_segnet(num_classes):
    """The flax SegNet of examples/segmentation/train_seg.py, as written
    there (it is defined inside that script's main)."""
    import flax.linen as nn
    import jax

    class SegNet(nn.Module):
        num_classes: int

        @nn.compact
        def __call__(self, x, train: bool = False):
            norm = lambda name: nn.BatchNorm(use_running_average=not train,  # noqa: E731
                                             momentum=0.9, name=name)
            h = nn.relu(norm("bn1")(nn.Conv(32, (3, 3), name="c1")(x)))
            h = nn.relu(norm("bn2")(nn.Conv(64, (3, 3), strides=(2, 2), name="c2")(h)))
            h = nn.relu(norm("bn3")(nn.Conv(64, (3, 3), name="c3")(h)))
            h = jax.image.resize(h, (h.shape[0], x.shape[1], x.shape[2], h.shape[-1]),
                                 "nearest")
            return nn.Conv(self.num_classes, (1, 1), name="head")(h)

    return SegNet(num_classes)


def segnet_pair(num_classes, h, w, seed=0):
    """(flax module, numpy variables with perturbed BatchNorms, the port's
    SegNet loaded from them)."""
    import jax
    import jax.numpy as jnp

    from nbdt_torch.models import SegNet, state_dict_from_flax

    module = flax_segnet(num_classes)
    variables = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)))
    variables = random_variables(variables, seed)
    port = SegNet(num_classes)
    port.load_state_dict(state_dict_from_flax(variables, "SegNet"), strict=True)
    return module, variables, port


def images(n, h, w, seed=1):
    return np.random.RandomState(seed).randn(n, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("hw", [(15, 21), (16, 24)])
def test_segnet_matches_flax(hw, train):
    """Eval mode (running statistics) and train mode (batch statistics)."""
    import jax

    module, variables, port = segnet_pair(7, *hw)
    x = images(2, *hw)
    if train:
        want, _ = jax.jit(lambda v, x: module.apply(v, x, train=True,
                                                    mutable=["batch_stats"]))(variables, x)
    else:
        want = jax.jit(lambda v, x: module.apply(v, x))(variables, x)
    port.train(train)
    with torch.no_grad():
        got = port(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, *hw, 7)
    np.testing.assert_allclose(got, np.asarray(want), rtol=SOFT_TOL, atol=SOFT_TOL)


@pytest.mark.parametrize("hw,trap", [((16, 24), "padding=1"), ((15, 21), "nearest")])
def test_segnet_crops_catch_both_traps(hw, trap):
    """At an even side, torch's symmetric ``padding=1`` at stride 2 shifts
    every tap of c2; at 15x21, ``mode="nearest"`` picks other source rows
    than flax's half-pixel nearest. Either slip fails the test above."""
    import jax
    import torch.nn.functional as F

    from nbdt_torch.models.efficientnet import _same_pad

    module, variables, port = segnet_pair(7, *hw)
    x = images(2, *hw)
    want = np.asarray(jax.jit(lambda v, x: module.apply(v, x))(variables, x))
    port.eval()
    with torch.no_grad():
        t = torch.as_tensor(x).permute(0, 3, 1, 2)
        h = F.relu(port.bn1(port.c1(t)))
        h = F.pad(h, [1, 1, 1, 1]) if trap == "padding=1" else _same_pad(h, 3, 2)
        h = F.relu(port.bn3(port.c3(F.relu(port.bn2(port.c2(h))))))
        h = F.interpolate(h, size=hw, mode="nearest" if trap == "nearest" else "nearest-exact")
        slipped = port.head(h).permute(0, 2, 3, 1).numpy()
    assert np.abs(slipped - want).max() > 1e-2


def test_segnet_converter_keys():
    from nbdt_torch.models import SegNet, state_dict_from_flax

    _, variables, _ = segnet_pair(5, 8, 8)
    sd = state_dict_from_flax(variables, "SegNet")
    want = {k for k in SegNet(5).state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == want
    np.testing.assert_array_equal(sd["head.weight"][:, :, 0, 0].numpy(),
                                  np.asarray(variables["params"]["head"]["kernel"])[0, 0].T)


# -- the per-pixel wrappers ----------------------------------------------------


@pytest.mark.parametrize("tree_name", ["Cityscapes-induced-HRNet-w48",
                                       "LookIntoPerson-induced-HRNet-w48-cls20"])
def test_seg_wrappers_match_jax(tree_name):
    """SoftSegNBDT within 1e-5 and HardSegNBDT exactly, at a non-square crop
    (13x22: a wrapper that flattened NCHW maps would mix pixels and
    classes), on a vendored seg tree; the hard maps are one-hot."""
    from nbdt_tpu.model import HardSegNBDT as JHard
    from nbdt_tpu.model import SoftSegNBDT as JSoft

    from nbdt_torch.model import HardSegNBDT, SoftSegNBDT, TaggedOutput

    jtree, ttree = tree_pair(tree_name)
    C = ttree.arrays.num_classes
    module, variables, port = segnet_pair(C, 13, 22, seed=2)
    x = images(2, 13, 22, seed=3)
    for jcls, tcls in ((JSoft, SoftSegNBDT), (JHard, HardSegNBDT)):
        want = np.asarray(jcls(None, module, tree=jtree, params=variables)(x))
        got = tcls(None, port, tree=ttree, device="cpu")(x)
        assert isinstance(got, TaggedOutput) and got.shape == (2, 13, 22, C)
        if tcls is SoftSegNBDT:
            np.testing.assert_allclose(got.numpy(), want, rtol=SOFT_TOL, atol=SOFT_TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
            assert ((got.reshape(-1, C) > 0).sum(1) == 1).all()
        with pytest.raises(ValueError, match="N, H, W, C"):
            tcls(None, port, tree=ttree, device="cpu")(x[0])


def test_seg_wrappers_refuse_fused():
    from nbdt_tpu.model import SoftSegNBDT as JSoft

    from nbdt_torch.model import SoftSegNBDT

    jtree, ttree = tree_pair("Cityscapes-induced-HRNet-w48")
    module, variables, port = segnet_pair(19, 8, 8)
    with pytest.raises(AssertionError, match="segmentation"):
        JSoft(None, module, tree=jtree, params=variables, fused=True)
    with pytest.raises(AssertionError, match="segmentation"):
        SoftSegNBDT(None, port, tree=ttree, fused=True, device="cpu")


def test_seg_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default does not raise")
    from nbdt_torch.examples.train_seg import main
    from nbdt_torch.model import HardSegNBDT, SoftSegNBDT
    from nbdt_torch.models import SegNet

    _, tree = tree_pair("Cityscapes-induced-HRNet-w48")
    for cls in (SoftSegNBDT, HardSegNBDT):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(None, SegNet(19), tree=tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--epochs", "1", "--batch-size", "2", "--crop", "16"])


# -- the trainer -----------------------------------------------------------------


@pytest.mark.parametrize("num_classes,hw", [(7, (15, 21)), (23, (16, 24))])
def test_two_trainer_steps_match_jax(num_classes, hw):
    """The tree induced from the head's rows (both wnid rules: up to 20
    classes and above), then two SGD steps of the example's loss (masked CE
    + tsw x soft seg tree loss, void pixels included) from one init: the
    loss, every weight and the BatchNorm statistics after each step."""
    import jax
    import jax.numpy as jnp
    import optax
    from nbdt_tpu.losses import masked_cross_entropy, soft_seg_tree_sup_loss
    from nbdt_tpu.rules import to_device_tree as jdevice

    from nbdt_torch.examples.train_seg import induce_tree, make_seg_step
    from nbdt_torch.models import state_dict_from_flax
    from nbdt_torch.rules import to_device_tree

    lr, tsw = 0.05, 1.0
    module, variables, port = segnet_pair(num_classes, *hw, seed=4)
    classes = [f"segclass{i}" for i in range(num_classes)]
    wnids = ([f"f{i:08d}" for i in range(num_classes)])
    centers = np.asarray(variables["params"]["head"]["kernel"])[0, 0].T
    jtree, _ = induced_tree_pair(centers, wnids)
    ttree = induce_tree(port, classes)
    for f in dataclasses.fields(jtree.arrays):
        a, b = getattr(jtree.arrays, f.name), getattr(ttree.arrays, f.name)
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, f.name
    jt = jdevice(jtree.arrays)
    opt = optax.sgd(lr, momentum=0.9)

    @jax.jit
    def jstep(params, batch_stats, opt_state, x, y):  # the example's step
        def loss_fn(p):
            out, mutated = module.apply({"params": p, "batch_stats": batch_stats}, x,
                                        train=True, mutable=["batch_stats"])
            flat_out, flat_y = out.reshape(-1, out.shape[-1]), y.reshape(-1)
            loss = masked_cross_entropy(flat_out, flat_y)
            loss += tsw * soft_seg_tree_sup_loss(flat_out, flat_y, jt)
            return loss, mutated["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    step = make_seg_step(port, torch.optim.SGD(port.parameters(), lr=lr, momentum=0.9),
                         to_device_tree(ttree.arrays, "cpu"), tsw)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = opt.init(params)
    init = state_dict_from_flax(variables, "SegNet")
    h2, w2 = -(-hw[0] // 2), -(-hw[1] // 2)
    counts = {"bn1": 2 * hw[0] * hw[1], "bn2": 2 * h2 * w2, "bn3": 2 * h2 * w2}
    rng = np.random.RandomState(5)
    for s in (1, 2):
        x = rng.randn(2, *hw, 3).astype(np.float32)
        y = rng.randint(0, num_classes, (2, *hw)).astype(np.int32)
        y[0, :3] = -1
        params, stats, opt_state, jloss = jstep(params, stats, opt_state, jnp.asarray(x),
                                                jnp.asarray(y))
        tloss = step(torch.as_tensor(x), torch.as_tensor(y))
        assert abs(float(tloss) - float(jloss)) <= STEP_TOL, (s, float(tloss), float(jloss))
        want = state_dict_from_flax({"params": params, "batch_stats": stats}, "SegNet")
        got = port.state_dict()
        keep = 0.9 ** s
        for k, w in want.items():
            if k.endswith("running_var"):  # flax's biased updates -> torch's unbiased ones
                n = counts[k.split(".")[0]]
                w = keep * init[k] + n / (n - 1) * (w - keep * init[k])
            torch.testing.assert_close(got[k], w, rtol=STEP_TOL, atol=STEP_TOL, msg=k)


def test_example_runs_end_to_end(capsys):
    from nbdt_torch.examples.train_seg import main

    out = main(["--device", "cpu", "--epochs", "1", "--batch-size", "2", "--crop", "32"])
    (rec,) = out["epochs"]
    assert len(rec["step_losses"]) == 8 and all(np.isfinite(rec["step_losses"]))
    assert 0 <= rec["pixel_acc"] <= 100
    assert out["output_shape"] == (2, 32, 32, 20)
    text = capsys.readouterr().out
    assert "epoch 0: loss=" in text and "SoftSegNBDT output: (2, 32, 32, 20)" in text


@pytest.mark.gpu
def test_seg_wrappers_card_match_cpu_on_gpu():
    """SoftSegNBDT and HardSegNBDT on the card against device="cpu" at a
    non-square crop on the ADE20K tree: soft within 1e-5; hard equal but at
    pixels where a node's two best children are closer than twice the
    class maps' card-vs-CPU difference (none expected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from nbdt_torch.model import HardSegNBDT, SoftSegNBDT
    from nbdt_torch.models import SegNet
    from nbdt_torch.rules import get_all_node_outputs, to_device_tree
    from nbdt_torch.tree import Tree

    tree = Tree("ADE20K", hierarchy="induced-HRNet-w48")
    torch.manual_seed(0)
    cpu_model = SegNet(150).eval()
    card_model = copy.deepcopy(cpu_model)
    x = images(2, 24, 40, seed=6)
    with torch.no_grad():
        t = torch.as_tensor(x).permute(0, 3, 1, 2)
        map_cpu = cpu_model(t).permute(0, 2, 3, 1).reshape(-1, 150)
        map_diff = float((card_model.cuda()(t.cuda()).permute(0, 2, 3, 1).reshape(-1, 150).cpu()
                          - map_cpu).abs().max())
    soft = [SoftSegNBDT(None, m, tree=tree, device=d)(x).cpu()
            for m, d in ((card_model, "cuda"), (cpu_model, "cpu"))]
    torch.testing.assert_close(soft[0], soft[1], rtol=0, atol=SOFT_TOL)
    hard = [HardSegNBDT(None, m, tree=tree, device=d)(x).cpu().reshape(-1, 150)
            for m, d in ((card_model, "cuda"), (cpu_model, "cpu"))]
    bad = (hard[0] != hard[1]).any(-1)
    jt = to_device_tree(tree.arrays, "cpu")
    nl = get_all_node_outputs(map_cpu[bad], jt).logits
    top2 = torch.where(jt.child_mask[None], nl, -torch.inf).topk(2, dim=-1).values
    assert bool(((top2[..., 0] - top2[..., 1]) <= 2 * map_diff + 1e-6).any(-1).all())
