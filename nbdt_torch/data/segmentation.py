"""Segmentation datasets: Cityscapes, PascalContext, LookIntoPerson, ADE20K.

Counterpart of ``nbdt_tpu/data/segmentation.py``, sample for sample: the
same PIL resizes (bilinear for images, nearest for masks), the same
``RandomState`` draws in the same order (flip, scale, crop), the same
``ignore_label`` on void and padded pixels and the same fixed ``crop_size``
for train and eval, so that every batch has one static shape. Samples are
NHWC float32 images and int32 HW masks, as in the JAX package; a model's
NCHW class maps are permuted back by :class:`~nbdt_torch.model.SegNBDT`.

A dataset whose files are absent raises ``FileNotFoundError`` naming the
layout it expects; :class:`SyntheticSegDataset` is the offline stand-in.
Class lists and label mappings are the reference's dataset facts
(pascal_context.py, lip.py, ade20k.py; Cityscapes' labelId -> trainId
table).
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from .transforms import IMAGENET_MEAN, IMAGENET_STD

__all__ = [
    "SegDatasetBase",
    "Cityscapes",
    "PascalContext",
    "LookIntoPerson",
    "ADE20K",
    "SyntheticSegDataset",
    "SegDataLoader",
]


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _load_mask(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, dtype=np.int32)


def _resize(img: np.ndarray, size_hw: Tuple[int, int], nearest: bool) -> np.ndarray:
    """PIL resize; bilinear for images (HWC u8), nearest for masks (HW i32)."""
    from PIL import Image

    h, w = size_hw
    if nearest:
        pil = Image.fromarray(img.astype(np.int32), mode="I")
        out = pil.resize((w, h), Image.NEAREST)
        return np.asarray(out, dtype=np.int32)
    pil = Image.fromarray(img)
    out = pil.resize((w, h), Image.BILINEAR)
    return np.asarray(out, dtype=np.uint8)


class SegDatasetBase:
    """Shared scale/flip/crop machinery (reference pascal_context.py:20-113,
    lip.py/ade20k.py BaseDataset gen_sample semantics), in numpy and PIL.

    Subclasses set ``NUM_CLASS``, ``classes``, and implement
    ``_load_pair(index) -> (image u8 HWC, mask i32 HW)``.
    """

    NUM_CLASS: int = 0
    classes: List[str] = []

    def __init__(
        self,
        root: str = "./data",
        split: str = "train",
        base_size: int = 520,
        crop_size: int = 480,
        scale_range: Tuple[float, float] = (0.5, 2.0),
        ignore_label: int = -1,
        mean: np.ndarray = IMAGENET_MEAN,
        std: np.ndarray = IMAGENET_STD,
        seed: int = 0,
    ):
        self.root = root
        self.split = split
        self.base_size = base_size
        self.crop_size = crop_size
        self.scale_range = scale_range
        self.ignore_label = ignore_label
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.rng = np.random.RandomState(seed)

    # -- per-sample pipeline ---------------------------------------------

    def _train_sample(self, img: np.ndarray, mask: np.ndarray):
        # random horizontal mirror
        if self.rng.rand() < 0.5:
            img, mask = img[:, ::-1], mask[:, ::-1]
            mask = self._on_hflip(mask)
        # random scale of the long side in [0.5, 2.0] * base_size
        h, w = img.shape[:2]
        lo, hi = self.scale_range
        long_size = self.rng.randint(
            int(self.base_size * lo), int(self.base_size * hi) + 1
        )
        if h > w:
            oh, ow = long_size, max(1, int(w * long_size / h + 0.5))
        else:
            ow, oh = long_size, max(1, int(h * long_size / w + 0.5))
        img = _resize(img, (oh, ow), nearest=False)
        mask = _resize(mask, (oh, ow), nearest=True)
        # pad to at least crop_size (image 0, mask ignore)
        cs = self.crop_size
        ph, pw = max(0, cs - oh), max(0, cs - ow)
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            mask = np.pad(mask, ((0, ph), (0, pw)), constant_values=self.ignore_label)
        # random crop
        h, w = img.shape[:2]
        y = self.rng.randint(0, h - cs + 1)
        x = self.rng.randint(0, w - cs + 1)
        return img[y : y + cs, x : x + cs], mask[y : y + cs, x : x + cs]

    def _val_sample(self, img: np.ndarray, mask: np.ndarray):
        # resize short side to crop_size, center crop (reference
        # pascal_context.py:56-75 _val_sync_transform)
        cs = self.crop_size
        h, w = img.shape[:2]
        if w > h:
            oh, ow = cs, max(cs, int(w * cs / h))
        else:
            ow, oh = cs, max(cs, int(h * cs / w))
        img = _resize(img, (oh, ow), nearest=False)
        mask = _resize(mask, (oh, ow), nearest=True)
        y = int(round((oh - cs) / 2.0))
        x = int(round((ow - cs) / 2.0))
        return img[y : y + cs, x : x + cs], mask[y : y + cs, x : x + cs]

    def _on_hflip(self, mask: np.ndarray) -> np.ndarray:
        """Hook: fix left/right-sensitive labels after a mirror."""
        return mask

    def __getitem__(self, index: int):
        img, mask = self._load_pair(index)
        if self.split == "train":
            img, mask = self._train_sample(img, mask)
        else:
            img, mask = self._val_sample(img, mask)
        x = (img.astype(np.float32) / 255.0 - self.mean) / self.std
        return x, np.ascontiguousarray(mask.astype(np.int32))

    def _load_pair(self, index: int):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class PascalContext(SegDatasetBase):
    """PASCAL-Context 59-class segmentation (reference pascal_context.py:116+).

    Requires the `detail` annotation API + trainval_merged.json; since that
    toolkit is not installable here, this loader reads pre-rendered mask PNGs
    from ``<root>/PascalContext/Masks59/<image_id>.png`` (generate once with
    the detail API elsewhere) next to ``JPEGImages``. The 459->59 category
    mapping and class names are the reference's.
    """

    NUM_CLASS = 59
    # 459-category detail ids that survive into the 59-class task, sorted;
    # position in this list = class id (0 = background, dropped from logits).
    DETAIL_MAPPING = np.array(sorted([
        0, 2, 259, 260, 415, 324, 9, 258, 144, 18, 19, 22, 23, 397, 25, 284,
        158, 159, 416, 33, 162, 420, 454, 295, 296, 427, 44, 45, 46, 308, 59,
        440, 445, 31, 232, 65, 354, 424, 68, 326, 72, 458, 34, 207, 80, 355,
        85, 347, 220, 349, 360, 98, 187, 104, 105, 366, 189, 368, 113, 115,
    ]), dtype=np.int32)
    classes = [
        "aeroplane", "mountain", "mouse", "track", "road", "bag", "motorbike",
        "fence", "bed", "bedclothes", "bench", "bicycle", "diningtable",
        "bird", "person", "floor", "boat", "train", "book", "bottle", "tree",
        "window", "plate", "platform", "tvmonitor", "building", "bus",
        "cabinet", "shelves", "light", "pottedplant", "wall", "car", "ground",
        "cat", "sidewalk", "truck", "ceiling", "rock", "chair", "wood",
        "food", "horse", "cloth", "sign", "computer", "sheep", "keyboard",
        "flower", "sky", "cow", "grass", "cup", "curtain", "snow", "water",
        "sofa", "dog", "door",
    ]

    def __init__(self, root="./data", split="train", base_size=520,
                 crop_size=480, **kw):
        super().__init__(root, split, base_size, crop_size, **kw)
        base = os.path.join(root, "PascalContext")
        self.img_dir = os.path.join(base, "JPEGImages")
        self.mask_dir = os.path.join(base, "Masks59")
        list_file = os.path.join(base, f"{split}.txt")
        if not os.path.exists(list_file):
            raise FileNotFoundError(
                f"PascalContext file list not found: {list_file}. Expected "
                "layout: PascalContext/{JPEGImages,Masks59,train.txt,val.txt} "
                "(render Masks59 once with the `detail` toolkit; see docstring)."
            )
        with open(list_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    def __len__(self):
        return len(self.ids)

    def _load_pair(self, index):
        name = self.ids[index]
        img = _load_image(os.path.join(self.img_dir, name + ".jpg"))
        mask = _load_mask(os.path.join(self.mask_dir, name + ".png"))
        # rendered masks are already 0..59; shift so background=0 -> ignore,
        # classes become 0..58 (reference trains on 59 classes, making
        # make_pred offset +1; here void/background is ignore_label)
        mask = mask.astype(np.int32) - 1
        mask[mask < 0] = self.ignore_label
        return img, mask


class LookIntoPerson(SegDatasetBase):
    """LIP 20-class human parsing (reference lip.py:150-268).

    File lists: ``<root>/LookIntoPerson/{train,val}_id.txt`` with one image
    id per line; images under TrainVal_images/<split>_images/<id>.jpg, masks
    under TrainVal_parsing_annotations/<split>_segmentations/<id>.png.
    """

    NUM_CLASS = 20
    classes = [
        "background", "hat", "hair", "glove", "sunglasses", "upper-clothes",
        "dress", "coat", "socks", "pants", "jumpsuits", "scarf", "skirt",
        "face", "left-arm", "right-arm", "left-leg", "right-leg",
        "left-shoe", "right-shoe",
    ]
    # (left, right) id pairs swapped on horizontal flip (reference lip.py:256-262)
    FLIP_PAIRS = ((14, 15), (16, 17), (18, 19))

    def __init__(self, root="./data", split="train", base_size=473,
                 crop_size=473, **kw):
        super().__init__(root, split, base_size, crop_size, **kw)
        base = os.path.join(root, "LookIntoPerson")
        list_file = os.path.join(base, f"{split}_id.txt")
        if not os.path.exists(list_file):
            raise FileNotFoundError(
                f"LIP file list not found: {list_file}. Expected layout: "
                "LookIntoPerson/{train_id.txt,val_id.txt,TrainVal_images,"
                "TrainVal_parsing_annotations}."
            )
        with open(list_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.img_dir = os.path.join(base, "TrainVal_images", f"{split}_images")
        self.mask_dir = os.path.join(
            base, "TrainVal_parsing_annotations", f"{split}_segmentations"
        )

    def __len__(self):
        return len(self.ids)

    def _load_pair(self, index):
        name = self.ids[index]
        img = _load_image(os.path.join(self.img_dir, name + ".jpg"))
        mask = _load_mask(os.path.join(self.mask_dir, name + ".png"))
        return img, mask

    def _on_hflip(self, mask):
        out = mask.copy()
        for left, right in self.FLIP_PAIRS:
            out[mask == left] = right
            out[mask == right] = left
        return out


class ADE20K(SegDatasetBase):
    """ADE20K 150-class scene parsing (reference ade20k.py:146-382).

    File list: odgt (one JSON per line: {"fpath_img", "fpath_segm"}) as in
    the reference, at ``<root>/ADE20K/<split>.odgt``. Raw mask values are
    1..150 with 0 = void; converted to 0..149 with -1 void
    (reference ade20k.py:360-363 convert_label).
    """

    NUM_CLASS = 150
    classes = [
        "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
        "windowpane", "grass", "cabinet", "sidewalk", "person", "earth",
        "door", "table", "mountain", "plant", "curtain", "chair", "car",
        "water", "painting", "sofa", "shelf", "house", "sea", "mirror",
        "rug", "field", "armchair", "seat", "fence", "desk", "rock",
        "wardrobe", "lamp", "bathtub", "railing", "cushion", "pedestal",
        "box", "column", "signboard", "chest_of_drawers", "counter", "sand",
        "sink", "skyscraper", "fireplace", "refrigerator", "grandstand",
        "path", "stairs", "runway", "case", "pool_table", "pillow",
        "screen_door", "stairway", "river", "bridge", "bookcase", "blind",
        "coffee_table", "toilet", "flower", "book", "hill", "bench",
        "countertop", "stove", "palm_tree", "kitchen_island", "computer",
        "swivel_chair", "boat", "bar", "arcade_machine", "hovel", "bus",
        "towel", "light_source", "truck", "tower", "chandelier", "awning",
        "streetlight", "booth", "television_receiver", "airplane",
        "dirt_track", "apparel", "pole", "land", "handrail", "escalator",
        "ottoman", "bottle", "buffet", "poster", "stage", "van", "ship",
        "fountain", "conveyer_belt", "canopy", "washer", "toy",
        "swimming_pool", "stool", "barrel", "basket", "waterfall", "tent",
        "bag", "minibike", "cradle", "oven", "ball", "food", "step",
        "storage_tank", "brand", "microwave", "flowerpot", "animal",
        "bicycle", "lake", "dishwasher", "screen", "blanket", "sculpture",
        "exhaust_hood", "sconce", "vase", "traffic_light", "tray",
        "trash_can", "fan", "pier", "crt_screen", "plate", "monitor",
        "bulletin_board", "shower", "radiator", "drinking_glass", "clock",
        "flag",
    ]

    def __init__(self, root="./data", split="training", base_size=512,
                 crop_size=512, **kw):
        # Accept both the sibling datasets' split names (train/val) and
        # ADE20K's own odgt names (training/validation); normalize each way.
        canonical = {"training": "train", "validation": "val"}
        odgt_name = {"train": "training", "val": "validation"}
        super().__init__(root, canonical.get(split, split),
                         base_size, crop_size, **kw)
        odgt = os.path.join(
            root, "ADE20K", f"{odgt_name.get(split, split)}.odgt"
        )
        if not os.path.exists(odgt):
            raise FileNotFoundError(
                f"ADE20K odgt list not found: {odgt}. Expected layout: "
                "ADE20K/{training.odgt,validation.odgt,images/...}."
            )
        with open(odgt) as f:
            self.items = [json.loads(line) for line in f if line.strip()]

    def __len__(self):
        return len(self.items)

    def _load_pair(self, index):
        item = self.items[index]
        img = _load_image(os.path.join(self.root, item["fpath_img"]))
        mask = _load_mask(os.path.join(self.root, item["fpath_segm"])) \
            .astype(np.int32)
        # 1..150 -> 0..149; void (0) -> the CONFIGURED ignore_label, like
        # the other seg datasets (a bare -1 breaks ignore_label=255 runs)
        remapped = mask - 1
        remapped[mask == 0] = self.ignore_label
        return img, remapped


class SyntheticSegDataset(SegDatasetBase):
    """Random image/mask pairs through the real pipeline: the offline
    stand-in, as cifar.py's SyntheticDataset is for classification."""

    def __init__(self, num_classes=20, size=16, image_size=64, crop_size=None,
                 seed=0, **kw):
        crop = crop_size or image_size
        super().__init__(base_size=image_size, crop_size=crop, seed=seed, **kw)
        self.NUM_CLASS = num_classes
        self.classes = [f"segclass{i}" for i in range(num_classes)]
        rng = np.random.RandomState(seed)
        self.images = rng.randint(0, 256, (size, image_size, image_size, 3),
                                  dtype=np.uint8)
        self.masks = rng.randint(0, num_classes, (size, image_size, image_size)
                                 ).astype(np.int32)

    def __len__(self):
        return len(self.images)

    def _load_pair(self, index):
        return self.images[index], self.masks[index]


class SegDataLoader:
    """Static-shape batcher for segmentation: yields (images f32 NHWC,
    masks i32 NHW). The last partial batch is dropped (``drop_last``) or
    padded with zero images and ``ignore_label`` masks, so that every batch
    has one shape."""

    def __init__(self, dataset: SegDatasetBase, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        stop = n - (n % bs) if self.drop_last else n
        for start in range(0, stop, bs):
            idx = order[start : start + bs]
            samples = [self.dataset[i] for i in idx]
            xs = np.stack([s[0] for s in samples]).astype(np.float32)
            ys = np.stack([s[1] for s in samples]).astype(np.int32)
            if len(idx) < bs:  # pad eval batch to static shape
                pad = bs - len(idx)
                xs = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:], xs.dtype)])
                ys = np.concatenate([
                    ys,
                    np.full((pad,) + ys.shape[1:], self.dataset.ignore_label,
                            ys.dtype),
                ])
            yield xs, ys


class Cityscapes(SegDatasetBase):
    """Cityscapes 19-class semantic segmentation.

    The reference lists Cityscapes in its registry and ships its hierarchy
    JSON (reference utils.py:26-40, nbdt/hierarchies/Cityscapes/) but
    provides no loader — its seg training lives in the companion HRNet repo.
    This loader completes the set: standard layout
    ``<root>/Cityscapes/leftImg8bit/{split}/<city>/*_leftImg8bit.png`` with
    ``gtFine/{split}/<city>/*_gtFine_labelIds.png`` masks, raw labelIds
    converted to the canonical 19 train ids (void -> ignore_label).
    """

    NUM_CLASS = 19
    classes = [
        "road", "sidewalk", "building", "wall", "fence", "pole",
        "traffic_light", "traffic_sign", "vegetation", "terrain", "sky",
        "person", "rider", "car", "truck", "bus", "train", "motorcycle",
        "bicycle",
    ]
    # labelId -> trainId (the canonical Cityscapes mapping; everything
    # else, incl. license plate (-1) and ego vehicle, is void)
    _LABEL_TO_TRAIN = {
        7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
        22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16,
        32: 17, 33: 18,
    }

    def __init__(self, root="./data", split="train", base_size=1024,
                 crop_size=512, **kw):
        super().__init__(root, split, base_size, crop_size, **kw)
        base = os.path.join(root, "Cityscapes")
        img_root = os.path.join(base, "leftImg8bit", split)
        if not os.path.isdir(img_root):
            raise FileNotFoundError(
                f"Cityscapes images not found at {img_root}. Expected layout: "
                "Cityscapes/{leftImg8bit,gtFine}/{split}/<city>/*.png."
            )
        self.pairs = []
        for city in sorted(os.listdir(img_root)):
            cdir = os.path.join(img_root, city)
            for fname in sorted(os.listdir(cdir)):
                if not fname.endswith("_leftImg8bit.png"):
                    continue
                mask = os.path.join(
                    base, "gtFine", split, city,
                    fname.replace("_leftImg8bit.png", "_gtFine_labelIds.png"),
                )
                self.pairs.append((os.path.join(cdir, fname), mask))

        lut = np.full(256, self.ignore_label, dtype=np.int32)
        for label_id, train_id in self._LABEL_TO_TRAIN.items():
            lut[label_id] = train_id
        self._lut = lut

    def __len__(self):
        return len(self.pairs)

    def _load_pair(self, index):
        img_path, mask_path = self.pairs[index]
        img = _load_image(img_path)
        mask = self._lut[np.clip(_load_mask(mask_path), 0, 255)]
        return img, mask
