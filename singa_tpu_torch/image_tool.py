"""PIL-based image augmentation toolkit (counterpart of
singa_tpu/image_tool.py; the reference's python/singa/image_tool.py).

Chainable `ImageTool` plus the free functions the reference exposes, on
the host (numpy and PIL): per-image augmentation runs on the CPU while the
card runs the previous step. Pillow is imported at the first call that
needs it, so importing this module does not need it.
"""

from __future__ import annotations

import random

import numpy as np


def _pil():
    """(PIL.Image, PIL.ImageEnhance), imported at first use."""
    try:
        from PIL import Image, ImageEnhance
    except ImportError as e:
        raise ImportError("image_tool requires Pillow") from e
    return Image, ImageEnhance


def load_img(path, grayscale=False):
    """(ref image_tool.py:41)"""
    img = _pil()[0].open(path)
    return img.convert("L" if grayscale else "RGB")


def crop(img, patch, position):
    """Crop a (h, w) patch at one of five positions (ref :51)."""
    w, h = img.size
    ph, pw = patch
    pos = {
        "left_top": (0, 0),
        "left_bottom": (0, h - ph),
        "right_top": (w - pw, 0),
        "right_bottom": (w - pw, h - ph),
        "center": ((w - pw) // 2, (h - ph) // 2),
    }
    if position not in pos:
        raise Exception(f"position {position} not supported")
    x, y = pos[position]
    return img.crop((x, y, x + pw, y + ph))


def crop_and_resize(img, patch, position):
    """Crop a square along one axis then resize to patch (ref :86)."""
    w, h = img.size
    ph, pw = patch
    if position in ("left", "top"):
        box = (0, 0, h, h) if w > h else (0, 0, w, w)
    elif position in ("right", "bottom"):
        box = (w - h, 0, w, h) if w > h else (0, h - w, w, h)
    elif position == "center":
        box = ((w - h) // 2, 0, (w + h) // 2, h) if w > h \
            else (0, (h - w) // 2, w, (h + w) // 2)
    else:
        raise Exception(f"position {position} not supported")
    return img.crop(box).resize((pw, ph))


def resize(img, small_size):
    """Resize so the smaller side equals small_size (ref :124)."""
    w, h = img.size
    if w < h:
        return img.resize((small_size, int(h * small_size / w)))
    return img.resize((int(w * small_size / h), small_size))


scale = resize


def resize_by_hw(img, size):
    return img.resize((size[1], size[0]))


def color_cast(img, offset):
    """Random additive RGB cast in [-offset, offset] (ref :148)."""
    arr = np.asarray(img, np.int16)
    cast = np.random.randint(-offset, offset + 1, 3)
    arr = np.clip(arr + cast[None, None, :], 0, 255).astype(np.uint8)
    return _pil()[0].fromarray(arr)


def enhance(img, scale):
    """Random color/brightness/contrast/sharpness jitter (ref :172)."""
    ImageEnhance = _pil()[1]
    for enh in (ImageEnhance.Color, ImageEnhance.Brightness,
                ImageEnhance.Contrast, ImageEnhance.Sharpness):
        factor = 1.0 + random.uniform(-scale, scale)
        img = enh(img).enhance(factor)
    return img


def flip(img):
    return img.transpose(_pil()[0].FLIP_LEFT_RIGHT)


def flip_down(img):
    return img.transpose(_pil()[0].FLIP_TOP_BOTTOM)


def get_list_sample(lst, sample_size):
    return random.sample(list(lst), sample_size)


class ImageTool:
    """Chainable augmentation pipeline over a working list of images
    (ref image_tool.py:214). Each op either replaces the list (inplace) or
    returns the transformed copies."""

    def __init__(self):
        self.imgs = []

    def load(self, path, grayscale=False):
        self.imgs = [load_img(path, grayscale)]
        return self

    def set(self, imgs):
        self.imgs = list(imgs)
        return self

    def append(self, img):
        self.imgs.append(img)
        return self

    def get(self):
        return self.imgs

    def num_augmentation(self):
        return len(self.imgs)

    def _apply(self, fn, inplace):
        out = [fn(img) for img in self.imgs]
        if inplace:
            self.imgs = out
            return self
        return out

    def resize_by_range(self, rng, inplace=True):
        size = random.randint(rng[0], rng[1] - 1)
        return self._apply(lambda im: resize(im, size), inplace)

    def resize_by_list(self, size_list, num_case=1, inplace=True):
        sizes = get_list_sample(size_list, num_case)
        out = [resize(im, s) for im in self.imgs for s in sizes]
        if inplace:
            self.imgs = out
            return self
        return out

    def scale_by_range(self, rng, inplace=True):
        return self.resize_by_range(rng, inplace)

    def rotate_by_range(self, rng, inplace=True):
        angle = random.uniform(rng[0], rng[1])
        return self._apply(lambda im: im.rotate(angle), inplace)

    def rotate_by_list(self, angle_list, num_case=1, inplace=True):
        angles = get_list_sample(angle_list, num_case)
        out = [im.rotate(a) for im in self.imgs for a in angles]
        if inplace:
            self.imgs = out
            return self
        return out

    def random_crop(self, patch, inplace=True):
        def f(im):
            w, h = im.size
            ph, pw = patch
            x = random.randint(0, w - pw)
            y = random.randint(0, h - ph)
            return im.crop((x, y, x + pw, y + ph))
        return self._apply(f, inplace)

    def crop5(self, patch, num_case=1, inplace=True):
        positions = get_list_sample(
            ["left_top", "left_bottom", "right_top", "right_bottom",
             "center"], num_case)
        out = [crop(im, patch, p) for im in self.imgs for p in positions]
        if inplace:
            self.imgs = out
            return self
        return out

    def crop3(self, patch, num_case=1, inplace=True):
        positions = get_list_sample(["left", "center", "right"], num_case)
        out = [crop_and_resize(im, patch, p)
               for im in self.imgs for p in positions]
        if inplace:
            self.imgs = out
            return self
        return out

    def flip(self, num_case=1, inplace=True):
        if num_case == 1 and random.randint(0, 1):
            return self._apply(flip, inplace)
        if inplace:
            return self
        return list(self.imgs)

    def flip_down(self, num_case=1, inplace=True):
        if num_case == 1 and random.randint(0, 1):
            return self._apply(flip_down, inplace)
        if inplace:
            return self
        return list(self.imgs)

    def color_cast(self, offset=20, inplace=True):
        return self._apply(lambda im: color_cast(im, offset), inplace)

    def enhance(self, scale=0.2, inplace=True):
        return self._apply(lambda im: enhance(im, scale), inplace)
