"""Image loading and resizing with the reference's exact shape semantics.

Parity target: ``Utils::readImg`` / ``reshapeImg`` (utils.cpp:61-117) —
cap the max side at ``img_max_size``, scale the other side by aspect ratio
and floor it to a multiple of 8 (the SuperPoint cell size), returning the
downscale factor. RGB is used for feature colors; grayscale (ITU-R BT.601,
matching cv::COLOR_RGB2GRAY) feeds the detectors.

Decoding is host-side. ``load_folder`` takes the native C++ libjpeg
loader (``io/native.py``) for JPEG folders whenever its library loads, as
the TPU package does, and otherwise decodes with PIL over a thread pool.
PIL is imported inside ``load_image`` only, so every other part of the
package (and any caller that hands in decoded arrays, see
``IncrementalReconstructor.detect_features_from_images``) runs without it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np

from reconstructor_tpu_torch.io import native

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".tif", ".tiff")


@dataclasses.dataclass
class LoadedImage:
    """One decoded image, reference-resized."""
    path: str
    rgb: np.ndarray          # (H, W, 3) uint8
    gray: np.ndarray         # (H, W) float32 in [0, 1]
    downscale: float         # applied scale factor (<= 1.0)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.gray.shape  # (H, W)


def reference_target_size(height: int, width: int, img_max_size: int) -> Tuple[int, int]:
    """Replicates reshapeImg's output dims (utils.cpp:61-98): the longer
    side becomes img_max_size, the shorter side is scaled and floored to a
    multiple of 8."""
    if height > width:
        if height <= img_max_size:
            return height, width
        new_h = img_max_size
        new_w = int(width / height * img_max_size)
        new_w -= new_w % 8
        return new_h, new_w
    else:
        if width <= img_max_size:
            return height, width
        new_w = img_max_size
        new_h = int(height / width * img_max_size)
        new_h -= new_h % 8
        return new_h, new_w


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma, same coefficients as cv::cvtColor RGB2GRAY."""
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)


def from_rgb(rgb: np.ndarray, path: str = "") -> LoadedImage:
    """A LoadedImage from an already-decoded, already-sized (H, W, 3)
    uint8 array — the entry for rendered or otherwise in-memory images."""
    rgb = np.asarray(rgb, np.uint8)
    return LoadedImage(path=path, rgb=rgb, gray=rgb_to_gray(rgb) / 255.0,
                       downscale=1.0)


def load_image(path: str, img_max_size: int = 512) -> LoadedImage:
    from PIL import Image
    im = Image.open(path).convert("RGB")
    w, h = im.size
    nh, nw = reference_target_size(h, w, img_max_size)
    if (nh, nw) != (h, w):
        im = im.resize((nw, nh), Image.BILINEAR)
    rgb = np.asarray(im, dtype=np.uint8)
    gray = rgb_to_gray(rgb) / 255.0
    down = nh / h if h > w else nw / w
    return LoadedImage(path=path, rgb=rgb, gray=gray, downscale=down if (nh, nw) != (h, w) else 1.0)


def list_images(folder: str) -> List[str]:
    """Enumerate image files; deterministic sorted order (the reference uses
    raw directory_iterator order, SequentialReconstructor.cpp:989 — sorting
    makes runs reproducible, ids still 0..N-1)."""
    names = [n for n in os.listdir(folder) if n.lower().endswith(IMG_EXTENSIONS)]
    return [os.path.join(folder, n) for n in sorted(names)]


def load_folder(folder: str, img_max_size: int = 512,
                max_workers: int = 8) -> List[LoadedImage]:
    """Threaded decode of a whole folder (replaces the OpenMP parallel-for
    over images in detectFeatures, SequentialReconstructor.cpp:58).

    Uses the native C++ libjpeg dataloader (native/reconstructor_native.cpp)
    when it loads and every file is a JPEG: DCT-prescaled decode, then a
    bilinear resize, on a thread pool (``downscale`` is 1.0 on that branch,
    as in the TPU package). Otherwise PIL decodes each file."""
    paths = list_images(folder)
    out = native.decode_batch(paths, img_max_size, num_threads=max_workers)
    if out is not None:
        gray, shapes, rgb = out
        images = []
        for i, p in enumerate(paths):
            h, w = int(shapes[i, 0]), int(shapes[i, 1])
            images.append(LoadedImage(path=p, rgb=rgb[i, :h, :w],
                                      gray=gray[i, :h, :w], downscale=1.0))
        return images
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(lambda p: load_image(p, img_max_size), paths))


def pad_batch(images: Sequence[LoadedImage]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack variable-size grayscale images into one padded (N, H, W)
    float32 batch + per-image (h, w) shapes + padded RGB batch.

    Fixed shapes let detection run as one batched program.
    """
    H = max(im.gray.shape[0] for im in images)
    W = max(im.gray.shape[1] for im in images)
    n = len(images)
    gray = np.zeros((n, H, W), np.float32)
    rgb = np.zeros((n, H, W, 3), np.uint8)
    shapes = np.zeros((n, 2), np.int32)
    for i, im in enumerate(images):
        h, w = im.gray.shape
        gray[i, :h, :w] = im.gray
        rgb[i, :h, :w] = im.rgb
        shapes[i] = (h, w)
    return gray, shapes, rgb
