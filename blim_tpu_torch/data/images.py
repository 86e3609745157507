"""AnyRes image tiling and image preprocessing on the host (copy of
blim_tpu/data/images.py).

The reference's anyres helpers (reference: mm_utils.py:395-745) prepare
single images for the vision tower: pick the best grid resolution for the
aspect ratio, resize (the "nopad" variant, the only one BLiM-era configs
use), split into tower-sized tiles, and prepend a low-res base view. The
paths the reference itself leaves as `raise NotImplementedError`
(process_anyres_image with padding, highres, crop_split) raise here too.

numpy and PIL on the host; `processor` is umt_vit.UMTImageProcessor.
tests/test_torch_images.py holds every helper to the original exactly."""

from __future__ import annotations

import ast
import math
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _proc_size(processor) -> int:
    """Tower input edge from a processor with either .size tuple or int."""
    size = getattr(processor, "image_size", None) or getattr(processor, "size")
    if isinstance(size, (tuple, list)):
        size = size[0]
    if isinstance(size, dict):
        size = size.get("shortest_edge") or min(size.values())
    return int(size)


def _to_pil(image):
    from PIL import Image

    if isinstance(image, Image.Image):
        return image
    return Image.fromarray(np.asarray(image))


def parse_grid_pinpoints(grid_pinpoints, patch_size: int) -> List[List[int]]:
    """"(1x1),...,(6x6)" range syntax or a literal list of resolutions
    (reference: mm_utils.py:612-625,698-718)."""
    if isinstance(grid_pinpoints, str) and "x" in grid_pinpoints:
        assert patch_size in (224, 336, 384, 448, 512), patch_size
        matches = re.findall(r"\((\d+)x(\d+)\)", grid_pinpoints)
        range_start = tuple(map(int, matches[0]))
        range_end = tuple(map(int, matches[-1]))
        grid = [
            (i, j)
            for i in range(range_start[0], range_end[0] + 1)
            for j in range(range_start[1], range_end[1] + 1)
        ]
        return [[dim * patch_size for dim in pair] for pair in grid]
    if isinstance(grid_pinpoints, list):
        return grid_pinpoints
    return ast.literal_eval(grid_pinpoints)


def select_best_resolution(
    original_size: Tuple[int, int],
    possible_resolutions: Sequence[Sequence[int]],
    max_resolutions: Optional[int] = None,
    patch_size: int = 448,
) -> Tuple[int, int]:
    """Max effective resolution, then min waste (reference: mm_utils.py:505-537)."""
    original_width, original_height = original_size
    best_fit = None
    max_effective = 0
    min_wasted = float("inf")
    for width, height in possible_resolutions:
        if max_resolutions is not None and width * height != patch_size * patch_size:
            if width * height + patch_size * patch_size > max_resolutions:
                continue
        scale = min(width / original_width, height / original_height)
        dw, dh = int(original_width * scale), int(original_height * scale)
        effective = min(dw * dh, original_width * original_height)
        wasted = width * height - effective
        if effective > max_effective or (effective == max_effective and wasted < min_wasted):
            max_effective = effective
            min_wasted = wasted
            best_fit = (width, height)
    assert best_fit is not None, (
        f"Can't find suitable fit in {possible_resolutions} at max:{max_resolutions}"
    )
    return best_fit


def resize_and_pad_image(image, target_resolution: Tuple[int, int]):
    """Aspect-preserving resize + centered black padding
    (reference: mm_utils.py:540-576)."""
    from PIL import Image

    image = _to_pil(image)
    ow, oh = image.size
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh))
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def divide_to_patches(image, patch_size: int) -> List:
    """Row-major patch_size tiles (reference: mm_utils.py:579-598)."""
    image = _to_pil(image)
    width, height = image.size
    patches = []
    for i in range(0, height, patch_size):
        for j in range(0, width, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def expand2square(image, background_color):
    """Pad to square with the processor's mean color (reference: mm_utils.py:693-704)."""
    from PIL import Image

    image = _to_pil(image)
    width, height = image.size
    if width == height:
        return image
    side = max(width, height)
    result = Image.new(image.mode, (side, side), background_color)
    result.paste(image, ((side - width) // 2 if height > width else 0,
                         (side - height) // 2 if width > height else 0))
    return result


def resize_and_center_crop(image, shortest_edge_length: int):
    """(reference: mm_utils.py:395-414)"""
    image = _to_pil(image)
    aspect = float(image.width) / float(image.height)
    if aspect > 1:
        nw, nh = int(shortest_edge_length * aspect), shortest_edge_length
    else:
        nw, nh = shortest_edge_length, int(shortest_edge_length / aspect)
    resized = image.resize((nw, nh))
    left = (nw - shortest_edge_length) // 2
    top = (nh - shortest_edge_length) // 2
    return resized.crop((left, top, left + shortest_edge_length, top + shortest_edge_length))


def auto_pad_images(image, grid_params: Sequence[int]):
    """Closest-aspect grid resolution, aspect-preserving resize, centered
    black padding (reference: mm_utils.py:416-443)."""
    from PIL import Image

    image = _to_pil(image)
    assert len(grid_params) > 0, "Grid parameters should not be empty"
    iw, ih = image.size
    input_aspect = iw / ih
    candidates = [(w / h, w, h) for w in grid_params for h in grid_params]
    closest = min(candidates, key=lambda x: abs(input_aspect - x[0]))
    candidates = [(w, h) for a, w, h in candidates if abs(a - closest[0]) < 1e-3]
    target = min(candidates, key=lambda res: abs(max(iw, ih) / max(res) - 1))
    rw, rh = target
    if iw > ih:
        rh = int(rw / input_aspect)
    else:
        rw = int(rh * input_aspect)
    # the reference resizes with Image.ANTIALIAS (mm_utils.py:436), which
    # modern Pillow names LANCZOS
    resized = image.resize((rw, rh), Image.LANCZOS)
    out = Image.new("RGB", target, color=(0, 0, 0))
    out.paste(resized, ((target[0] - rw) // 2, (target[1] - rh) // 2))
    return out


def load_image_from_base64(image: str):
    """PIL image from a base64 string (reference: mm_utils.py:747-748)."""
    import base64
    from io import BytesIO

    from PIL import Image

    return Image.open(BytesIO(base64.b64decode(image)))


def get_model_name_from_path(model_path: str) -> str:
    """Last path segment; checkpoint dirs keep their parent
    (reference: mm_utils.py:819-825)."""
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


def extract_patches(image, patch_size: int, overlap_ratio: float) -> List:
    """Strided overlapping tiles (reference: mm_utils.py:447-468)."""
    image = _to_pil(image)
    W, H = image.size
    stride = int(patch_size * (1 - overlap_ratio))
    ny = (H - patch_size) // stride + 1
    nx = (W - patch_size) // stride + 1
    y0 = (H - (ny - 1) * stride - patch_size) // 2
    x0 = (W - (nx - 1) * stride - patch_size) // 2
    patches = []
    for y in range(y0, y0 + ny * stride, stride):
        for x in range(x0, x0 + nx * stride, stride):
            patches.append(image.crop((x, y, x + patch_size, y + patch_size)))
    return patches


def get_anyres_image_grid_shape(
    image_size: Tuple[int, int],
    grid_pinpoints,
    patch_size: int,
    max_resolutions: Optional[int] = None,
) -> Tuple[int, int]:
    """(patches_wide, patches_high) of the chosen grid
    (reference: mm_utils.py:602-630)."""
    possible = parse_grid_pinpoints(grid_pinpoints, patch_size)
    width, height = select_best_resolution(
        image_size, possible, max_resolutions=max_resolutions, patch_size=patch_size
    )
    return width // patch_size, height // patch_size


def process_anyres_image_nopad(image, processor, grid_pinpoints) -> np.ndarray:
    """Best-grid resize (no padding) + tiles, base view first
    (reference: mm_utils.py:689 `process_anyres_image_nopad`).
    Returns (1 + n_tiles, 3, patch, patch) float32."""
    image = _to_pil(image).convert("RGB")
    patch_size = _proc_size(processor)
    possible = parse_grid_pinpoints(grid_pinpoints, patch_size)
    best = select_best_resolution(image.size, possible, None, patch_size)
    patches = divide_to_patches(image.resize(best), patch_size)
    base = image.resize((patch_size, patch_size))
    tiles = [base] + patches
    arr = np.stack([np.asarray(t.convert("RGB")) for t in tiles])  # (N, H, W, 3)
    return processor.preprocess(arr)


def process_anyres_image(image, processor, grid_pinpoints):
    """The padded variant is dead code in the reference
    (mm_utils.py:633 `raise NotImplementedError`)."""
    raise NotImplementedError("the reference's padded anyres path is itself unimplemented")


def process_highres_image(image, processor, grid_pinpoints) -> np.ndarray:
    """(reference: mm_utils.py:483-503)"""
    image = _to_pil(image).convert("RGB")
    grid_params = [int(x) for x in str(grid_pinpoints).split(",")]
    select_size = max(grid_params)
    mean = tuple(int(x * 255) for x in processor.image_mean)
    image_padded = expand2square(image, mean)
    base = image.resize((_proc_size(processor), _proc_size(processor)))
    image_padded = image_padded.resize((select_size, select_size))
    patches = extract_patches(image_padded, _proc_size(processor), overlap_ratio=0)
    tiles = [base] + patches
    arr = np.stack([np.asarray(t.convert("RGB")) for t in tiles])
    return processor.preprocess(arr)


def process_highres_image_crop_split(image, crop_resolution: int,
                                     split_resolution: int, processor) -> np.ndarray:
    """Center-crop then non-overlapping split (reference: mm_utils.py:470-479).
    Reachable only through explicit calls — process_images' crop_split branch
    raises first, mirroring the reference's own dispatch (mm_utils.py:781)."""
    crop = resize_and_center_crop(image, crop_resolution)
    patches = extract_patches(crop, patch_size=split_resolution, overlap_ratio=0)
    arr = np.stack([np.asarray(p.convert("RGB")) for p in patches])
    return processor.preprocess(arr)


def process_images(images, image_processor, image_aspect_ratio: Optional[str],
                   grid_pinpoints=None):
    """Dispatch on image_aspect_ratio like the reference's process_images
    (reference: mm_utils.py:707-738). Returns a list of (N_i, 3, H, W) arrays
    or one stacked array when shapes agree."""
    if image_aspect_ratio == "highres":
        # the reference raises before its own highres body (mm_utils.py:711)
        raise NotImplementedError("highres: unimplemented in the reference")
    if image_aspect_ratio and "anyres" in image_aspect_ratio:
        out = []
        for image in images:
            if "nopad" in image_aspect_ratio:
                out.append(process_anyres_image_nopad(image, image_processor, grid_pinpoints))
            else:
                out.append(process_anyres_image(image, image_processor, grid_pinpoints))
        if all(x.shape == out[0].shape for x in out):
            return np.stack(out)
        return out
    if image_aspect_ratio == "crop_split":
        raise NotImplementedError("crop_split: unimplemented in the reference")
    if image_aspect_ratio == "pad":
        mean = tuple(int(x * 255) for x in image_processor.image_mean)
        arr = np.stack([
            np.asarray(expand2square(im, mean).convert("RGB").resize(
                (_proc_size(image_processor), _proc_size(image_processor))
            ))
            for im in images
        ])
        return image_processor.preprocess(arr)
    arr = np.stack([
        np.asarray(_to_pil(im).convert("RGB").resize(
            (_proc_size(image_processor), _proc_size(image_processor))
        ))
        for im in images
    ])
    return image_processor.preprocess(arr)
