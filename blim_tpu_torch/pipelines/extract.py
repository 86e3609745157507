"""Offline video feature extraction on one GPU (port of
blim_tpu/pipelines/extract.py).

Glob the dataset's videos, chunk the sorted list statically over independent
workers (--num_chunk/--chunk_idx), decode 16 uniformly sampled frames per
video on host threads (decord, PyAV or OpenCV, whichever is installed; gifs
and frame directories too), run the UMT ViT-L tower and ToMe compression on
the card (`make_featurizer`: pre-MLP features, `return_video_feature=True`),
and cache (clips, 64, 1024) fp16 features per video (data/features.py).

Usage:
    python -m blim_tpu_torch.pipelines.extract --dataset MSRVTT --num_chunk 4 --chunk_idx 0

With a checkpoint directory (`config.json` + safetensors or
pytorch_model*.bin) the tower is read from it, streamed to the card in
bf16 (fp32 with --device cpu); without one the tower is random, made from a
seed on the card (smoke mode).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from blim_tpu_torch.core.device import DeviceLike, resolve_device


def middle_frame_indices(num_frames: int, vlen: int) -> np.ndarray:
    """The reference's 'middle' sampling: split [0, vlen) into num_frames
    intervals and take each interval's midpoint; videos shorter than
    num_frames pad by repeating the last index."""
    acc = max(1, min(num_frames, vlen))
    intervals = np.linspace(0, vlen, acc + 1).astype(int)
    idx = [
        (intervals[i] + max(intervals[i + 1] - 1, intervals[i])) // 2
        for i in range(acc)
    ]
    if len(idx) < num_frames:
        idx = idx + [idx[-1]] * (num_frames - len(idx))
    return np.asarray(idx, int)


def read_frames_gif(video_path: str, num_frames: int) -> np.ndarray:
    """Animated-gif reader -> (T, H, W, 3) uint8: imageio frame iteration,
    'middle' sampling at an assumed 1 fps, alpha dropped, and, when frames
    vary in size, all sampled frames cropped to the common min height/width."""
    import imageio

    gif = imageio.get_reader(video_path)
    try:
        vlen = len(gif)
    except TypeError:
        vlen = sum(1 for _ in gif)
    order = middle_frame_indices(num_frames, vlen)
    wanted = set(order.tolist())
    frames = {}
    for i, frame in enumerate(gif):
        if i in wanted:
            f = np.asarray(frame)
            if f.ndim == 2:
                f = np.stack([f] * 3, axis=-1)
            elif f.shape[-1] == 4:
                f = f[..., :3]  # RGBA -> RGB (drop alpha)
            frames[i] = f.astype(np.uint8)
    out = [frames[i] for i in order]
    if len({f.shape for f in out}) > 1:
        mh = min(f.shape[0] for f in out)
        mw = min(f.shape[1] for f in out)
        out = [f[:mh, :mw] for f in out]
    return np.stack(out)


def read_frames_img(video_path: str, num_frames: int) -> np.ndarray:
    """Frame-directory reader -> (T, H, W, 3) uint8: files sorted by the
    numeric tail of their name (``..._NNN.jpg``, falling back to plain name
    order when no number), 'middle' sampling, decoded to RGB."""
    import re

    names = [
        n for n in os.listdir(video_path)
        if n.lower().endswith((".jpg", ".jpeg", ".png"))
    ]
    if not names:
        raise RuntimeError(f"no frame images in {video_path}")

    def frame_number(name: str) -> int:
        m = re.search(r"_(\d+)\.(?:jpg|jpeg|png)$", name, re.IGNORECASE)
        return int(m.group(1)) if m else -1

    if any(frame_number(n) >= 0 for n in names):
        names.sort(key=frame_number)
    else:
        names.sort()
    order = middle_frame_indices(num_frames, len(names))
    imgs = []
    try:
        import cv2

        for i in order:
            img = cv2.imread(os.path.join(video_path, names[i]), cv2.IMREAD_COLOR)
            imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    except ImportError:
        from PIL import Image

        for i in order:
            with Image.open(os.path.join(video_path, names[i])) as im:
                imgs.append(np.asarray(im.convert("RGB")))
    return np.stack(imgs).astype(np.uint8)


def read_frames(video_path: str, num_frames: int, max_duration: Optional[float] = None):
    """Decode `num_frames` sampled frames -> (T, H, W, 3) uint8: a directory
    -> the frame-image reader, .gif -> the gif reader, otherwise the video
    stack (decord, then PyAV, then OpenCV). DiDeMo passes max_duration=30."""
    if os.path.isdir(video_path):
        return read_frames_img(video_path, num_frames)
    if video_path.lower().endswith(".gif"):
        return read_frames_gif(video_path, num_frames)
    try:
        from decord import VideoReader

        vr = VideoReader(video_path, num_threads=1)
        vlen = len(vr)
        fps = vr.get_avg_fps()
        duration = vlen / float(fps)
        if max_duration and duration > max_duration:
            vlen = int(max_duration * fps)
        idx = np.linspace(0, vlen - 2, num_frames).astype(int)
        return vr.get_batch(idx).asnumpy()
    except ImportError:
        pass
    try:
        import av

        container = av.open(video_path)
        frames = [f.to_ndarray(format="rgb24") for f in container.decode(video=0)]
        container.close()
        fps = 30.0
        if max_duration:
            frames = frames[: int(max_duration * fps)]
        idx = np.linspace(0, len(frames) - 2, num_frames).astype(int)
        return np.stack([frames[i] for i in idx])
    except ImportError:
        pass
    try:
        import cv2

        cap = cv2.VideoCapture(video_path)
        vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        if max_duration and vlen > 0 and vlen / fps > max_duration:
            vlen = int(max_duration * fps)
        if vlen > 1:
            # grab() decodes without retrieve + BGR2RGB: only the sampled
            # frames pay the copy and the colour conversion
            idx = np.linspace(0, vlen - 2, num_frames).astype(int)
            pos = {u: j for j, u in enumerate(sorted(set(idx.tolist())))}
            frames = []
            for i in range(vlen):
                if not cap.grab():
                    break
                if i in pos:
                    ok, frame = cap.retrieve()
                    if ok:
                        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            cap.release()
            if len(frames) == len(pos):
                return np.stack([frames[pos[i]] for i in idx])
            cap = cv2.VideoCapture(video_path)  # unreliable header: full read
        frames = []
        ok, frame = cap.read()
        while ok:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            ok, frame = cap.read()
        cap.release()
        if max_duration and len(frames) / fps > max_duration:
            frames = frames[: max(int(max_duration * fps), 2)]
        idx = np.linspace(0, len(frames) - 2, num_frames).astype(int)
        return np.stack([frames[i] for i in idx])
    except ImportError as e:
        raise RuntimeError(
            "no video decoder available (need decord, av, or cv2)"
        ) from e


class DecodePrefetcher:
    """Threaded host decode: worker threads decode upcoming videos while the
    card featurizes the current batch. Results come back in submission order
    as (path, frames, None), or (path, None, error) for a video that failed
    to decode; `depth` bounds the decodes in flight."""

    def __init__(self, paths: List[str], decode_fn, workers: int = 4, depth: int = 8):
        self.paths = paths
        self.decode_fn = decode_fn
        self.workers = max(1, workers)
        self.depth = max(depth, self.workers)

    def __iter__(self):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=self.workers)
        pending = deque()
        it = iter(self.paths)
        try:
            while True:
                while len(pending) < self.depth:
                    try:
                        p = next(it)
                    except StopIteration:
                        break
                    pending.append((p, pool.submit(self.decode_fn, p)))
                if not pending:
                    break
                path, fut = pending.popleft()
                try:
                    yield path, fut.result(), None
                except Exception as e:   # corrupt video -> reported, skipped
                    yield path, None, e
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def chunk_list(items: List[str], num_chunk: int, chunk_idx: int) -> List[str]:
    """Static chunking over independent workers."""
    chunk_size = len(items) // num_chunk
    start = chunk_size * chunk_idx
    end = len(items) if chunk_idx == num_chunk - 1 else min(chunk_size * (chunk_idx + 1), len(items))
    return items[start:end]


def _check_full_fp32_matmul() -> None:
    """The on-card resize must reproduce the host's float64 resize to +-1
    grey level, so its fp32 products may not run in TF32."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the on-card resize needs full fp32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def device_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """PIL-exact bicubic resize of (..., H, W, 3) fp32 pixel values in
    [0, 255] to (..., size, size, 3): the horizontal pass first, rounding
    (half to even) and clamping to the uint8 domain between passes and
    after, as the host UMTImageProcessor.resize_frames does (+-1 grey level
    against PIL)."""
    from blim_tpu_torch.models import umt_vit

    if x.device.type == "cuda":
        _check_full_fp32_matmul()
    h_in, w_in = x.shape[-3], x.shape[-2]
    mh = torch.from_numpy(umt_vit.pil_resize_matrix(h_in, size).astype(np.float32)).to(x.device)
    mw = torch.from_numpy(umt_vit.pil_resize_matrix(w_in, size).astype(np.float32)).to(x.device)
    x = torch.einsum("ow,...hwx->...hox", mw, x)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    x = torch.einsum("oh,...hwx->...owx", mh, x)
    return torch.clamp(torch.round(x), 0.0, 255.0)


def make_featurizer(vit_params, config, device: DeviceLike = "cuda",
                    device_preprocess: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, clips, local_frames, 3, H, W) pixels -> (B, clips, tokens, mm)
    cached features on `device`: tower + ToMe, pre-MLP
    (`return_video_feature=True`), under torch.inference_mode().

    With ``device_preprocess=True`` the featurizer instead takes (B, clips,
    local_frames, H, W, 3) **uint8** frames (channels-last, as decoded) and
    does rescale + ImageNet-normalise + channels-first on the card; if
    (H, W) is not the tower's image_size it also resizes there (two fp32
    matrix products against pil_resize_matrix, `device_resize`), so the host
    ships the raw decoded bytes. Pixels enter the tower in the parameters'
    dtype. The parameters are expected on `device`
    (convert.init_vision_tower, or params_from_numpy of a converted tree); a
    pixel tensor elsewhere is moved there."""
    from blim_tpu_torch.models import projector as projector_lib
    from blim_tpu_torch.models import umt_vit

    dev = resolve_device(device)
    vcfg = config.vision
    pos_video, _ = umt_vit.build_pos_tables(vcfg)
    pos = torch.from_numpy(np.asarray(pos_video, np.float32)).to(dev)
    dtype = vit_params["patch_embed"]["kernel"].dtype
    mean = torch.from_numpy(umt_vit.IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(umt_vit.IMAGENET_STD).to(dev)

    def featurize(pixels: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            pixels = torch.as_tensor(pixels).to(dev)
            if device_preprocess:
                x = pixels.float()
                tgt = vcfg.image_size
                if (x.shape[3], x.shape[4]) != (tgt, tgt):
                    x = device_resize(x, tgt)
                x = (x / 255.0 - mean) / std
                pixels = x.permute(0, 1, 2, 5, 3, 4)
            pixels = pixels.to(dtype)
            b, clips, lf, ch, h, w = pixels.shape
            flat = pixels.reshape(b * clips, lf, ch, h, w)
            feats = umt_vit.encode_clips(vit_params, flat, pos, vcfg)
            compressed = projector_lib.compress_clip_tokens(
                feats, config.tokens_per_frame, config.mm_local_num_frames,
                vcfg.num_attention_heads,
            )
            return compressed.reshape(b, clips, compressed.shape[-2], compressed.shape[-1])

    return featurize


def resize_for_upload(frames: np.ndarray, proc, target_hw: Tuple[int, int]) -> np.ndarray:
    """Host-resize only when it shrinks the upload: (T, H, W, 3) uint8 frames
    that carry no more pixels than the tower resolution ship as they are
    (the device_preprocess featurizer resizes them on the card); larger ones
    (e.g. 1080p sources) are resized on the host, which shrinks the bytes
    sent."""
    h, w = target_hw
    if frames.shape[1] * frames.shape[2] <= h * w:
        return frames
    return proc.resize_frames(frames, (h, w))


def _upload(pixels: np.ndarray, dev: torch.device) -> torch.Tensor:
    """uint8 frames stay uint8 (the device_preprocess featurizer normalises
    on the card, and the upload is half the bf16 size); float pixels go as
    bf16. Pinned host memory lets the copy overlap the card's work."""
    t = torch.from_numpy(pixels)
    if t.dtype != torch.uint8:
        t = t.to(torch.bfloat16)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def run_extraction(video_list, decode_fn, featurize, on_features, *,
                   batch_size: int, clips: int, local_frames: int,
                   decode_workers: int = 4, save_iter: int = 10, log=print,
                   device: DeviceLike = "cuda"):
    """The decode -> featurize -> consume pipeline: threaded host decode
    (DecodePrefetcher) feeds fixed-size batches to the featurizer, and the
    card's results are consumed with a lag-2 in-flight window, so the card
    runs ahead of the host-side saves. `on_features(paths, feats)` gets the
    features as a tensor on `device`, one row per path. Returns (n_ok,
    elapsed_seconds)."""
    dev = resolve_device(device)
    # batches accumulate per decoded shape: with raw-upload decoding
    # (resize_for_upload) different source resolutions batch separately. A
    # single-resolution dataset (the common case) uses exactly one bucket.
    buckets: dict = {}
    in_flight: List = []

    def consume(paths, feats):
        # drop the tail-pad rows (flush pads partial batches to batch_size)
        on_features(paths, feats[: len(paths)])

    def flush(key):
        batch_paths, batch_pixels = buckets.pop(key)
        # pad tail batches to batch_size by repeating the last video, so
        # every batch has one shape; `consume` slices the features back to
        # len(batch_paths), so padded rows never reach the consumer
        if len(batch_pixels) < batch_size:
            batch_pixels = batch_pixels + [batch_pixels[-1]] * (
                batch_size - len(batch_pixels))
        pixels = np.stack(batch_pixels)  # (B, T, 3, H, W) f32 or (B, T, H, W, 3) u8
        b = pixels.shape[0]
        pixels = pixels.reshape(b, clips, local_frames, *pixels.shape[2:])
        # asynchronous: featurize returns once its kernels are queued; the
        # copy back and save of the previous batch happen while this one runs
        in_flight.append((batch_paths, featurize(_upload(pixels, dev))))
        while len(in_flight) > 2:
            consume(*in_flight.pop(0))

    t0 = time.perf_counter()
    n_ok = 0
    prefetch = DecodePrefetcher(video_list, decode_fn, workers=decode_workers)
    for i, (path, pix, err) in enumerate(prefetch):
        if err is not None:  # corrupt video -> skip
            log(f"Error loading video {path}: {err}")
            continue
        key = pix.shape
        paths_pixels = buckets.setdefault(key, ([], []))
        paths_pixels[0].append(path)
        paths_pixels[1].append(pix)
        n_ok += 1
        if len(paths_pixels[0]) == batch_size:
            flush(key)
        if i % save_iter == 0:
            log(f"[{i}/{len(video_list)}]")
    for key in list(buckets):
        flush(key)
    while in_flight:
        consume(*in_flight.pop(0))
    return n_ok, time.perf_counter() - t0


def main(args):
    from blim_tpu_torch.checkpoints.convert import init_vision_tower, load_videochat_flash
    from blim_tpu_torch.core.config import ModelConfig, load_model_config
    from blim_tpu_torch.data.features import FeatureStore
    from blim_tpu_torch.models import umt_vit

    if args.dataset == "LSMDC":
        video_list = glob.glob(f"{args.data_root}/{args.dataset}/videos/*/*")
    else:
        video_list = glob.glob(f"{args.data_root}/{args.dataset}/videos/*")
    video_list.sort()
    print(f"Number of videos: {len(video_list)}")
    video_list = chunk_list(video_list, args.num_chunk, args.chunk_idx)
    print(f"{args.chunk_idx}-th of {args.num_chunk} chunks: {len(video_list)} videos")

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    have_ckpt = os.path.isdir(args.model_path) and os.path.exists(
        os.path.join(args.model_path, "config.json")
    )
    if have_ckpt:
        config = load_model_config(args.model_path)
        tree = load_videochat_flash(args.model_path, config, dtype=dtype, device=dev,
                                    parts=("vision_tower",))
        if "vision_tower" not in tree:
            raise KeyError(f"{args.model_path} has no model.vision_tower.* tensors")
        vit_params = tree["vision_tower"]
    else:
        print(f"WARNING: no checkpoint at {args.model_path}; random tower (smoke mode)")
        config = ModelConfig()
        vit_params = init_vision_tower(config.vision, seed=0, dtype=dtype, device=dev)

    processor = umt_vit.UMTImageProcessor(size=(config.vision.image_size,) * 2)
    featurize = make_featurizer(vit_params, config, device=dev, device_preprocess=True)
    out_dir = f"{args.data_root}/{args.dataset}/features"
    os.makedirs(out_dir, exist_ok=True)
    store = FeatureStore(out_dir)

    max_dur = 30.0 if args.dataset == "DiDeMo" else None
    lf = config.mm_local_num_frames
    clips = args.num_frames // lf

    def consume(paths, feats_dev):
        feats = feats_dev.to(torch.float16).cpu().numpy()
        for path, feat in zip(paths, feats):
            vid = os.path.basename(path)
            vid = vid[: vid.rfind(".")] if "." in vid else vid
            store.save(vid, feat)

    def decode(path):
        frames = read_frames(path, args.num_frames, max_dur)
        return resize_for_upload(frames, processor, processor.size)

    n_ok, elapsed = run_extraction(
        video_list, decode, featurize, consume,
        batch_size=args.batch_size, clips=clips, local_frames=lf,
        decode_workers=args.decode_workers, save_iter=args.save_iter, device=dev,
    )
    if args.bench and n_ok:
        import json

        print(json.dumps({
            "metric": "extract_videos_per_sec_e2e",
            "value": round(n_ok / elapsed, 3),
            "unit": f"videos/s end-to-end (decode + preprocess + featurize, "
                    f"{args.decode_workers} decode threads, batch {args.batch_size})",
            "device": str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev),
        }))

    if args.pack and args.num_chunk == 1:
        # consolidate into the mmap-able single-file cache
        npys = sorted(glob.glob(os.path.join(out_dir, "*.npy")))
        if npys:
            vids = [os.path.splitext(os.path.basename(p))[0] for p in npys]
            feats = np.stack([np.load(p) for p in npys]).astype(np.float16)
            FeatureStore.write_pack(out_dir, vids, feats)
            print(f"packed {len(vids)} videos into features.pack")
    print("done")


def get_args_parser():
    p = argparse.ArgumentParser("blim_tpu_torch feature extractor")
    p.add_argument("--dataset", default="DiDeMo",
                   choices=["DiDeMo", "ActivityNet", "LSMDC", "MSRVTT"])
    p.add_argument("--data_root", default="./data")
    p.add_argument("--model_path", default="./pretrained/VideoChat-Flash-Qwen2-7B_res448")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_chunk", type=int, default=1)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--save_iter", type=int, default=10)
    p.add_argument("--pack", action="store_true",
                   help="after extraction, consolidate per-video .npy files "
                        "into the single-file packed cache (features.pack)")
    p.add_argument("--decode-workers", type=int, default=4,
                   help="host decode threads overlapping the card's featurization")
    p.add_argument("--bench", action="store_true",
                   help="print an end-to-end videos/s JSON line at the end")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu' (plain versions)")
    return p


if __name__ == "__main__":
    main(get_args_parser().parse_args())
