"""The input side of the port: normalize constants, host loaders, the device resize.

The port's counterpart of ``pytorch_object_detection_tpu/data/pipeline.py``
(which imports jax, so the port keeps its own copy):

  * ``IMAGENET_MEAN``/``IMAGENET_STD``: images are normalized as ``(u8 /
    255 - mean) / std`` per RGB channel (serving pipelines and the PTQ);
  * :class:`Batch`, :func:`decode_to_tile`, :class:`DetectionLoader` (a
    thread pool over a map-style dataset) and :class:`RingTileLoader` (one
    native batch decode per batch into a preallocated ring), yielding the
    JAX loaders' batches byte for byte;
  * :func:`make_device_resize`: the aspect-preserving resize of raw tiles
    onto the canvas, batched on the tensors' device;
  * :func:`make_device_preprocess`: uint8 -> float, the train-time random
    horizontal flip (:func:`hflip`) and colour jitter
    (:func:`color_jitter`), and the normalize, on the images' device.  Each
    random function is its draws (``*_draws``, from a ``torch.Generator``)
    and a deterministic core that takes them (``*_apply``), so that a test
    can feed the JAX functions' draws to the core.

The loaders shard the index list across processes: ``process_count`` and
``process_index`` when given, else ``torch.distributed``'s world size and
rank where a process group is initialised, else one process (the JAX
loaders read ``jax.process_count()``).  They have no PIL fallback: an
image the native decoder declines raises ``ValueError``.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Batch(NamedTuple):
    """One statically-shaped host batch.

    Iterating a Batch unpacks like the plain 5-tuple the train loop uses;
    ``image_ids`` carries dataset identity for evaluators (order-independent,
    so sharded eval attributes detections correctly).
    """

    images: np.ndarray  # uint8 [B, H, W, 3]
    boxes: np.ndarray  # f32 [B, M, 4], -1 padded
    labels: np.ndarray  # i32 [B, M], -1 padded
    scales: np.ndarray  # f32 [B]
    content_w: np.ndarray  # i32 [B]
    image_ids: List[str]
    n_valid: int = -1  # real samples in the batch (-1 = all; see pad_last)
    content_h: Optional[np.ndarray] = None  # i32 [B] (device-resize path)


def process_shard(process_count: Optional[int], process_index: Optional[int]) -> Tuple[int, int]:
    """``(count, index)`` of this process's index shard: the arguments when
    given, else ``torch.distributed``'s world size and rank where a process
    group is initialised, else ``(1, 0)``."""
    if process_count is None or process_index is None:
        dist = torch.distributed
        initialised = dist.is_available() and dist.is_initialized()
        if process_count is None:
            process_count = dist.get_world_size() if initialised else 1
        if process_index is None:
            process_index = dist.get_rank() if initialised else 0
    return process_count, process_index


def _indices(n: int, shuffle: bool, seed: int, epoch: int, process_count, process_index) -> np.ndarray:
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed + epoch).permutation(n)
    # strided shard across processes: no sample is dropped (counts differ by at most 1)
    pc, pi = process_shard(process_count, process_index)
    return idx[pi::pc] if pc > 1 else idx


def make_device_resize(canvas_hw: Tuple[int, int]):
    """Batched aspect-preserving resize of raw uint8 tiles onto the canvas,
    on the tiles' device.

    The host only decodes into a fixed uint8 tile (content top-left, its
    last row and column replicated once past the content:
    :func:`decode_to_tile`); this does the per-image resize the host cv2
    call of ``data/voc.resize_to_canvas`` would do.  It is the JAX
    function's ``jax.image.scale_and_translate(method="linear",
    antialias=False)`` at the per-image scale ``sy, sx = round(h * s) / h,
    round(w * s) / w`` with ``s = min(ch / h, cw / w)``: per image, a ``[ch,
    TH]`` and a ``[cw, TW]`` weight matrix built on the device with the JAX
    weights (a tap outside the tile is dropped and the remaining weights
    renormalised; a sample outside the tile gets none), then two batched
    ``torch.matmul`` in f32, the content masked to ``(nh, nw)``, rounded half
    to even and clipped to uint8.  The f32 sums run in another order than
    XLA's, so a pixel whose value sits at .5 may round the other way: the
    CPU test holds it within one step of the JAX function on a stated
    share of pixels.  The products are f32: with TF32 matmuls allowed
    (``torch.backends.cuda.matmul.allow_tf32``, False by default) they would
    not be.

    Returns ``fn(tiles_u8 [B, TH, TW, 3] uint8, src_hw [B, 2] int32) ->
    (canvas_u8 [B, ch, cw, 3] uint8, scale [B] f32, content_hw [B, 2]
    int32)``, on the tiles' device.
    """
    ch, cw = canvas_hw

    def weights(n_in: int, n_out: int, scale):
        """[B, n_out, n_in] linear-resample weights at ``scale`` [B]."""
        inv = (1.0 / scale)[:, None]
        sample = (torch.arange(n_out, dtype=torch.float32, device=scale.device) + 0.5) * inv - 0.5  # [B, n_out]
        taps = torch.arange(n_in, dtype=torch.float32, device=scale.device)
        wt = torch.clamp(1.0 - (sample[:, :, None] - taps).abs(), min=0.0)  # [B, n_out, n_in]
        total = wt.sum(dim=2, keepdim=True)
        wt = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                         wt / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(wt))
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        return torch.where(inside[:, :, None], wt, torch.zeros_like(wt))

    def resize(tiles_u8, src_hw):
        if tiles_u8.dtype != torch.uint8 or tiles_u8.dim() != 4 or tiles_u8.shape[-1] != 3:
            raise ValueError(f"tiles must be uint8 [B, TH, TW, 3]; got {tiles_u8.dtype} {tuple(tiles_u8.shape)}")
        b, th, tw, _ = tiles_u8.shape
        if tuple(src_hw.shape) != (b, 2):
            raise ValueError(f"src_hw must be [{b}, 2]; got {tuple(src_hw.shape)}")
        dev = tiles_u8.device
        hw = src_hw.to(dev, torch.float32)
        h, w = hw[:, 0], hw[:, 1]
        scale = torch.minimum(ch / h, cw / w)
        nh, nw = torch.round(h * scale), torch.round(w * scale)
        wy, wx = weights(th, ch, nh / h), weights(tw, cw, nw / w)  # post-rounding factors, as cv2's
        rows = torch.matmul(wy, tiles_u8.to(torch.float32).reshape(b, th, tw * 3))  # [B, ch, TW * 3]
        rows = rows.reshape(b, ch, tw, 3).permute(0, 2, 1, 3).reshape(b, tw, ch * 3)
        out = torch.matmul(wx, rows).reshape(b, cw, ch, 3).permute(0, 2, 1, 3)  # [B, ch, cw, 3]
        keep = ((torch.arange(ch, device=dev)[None, :, None] < nh[:, None, None])
                & (torch.arange(cw, device=dev)[None, None, :] < nw[:, None, None]))
        out = torch.where(keep[..., None], out, torch.zeros((), device=dev))
        canvas = torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8).contiguous()
        return canvas, scale, torch.stack([nh, nw], dim=1).to(torch.int32)

    return resize


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), device=rgb.device)
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-8), zero)
    rc = (maxc - r) / delta.clamp(min=1e-8)
    gc = (maxc - g) / delta.clamp(min=1e-8)
    bc = (maxc - b) / delta.clamp(min=1e-8)
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*by_sector):  # the value of sector i, for i in 0..5
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, by_sector[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)], dim=-1)


def color_jitter_draws(generator: torch.Generator, batch: int, prob: float = 0.3,
                       strength: float = 0.1) -> Dict[str, torch.Tensor]:
    """The draws of :func:`color_jitter` on ``generator.device``: ``apply``
    [B, 1, 1, 1] bool (p=``prob``), the brightness, contrast and saturation
    factors [B, 1, 1, 1] in ``[1 - strength, 1 + strength)`` and ``hue``
    [B, 1, 1] in ``[-strength, strength)``."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    apply = torch.rand((batch, 1, 1, 1), generator=generator, device=dev) < prob
    factors = {k: uniform((batch, 1, 1, 1), 1.0 - strength, 1.0 + strength)
               for k in ("brightness", "contrast", "saturation")}
    return {"apply": apply, **factors, "hue": uniform((batch, 1, 1), -strength, strength)}


def color_jitter_apply(images: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Brightness, contrast, saturation, then hue (torchvision's semantics in
    that fixed order; the contrast's mean and the saturation's gray both
    from the brightened image), clipped to [0, 1], on the images where
    ``apply``: the JAX ``color_jitter`` given its draws."""
    out = images * draws["brightness"]
    gray = out.mean(dim=-1, keepdim=True)
    gray_mean = gray.mean(dim=(1, 2), keepdim=True)
    out = (out - gray_mean) * draws["contrast"] + gray_mean
    out = (out - gray) * draws["saturation"] + gray
    hsv = _rgb_to_hsv(out.clamp(0.0, 1.0))
    hsv = torch.cat([torch.remainder(hsv[..., :1] + draws["hue"][..., None], 1.0), hsv[..., 1:]], dim=-1)
    out = _hsv_to_rgb(hsv)
    return torch.where(draws["apply"], out.clamp(0.0, 1.0), images)


def color_jitter(generator: torch.Generator, images: torch.Tensor, prob: float = 0.3,
                 strength: float = 0.1) -> torch.Tensor:
    """Batched colour jitter of ``images [B, H, W, 3]`` in [0, 1] (p=``prob``)."""
    return color_jitter_apply(images, color_jitter_draws(generator, images.shape[0], prob, strength))


def hflip_draws(generator: torch.Generator, batch: int, prob: float = 0.5) -> torch.Tensor:
    """The draws of :func:`hflip`: ``flip`` [B] bool (p=``prob``) on ``generator.device``."""
    return torch.rand((batch,), generator=generator, device=generator.device) < prob


def hflip_apply(images: torch.Tensor, boxes: torch.Tensor, content_w: torch.Tensor,
                flip: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror each flipped image about its content width (the content sits
    at the canvas's left edge, so it stays there and the padding is
    untouched) and its valid boxes with it: the JAX ``hflip`` given its draws."""
    b, _, w, c = images.shape
    cols = torch.arange(w, device=images.device)[None, :]  # [1, W]
    nw = content_w.to(images.device)[:, None].long()  # [B, 1]
    src = torch.where(cols < nw, nw - 1 - cols, cols)
    src = torch.where(flip[:, None], src, cols)  # [B, W]
    flipped = images.gather(2, src[:, None, :, None].expand(b, images.shape[1], w, c))
    valid = boxes[..., 0] > -0.5
    nw_b = content_w.to(boxes.device)[:, None].to(boxes.dtype)
    fb = torch.stack([nw_b - 1.0 - boxes[..., 2], boxes[..., 1], nw_b - 1.0 - boxes[..., 0], boxes[..., 3]], dim=-1)
    return flipped, torch.where((flip[:, None] & valid)[..., None], fb, boxes)


def hflip(generator: torch.Generator, images: torch.Tensor, boxes: torch.Tensor, content_w: torch.Tensor,
          prob: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random horizontal flip (p=``prob``) of images and boxes about each image's content width."""
    return hflip_apply(images, boxes, content_w, hflip_draws(generator, images.shape[0], prob))


def make_device_preprocess(train: bool, mean: Sequence[float] = IMAGENET_MEAN, std: Sequence[float] = IMAGENET_STD,
                           flip_prob: float = 0.5, jitter_prob: float = 0.3):
    """``fn(generator, images_u8 [B, H, W, 3], boxes [B, M, 4], content_w
    [B]) -> (images f32 normalized, boxes)`` on the images' device: ``u8 /
    255``, then with ``train`` the flip and the jitter (drawn from
    ``generator`` in that order; ``generator`` is unused otherwise), then
    ``(x - mean) / std``."""
    def fn(generator: Optional[torch.Generator], images_u8: torch.Tensor, boxes: torch.Tensor,
           content_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = images_u8.device
        boxes = boxes.to(dev)
        x = images_u8.float() / 255.0
        if train:
            x, boxes = hflip(generator, x, boxes, content_w.to(dev), flip_prob)
            x = color_jitter(generator, x, jitter_prob)
        return (x - torch.tensor(mean, device=dev)) / torch.tensor(std, device=dev), boxes

    return fn


def decode_to_tile(image: np.ndarray, tile_hw: Tuple[int, int]) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Place a decoded image into a fixed uint8 tile (top-left), replicating
    the last content row/col once so device-side linear resampling past the
    edge sees cv2's clamp semantics.  Images larger than the tile are
    cropped to it (top-left; rare, the tile should bound the dataset)."""
    th, tw = tile_hw
    h, w = image.shape[:2]
    if h > th or w > tw:
        image = image[:th, :tw]
        h, w = image.shape[:2]
    tile = np.zeros((th, tw, 3), np.uint8)
    tile[:h, :w] = image
    if h < th:
        tile[h, :w] = image[h - 1, :w]
    if w < tw:
        tile[: min(h + 1, th), w] = tile[: min(h + 1, th), w - 1]
    return tile, (h, w)


class DetectionLoader:
    """Thread-pool prefetching loader over a map-style dataset.

    Yields statically-shaped numpy :class:`Batch` es: images uint8 [B, H, W,
    3], boxes f32 [B, M, 4] (-1 padded), labels i32 [B, M] (-1 padded),
    scales f32 [B], content_w i32 [B].  The index list is sharded across
    processes (:func:`process_shard`) and the per-epoch shuffle is seeded.
    ``pad_last`` pads the final batch to ``batch_size`` with its last
    sample (one shape for every batch; the padding excluded by
    ``Batch.n_valid``).
    """

    def __init__(self, dataset, batch_size: int, max_boxes: int = 64, shuffle: bool = True, num_workers: int = 8,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 4, pad_last: bool = False,
                 process_count: Optional[int] = None, process_index: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pad_last = pad_last
        self.process_count = process_count
        self.process_index = process_index
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        return _indices(len(self.dataset), self.shuffle, self.seed, self.epoch, self.process_count,
                        self.process_index)

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_from_samples(self, samples) -> Batch:
        n_real = len(samples)
        if self.pad_last and n_real < self.batch_size:
            samples = list(samples) + [samples[-1]] * (self.batch_size - n_real)
        b = len(samples)
        h, w = samples[0].image.shape[:2]
        images = np.zeros((b, h, w, 3), np.uint8)
        boxes = np.full((b, self.max_boxes, 4), -1.0, np.float32)
        labels = np.full((b, self.max_boxes), -1, np.int32)
        scales = np.zeros((b,), np.float32)
        content_w = np.zeros((b,), np.int32)
        content_h = np.zeros((b,), np.int32)
        ids = []
        for i, s in enumerate(samples):
            images[i] = s.image
            n = min(len(s.boxes), self.max_boxes)
            if n:
                boxes[i, :n] = s.boxes[:n]
                labels[i, :n] = s.labels[:n]
            scales[i] = s.scale
            content_w[i] = s.content_hw[1] or w
            content_h[i] = s.content_hw[0] or h
            ids.append(s.image_id)
        return Batch(images, boxes, labels, scales, content_w, ids, n_real, content_h)

    def __iter__(self) -> Iterator[Batch]:
        from concurrent.futures import ThreadPoolExecutor

        indices = self._indices()
        self.epoch += 1
        n_batches = len(self) if not self.drop_last else len(indices) // self.batch_size
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
            stop = threading.Event()

            def producer():
                try:
                    for bi in range(n_batches):
                        if stop.is_set():
                            return
                        chunk = indices[bi * self.batch_size:(bi + 1) * self.batch_size]
                        samples = list(pool.map(lambda i: self.dataset[int(i)], chunk))
                        out_q.put(self._batch_from_samples(samples))
                except Exception as err:  # handed to the consumer, which raises it
                    out_q.put(err)
                    return
                out_q.put(None)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    item = out_q.get()
                    if item is None:
                        return
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
                while t.is_alive():  # drain, so a producer blocked on a full queue ends
                    try:
                        out_q.get(timeout=0.1)
                    except queue.Empty:
                        pass


class RingTileLoader:
    """Batched-native loader: one Python call per batch, a preallocated ring.

    The port's counterpart of the JAX ``RingTileLoader``:

      * annotations are parsed once at init into dense [N, M, 4]/[N, M]
        arrays; per batch they are indexed and scaled as arrays;
      * the raw JPEG bytes are kept in host memory at init;
      * each batch is decoded by one ctypes call into the native thread pool
        (the GIL released), straight into one of ``depth`` preallocated [B,
        th, tw, 3] ring slots.

    Yields the raw-tile :class:`Batch` of ``DetectionLoader(dataset
    (raw_tiles=True))``; a Batch's ``images`` is a view of a ring slot,
    valid until ``depth - 1`` further batches have been drawn (copy it to
    the device before then).

    Takes VOC-style datasets (``.items`` of (root, image_id)) with no
    augment.  An image the native decoder declines raises ``ValueError``
    (the JAX loader re-decodes it through PIL).  The JAX loader's
    ``skip_decode`` measurement switch is not ported.
    """

    def __init__(self, dataset, batch_size: int, max_boxes: int = 64, shuffle: bool = True, seed: int = 0,
                 decode_threads: int = 0, depth: int = 3, drop_last: bool = True, pad_last: bool = False,
                 process_count: Optional[int] = None, process_index: Optional[int] = None):
        from pytorch_object_detection_tpu_torch.data.voc import parse_voc_xml

        if getattr(dataset, "augment", None) is not None:
            raise ValueError("RingTileLoader is the batched host path: it takes a dataset with no augment")
        if depth < 2:
            raise ValueError(f"depth must be at least 2; got {depth}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.seed = seed
        self.decode_threads = decode_threads
        self.depth = depth
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.process_count = process_count
        self.process_index = process_index
        self.epoch = 0
        self.canvas_hw = dataset.canvas_hw
        self.tile_hw = getattr(dataset, "tile_hw", dataset.canvas_hw)

        n = len(dataset.items)
        self._ids = [img_id for _root, img_id in dataset.items]
        self._blobs: List[bytes] = []
        self.boxes_all = np.full((n, max_boxes, 4), -1.0, np.float32)
        self.labels_all = np.full((n, max_boxes), -1, np.int32)
        for i, (root, img_id) in enumerate(dataset.items):
            with open(os.path.join(root, "JPEGImages", f"{img_id}.jpg"), "rb") as f:
                self._blobs.append(f.read())
            bx, lb = parse_voc_xml(os.path.join(root, "Annotations", f"{img_id}.xml"),
                                   getattr(dataset, "use_difficult", False))
            k = min(len(bx), max_boxes)
            if k:
                self.boxes_all[i, :k] = bx[:k]
                self.labels_all[i, :k] = lb[:k]
        th, tw = self.tile_hw
        self._ring_tiles = np.zeros((depth, batch_size, th, tw, 3), np.uint8)
        self._ring_hw = np.zeros((depth, batch_size, 2), np.int32)

    def _indices(self) -> np.ndarray:
        return _indices(len(self._blobs), self.shuffle, self.seed, self.epoch, self.process_count,
                        self.process_index)

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _produce(self, chunk: np.ndarray, slot: int) -> Batch:
        from pytorch_object_detection_tpu_torch.native.lib import jpeg_decode_batch_native

        n_real = len(chunk)
        if self.pad_last and n_real < self.batch_size:
            chunk = np.concatenate([chunk, np.full(self.batch_size - n_real, chunk[-1], chunk.dtype)])
        b = len(chunk)
        tiles = self._ring_tiles[slot, :b]
        hw = self._ring_hw[slot, :b]
        _, _, ok = jpeg_decode_batch_native([self._blobs[i] for i in chunk], self.tile_hw, self.decode_threads,
                                            out_tiles=tiles, out_hw=hw)
        if not ok.all():
            bad = [self._ids[chunk[j]] for j in np.nonzero(~ok)[0]]
            raise ValueError(f"the native JPEG decoder declines {bad} (not baseline RGB/gray JPEGs?)")
        np.minimum(hw, np.asarray(self.tile_hw, np.int32), out=hw)
        ch, cw = self.canvas_hw
        scale = np.minimum(ch / np.maximum(hw[:, 0], 1), cw / np.maximum(hw[:, 1], 1)).astype(np.float32)
        raw = self.boxes_all[chunk]
        boxes = np.where(raw >= 0.0, raw * scale[:, None, None], -1.0)
        return Batch(tiles, boxes, self.labels_all[chunk], scale, hw[:, 1].copy(), [self._ids[i] for i in chunk],
                     n_real, hw[:, 0].copy())

    def __iter__(self):
        indices = self._indices()
        self.epoch += 1
        n_batches = len(self) if not self.drop_last else len(indices) // self.batch_size
        free_q: "queue.Queue" = queue.Queue()
        for s in range(self.depth):
            free_q.put(s)
        out_q: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        def producer():
            try:
                for bi in range(n_batches):
                    slot = free_q.get()
                    if stop.is_set():
                        return
                    chunk = indices[bi * self.batch_size:(bi + 1) * self.batch_size]
                    out_q.put((slot, self._produce(chunk, slot)))
            except Exception as err:  # handed to the consumer, which raises it
                out_q.put(err)
                return
            out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        held: List[int] = []
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                slot, batch = item
                # the consumer may still be copying the previous slot: recycle
                # slots depth - 1 batches behind the one yielded
                held.append(slot)
                if len(held) > self.depth - 1:
                    free_q.put(held.pop(0))
                yield batch
        finally:
            stop.set()
            free_q.put(0)  # unblock a producer waiting on a slot
            t.join()
