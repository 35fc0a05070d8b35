"""Pipeline parallelism: two-stage serving across devices (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/pp.py``.  The
detector is split at the backbone/FPN seam: the backbone's weights live on
``devices[0]``, the FPN's, the head's and the decode on ``devices[1]``, and
microbatches stream through.  Stage 1 runs on a CUDA stream of its own;
the hop between the stages is a non-blocking copy (or, on one card, the
same memory) ordered after stage 1 by an event, so the card runs stage 1
of microbatch k+1 while stage 2 of microbatch k runs.  On one card both
stages take ``cuda:0`` with two streams; on the CPU the stages run one
after the other.

As in JAX, a deployment uses the seam where one device cannot hold the
whole model and its serving working set; data parallelism is the faster
layout for every model the repo ships.
"""
from __future__ import annotations

import contextlib
import copy
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from pytorch_object_detection_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from pytorch_object_detection_tpu_torch.ops.postprocess import Detections, decode_detections, resolve_nms_impl


def _fpn_head_for(model: nn.Module) -> Tuple[nn.Module, nn.Module]:
    """The (fpn, head) submodules of a detector assembly (the JAX
    ``utils/gradcam._fpn_head_for``): those of an FCOS (on either
    backbone), a HISFCOS or an MNFCOS."""
    from pytorch_object_detection_tpu_torch.models.fcos import FCOS, HISFCOS, MNFCOS

    if not isinstance(model, (FCOS, HISFCOS, MNFCOS)):
        raise ValueError(f"the two-stage pipeline splits FCOS, HISFCOS and MNFCOS at the backbone/FPN seam; got "
                         f"{type(model).__name__}")
    return model.fpn, model.head


def make_two_stage_pipeline(
    model: nn.Module,
    strides: Sequence[int],
    canvas_hw: Tuple[int, int],
    devices: Optional[Sequence] = None,
    score_threshold: float = 0.05,
    nms_iou: float = 0.6,
    max_detections: int = 1000,
    compute_dtype: torch.dtype = torch.bfloat16,
    mean=None,
    std=None,
):
    """Two-stage pipeline: ``run(batches) -> [Detections]`` streams an
    iterable of uint8 ``[B, H, W, 3]`` microbatches through the backbone
    on ``devices[0]`` and the FPN, head and decode on ``devices[1]``
    (default: ``cuda:0`` twice on one card, ``cuda:0, cuda:1`` on two, the
    CPU twice without a card).  Each microbatch's detections equal
    :func:`~pytorch_object_detection_tpu_torch.eval.evaluator.make_eval_pipeline`'s
    (kernel A's NMS on the card, the plain NMS on the CPU) and lie on
    ``devices[1]``.  The model carries its weights (the JAX function's
    ``variables``): each stage gets its own ``compute_dtype`` copy, made
    here; later changes to ``model`` are not seen.  ``run.devices`` is
    ``(d0, d1)``, ``run.stage_params`` the two stages' modules
    ``(backbone, (fpn, head))``."""
    if devices is None:
        n = torch.cuda.device_count()
        devices = ["cuda:0", f"cuda:{min(1, n - 1)}"] if n else ["cpu", "cpu"]
    if len(devices) < 2:
        raise ValueError("the two-stage pipeline takes two devices (the same one twice runs both stages there)")
    d0, d1 = torch.device(devices[0]), torch.device(devices[1])
    fpn, head = _fpn_head_for(model)
    stage1 = copy.deepcopy(model.backbone).to(d0, compute_dtype).eval()
    stage2 = (copy.deepcopy(fpn).to(d1, compute_dtype).eval(), copy.deepcopy(head).to(d1, compute_dtype).eval())
    mean0 = torch.tensor(IMAGENET_MEAN if mean is None else mean, dtype=torch.float32, device=d0)
    std0 = torch.tensor(IMAGENET_STD if std is None else std, dtype=torch.float32, device=d0)
    nms_plain = resolve_nms_impl("auto", d1) == "fixpoint"
    cuda = d0.type == "cuda" and d1.type == "cuda"
    s1 = torch.cuda.Stream(d0) if cuda else None
    s2 = torch.cuda.Stream(d1) if cuda else None

    def on(stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    @torch.inference_mode()
    def run(batches) -> List[Detections]:
        """Detections in the microbatches' order; stage 1 of microbatch
        k+1 is queued before the card finishes stage 2 of microbatch k."""
        outs, held = [], []
        if cuda:  # the streams start after what the caller queued
            s1.wait_stream(torch.cuda.current_stream(d0))
            s2.wait_stream(torch.cuda.current_stream(d1))
        for x in batches:
            with on(s1):
                x = torch.as_tensor(x).to(d0)
                x = ((x.float() / 255.0 - mean0) / std0).to(compute_dtype).permute(0, 3, 1, 2).contiguous()
                feats = stage1(x)[-3:]  # EfficientNet returns five endpoints
                done = s1.record_event() if cuda else None
            with on(s2):
                if cuda:
                    s2.wait_event(done)
                    if d0 == d1:  # the allocator keeps stage 1's maps until stage 2 has read them
                        for f in feats:
                            f.record_stream(s2)
                    else:  # held until the copies are done
                        held.append(feats)
                feats = [f.to(d1, non_blocking=True) for f in feats]  # the hop between the stages
                cls_l, cnt_l, reg_l = stage2[1](stage2[0](feats))
                nhwc = lambda xs: [t.permute(0, 2, 3, 1).float() for t in xs]
                outs.append(decode_detections(nhwc(cls_l), nhwc(cnt_l), nhwc(reg_l), strides, score_threshold,
                                              nms_iou, max_detections, canvas_hw, plain=nms_plain))
        if cuda:
            torch.cuda.current_stream(d1).wait_stream(s2)
            torch.cuda.current_stream(d0).wait_stream(s2)
        return outs

    run.devices = (d0, d1)
    run.stage_params = (stage1, stage2)
    return run
