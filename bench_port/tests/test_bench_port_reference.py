"""The frozen reference against the program's float modules and decode, at 128x128 on the CPU."""
import pytest
import torch

from bench_port import harness, inputs, weights
from bench_port.reference import models, postprocess
from bench_port.tests.small import CANVAS, CPU


@pytest.mark.parametrize("config", ["hisfcos20_r50_voc512", "fcos20_r50_voc512"])
def test_forward_matches_program(config):
    from pytorch_object_detection_tpu_torch.models.registry import build_model

    cfg = harness.load_json(harness.ROOT / "configs" / f"{config}.json")
    w = weights.draw(cfg, 3, CPU)
    model = build_model(cfg["family"], cfg["num_classes"], cfg["features"], device="cpu",
                        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(w, strict=True)  # the reference names every weight the program holds, and no other
    cell, _ = harness.load_cell("hisfcos20-int8-serve-b64")
    u8, _, _ = inputs.frames(weights.generator(CPU, 3, 1), 2, tuple(CANVAS), cell["frames"], 20, CPU)
    x = inputs.normalize(u8)
    with torch.no_grad():
        got, want = model(x), models.forward(cfg["family"], w, x)
    for branch_got, branch_want in zip(got, want):
        for g, r in zip(branch_got, branch_want):
            assert g.shape == r.shape
            assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


def test_decode_and_nms_match_program():
    from pytorch_object_detection_tpu_torch.ops.postprocess import decode_detections

    g = torch.Generator().manual_seed(5)
    shapes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    cls = [torch.randn(2, h, w, 20, generator=g) * 1.5 - 6 for h, w in shapes]
    cnt = [torch.randn(2, h, w, 1, generator=g) for h, w in shapes]
    reg = [torch.exp(torch.randn(2, h, w, 4, generator=g) * 0.6 + 3) for h, w in shapes]
    strides = [8, 16, 32, 64, 128]
    det = decode_detections(cls, cnt, reg, strides, 0.05, 0.6, 100, tuple(CANVAS), plain=True)
    want = postprocess.detections((cls, cnt, reg), strides, 0.05, 0.6, 100, tuple(CANVAS))
    for i, r in enumerate(want):
        keep = det.valid[i]
        assert int(keep.sum()) == len(r["scores"]) > 0
        torch.testing.assert_close(det.scores[i][keep], torch.from_numpy(r["scores"]))
        torch.testing.assert_close(det.classes[i][keep], torch.from_numpy(r["classes"]))
        torch.testing.assert_close(det.boxes[i][keep], torch.from_numpy(r["boxes"]))


def test_weights_repeat_by_seed_and_cover_every_tensor():
    cfg = harness.load_json(harness.ROOT / "configs" / "hisfcos20_r50_voc512.json")
    a, b, c = weights.draw(cfg, 9, CPU), weights.draw(cfg, 9, CPU), weights.draw(cfg, 10, CPU)
    assert list(a) == list(models.weight_specs("HISFCOS", 20, 256))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.cls_pred.weight"], c["head.cls_pred.weight"])
