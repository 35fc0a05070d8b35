"""Faults planted underneath the timed path, for the tests: each wraps what the program gives the harness."""
import torch


class BrokenPipeline:
    """The program's pipeline with its detections spoiled in ``decode``: ``half`` drops the second half
    of the batch's detections, ``altered`` moves every class by one."""

    def __init__(self, pipeline, fault: str):
        self.pipeline, self.fault = pipeline, fault

    def __getattr__(self, name):
        return getattr(self.pipeline, name)

    def decode(self, levels):
        det = self.pipeline.decode(levels)
        if self.fault == "half":
            valid = det.valid.clone()
            valid[valid.shape[0] // 2:] = False
            return det._replace(valid=valid)
        return det._replace(classes=det.classes % self.pipeline_classes() + 1)

    def pipeline_classes(self):
        return 20

    def __call__(self, frames, src_hw=None):
        return self.decode(self.pipeline.forward_levels(self.pipeline.canvas(frames)))


def broken_step(step, fault: str):
    """The program's train step with ``fault``: ``unchanged`` leaves the state as it was (no update),
    ``half`` takes the mean over the first half of the batch only, ``altered`` halves every gradient
    where the backward produced it (a mean taken twice)."""

    def run(state, images, boxes, labels, record=None):
        if fault == "unchanged":
            saved = [p.detach().clone() for p in state.model.parameters()]
            out = step(state, images, boxes, labels, record=record)
            with torch.no_grad():
                for p, s in zip(state.model.parameters(), saved):
                    p.copy_(s)
            state.optimizer.state.clear()
            return out
        if fault == "half":
            h = images.shape[0] // 2
            return step(state, images[:h], boxes[:h], labels[:h], record=record)
        update = state.optimizer.step

        def halved_update(*args, **kwargs):
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.mul_(0.5)
            return update(*args, **kwargs)

        state.optimizer.step = halved_update
        try:
            return step(state, images, boxes, labels, record=record)
        finally:
            del state.optimizer.step

    return run


def no_exchange_rank(rank, world, port, cell, cfg, args, t_start, spec, queue, device_type="cuda"):
    """A rank whose gradients are never averaged over the group."""
    from pytorch_object_detection_tpu_torch.train import trainer

    from bench_port import train

    trainer.pmean_grads = lambda grads, group: None
    train.rank_main(rank, world, port, cell, cfg, args, t_start, spec, queue, device_type)


def jax_rank(rank, world, port, cell, cfg, args, t_start, spec, queue, device_type="cuda"):
    """A rank in which something loads JAX (here planted in ``sys.modules``) as the rank's port would."""
    import sys
    import types

    from bench_port import train

    if rank == world - 1:
        sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
    train.rank_main(rank, world, port, cell, cfg, args, t_start, spec, queue, device_type)
