"""Input-normalize constants, shared by the serving pipelines and the PTQ.

The port's own copy of the constants in ``pytorch_object_detection_tpu/
data/pipeline.py`` (that module imports jax).  Images are normalized as
``(u8 / 255 - IMAGENET_MEAN) / IMAGENET_STD`` per RGB channel.
"""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
