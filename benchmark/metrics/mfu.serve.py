"""The reference's matrix FLOPs an image (backbone, classifier, soft
rules; direct convolution) times the images a second the traced window
completed, over the H100's published 67 TFLOP/s f32 peak."""

from benchmark.readers import mfu_percent


def read(run):
    return mfu_percent(run, "images", train=False)
