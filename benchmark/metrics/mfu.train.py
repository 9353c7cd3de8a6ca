"""The reference's matrix FLOPs an image of a SoftTreeSupLoss step
(forward and backward; direct convolution) times the images a second the
traced window stepped (over every card), over the H100's published 67
TFLOP/s f32 peak times the cards the run uses."""

from benchmark.readers import mfu_percent


def read(run):
    return mfu_percent(run, "train_images", train=True)
