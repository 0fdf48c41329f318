"""Device milliseconds a batch of cuDNN's convolutions and their layout
transposes over the whole batch: the backbone body's convs
(``models/resnet_fpn.py``, ``models/mobilenet_fpn.py``) and MobileNet's FPN
convs; a class of kernel rather than a layer."""

INCLUDE = ("conv", "cudnn", "fprop", "dgrad", "nchwToNhwc", "nhwcToNchw", "xmma", "implicit")
EXCLUDE = ("rpn_level", "roi_align", "encoder_code", "lif6_", "fpn_level", "stem_kernel",
           "sweep_kernel", "wgrad_kernel", "dwout_", "elementwise")


def read(ctx):
    s = ctx.trace.seconds(INCLUDE, EXCLUDE)
    return 1e3 * s / ctx.batches if s > 0 else None
