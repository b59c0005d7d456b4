"""FCN-32s semantic segmentation on a ResNet trunk (Long, Shelhamer and
Darrell, "Fully Convolutional Networks for Semantic Segmentation", CVPR
2015), written once for both packages: ``models/resnet.py``'s trunk up
to its last stage (no global pool, no ``fc``), a 1×1 ``conv2d`` to the
classes, ``resize_bilinear`` back to the image, a per-pixel softmax
cross entropy that skips the ignore label, averaged over the pixels,
and ``mean_iou`` of the per-pixel argmax, trained by Momentum.
``fluid`` and ``resnet`` are a package's ``fluid`` and
``models.resnet`` modules: the port's by default; a parity test passes
the JAX package's to build the same program there.

``fcn_batch`` makes a synthetic batch at Cityscapes' label form (classes
0..n−1, ignore 255): coarse blocks of one class each, the image's colour
in a block telling its class."""

import numpy as np

__all__ = ["IGNORE_LABEL", "build_fcn_resnet", "fcn_batch"]

IGNORE_LABEL = 255


def build_fcn_resnet(fluid=None, resnet=None, depth=50, num_classes=19,
                     image_hw=(512, 1024)):
    """Returns (main, startup, feeds, avg_loss, (mean_iou, wrong,
    correct), pred): the feeds ``img`` [N, 3, H, W] float32 and
    ``label`` [N, H, W] int64; ``pred`` [N, H, W] int64 the argmax over
    the classes. Momentum at lr 0.01, µ 0.9."""
    if fluid is None:
        from .. import fluid
    if resnet is None:
        from ..models import resnet
    H, W = int(image_hw[0]), int(image_hw[1])
    block_kind, stages = resnet._DEPTH_CFG[depth]
    block = resnet._basic_block if block_kind == "basic" else \
        resnet._bottleneck_block
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        img = layers.data(name="img", shape=[3, H, W], dtype="float32")
        label = layers.data(name="label", shape=[H, W], dtype="int64")
        x = resnet._conv_bn(img, 64, 7, stride=2, act="relu")
        x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                          pool_type="max")
        for stage, count in enumerate(stages):
            for i in range(count):
                x = block(x, [64, 128, 256, 512][stage],
                          2 if i == 0 and stage > 0 else 1, False)
        score = layers.conv2d(x, num_filters=num_classes, filter_size=1)
        up = layers.resize_bilinear(score, out_shape=[H, W])
        logits = layers.reshape(layers.transpose(up, [0, 2, 3, 1]),
                                [-1, num_classes])
        loss = layers.softmax_with_cross_entropy(
            logits, layers.reshape(label, [-1, 1]),
            ignore_index=IGNORE_LABEL)
        avg_loss = layers.mean(loss)
        pred = layers.argmax(up, axis=1)
        miou = layers.mean_iou(pred, label, num_classes)
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(avg_loss)
    return main, startup, [img, label], avg_loss, miou, pred


def fcn_batch(batch, num_classes, image_hw, seed=0):
    """(img [batch, 3, H, W] float32, label [batch, H, W] int64): the
    image cut into 64 × 64 tiles, each tile one class from the seed (a
    tenth of the tiles the ignore label), its pixels the class's colour
    (a fixed random colour a class) plus noise of standard deviation
    0.3."""
    H, W = int(image_hw[0]), int(image_hw[1])
    bh, bw = min(64, H), min(64, W)
    rng = np.random.default_rng(seed)
    palette = rng.uniform(-1.0, 1.0, (num_classes + 1, 3))
    gh, gw = -(-H // bh), -(-W // bw)
    tiles = rng.integers(0, num_classes, (batch, gh, gw))
    tiles[rng.random((batch, gh, gw)) < 0.1] = IGNORE_LABEL
    label = tiles.repeat(bh, 1).repeat(bw, 2)[:, :H, :W]
    colour = palette[np.where(label == IGNORE_LABEL, num_classes, label)]
    img = colour.transpose(0, 3, 1, 2) + 0.3 * rng.standard_normal(
        (batch, 3, H, W))
    return img.astype(np.float32), label.astype(np.int64)
