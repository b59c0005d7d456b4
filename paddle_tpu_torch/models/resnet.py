"""The ResNet family, v1.5 (stride 2 in the bottleneck's 3x3), built as a
Fluid program and trained through ``fluid.Executor`` (port of
``paddle_tpu/models/resnet.py``): BASELINE.json's ResNet-50 headline
model. Convolutions and batch norm run NCHW; each batch norm's running
Mean and Variance are persistable variables its op rewrites in place."""

from .. import fluid

__all__ = ["resnet", "build_resnet_train"]

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _conv_bn(input, num_filters, filter_size, stride=1, groups=1, act=None,
             is_test=False):
    """conv (no bias, "same" padding) then batch norm with ``act``."""
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return fluid.layers.batch_norm(conv, act=act, is_test=is_test)


def _shortcut(input, ch_out, stride, is_test):
    """The identity, or a 1x1 conv + batch norm where the channels or the
    stride change."""
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(input, ch_out, 1, stride, is_test=is_test)
    return input


def _basic_block(input, num_filters, stride, is_test):
    conv0 = _conv_bn(input, num_filters, 3, stride, act="relu",
                     is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, 1, is_test=is_test)
    short = _shortcut(input, num_filters, stride, is_test)
    return fluid.layers.relu(fluid.layers.elementwise_add(short, conv1))


def _bottleneck_block(input, num_filters, stride, is_test):
    conv0 = _conv_bn(input, num_filters, 1, act="relu", is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, stride, act="relu",
                     is_test=is_test)
    conv2 = _conv_bn(conv1, num_filters * 4, 1, is_test=is_test)
    short = _shortcut(input, num_filters * 4, stride, is_test)
    return fluid.layers.relu(fluid.layers.elementwise_add(short, conv2))


def resnet(img, class_num=1000, depth=50, is_test=False, checkpoints=None):
    """ResNet's forward (``resnet.py:62``): ``img`` [N, 3, H, W] ->
    logits [N, class_num]. A 7x7/2 stem, a 3x3/2 max pool, the four
    stages of ``_DEPTH_CFG[depth]``, global average pooling, an fc.
    ``checkpoints``: a list collects each residual block's output."""
    block_kind, stages = _DEPTH_CFG[depth]
    block = _basic_block if block_kind == "basic" else _bottleneck_block
    conv = _conv_bn(img, 64, 7, stride=2, act="relu", is_test=is_test)
    pool = fluid.layers.pool2d(conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type="max")
    num_filters = [64, 128, 256, 512]
    for stage, count in enumerate(stages):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            pool = block(pool, num_filters[stage], stride, is_test)
            if checkpoints is not None:
                checkpoints.append(pool)
    pool = fluid.layers.pool2d(pool, pool_type="avg", global_pooling=True)
    return fluid.layers.fc(input=pool, size=class_num)


def build_resnet_train(depth=50, class_num=1000, image_size=224,
                       learning_rate=0.1, momentum=0.9, is_test=False,
                       use_amp=False, recompute=False):
    """(main, startup, feeds, avg_loss, acc) for ResNet training
    (``resnet.py:88``): feeds ``img`` [N, 3, image_size, image_size]
    float32 and ``label`` [N, 1] int64, softmax cross entropy, top-1
    accuracy, Momentum. ``use_amp``: the optimizer decorated with
    ``contrib.mixed_precision.decorate`` (bf16 convolutions and fc, batch
    norm following its input with fp32 statistics, fp32 master weights
    and update). ``recompute``: activation recompute at every other
    residual block's output (``RecomputeOptimizer`` with checkpoints
    ``ckpts[1::2]``, inside the AMP decorator as at ``resnet.py:106-124``:
    AMP's backward rewrites the program, then delegates to the
    checkpointed ``append_backward``)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img",
                                shape=[3, image_size, image_size],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        ckpts = [] if recompute else None
        logits = resnet(img, class_num=class_num, depth=depth,
                        is_test=is_test, checkpoints=ckpts)
        loss = fluid.layers.softmax_with_cross_entropy(logits, label)
        avg_loss = fluid.layers.mean(loss)
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        opt = fluid.optimizer.Momentum(learning_rate=learning_rate,
                                       momentum=momentum)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts[1::2])
        if use_amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg_loss)
    return main, startup, [img, label], avg_loss, acc
