"""LeNet-5 for MNIST-shaped input (port of ``paddle_tpu/models/lenet.py``),
built as a Fluid program and trained through ``fluid.Executor``."""

from .. import fluid

__all__ = ["lenet", "build_lenet_train"]


def lenet(img, label, class_num=10):
    """LeNet's forward and loss on the current program (``lenet.py:8``):
    conv 5x5 (6, padding 2) - max pool 2 - conv 5x5 (16) - max pool 2 -
    fc 120 - fc 84 - fc ``class_num``, ReLU between. ``img``: [N, 1, 28,
    28] float32, ``label``: [N, 1] int64. The first conv, one input
    channel at groups 1, is a ``depthwise_conv2d`` op, as the reference
    emits it. Returns (avg_loss, accuracy, logits)."""
    conv1 = fluid.layers.conv2d(input=img, num_filters=6, filter_size=5,
                                padding=2, act="relu")
    pool1 = fluid.layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = fluid.layers.conv2d(input=pool1, num_filters=16, filter_size=5,
                                act="relu")
    pool2 = fluid.layers.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = fluid.layers.fc(input=pool2, size=120, act="relu")
    fc2 = fluid.layers.fc(input=fc1, size=84, act="relu")
    logits = fluid.layers.fc(input=fc2, size=class_num)
    loss = fluid.layers.softmax_with_cross_entropy(logits, label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                label=label)
    return avg_loss, acc, logits


def build_lenet_train(batch_size=None, learning_rate=0.01, optimizer="sgd"):
    """(main, startup, feeds, avg_loss, acc) for LeNet training
    (``lenet.py:29``): feeds ``img`` [N, 1, 28, 28] float32 and ``label``
    [N, 1] int64; ``optimizer`` "sgd" or "adam". ``batch_size`` is the
    reference's argument, unused there too (the batch dim is -1)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        avg_loss, acc, _ = lenet(img, label)
        if optimizer == "adam":
            opt = fluid.optimizer.Adam(learning_rate=learning_rate)
        else:
            opt = fluid.optimizer.SGD(learning_rate=learning_rate)
        opt.minimize(avg_loss)
    return main, startup, [img, label], avg_loss, acc
