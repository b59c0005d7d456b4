"""Dygraph model programs written on the public ``fluid.dygraph`` API, as
factories that take the ``fluid`` module they build with, so the same
user program runs on either package: the port's
(``paddle_tpu_torch.fluid``) or the reference's. Imports neither JAX nor
the reference; the caller passes its ``fluid``.

- ``make_bert_classifier(fluid, cfg, seq_len)``: the BERT sequence
  classifier of ``models/bert.py`` ``build_bert_classifier``, op for op
  where the layers allow (``Linear`` traces ``matmul`` where the
  program's ``fc`` traces ``mul``), with the flash attention op and the
  mask's key bias; ``bert_static_names(cfg)`` maps the program's
  parameter names to its ``state_dict`` keys.
- ``make_lenet(fluid)``: LeNet-5 of ``models/lenet.py``.
- ``make_mnist``, ``make_resnet``, ``make_ptb``: small versions of the
  reference's dygraph/static parity models (MNIST convnet, ResNet of
  basic blocks, PTB LSTM LM).

Layers whose parameters are made at their first call (``LayerNorm``,
``Conv2D``, ``FC``) are built by the factory or by one call before
parameters are copied in.
"""

import math

import numpy as np

__all__ = ["make_bert_classifier", "bert_static_names", "make_lenet",
           "make_mnist", "make_resnet", "make_ptb", "build_lazy"]


def build_lazy(fluid, layer, shape):
    """Make ``layer``'s parameters by one call on zeros of ``shape``
    (outside the tape)."""
    with fluid.dygraph.no_grad():
        layer(fluid.dygraph.to_variable(np.zeros(shape, np.float32)))


def make_bert_classifier(fluid, cfg, seq_len, num_classes=2):
    """BERT's classifier as a dygraph ``Layer``: ``model(src_ids, pos_ids,
    sent_ids, input_mask, label)`` -> the mean softmax cross entropy,
    feeds as ``build_bert_classifier``'s ([N, S, 1] int64 ids, [N, S, 1]
    float32 mask, [N, 1] int64 labels). Dropout layers only where the
    rate is above 0 and not ``cfg.is_test``, as the program's
    ``_dropout``."""
    dy = fluid.dygraph
    layers = fluid.layers
    H, heads = cfg.hidden_size, cfg.num_heads
    d_head = H // heads

    def dropout(rate):
        return dy.Dropout(p=rate) if rate > 0.0 and not cfg.is_test else None

    def apply(drop, x):
        return x if drop is None else drop(x)

    def layer_norm(name):
        ln = dy.LayerNorm(name, begin_norm_axis=2)
        build_lazy(fluid, ln, (1, 1, H))
        return ln

    class Encoder(dy.Layer):
        def __init__(self, name):
            super(Encoder, self).__init__(name)
            self.att_q = dy.Linear(H, H)
            self.att_k = dy.Linear(H, H)
            self.att_v = dy.Linear(H, H)
            self.att_out = dy.Linear(H, H)
            self.ln1 = layer_norm("ln1")
            self.ffn_fc0 = dy.Linear(H, cfg.intermediate_size, act="gelu")
            self.ffn_fc1 = dy.Linear(cfg.intermediate_size, H)
            self.ln2 = layer_norm("ln2")
            self.drop_att = dropout(cfg.hidden_dropout)
            self.drop_ffn = dropout(cfg.hidden_dropout)

        def forward(self, x, key_bias):
            def split_heads(t):
                t = layers.reshape(t, shape=[0, 0, heads, d_head])
                return layers.transpose(t, perm=[0, 2, 1, 3])

            q = split_heads(self.att_q(x))
            k = split_heads(self.att_k(x))
            v = split_heads(self.att_v(x))
            ctxt = layers.flash_attention(
                q, k, v, key_bias=key_bias, causal=False,
                scale=1.0 / math.sqrt(d_head),
                dropout_rate=cfg.attention_dropout, is_test=cfg.is_test)
            ctxt = layers.transpose(ctxt, perm=[0, 2, 1, 3])
            ctxt = layers.reshape(ctxt, shape=[0, 0, H])
            attn = apply(self.drop_att, self.att_out(ctxt))
            x = self.ln1(layers.elementwise_add(x, attn))
            ff = apply(self.drop_ffn, self.ffn_fc1(self.ffn_fc0(x)))
            return self.ln2(layers.elementwise_add(x, ff))

    class BertClassifier(dy.Layer):
        def __init__(self):
            super(BertClassifier, self).__init__("bert")
            self.word_embedding = dy.Embedding(size=[cfg.vocab_size, H])
            self.pos_embedding = dy.Embedding(
                size=[cfg.max_position_embeddings, H])
            self.sent_embedding = dy.Embedding(size=[cfg.type_vocab_size, H])
            self.emb_ln = layer_norm("emb_ln")
            self.emb_drop = dropout(cfg.hidden_dropout)
            self.encoder = dy.Sequential(*[
                ("layer_%d" % i, Encoder("layer_%d" % i))
                for i in range(cfg.num_layers)])
            self.pooler = dy.Linear(H, H, act="tanh")
            self.pool_drop = dropout(cfg.hidden_dropout)
            self.cls = dy.Linear(H, num_classes)

        def forward(self, src_ids, pos_ids, sent_ids, input_mask, label):
            emb = layers.elementwise_add(
                layers.elementwise_add(self.word_embedding(src_ids),
                                       self.pos_embedding(pos_ids)),
                self.sent_embedding(sent_ids))
            x = apply(self.emb_drop, self.emb_ln(emb))
            # [N, S, 1] 0/1 mask -> [N, S] key bias, 0 or -1e4
            key_bias = layers.scale(
                layers.reshape(input_mask, shape=[0, -1]), scale=1e4,
                bias=-1e4)
            key_bias.stop_gradient = True
            for enc in self.encoder._sub_layers.values():
                x = enc(x, key_bias)
            first = layers.slice(x, axes=[1], starts=[0], ends=[1])
            first = layers.reshape(first, shape=[-1, H])
            pooled = apply(self.pool_drop, self.pooler(first))
            logits = self.cls(pooled)
            return layers.mean(layers.softmax_with_cross_entropy(logits,
                                                                 label))

    _ = seq_len  # the feeds' length; no parameter depends on it
    return BertClassifier()


def bert_static_names(cfg):
    """{``build_bert_classifier`` parameter name: ``make_bert_classifier``
    ``state_dict`` key}."""
    names = {"word_embedding": "word_embedding.weight",
             "pos_embedding": "pos_embedding.weight",
             "sent_embedding": "sent_embedding.weight",
             "emb_ln.w_0": "emb_ln.weight", "emb_ln.b_0": "emb_ln.bias",
             "pooler.w_0": "pooler.weight", "pooler.b_0": "pooler.bias",
             "cls.w_0": "cls.weight", "cls.b_0": "cls.bias"}
    for i in range(cfg.num_layers):
        for part in ("att_q", "att_k", "att_v", "att_out", "ffn_fc0",
                     "ffn_fc1", "ln1", "ln2"):
            for s, key in (("w_0", "weight"), ("b_0", "bias")):
                names["layer_%d_%s.%s" % (i, part, s)] = \
                    "encoder.layer_%d.%s.%s" % (i, part, key)
    return names


def make_lenet(fluid, class_num=10):
    """LeNet-5 (``models/lenet.py``) as a dygraph ``Layer``: ``model(img)``
    -> logits, ``img`` [N, 1, 28, 28] float32. Its parameters are made
    here (one call on a zero image)."""
    dy = fluid.dygraph
    layers = fluid.layers

    class LeNet(dy.Layer):
        def __init__(self):
            super(LeNet, self).__init__("lenet")
            self.conv1 = dy.Conv2D("conv1", num_filters=6, filter_size=5,
                                   padding=2, act="relu")
            self.pool1 = dy.Pool2D("pool1", pool_size=2, pool_stride=2)
            self.conv2 = dy.Conv2D("conv2", num_filters=16, filter_size=5,
                                   act="relu")
            self.pool2 = dy.Pool2D("pool2", pool_size=2, pool_stride=2)
            self.fc1 = dy.Linear(16 * 5 * 5, 120, act="relu")
            self.fc2 = dy.Linear(120, 84, act="relu")
            self.fc3 = dy.Linear(84, class_num)

        def forward(self, img):
            h = self.pool2(self.conv2(self.pool1(self.conv1(img))))
            h = layers.reshape(h, shape=[-1, 16 * 5 * 5])
            return self.fc3(self.fc2(self.fc1(h)))

    model = LeNet()
    build_lazy(fluid, model, (1, 1, 28, 28))
    return model


def make_mnist(fluid):
    """The parity file's MNIST convnet: conv 3x3 (4, ReLU), max pool 2,
    ``Linear`` to 10 classes, on [N, 1, 12, 12]."""
    dy = fluid.dygraph
    layers = fluid.layers

    class Mnist(dy.Layer):
        def __init__(self):
            super(Mnist, self).__init__("mnist")
            self.conv = dy.Conv2D("c1", num_filters=4, filter_size=3,
                                  act="relu")
            self.pool = dy.Pool2D("p1", pool_size=2, pool_type="max",
                                  pool_stride=2)
            self.fc = dy.Linear(4 * 5 * 5, 10)

        def forward(self, x):
            h = self.pool(self.conv(x))
            return self.fc(layers.reshape(h, [h.shape[0], -1]))

    return Mnist()


def make_resnet(fluid, depth=18, width=8, class_num=5):
    """A ResNet of basic blocks (depth 18: [2, 2, 2, 2]) at ``width``
    channels in every stage, stride 2 from the second stage, batch norm
    after every conv, global average pool, ``Linear`` head; NCHW input
    with 3 channels."""
    dy = fluid.dygraph
    layers = fluid.layers
    stages = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3]}[depth]

    class ConvBN(dy.Layer):
        def __init__(self, name, filter_size, stride=1, act=None):
            super(ConvBN, self).__init__(name)
            self.conv = dy.Conv2D(name + "c", num_filters=width,
                                  filter_size=filter_size, stride=stride,
                                  padding=(filter_size - 1) // 2,
                                  bias_attr=False)
            self.bn = dy.BatchNorm(name + "b", width, act=act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class Block(dy.Layer):
        def __init__(self, name, stride):
            super(Block, self).__init__(name)
            self.c0 = ConvBN(name + "0", 3, stride, act="relu")
            self.c1 = ConvBN(name + "1", 3)
            self.short = ConvBN(name + "s", 1, stride) if stride != 1 \
                else None

        def forward(self, x):
            s = x if self.short is None else self.short(x)
            return layers.relu(layers.elementwise_add(self.c1(self.c0(x)),
                                                      s))

    class ResNet(dy.Layer):
        def __init__(self):
            super(ResNet, self).__init__("resnet")
            self.stem = ConvBN("stem", 3, act="relu")
            blocks = []
            for i, n in enumerate(stages):
                for j in range(n):
                    blocks.append(("b%d_%d" % (i, j), Block(
                        "b%d_%d" % (i, j), 2 if i and not j else 1)))
            self.blocks = dy.Sequential(*blocks)
            self.gpool = dy.Pool2D("gp", global_pooling=True,
                                   pool_type="avg")
            self.fc = dy.Linear(width, class_num)

        def forward(self, x):
            h = self.gpool(self.blocks(self.stem(x)))
            return self.fc(layers.reshape(h, [h.shape[0], width]))

    return ResNet()


def make_ptb(fluid, vocab, emb, hid, steps):
    """The parity file's PTB LSTM LM: embedding, one LSTM cell unrolled
    over ``steps`` (the gates a ``Linear`` over [x, h]), a ``Linear``
    projection a step. ``model(tokens [B, steps] int64)`` -> a list of
    [B, vocab] logits a step."""
    dy = fluid.dygraph
    layers = fluid.layers

    class Ptb(dy.Layer):
        def __init__(self):
            super(Ptb, self).__init__("ptb")
            self.emb = dy.Embedding(size=[vocab, emb])
            self.gates = dy.Linear(emb + hid, 4 * hid)
            self.proj = dy.Linear(hid, vocab)

        def forward(self, tokens):
            B = tokens.shape[0]
            h = layers.fill_constant([B, hid], "float32", 0.0)
            c = layers.fill_constant([B, hid], "float32", 0.0)
            e = self.emb(tokens)
            logits = []
            for t in range(steps):
                xt = layers.reshape(layers.slice(e, axes=[1], starts=[t],
                                                 ends=[t + 1]), [B, emb])
                z = self.gates(layers.concat([xt, h], axis=1))
                i, f, o, g = layers.split(z, num_or_sections=4, dim=1)
                c = layers.elementwise_add(
                    layers.elementwise_mul(layers.sigmoid(f), c),
                    layers.elementwise_mul(layers.sigmoid(i),
                                           layers.tanh(g)))
                h = layers.elementwise_mul(layers.sigmoid(o),
                                           layers.tanh(c))
                logits.append(self.proj(h))
            return logits

    return Ptb()
