"""BERT's sequence classifier trained under LAMB, written once for both
packages: the program of ``models/bert.py``'s ``build_bert_classifier``
(the encoder, dropout on the pooled output, the ``cls`` fc, softmax
cross entropy averaged over the batch, top-1 accuracy) with
``fluid.optimizer.LambOptimizer`` in place of Adam (You et al., 2019,
the optimizer of BERT pre-training at scale). ``fluid`` and ``bert``
are a package's ``fluid`` and ``models.bert`` modules: the port's by
default; a parity test passes the JAX package's to build the same
program there from its own ``bert_encoder``."""

__all__ = ["build_bert_classifier_lamb"]


def build_bert_classifier_lamb(cfg, seq_len, num_classes=2,
                               learning_rate=2e-5, lamb_weight_decay=0.01,
                               exclude_from_weight_decay_fn=None,
                               fluid=None, bert=None):
    """Returns (main, startup, feeds, avg_loss, acc), the feeds those of
    ``build_bert_classifier``: ``src_ids`` / ``pos_ids`` / ``sent_ids``
    [N, seq_len, 1] int64, ``input_mask`` [N, seq_len, 1] float32,
    ``label`` [N, 1] int64."""
    if fluid is None:
        from .. import fluid
    if bert is None:
        from ..models import bert
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        feeds = [layers.data(name=n, shape=[seq_len, 1], dtype="int64")
                 for n in ("src_ids", "pos_ids", "sent_ids")]
        feeds.append(layers.data(name="input_mask", shape=[seq_len, 1],
                                 dtype="float32"))
        label = layers.data(name="label", shape=[1], dtype="int64")
        feeds.append(label)
        _, pooled = bert.bert_encoder(*feeds[:4], cfg)
        pooled = bert._dropout(pooled, cfg.hidden_dropout, cfg.is_test)
        logits = layers.fc(input=pooled, size=num_classes, name="cls")
        avg_loss = layers.mean(layers.softmax_with_cross_entropy(logits,
                                                                 label))
        acc = layers.accuracy(input=layers.softmax(logits), label=label)
        fluid.optimizer.LambOptimizer(
            learning_rate=learning_rate, lamb_weight_decay=lamb_weight_decay,
            exclude_from_weight_decay_fn=exclude_from_weight_decay_fn,
        ).minimize(avg_loss)
    return main, startup, feeds, avg_loss, acc
