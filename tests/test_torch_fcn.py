"""FCN-32s on a ResNet trunk (``paddle_tpu_torch/testing/fcn.py``) held
against the JAX package on the CPU: the program each package builds from
its own ``fluid`` and ``models/resnet.py`` is the same desc, and from the
same weights the port's Momentum steps give the reference's loss within
1e-5 and its ``mean_iou`` counts exactly. ResNet-18, 5 classes, 64 × 128
images, batch 2 (the card runs ResNet-50 at Cityscapes' 19 classes and
512 × 1024: ``chip_smoke.py`` op_corpus)."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import profiler as tprofiler
from paddle_tpu_torch.fluid.ops import registry as tregistry
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.testing import fcn
from test_torch_cpu_math import pin_vector_math

pin_vector_math(2)  # 2 threads, vector math set up on one (see there)

DEPTH, CLASSES, HW, BATCH = 18, 5, (64, 128), 2


def _build(fl, rn, depth=DEPTH, classes=CLASSES, hw=HW):
    with fl.unique_name.guard():
        return fcn.build_fcn_resnet(fl, rn, depth, classes, hw)


def _desc(program):
    return [(o.type, {k: list(v) for k, v in o.inputs.items()},
             {k: list(v) for k, v in o.outputs.items()},
             {k: (v.tolist() if isinstance(v, np.ndarray) else
                  list(v) if isinstance(v, tuple) else v)
              for k, v in o.attrs.items()
              if not k.startswith("op_") and not k.startswith("__")})
            for o in program.global_block().ops]


@pytest.mark.parametrize("depth,classes,hw", [(18, 5, (64, 128)),
                                              (50, 19, (512, 1024))],
                         ids=["r18_64x128", "r50_cityscapes"])
def test_fcn_program_is_the_references(depth, classes, hw):
    """The main and startup programs op for op (types, slots, variable
    names, attrs), and every persistable's shape and dtype."""
    ref = _build(jfluid, jresnet, depth, classes, hw)
    port = _build(tfluid, tresnet, depth, classes, hw)
    assert _desc(port[0]) == _desc(ref[0])
    assert [o.type for o in port[1].global_block().ops] == \
        [o.type for o in ref[1].global_block().ops]
    shapes = lambda p: {v.name: (tuple(v.shape), str(v.dtype))  # noqa: E731
                        for v in p.list_vars() if v.persistable}
    assert {k: v[0] for k, v in shapes(port[0]).items()} == \
        {k: v[0] for k, v in shapes(ref[0]).items()}
    types = [o.type for o in port[0].global_block().ops]
    assert types.count("bilinear_interp") == 1
    assert types.count("mean_iou") == 1
    assert port[3].name == ref[3].name


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def test_fcn_momentum_steps_match_reference():
    """Three Momentum steps (lr 0.01, µ 0.9), each from the reference's
    state before it (parameters, velocities, batch-norm statistics, put
    into the port's scope with ``fluid.load_program_scope``): the loss
    within 1e-5 relative, ``mean_iou``'s OutCorrect and OutWrong equal
    and OutMeanIou within 1e-6, no forward replayed, and every
    persistable after the step within 2e-2 relative norm (a wrong op
    moves one by O(1)).

    Each step starts from the reference's state because the two
    trajectories part by rounding alone: in step 1 a stage-3 activation
    within fp32 rounding of 0 (the forward values differ ~7e-6
    relative, other convolution orders) falls on either side of its
    relu, and the batch norms over 64 values a channel carry that flip
    into the gradients below it: the step's velocities and the batch-norm
    biases (which start at 0) read up to 1.4e-2 from the reference's
    (7.0e-4 after steps 2 and 3, where nothing flips), and a free run's
    second loss differs by ~3e-3 (ROADMAP C)."""
    ref_p = _build(jfluid, jresnet)
    port_p = _build(tfluid, tresnet)
    img, lab = fcn.fcn_batch(BATCH, CLASSES, HW, seed=1)
    feed = {"img": img, "label": lab}
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.core.Scope()
    jexe.run(ref_p[1], scope=jscope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(port_p[1], scope=tscope)
    names = _persistables(ref_p[0])
    assert names == _persistables(port_p[0])
    fetch = [ref_p[3].name] + [v.name for v in ref_p[4]]
    losses = []
    for step in range(3):
        state = {n: np.array(jscope.get(n)) for n in names}
        tfluid.load_program_scope(port_p[0], tscope, state)
        replays = tprofiler.get_counter(tregistry.REPLAY_COUNTER)
        r = [np.asarray(v) for v in jexe.run(ref_p[0], feed=feed,
                                             fetch_list=fetch, scope=jscope)]
        p = texe.run(port_p[0], feed=feed, fetch_list=fetch, scope=tscope)
        assert tprofiler.get_counter(tregistry.REPLAY_COUNTER) == replays
        np.testing.assert_allclose(p[0], r[0], rtol=1e-5, err_msg=step)
        np.testing.assert_allclose(p[1], r[1], rtol=1e-6, err_msg=step)
        np.testing.assert_array_equal(p[2], r[2], err_msg=step)
        np.testing.assert_array_equal(p[3], r[3], err_msg=step)
        assert p[2].dtype == p[3].dtype == np.int32
        for n in names:
            want = np.array(jscope.get(n))
            d = float(np.linalg.norm(tscope.get(n).numpy() - want))
            assert d <= 2e-2 * max(float(np.linalg.norm(want)), 1e-6), \
                (step, n, d)
        losses.append(float(r[0].reshape(-1)[0]))
    assert losses[-1] < losses[0]


def test_fcn_learns_on_the_cpu():
    """Eight Momentum steps of the port's program on one fixed batch:
    the loss falls and the mean IoU rises (first two against last two,
    the card's check at its 20 steps)."""
    main, startup, _f, loss, miou, _pred = _build(tfluid, tresnet)
    img, lab = fcn.fcn_batch(BATCH, CLASSES, HW, seed=2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    got = [exe.run(main, feed={"img": img, "label": lab},
                   fetch_list=[loss, miou[0]], scope=scope)
           for _ in range(8)]
    losses = [float(g[0].reshape(-1)[0]) for g in got]
    ious = [float(g[1].reshape(-1)[0]) for g in got]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    assert np.mean(ious[-2:]) > np.mean(ious[:2])


def test_fcn_batch_has_cityscapes_labels():
    """The synthetic batch: int64 labels in [0, classes) or the ignore
    label 255 (about a tenth of the tiles), constant on each tile, and
    each labelled tile's mean colour nearest its class's colour."""
    img, lab = fcn.fcn_batch(2, 19, (128, 256), seed=3)
    assert img.shape == (2, 3, 128, 256) and img.dtype == np.float32
    assert lab.shape == (2, 128, 256) and lab.dtype == np.int64
    vals = set(np.unique(lab).tolist())
    assert fcn.IGNORE_LABEL in vals and vals - {255} <= set(range(19))
    tiles = lab[:, ::64, ::64]
    assert (lab == tiles.repeat(64, 1).repeat(64, 2)).all()
    means = img.reshape(2, 3, 2, 64, 4, 64).mean((3, 5))   # [b, c, ty, tx]
    known = tiles != fcn.IGNORE_LABEL
    palette = {}
    for b, ty, tx in zip(*np.nonzero(known)):
        palette.setdefault(tiles[b, ty, tx], []).append(means[b, :, ty, tx])
    centres = {c: np.mean(v, 0) for c, v in palette.items()}
    for b, ty, tx in zip(*np.nonzero(known)):
        m = means[b, :, ty, tx]
        nearest = min(centres, key=lambda c: np.linalg.norm(centres[c] - m))
        assert nearest == tiles[b, ty, tx]
