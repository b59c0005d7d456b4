"""Program serialization (a copy of ``paddle_tpu/fluid/proto.py``, pointed
at the port's ``framework``).

Contract: framework/framework.proto ProgramDesc (L212) ⊃ BlockDesc (L174)
⊃ OpDesc (L43) + VarDesc (L165). ``program_to_spec`` flattens a Program
into a dict carrying exactly the proto's information content — op
type/inputs/outputs/attrs, var name/shape/dtype/persistable/parameter,
block parentage — and ``program_to_bytes`` writes it as framework.proto
wire bytes (``proto_wire``), the reference's bytes for the same Program.
``program_from_bytes`` reads those, and the older self-describing pickled
form (``MAGIC``-prefixed) the reference also reads.
"""

from __future__ import annotations

import pickle

MAGIC = b"PTPU-PROGRAM\x00"
VERSION = 1


def _var_spec(v):
    from .framework import Parameter

    return dict(
        name=v.name,
        shape=list(v.shape),
        dtype=v.dtype,
        lod_level=v.lod_level,
        persistable=v.persistable,
        need_check_feed=getattr(v, "need_check_feed", False),
        stop_gradient=v.stop_gradient,
        is_data=v.is_data,
        type=v.type,
        is_parameter=isinstance(v, Parameter),
        trainable=getattr(v, "trainable", None),
    )


def program_to_spec(program):
    blocks = []
    for b in program.blocks:
        blocks.append(
            dict(
                idx=b.idx,
                parent_idx=b.parent_idx,
                vars=[_var_spec(v) for v in b.vars.values()],
                ops=[
                    dict(
                        type=op_.type,
                        inputs={k: list(v) for k, v in op_.inputs.items()},
                        outputs={k: list(v) for k, v in op_.outputs.items()},
                        attrs=dict(op_.attrs),
                    )
                    for op_ in b.ops
                ],
            )
        )
    return dict(
        version=VERSION,
        blocks=blocks,
        random_seed=program._seed,
        inference_io=getattr(program, "_inference_io", None),
        params_grads=list(program._params_grads),
    )


def program_from_spec(spec):
    from .framework import Operator, Parameter, Program, Variable

    program = Program.__new__(Program)
    Program.__init__(program)
    program.blocks = []
    for bspec in spec["blocks"]:
        from .framework import Block

        b = Block(program, bspec["idx"], bspec["parent_idx"])
        program.blocks.append(b)
    for b, bspec in zip(program.blocks, spec["blocks"]):
        for vs in bspec["vars"]:
            kwargs = dict(
                name=vs["name"],
                shape=vs["shape"],
                dtype=vs["dtype"],
                lod_level=vs["lod_level"],
                persistable=vs["persistable"],
                need_check_feed=vs.get("need_check_feed", False),
                stop_gradient=vs["stop_gradient"],
                is_data=vs["is_data"],
                type=vs["type"],
            )
            if vs.get("is_parameter"):
                v = Parameter(
                    b,
                    kwargs.pop("shape"),
                    kwargs.pop("dtype"),
                    trainable=vs.get("trainable", True),
                    **kwargs,
                )
            else:
                v = Variable(b, **kwargs)
            b.vars[v.name] = v
        for ospec in bspec["ops"]:
            op_ = Operator.__new__(Operator)
            op_.block = b
            op_.type = ospec["type"]
            op_.inputs = {k: list(v) for k, v in ospec["inputs"].items()}
            op_.outputs = {k: list(v) for k, v in ospec["outputs"].items()}
            op_.attrs = dict(ospec["attrs"])
            b.ops.append(op_)
    program._seed = spec.get("random_seed", 0)
    program._params_grads = list(spec.get("params_grads", []))
    if spec.get("inference_io"):
        program._inference_io = spec["inference_io"]
    program.current_block_idx = 0
    return program


def program_to_bytes(program):
    """Serialize to framework.proto wire-format bytes (proto_wire.py);
    metadata the schema has no slot for rides in an unknown field that
    conformant parsers skip."""
    from . import proto_wire

    return proto_wire.encode_program(program_to_spec(program))


def program_from_bytes(data):
    """Deserialize a program; accepts both the protobuf wire format and the
    pickled-dict format (MAGIC-prefixed)."""
    if data.startswith(MAGIC):
        spec = pickle.loads(data[len(MAGIC):])
    else:
        from . import proto_wire

        try:
            spec = proto_wire.decode_program(data)
        except Exception as e:
            raise ValueError(
                "not a program blob (neither pickle-format nor "
                "framework.proto wire bytes): %s" % e
            )
        if not spec.get("blocks"):
            raise ValueError("not a program blob (no blocks)")
    return program_from_spec(spec)

