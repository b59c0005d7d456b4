"""Collective transpilers (port of
``paddle_tpu/fluid/transpiler/collective.py``) — rewrite a single-process
Program for data-parallel training.

Reference: python/paddle/fluid/transpiler/collective.py — GradAllReduce
(:178: scale loss grad by 1/nranks, insert c_allreduce_sum per grad) and
LocalSGD (:269: periodic parameter averaging with snapshot vars); the
comm bootstrap (:99) inserts c_comm_init per ring.

The programs written are the JAX package's, op for op. Each rank runs
one of them in its own process: the inserted c_* ops lower to
``torch.distributed`` collectives over the ring's process group
(``ops/collective_ops.py``), and c_comm_init makes that group.
"""

from __future__ import annotations

from ..framework import OP_ROLE_KEY, OP_ROLE_VAR_KEY, OpRole


class Collective(object):
    def __init__(self, nrings=1):
        self.nrings = nrings
        self.endpoints = None
        self.current_endpoint = None
        self.nranks = None

    def transpile(
        self,
        startup_program,
        main_program,
        rank,
        endpoints,
        current_endpoint,
        wait_port=True,
        nranks=None,
    ):
        """``nranks`` defaults to len(endpoints): one rank per process,
        each driving one device."""
        self.startup_program = startup_program
        self.main_program = main_program
        self.rank = rank
        if isinstance(endpoints, str):
            endpoints = endpoints.split(",")
        self.endpoints = endpoints
        self.current_endpoint = current_endpoint
        self.nranks = int(nranks) if nranks else len(endpoints)
        self._transpile_startup_program()
        self._transpile_main_program()

    def _transpile_startup_program(self):
        # reference inserts c_gen_nccl_id + c_comm_init per ring; the world
        # starts from the launcher's env, and c_comm_init makes the ring's
        # group on every rank in the same order
        block = self.startup_program.global_block()
        for ring_id in range(self.nrings):
            block.append_op(
                type="c_comm_init",
                inputs={},
                outputs={},
                attrs={
                    "nranks": self.nranks,
                    "rank": self.rank,
                    "ring_id": ring_id,
                    OP_ROLE_KEY: OpRole.Forward,
                },
            )

    def _transpile_main_program(self):
        raise NotImplementedError


class GradAllReduce(Collective):
    """Insert allreduce on every param grad (reference: collective.py:178)."""

    def __init__(self, nrings=1):
        super().__init__(nrings)

    def _transpile_main_program(self):
        self._transpile_main_program_inplace(
            self.main_program, self.nranks, loss_name=None
        )

    def _transpile_main_program_inplace(self, program, nranks, loss_name=None):
        block = program.global_block()
        if nranks <= 1:
            return
        self._insert_scale_loss_grad_ops(block, nranks, loss_name)
        self._insert_allreduce_ops(block, nranks)

    def _insert_scale_loss_grad_ops(self, block, nranks, loss_name=None):
        """loss@GRAD *= 1/nranks so the summed allreduce averages
        (reference: collective.py _insert_scale_loss_grad_ops; PE equivalent
        ScaleLossGradOpHandle)."""
        for idx, op_ in reversed(list(enumerate(block.ops))):
            if not self._is_loss_grad_op(op_):
                continue
            loss_grad_var_name = op_.output_arg_names[0]
            if loss_name is not None and loss_grad_var_name != loss_name + "@GRAD":
                continue
            block._insert_op(
                idx + 1,
                type="scale",
                inputs={"X": [loss_grad_var_name]},
                outputs={"Out": [loss_grad_var_name]},
                attrs={
                    "scale": 1.0 / nranks,
                    OP_ROLE_KEY: OpRole.Backward,
                },
            )

    def _is_loss_grad_op(self, op_):
        if OP_ROLE_KEY not in op_.attrs:
            return False
        return op_.attrs[OP_ROLE_KEY] == (OpRole.Backward | OpRole.Loss) or (
            op_.type == "fill_constant"
            and op_.output_arg_names
            and op_.output_arg_names[0].endswith("@GRAD")
            and op_.attrs.get(OP_ROLE_KEY) == OpRole.Backward
        )

    def _is_backward_op(self, op_):
        return OP_ROLE_KEY in op_.attrs and (
            op_.attrs[OP_ROLE_KEY] & OpRole.Backward
        )

    def _is_optimizer_op(self, op_):
        return OP_ROLE_KEY in op_.attrs and (
            op_.attrs[OP_ROLE_KEY] & OpRole.Optimize
        )

    def _insert_allreduce_ops(self, block, nranks):
        # find grads via op_role_var annotations on backward ops
        grad_names = []
        for op_ in block.ops:
            if self._is_backward_op(op_) and OP_ROLE_VAR_KEY in op_.attrs:
                role_vars = op_.attrs[OP_ROLE_VAR_KEY]
                for i in range(1, len(role_vars), 2):
                    if role_vars[i] not in grad_names:
                        grad_names.append(role_vars[i])
        # DGC grads communicate inside dgc_momentum (the reference swaps
        # AllReduceOpHandle for SparseAllReduceOpHandle,
        # details/sparse_all_reduce_op_handle.cc); skip the dense allreduce
        dgc_grads = {
            n
            for op_ in block.ops
            if op_.type == "dgc_momentum"
            for n in op_.input("Grad")
        }
        grad_names = [g for g in grad_names if g not in dgc_grads]
        if not grad_names:
            return
        # insert c_allreduce_sum right before the first optimizer op
        insert_idx = None
        for idx, op_ in enumerate(block.ops):
            if self._is_optimizer_op(op_):
                insert_idx = idx
                break
        if insert_idx is None:
            insert_idx = len(block.ops)
        ring_id = 0
        for grad_name in grad_names:
            block._insert_op(
                insert_idx,
                type="c_allreduce_sum",
                inputs={"X": [grad_name]},
                outputs={"Out": [grad_name]},
                attrs={
                    "ring_id": ring_id % self.nrings,
                    OP_ROLE_KEY: OpRole.Backward,
                },
            )
            insert_idx += 1
            ring_id += 1


class LocalSGD(Collective):
    """Parameter averaging (reference: collective.py:269): after each
    update the parameter's change since its snapshot is summed over the
    ranks and divided by nranks, and the snapshot follows the parameter.
    The program averages every step, as the JAX package's does
    (``k_steps`` is recorded)."""

    def __init__(self, nrings=1, k_steps=1):
        super().__init__(nrings)
        self.k_steps = k_steps
        self.snapshot_key = "@SNAPSHOT"

    def snapshot_name(self, param_name):
        return param_name + self.snapshot_key

    def _transpile_main_program(self):
        block = self.main_program.global_block()
        ordered_param_snapshot = []
        ring_id = -1
        for idx, op_ in reversed(list(enumerate(block.ops))):
            if self._is_update_op(op_):
                param = block.vars[op_.input("Param")[0]]
                snapshot = block.create_var(
                    name=self.snapshot_name(param.name),
                    shape=param.shape,
                    persistable=True,
                    dtype=param.dtype,
                )
                # delta = param - snapshot ; allreduce-average delta ;
                # param = snapshot + delta/nranks ; snapshot = param
                ring_id = (ring_id + 1) % self.nrings
                block._insert_op(
                    idx + 1,
                    type="elementwise_sub",
                    inputs={"X": [snapshot], "Y": [param]},
                    outputs={"Out": [param]},
                    attrs={OP_ROLE_KEY: OpRole.Optimize},
                )
                block._insert_op(
                    idx + 2,
                    type="c_allreduce_sum",
                    inputs={"X": [param]},
                    outputs={"Out": [param]},
                    attrs={"ring_id": ring_id, OP_ROLE_KEY: OpRole.Optimize},
                )
                block._insert_op(
                    idx + 3,
                    type="scale",
                    inputs={"X": [param]},
                    outputs={"Out": [param]},
                    attrs={
                        "scale": 1.0 / self.nranks,
                        OP_ROLE_KEY: OpRole.Optimize,
                    },
                )
                block._insert_op(
                    idx + 4,
                    type="elementwise_sub",
                    inputs={"X": [snapshot], "Y": [param]},
                    outputs={"Out": [param]},
                    attrs={OP_ROLE_KEY: OpRole.Optimize},
                )
                block._insert_op(
                    idx + 5,
                    type="assign",
                    inputs={"X": [param]},
                    outputs={"Out": [snapshot]},
                    attrs={OP_ROLE_KEY: OpRole.Optimize},
                )
                ordered_param_snapshot.append((param, snapshot))

        # init snapshots in startup
        startup_block = self.startup_program.global_block()
        for param, snapshot in ordered_param_snapshot:
            if not startup_block.has_var(snapshot.name):
                startup_block.create_var(
                    name=snapshot.name,
                    shape=param.shape,
                    persistable=True,
                    dtype=param.dtype,
                )
            if startup_block.has_var(param.name):
                startup_block.append_op(
                    type="assign",
                    inputs={"X": [param.name]},
                    outputs={"Out": [snapshot.name]},
                )

    def _is_update_op(self, op_):
        return (
            "Param" in op_.inputs
            and "Grad" in op_.inputs
            and "LearningRate" in op_.inputs
        )
