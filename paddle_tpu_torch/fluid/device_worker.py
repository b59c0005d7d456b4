"""Device-worker descriptors (reference:
python/paddle/fluid/device_worker.py — DeviceWorker:19 / Hogwild:70 /
DownpourSGD:93 / Section:192 / DeviceWorkerFactory:240).

In the reference these classes only GENERATE the worker section of
trainer_desc.proto; the actual loops live in C++ (hogwild_worker.cc,
downpour_worker.cc, section_worker.cc). Here the loops live inside the
trainers themselves (fluid/trainer.py MultiTrainer / DownpourTrainer /
PipelineTrainer), so these descriptors carry the configuration surface
and map onto the matching trainer class.

Port of ``paddle_tpu/fluid/device_worker.py``."""

__all__ = ["DeviceWorker", "Hogwild", "DownpourSGD", "Section",
           "DeviceWorkerFactory"]


class DeviceWorker(object):
    """Abstract configuration holder (reference device_worker.py:19)."""

    # which fluid.trainer class runs this worker's loop
    trainer_name = "MultiTrainer"

    def __init__(self):
        self._program = None
        self._infer = None
        self._fleet_desc = None

    def _set_infer(self, infer=False):
        self._infer = infer

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program


class Hogwild(DeviceWorker):
    """Lock-free multi-thread loop (reference :70 / hogwild_worker.cc;
    executed by MultiTrainer here)."""

    trainer_name = "MultiTrainer"


class DownpourSGD(DeviceWorker):
    """Sparse pserver pull/push worker (reference :93 /
    downpour_worker.cc; executed by DownpourTrainer here)."""

    trainer_name = "DownpourTrainer"


class Section(DeviceWorker):
    """Pipeline section worker (reference :192 / section_worker.cc;
    executed by PipelineTrainer here)."""

    trainer_name = "PipelineTrainer"

    def __init__(self):
        super(Section, self).__init__()
        self._section_config = None

    def _set_section_config(self, cfg):
        self._section_config = cfg


class DeviceWorkerFactory(object):
    """reference :240 — name -> DeviceWorker instance."""

    def _create_device_worker(self, worker_type):
        classes = {"Hogwild": Hogwild, "DownpourSGD": DownpourSGD,
                   "Section": Section}
        key = worker_type[0].upper() + worker_type[1:]
        if key not in classes:
            raise ValueError("unknown device worker %r" % worker_type)
        return classes[key]()
