"""Role makers — rank/endpoint discovery (port of
``paddle_tpu/fluid/incubate/fleet/base/role_maker.py``; reference:
incubate/fleet/base/role_maker.py — PaddleCloudRoleMaker reads the env
the launcher sets; UserDefinedRoleMaker takes explicit config). The
port's launcher sets both Paddle's ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ENDPOINTS`` and torch's
``RANK`` / ``WORLD_SIZE``; the Paddle names win, torch's fill in."""

from __future__ import annotations

import os


def _env_int(names, default):
    for n in names:
        v = os.getenv(n)
        if v not in (None, ""):
            return int(v)
    return default


class Role(object):
    WORKER = 1
    SERVER = 2


class RoleMakerBase(object):
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False
        self._role = None
        self._current_id = -1

    def is_worker(self):
        raise NotImplementedError

    def is_server(self):
        raise NotImplementedError

    def is_first_worker(self):
        return self.is_worker() and self.worker_index() == 0

    def worker_num(self):
        return len(self._worker_endpoints)

    def server_num(self):
        return len(self._server_endpoints)

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def generate_role(self):
        raise NotImplementedError


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=False):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        if self._role_is_generated:
            return
        if self._is_collective:
            self._current_id = _env_int(("PADDLE_TRAINER_ID", "RANK"), 0)
            eps = os.getenv("PADDLE_TRAINER_ENDPOINTS")
            if eps:
                self._worker_endpoints = eps.split(",")
            else:
                n = _env_int(("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 1)
                self._worker_endpoints = [
                    "127.0.0.1:%d" % (6170 + i) for i in range(n)]
            self._role = Role.WORKER
        else:
            role = os.getenv("TRAINING_ROLE", "TRAINER")
            self._worker_endpoints = [
                e
                for e in os.getenv(
                    "PADDLE_TRAINER_ENDPOINTS", ""
                ).split(",")
                if e
            ]
            # pserver mode needs only a trainer COUNT, not endpoints
            # (reference launch env sets PADDLE_TRAINERS_NUM). Explicit
            # endpoints win; the count only fills in when absent, and a
            # conflict is a config error worth failing loudly on.
            n = _env_int(("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 0)
            if n and not self._worker_endpoints:
                self._worker_endpoints = ["w%d" % i for i in range(n)]
            elif n and len(self._worker_endpoints) != n:
                raise ValueError(
                    "PADDLE_TRAINERS_NUM=%d disagrees with %d "
                    "PADDLE_TRAINER_ENDPOINTS" % (
                        n, len(self._worker_endpoints)
                    )
                )
            self._server_endpoints = [
                e
                for e in os.getenv(
                    "PADDLE_PSERVERS_IP_PORT_LIST", ""
                ).split(",")
                if e
            ]
            if role == "TRAINER":
                self._role = Role.WORKER
                self._current_id = _env_int(("PADDLE_TRAINER_ID", "RANK"),
                                            0)
            else:
                self._role = Role.SERVER
                cur = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
                self._current_id = (
                    self._server_endpoints.index(cur)
                    if cur in self._server_endpoints
                    else 0
                )
        self._role_is_generated = True

    def is_worker(self):
        if not self._role_is_generated:
            self.generate_role()
        return self._role == Role.WORKER

    def is_server(self):
        if not self._role_is_generated:
            self.generate_role()
        return self._role == Role.SERVER


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = server_endpoints or []
        self._worker_endpoints = ["w%d" % i for i in range(worker_num)]

    def generate_role(self):
        self._role_is_generated = True

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def worker_num(self):
        return self._worker_num


class UserDefinedCollectiveRoleMaker(UserDefinedRoleMaker):
    def __init__(self, current_id=0, worker_endpoints=None):
        worker_endpoints = worker_endpoints or ["127.0.0.1:6170"]
        super().__init__(
            current_id=current_id,
            role=Role.WORKER,
            worker_num=len(worker_endpoints),
        )
        self._worker_endpoints = worker_endpoints
