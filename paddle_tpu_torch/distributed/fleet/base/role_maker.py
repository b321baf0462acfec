"""Role makers: who this process is in the job.

Port of ``paddle_tpu/distributed/fleet/base/role_maker.py``.
``PaddleCloudRoleMaker`` reads the launcher's environment contract
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``; in parameter-server mode
``TRAINING_ROLE`` and ``PADDLE_PSERVERS_IP_PORT_LIST``);
``UserDefinedRoleMaker`` takes the role and endpoints from its
arguments.
"""

from __future__ import annotations

import os
from typing import List, Optional

__all__ = ["Role", "PaddleCloudRoleMaker", "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def _worker_num(self) -> int:
        raise NotImplementedError

    def _worker_index(self) -> int:
        raise NotImplementedError

    def _is_worker(self) -> bool:
        raise NotImplementedError

    def _is_server(self) -> bool:
        raise NotImplementedError

    def _is_first_worker(self) -> bool:
        return self._is_worker() and self._worker_index() == 0

    # paddle's public spellings
    def worker_num(self) -> int:
        return self._worker_num()

    def worker_index(self) -> int:
        return self._worker_index()

    def is_worker(self) -> bool:
        return self._is_worker()

    def is_server(self) -> bool:
        return self._is_server()

    def is_first_worker(self) -> bool:
        return self._is_first_worker()


class PaddleCloudRoleMaker(RoleMakerBase):
    """Role from the launcher's environment variables (reference default).

    Collective mode: ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``.
    PS mode: ``TRAINING_ROLE`` in {TRAINER, PSERVER} plus
    ``PADDLE_PSERVERS_IP_PORT_LIST`` / ``PADDLE_PORT``.
    """

    def __init__(self, is_collective: bool = False, **kwargs):
        self._is_collective = is_collective
        self._kwargs = kwargs
        if is_collective:
            # collective jobs have no servers — a stale PS-mode
            # TRAINING_ROLE env var must not demote workers (reference
            # semantics)
            self._role = Role.WORKER
        else:
            self._role = (Role.WORKER
                          if os.environ.get("TRAINING_ROLE",
                                            "TRAINER").upper()
                          in ("TRAINER", "WORKER")
                          else Role.SERVER)

    def _worker_num(self) -> int:
        return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))

    def _worker_index(self) -> int:
        return int(os.environ.get("PADDLE_TRAINER_ID", 0))

    def _is_worker(self) -> bool:
        return self._role == Role.WORKER

    def _is_server(self) -> bool:
        return self._role == Role.SERVER

    def _server_num(self) -> int:
        return len(self._get_pserver_endpoints())

    def _get_pserver_endpoints(self) -> List[str]:
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        return [e for e in eps.split(",") if e]

    def _get_trainer_endpoints(self) -> List[str]:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return [e for e in eps.split(",") if e]


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """Explicit role/topology (reference UserDefinedRoleMaker): for tests
    and custom schedulers that don't use the env contract."""

    def __init__(self, is_collective: bool = False,
                 current_id: int = 0, role: int = Role.WORKER,
                 worker_num: int = 1,
                 server_endpoints: Optional[List[str]] = None,
                 worker_endpoints: Optional[List[str]] = None, **kwargs):
        super().__init__(is_collective, **kwargs)
        self._current_id = current_id
        self._role = role
        self._num_workers = worker_num
        self._server_eps = server_endpoints or []
        self._worker_eps = worker_endpoints or []

    def _worker_num(self) -> int:
        return self._num_workers

    def _worker_index(self) -> int:
        return self._current_id

    def _server_num(self) -> int:
        return len(self._server_eps)

    def _get_pserver_endpoints(self) -> List[str]:
        return list(self._server_eps)

    def _get_trainer_endpoints(self) -> List[str]:
        # fully user-supplied: never fall back to env (that's the point)
        return list(self._worker_eps)
