"""What a configuration's builder (``benchmark/configs/<config>.py``)
hands the harness."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class Cell:
    """The system under test and the benchmark's side of one configuration.

    ``mpc``: the port's controller; ``params``: the model weights it is
    given at every re-plan; ``problem``: the plain reference
    (:class:`benchmark.reference.nlp.Problem`, float64) that judges its
    plans; ``plant(x, u)``: the benchmark's true plant, one step, on the
    device; ``lift(x)``: a fleet's physical starts as the controller's
    states; ``stage_flops``: operations of one model evaluation at one
    stage, from the configuration's widths."""

    mpc: Any
    params: Any
    problem: Any
    plant: Callable
    lift: Callable
    stage_flops: int

    @property
    def H(self) -> int:
        return self.problem.H

    @property
    def nx(self) -> int:
        return self.problem.nx

    @property
    def nu(self) -> int:
        return self.problem.nu
