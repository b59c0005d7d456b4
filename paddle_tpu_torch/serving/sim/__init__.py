"""paddle_tpu_torch.serving.sim — trace-driven fleet simulator (port of
``paddle_tpu/serving/sim``).

Replays recorded flight-recorder journeys (or synthetic what-if
variants) through the REAL fleet control-plane classes — the
autoscaler policies, the gateway's admission controller, the router's
pick/breaker logic — on a virtual clock, against replicas whose
service-time model is fit from the same recordings.  A whole recorded
day replays in seconds, deterministically under a fed seed; the CLI
front end is ``python -m paddle_tpu_torch.tools.fleet_sim``.

Quickstart::

    from paddle_tpu_torch.serving import sim

    journeys = sim.load_journeys("flight_controller.jsonl")
    report = sim.FleetSim(
        sim.from_journeys(journeys, scale=10),
        model=sim.ServiceModel.fit(journeys),
        policy=sim.make_policy("slo"),
        seed=42,
    ).run()
    print(report["requests"], report["classes"]["interactive"])
"""

from ...observability.flight import load_journeys, to_journey  # noqa: F401
from ..fleet import make_policy  # noqa: F401
from .core import FleetSim  # noqa: F401
from .replica import ServiceModel, SimReplica  # noqa: F401
from .workload import from_journeys, synthetic_workload  # noqa: F401

__all__ = [
    "FleetSim",
    "ServiceModel",
    "SimReplica",
    "from_journeys",
    "synthetic_workload",
    "make_policy",
    "load_journeys",
    "to_journey",
]
