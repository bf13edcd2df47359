from repro_torch.serve.engine import Engine, ServeApp
from repro_torch.serve.fleet import FleetController
from repro_torch.serve.workload import FleetPolicy, RequestTrace, Router

__all__ = ["Engine", "ServeApp", "FleetController", "FleetPolicy",
           "RequestTrace", "Router"]
