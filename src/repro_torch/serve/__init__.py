from repro_torch.serve.engine import Engine, ServeApp

__all__ = ["Engine", "ServeApp"]
