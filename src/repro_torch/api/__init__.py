"""Facade of the port: Engine, Session and the value types."""
from repro_torch.api.engine import Engine  # noqa: F401
from repro_torch.api.session import Session  # noqa: F401
from repro_torch.api.spec import CompressionSpec, Request, Result  # noqa
